"""PyTorch/CUDA port of the Armada reproduction (``repro``, the JAX
package, stays the reference).  Imports torch and numpy only."""
