"""Hand-written Hopper kernels of the PyTorch port.

Each kernel subpackage ships three files:

* ``ref.py``    — the plain PyTorch version: the CPU path and the
  reference each kernel is held against on the card
* ``kernel.py`` — ctypes wrappers of the CUDA C++ kernels in
  ``repro_torch/csrc`` (built with ``nvcc`` on first CUDA use), each with
  a launch counter
* ``ops.py``    — the public entry point: dispatches CPU tensors to the
  plain version and CUDA tensors to the kernels

Kernels: geo_topk (fused control-plane edge selection: haversine + net
affinity + resource scoring with per-user top-k, paper §3.2 Algorithm 1).
The JAX package's model-serving kernels are not ported yet (ROADMAP).
"""
