"""Fused geo-selection top-k: hand-written CUDA kernels for Hopper
(``kernel.py`` + ``csrc/geo_topk.cu``) behind ``ops.geo_topk``, with the
plain PyTorch version in ``ref.py``."""
from repro_torch.kernels.geo_topk.ops import (GeoTopKInputs, geo_topk,  # noqa: F401
                                              inputs_from_numpy, pack_inputs,
                                              pack_node_inputs,
                                              pack_user_inputs)
