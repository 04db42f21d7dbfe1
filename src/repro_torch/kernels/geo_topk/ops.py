"""Public fused geo-selection op: CUDA kernels on the card, the plain
PyTorch version on the CPU.

``pack_inputs`` flattens a (users, replicas) query into the dtype-correct
numpy arrays (``pack_user_inputs`` / ``pack_node_inputs`` split the two
halves so callers with a static replica set can cache the node half —
see ``SelectionEngine``'s node-epoch cache); ``inputs_from_numpy`` moves
such a query onto a device as tensors; ``geo_topk`` dispatches and
returns per-user ``(scores, indices)`` top-k.  ``SelectionEngine`` in
``repro_torch.core.selection`` maps indices back to Task objects.

Layout rule on the card: the untiled kernel (``geo_topk_fused``, one
thread per user scanning every node) up to ``UNTILED_MAX_NODES`` nodes;
above that, or whenever the caller passes ``node_tile``, the node-tiled
pair (``prefix_count`` + ``geo_topk_tiled`` + ``topk_merge``), which
splits the node axis across thread blocks so that no thread's serial
scan grows with N.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.selection import AFFINITY_TABLE, CODE_PRECISION
from repro_torch.kernels.geo_topk import kernel
from repro_torch.kernels.geo_topk.ref import MIN_PROXIMITY_HITS

PREFIX_SHIFT = 5 * CODE_PRECISION - 20   # keep the top 4 chars = 20 bits
# Both from chip_smoke.py's layout grid on an H100 (PERF.md): for 1,024 to
# 100,000 users the untiled kernel is faster up to 4,096 nodes (3x at the
# main path's 1,024) and the tiled pair from 8,192 up; 4,096 was the
# fastest node tile at 100,000 users x 65,536 nodes.
UNTILED_MAX_NODES = 4096
DEFAULT_NODE_TILE = 4096


class GeoTopKInputs(NamedTuple):
    user_lat: torch.Tensor      # (U,) fp32
    user_lon: torch.Tensor      # (U,) fp32
    user_net: torch.Tensor      # (U,) int32 net-type index
    user_code20: torch.Tensor   # (U,) int32, top-4-char Morton prefix
    node_lat: torch.Tensor      # (N,) fp32
    node_lon: torch.Tensor      # (N,) fp32
    node_free: torch.Tensor     # (N,) fp32 free-slot fraction
    node_aff: torch.Tensor      # (M, N) fp32 affinity columns per node
    node_code20: torch.Tensor   # (N,) int32
    node_valid: torch.Tensor    # (N,) fp32 1.0 = schedulable


def code20(code45) -> np.ndarray:
    """45-bit engine Morton codes -> kernel 20-bit prefixes (int32)."""
    return (np.asarray(code45, np.int64) >> PREFIX_SHIFT).astype(np.int32)


def pack_user_inputs(user_lat, user_lon, user_net, user_code45):
    """User half of a query as kernel-ready numpy arrays."""
    return (np.asarray(user_lat, np.float32),
            np.asarray(user_lon, np.float32),
            np.asarray(user_net, np.int32),
            code20(user_code45))


def pack_node_inputs(node_lat, node_lon, node_free, node_net,
                     node_code45, node_valid=None):
    """Node half of a query.  ``node_valid`` marks schedulable rows
    (1.0); pass zeros for padding rows — they score ``NEG`` and fall out
    of the top-k."""
    node_net = np.asarray(node_net, np.int64)
    if node_valid is None:
        node_valid = np.ones(len(node_lat), np.float32)
    return (np.asarray(node_lat, np.float32),
            np.asarray(node_lon, np.float32),
            np.asarray(node_free, np.float32),
            AFFINITY_TABLE[node_net, :].T.astype(np.float32),
            code20(node_code45),
            np.asarray(node_valid, np.float32))


def pack_inputs(user_lat, user_lon, user_net, user_code45,
                node_lat, node_lon, node_free, node_net,
                node_code45, node_valid=None) -> tuple:
    """45-bit engine codes + net indices -> the ten kernel-ready numpy
    arrays, in ``GeoTopKInputs`` field order."""
    return (*pack_user_inputs(user_lat, user_lon, user_net, user_code45),
            *pack_node_inputs(node_lat, node_lon, node_free, node_net,
                              node_code45, node_valid))


def to_device(arrays, device) -> tuple:
    """numpy arrays -> contiguous tensors of the same dtypes on
    ``device`` (the host-to-device edge of every query)."""
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in arrays)


def inputs_from_numpy(packed, device) -> GeoTopKInputs:
    """The ten numpy arrays of a packed query (this module's
    ``pack_inputs``, or the JAX package's, which has the same fields and
    dtypes) -> ``GeoTopKInputs`` tensors on ``device``.  This is the
    system's state crossing onto the card: the node half plus the user
    half of one query."""
    dtypes = kernel.INPUT_DTYPES
    if len(packed) != len(dtypes):
        raise ValueError(f"expected {len(dtypes)} arrays, got {len(packed)}")
    return GeoTopKInputs(*(t.to(dt) for t, dt in
                           zip(to_device(packed, device), dtypes)))


def geo_topk(packed: GeoTopKInputs, *, k: int, need: Optional[int] = None,
             block_u: Optional[int] = None, node_tile: Optional[int] = None):
    """Per-user top-k replica ``(scores (U, k) fp32, indices (U, k)
    int32)`` over the packed query, ties to the lowest index.

    Tensors on the CPU go to the plain PyTorch version; tensors on a CUDA
    device go to the hand-written kernels (the layout rule is in the
    module docstring) or the call raises.  ``block_u`` is accepted for
    call-site parity with the JAX package; the CUDA kernels fix their
    thread-block width.
    """
    del block_u
    n = packed.node_lat.shape[0]
    if need is None:
        need = min(MIN_PROXIMITY_HITS, n)
    if node_tile is not None or n > UNTILED_MAX_NODES:
        tile = DEFAULT_NODE_TILE if node_tile is None else node_tile
        counts = kernel.prefix_count(packed.user_code20, packed.node_code20,
                                     packed.node_valid, node_tile=tile)
        part_s, part_i = kernel.geo_topk_tiled(packed, counts, k=k,
                                               need=need, node_tile=tile)
        return kernel.topk_merge(part_s, part_i, k=k)
    return kernel.geo_topk_fused(packed, k=k, need=need)
