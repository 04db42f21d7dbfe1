"""Plain PyTorch version of fused geo-selection top-k (paper Algorithm 1).

Scores every (user, replica) pair in one pass:

    score = W_RESOURCE * free + W_AFFINITY * aff + W_PROXIMITY * prox
    prox  = 1 / (1 + haversine_km / 10)

after the paper's adaptive-precision geohash proximity filter: for
p = 4..1, keep replicas whose first ``p`` geohash chars match the user's;
the first ``p`` with >= min(4, N) hits wins, else no filter.  Prefixes
are compared on 20-bit Morton codes (the first 4 base32 chars of
``repro_torch.core.geohash.encode_batch`` codes, computed in float64 on
the host), so every integer op stays inside int32.

This module is the port's reference for the CUDA kernels in
``repro_torch/csrc/geo_topk.cu``: the wrappers in ``kernel.py`` run these
functions for tensors on the CPU, and the card's kernels are held against
them.  It follows the JAX package's jnp oracle op for op (same fp32
operation order), and its top-k breaks score ties to the lowest index as
``lax.top_k`` does — ``torch.topk`` does not promise that, so top-k here
is a stable descending sort.  Masked-out pairs score ``NEG``.
"""
from __future__ import annotations

import numpy as np
import torch

# single source of truth for the Algorithm-1 constants lives with the
# engine; the kernel must score exactly what the numpy path scores
from repro_torch.core.selection import (MIN_PROXIMITY_HITS, W_AFFINITY,
                                        W_PROXIMITY, W_RESOURCE)
from repro_torch.core.selection import PROXIMITY_PRECISION as PREFIX_CHARS

EARTH_KM = 6371.0
NEG = -1e30
# float32(pi / 180), the JAX oracle's ``jnp.float32(jnp.pi / 180.0)``
RAD = float(np.float32(np.pi / 180.0))
# shift amounts of the adaptive filter, finest precision first (p = 4..1);
# a shift of 5 * PREFIX_CHARS (20) means no filter
SHIFTS = tuple(5 * (PREFIX_CHARS - p) for p in range(PREFIX_CHARS, 0, -1))
NO_FILTER_SHIFT = 5 * PREFIX_CHARS
IDX_SENTINEL = 2**31 - 1


def haversine_km(ulat, ulon, nlat, nlon):
    """Broadcasted fp32 haversine: (U, 1) x (1, N) -> (U, N)."""
    p1 = ulat * RAD
    p2 = nlat * RAD
    dp = (nlat - ulat) * RAD
    dl = (nlon - ulon) * RAD
    sdp = torch.sin(dp / 2)
    sdl = torch.sin(dl / 2)
    a = sdp * sdp + torch.cos(p1) * torch.cos(p2) * (sdl * sdl)
    return 2.0 * EARTH_KM * torch.asin(torch.sqrt(torch.clamp(a, 0.0, 1.0)))


def _raw_scores(user_lat, user_lon, user_net, node_lat, node_lon,
                node_free, node_aff):
    """Unfiltered (U, N) fp32 Algorithm-1 scores."""
    d = haversine_km(user_lat[:, None], user_lon[:, None],
                     node_lat[None, :], node_lon[None, :])
    # a 0-dim tensor divisor keeps this a true division on every device
    # (CUDA turns division by a Python scalar into a reciprocal multiply)
    prox = 1.0 / (1.0 + d / d.new_tensor(10.0))
    m = node_aff.shape[0]
    onehot = (user_net[:, None].long()
              == torch.arange(m, device=user_net.device)[None, :]
              ).to(torch.float32)
    aff = onehot @ node_aff                            # (U, N), exact
    return (W_RESOURCE * node_free[None, :] + W_AFFINITY * aff
            + W_PROXIMITY * prox)


def proximity_mask(user_code20, node_code20, node_valid, need: int):
    """(U, N) bool: the adaptive-precision prefix filter over valid
    nodes — the restricted filter down to p=1, with unsatisfied rows
    falling back to no filter (every valid node)."""
    local, done = proximity_mask_restricted(user_code20, node_code20,
                                            node_valid, need, 1)
    valid = node_valid[None, :] > 0
    return torch.where(done[:, None], local, valid)


def proximity_mask_restricted(user_code20, node_code20, node_valid,
                              need: int, p_min: int):
    """Adaptive filter restricted to precisions ``p >= p_min``, with NO
    global fallback.  Returns ``(mask, satisfied)``; unsatisfied rows
    stay all-False."""
    valid = node_valid[None, :] > 0
    u = user_code20.shape[0]
    local = torch.zeros((u, node_code20.shape[0]), dtype=torch.bool,
                        device=user_code20.device)
    done = torch.zeros(u, dtype=torch.bool, device=user_code20.device)
    for p in range(PREFIX_CHARS, p_min - 1, -1):
        shift = 5 * (PREFIX_CHARS - p)
        eq = ((user_code20[:, None] >> shift)
              == (node_code20[None, :] >> shift)) & valid
        use = (eq.sum(dim=1) >= need) & ~done
        local = torch.where(use[:, None], eq, local)
        done = done | use
    return local, done


def score_matrix_restricted(user_lat, user_lon, user_net, user_code20,
                            node_lat, node_lon, node_free, node_aff,
                            node_code20, node_valid, need: int, p_min: int):
    """(U, N) fp32 shard-local scores plus the (U,) satisfied mask."""
    scores = _raw_scores(user_lat, user_lon, user_net, node_lat, node_lon,
                         node_free, node_aff)
    local, sat = proximity_mask_restricted(user_code20, node_code20,
                                           node_valid, need, p_min)
    return torch.where(local, scores, scores.new_tensor(NEG)), sat


def score_matrix(user_lat, user_lon, user_net, user_code20,
                 node_lat, node_lon, node_free, node_aff, node_code20,
                 node_valid, need: int):
    """(U, N) fp32 scores with filtered/invalid pairs at ``NEG``."""
    scores = _raw_scores(user_lat, user_lon, user_net, node_lat, node_lon,
                         node_free, node_aff)
    local = proximity_mask(user_code20, node_code20, node_valid, need)
    return torch.where(local, scores, scores.new_tensor(NEG))


def topk_stable(scores, k: int):
    """``lax.top_k`` semantics: the k largest per row, ties to the lowest
    index (a stable descending sort; ``torch.topk`` promises no order
    among equal values).  Indices are int32."""
    s, i = torch.sort(scores, dim=-1, descending=True, stable=True)
    return s[..., :k].contiguous(), i[..., :k].to(torch.int32).contiguous()


def geo_topk_reference(user_lat, user_lon, user_net, user_code20,
                       node_lat, node_lon, node_free, node_aff,
                       node_code20, node_valid, *, k: int, need: int):
    """-> (scores (U, k) fp32, indices (U, k) int32): per-user top-k."""
    scores = score_matrix(user_lat, user_lon, user_net, user_code20,
                          node_lat, node_lon, node_free, node_aff,
                          node_code20, node_valid, need)
    return topk_stable(scores, k)


# ---------------------------------------------------------------------------
# plain versions of the node-tiled pair's stages
# ---------------------------------------------------------------------------

def prefix_counts_reference(user_code20, node_code20, node_valid):
    """(U, 4) int32: per user, the number of valid nodes that share its
    first 4, 3, 2, 1 geohash chars (columns in ``SHIFTS`` order)."""
    valid = node_valid[None, :] > 0
    cols = [(((user_code20[:, None] >> s) == (node_code20[None, :] >> s))
             & valid).sum(dim=1) for s in SHIFTS]
    return torch.stack(cols, dim=1).to(torch.int32)


def shifts_from_counts(counts, need: int):
    """(U,) int32 filter shift per user: the finest precision whose count
    reaches ``need``, else ``NO_FILTER_SHIFT`` (no filter)."""
    shift = torch.full((counts.shape[0],), NO_FILTER_SHIFT,
                       dtype=torch.int32, device=counts.device)
    for i in range(len(SHIFTS) - 1, -1, -1):
        shift = torch.where(counts[:, i] >= need,
                            shift.new_tensor(SHIFTS[i]), shift)
    return shift


def partial_topk_reference(user_lat, user_lon, user_net, user_code20,
                           node_lat, node_lon, node_free, node_aff,
                           node_code20, node_valid, counts, *, k: int,
                           need: int, node_tile: int):
    """(U, T, k) per-node-tile top-k lists (scores, global indices) under
    the shift chosen from ``counts``.  Slots past the last node of a
    ragged tile hold ``(-inf, IDX_SENTINEL)``."""
    n = node_lat.shape[0]
    scores = _raw_scores(user_lat, user_lon, user_net, node_lat, node_lon,
                         node_free, node_aff)
    shift = shifts_from_counts(counts, need)[:, None]
    local = (((user_code20[:, None] ^ node_code20[None, :]) >> shift) == 0)
    local = (local | (shift >= NO_FILTER_SHIFT)) & (node_valid[None, :] > 0)
    scores = torch.where(local, scores, scores.new_tensor(NEG))
    t = -(-n // node_tile)
    pad = t * node_tile - n
    scores = torch.nn.functional.pad(scores, (0, pad), value=-float("inf"))
    u = scores.shape[0]
    s, i = topk_stable(scores.view(u, t, node_tile), min(k, node_tile))
    gidx = i + (torch.arange(t, device=i.device, dtype=torch.int32)
                * node_tile)[None, :, None]
    gidx = torch.where(torch.isinf(s), gidx.new_tensor(IDX_SENTINEL), gidx)
    if s.shape[-1] < k:                   # tile narrower than k
        fill = k - s.shape[-1]
        s = torch.nn.functional.pad(s, (0, fill), value=-float("inf"))
        gidx = torch.nn.functional.pad(gidx, (0, fill), value=IDX_SENTINEL)
    return s.contiguous(), gidx.contiguous()


def topk_merge_reference(part_s, part_i, k: int):
    """Merge (U, T, k) partial lists into (U, k) by (score desc, index
    asc)."""
    u = part_s.shape[0]
    s = part_s.reshape(u, -1)
    i = part_i.reshape(u, -1)
    # order by index first, then a stable sort by score keeps the lowest
    # index first among equal scores whatever order the partials are in
    by_i = torch.argsort(i, dim=1, stable=True)
    s, i = s.gather(1, by_i), i.gather(1, by_i)
    order = torch.argsort(s, dim=1, descending=True, stable=True)[:, :k]
    return s.gather(1, order).contiguous(), i.gather(1, order).contiguous()
