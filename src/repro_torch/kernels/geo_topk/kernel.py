"""Wrappers of the hand-written Hopper kernels in ``csrc/geo_topk.cu``.

Four kernels carry geo_topk on the card (the source note at the top of
the ``.cu`` file says which TPU kernel each replaces, what bounds it and
what its design does about that):

* ``geo_topk_fused`` — the untiled query: one thread per user scans every
  node twice (prefix-hit counts, then scoring into a sorted per-thread
  top-k list);
* ``prefix_count`` — pass 1 of the node-tiled query: per-user hit counts
  at the four filter precisions, integer atomics across node tiles;
* ``geo_topk_tiled`` — pass 2: one thread per (user, node tile) keeps
  the tile's top-k under the shift chosen from the counts;
* ``topk_merge`` — merges the per-tile lists by (score desc, index asc).

Each wrapper takes tensors on one device.  On the CPU it runs the plain
PyTorch version from ``ref.py``; on a CUDA device it checks dtypes,
shapes and contiguity, launches its kernel on the current stream, adds
one to ``LAUNCHES[name]`` and raises if the launch was refused.  There is
no fallback: any other device raises.

The library is built on first CUDA use with ``nvcc`` into ``build/`` at
the repository root, under a name keyed by the source's hash, and loaded
with ``ctypes``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from repro_torch.core.selection import W_AFFINITY, W_PROXIMITY, W_RESOURCE
from repro_torch.kernels.geo_topk import ref

K_MAX = 64                       # client_pool.WIDE_TOP_N: the widest list
MAX_NET_TYPES = 32               # affinity rows staged in shared memory

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "geo_topk.cu"
BUILD_DIR = Path(__file__).resolve().parents[4] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-fmad=false", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas=-v")

# field dtypes of a packed query (ops.GeoTopKInputs), in field order
INPUT_DTYPES = (torch.float32, torch.float32, torch.int32, torch.int32,
                torch.float32, torch.float32, torch.float32, torch.float32,
                torch.int32, torch.float32)

# launches per kernel; each wrapper adds one where it launches its kernel
LAUNCHES = {"geo_topk_fused": 0, "prefix_count": 0, "geo_topk_tiled": 0,
            "topk_merge": 0}

_lib = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_ARGTYPES = {
    "geo_topk_fused": [_P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _P, _P, _I,
                       _I, _I, _F, _F, _F, _F, _F, _P, _P, _P],
    "prefix_count": [_P, _I, _P, _P, _I, _I, _P, _P],
    "geo_topk_tiled": [_P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _P, _P,
                       _I, _I, _I, _I, _F, _F, _F, _F, _F, _P, _P, _P],
    "topk_merge": [_P, _P, _I, _I, _I, _P, _P, _P],
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(Path(home) / "bin" / "nvcc")


def build() -> dict:
    """Compile ``geo_topk.cu`` (once per source hash) and load it.
    Returns ``{"path", "seconds", "log"}``: the library, the compile time
    (0.0 when it was already built) and the compiler's output."""
    global _lib
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"geo_topk_{digest}.so"
    seconds, log = 0.0, ""
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # build under a private name, then rename: a concurrent build of
        # the same source never sees a half-written library
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                              str(SOURCE)], capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n{log}")
        os.replace(tmp, out)
    if _lib is None:
        lib = ctypes.CDLL(str(out))
        for name, argtypes in _ARGTYPES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return {"path": str(out), "seconds": seconds, "log": log}


def _check(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1


def _device_of(tensors) -> torch.device:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"geo_topk runs on cpu or cuda, not {dev}")
    return dev


def _require(t: torch.Tensor, dtype, shape, what: str) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(f"{what}: need contiguous {dtype} {tuple(shape)}, "
                         f"got {t.dtype} {tuple(t.shape)}")


def _check_query(packed, k: int) -> tuple:
    u = packed.user_lat.shape[0]
    n = packed.node_lat.shape[0]
    m = packed.node_aff.shape[0]
    if not 1 <= k <= K_MAX:
        raise ValueError(f"k={k} outside [1, {K_MAX}]")
    if k > n:
        raise ValueError(f"k={k} > {n} nodes")
    if not 1 <= m <= MAX_NET_TYPES:
        raise ValueError(f"{m} affinity rows outside [1, {MAX_NET_TYPES}]")
    shapes = [(u,)] * 4 + [(n,)] * 3 + [(m, n), (n,), (n,)]
    for t, dt, sh, name in zip(packed, INPUT_DTYPES, shapes,
                               packed._fields):
        _require(t, dt, sh, name)
    return u, n, m


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _weights():
    return (ref.RAD, W_RESOURCE, W_AFFINITY, W_PROXIMITY, ref.NEG)


def geo_topk_fused(packed, *, k: int, need: int):
    """Untiled query -> ``(scores (U, k) fp32, indices (U, k) int32)``."""
    dev = _device_of(list(packed))
    u, n, m = _check_query(packed, k)
    if dev.type == "cpu":
        return ref.geo_topk_reference(*packed, k=k, need=need)
    scores = torch.empty((u, k), dtype=torch.float32, device=dev)
    idx = torch.empty((u, k), dtype=torch.int32, device=dev)
    if u == 0:
        return scores, idx
    build()
    rc = _lib.geo_topk_fused(
        *(t.data_ptr() for t in packed[:4]), u,
        *(t.data_ptr() for t in packed[4:8]), m,
        packed.node_code20.data_ptr(), packed.node_valid.data_ptr(), n,
        k, need, *_weights(), scores.data_ptr(), idx.data_ptr(),
        _stream(dev))
    _check("geo_topk_fused", rc)
    return scores, idx


def prefix_count(user_code20, node_code20, node_valid, *, node_tile: int):
    """Pass 1 of the tiled query -> ``(U, 4)`` int32 hit counts at 4, 3,
    2, 1 shared geohash chars over every valid node."""
    dev = _device_of([user_code20, node_code20, node_valid])
    u, n = user_code20.shape[0], node_code20.shape[0]
    _require(user_code20, torch.int32, (u,), "user_code20")
    _require(node_code20, torch.int32, (n,), "node_code20")
    _require(node_valid, torch.float32, (n,), "node_valid")
    if node_tile < 1:
        raise ValueError(f"node_tile={node_tile} < 1")
    if dev.type == "cpu":
        return ref.prefix_counts_reference(user_code20, node_code20,
                                           node_valid)
    counts = torch.zeros((u, len(ref.SHIFTS)), dtype=torch.int32,
                         device=dev)
    if u == 0 or n == 0:
        return counts
    build()
    rc = _lib.prefix_count(user_code20.data_ptr(), u, node_code20.data_ptr(),
                           node_valid.data_ptr(), n, node_tile,
                           counts.data_ptr(), _stream(dev))
    _check("prefix_count", rc)
    return counts


def geo_topk_tiled(packed, counts, *, k: int, need: int, node_tile: int):
    """Pass 2 of the tiled query -> per-tile lists ``(U, T, k)`` scores
    and global indices, ``T = ceil(N / node_tile)``; slots a ragged tile
    cannot fill hold ``(-inf, 2**31 - 1)``."""
    dev = _device_of(list(packed) + [counts])
    u, n, m = _check_query(packed, k)
    _require(counts, torch.int32, (u, len(ref.SHIFTS)), "counts")
    if node_tile < 1:
        raise ValueError(f"node_tile={node_tile} < 1")
    if dev.type == "cpu":
        return ref.partial_topk_reference(*packed, counts, k=k, need=need,
                                          node_tile=node_tile)
    t = -(-n // node_tile)
    part_s = torch.empty((u, t, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((u, t, k), dtype=torch.int32, device=dev)
    if u == 0:
        return part_s, part_i
    build()
    rc = _lib.geo_topk_tiled(
        *(t_.data_ptr() for t_ in packed[:4]), counts.data_ptr(), u,
        *(t_.data_ptr() for t_ in packed[4:8]), m,
        packed.node_code20.data_ptr(), packed.node_valid.data_ptr(), n,
        node_tile, k, need, *_weights(), part_s.data_ptr(),
        part_i.data_ptr(), _stream(dev))
    _check("geo_topk_tiled", rc)
    return part_s, part_i


def topk_merge(part_s, part_i, *, k: int):
    """``(U, T, k)`` per-tile lists -> ``(U, k)`` by (score desc, index
    asc)."""
    dev = _device_of([part_s, part_i])
    if part_s.dim() != 3:
        raise ValueError(f"part_s: need (U, T, k), got {tuple(part_s.shape)}")
    u, t, kp = part_s.shape
    if not 1 <= k <= min(kp * t, K_MAX):
        raise ValueError(f"k={k} outside [1, {min(kp * t, K_MAX)}]")
    _require(part_s, torch.float32, (u, t, kp), "part_s")
    _require(part_i, torch.int32, (u, t, kp), "part_i")
    if dev.type == "cpu":
        return ref.topk_merge_reference(part_s, part_i, k)
    scores = torch.empty((u, k), dtype=torch.float32, device=dev)
    idx = torch.empty((u, k), dtype=torch.int32, device=dev)
    if u == 0:
        return scores, idx
    build()
    rc = _lib.topk_merge(part_s.data_ptr(), part_i.data_ptr(), u, t * kp, k,
                         scores.data_ptr(), idx.data_ptr(), _stream(dev))
    _check("topk_merge", rc)
    return scores, idx
