#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and the
repository's sources; imports nothing of JAX or of the JAX package.
Phases, each printed as it runs:

1. card and build — ``nvidia-smi``'s name and power limit, then the
   kernels are compiled from ``src/repro_torch/csrc`` with ``nvcc``;
2. every geo_topk kernel against its plain PyTorch version on the card:
   the untiled query at 100,000 users x the 1,000-node fleet (padded to
   1,024 rows) with k = 3 and 64, the tiled pair at 4,096 x 65,536 with
   k = 8, a ragged case, clones straddling a tile edge and an all-invalid
   query.  Scores must agree within 1e-5, counts exactly, indices exactly
   except where the plain version scores the two swapped nodes within
   1e-5 of each other (each such flip is printed with its margin);
3. the main path — ``ArmadaSystem(device="cuda")`` with the 1,000-node
   metro fleet and a fluid ``ClientPool`` of 100,000 users whose every
   candidate refresh goes through ``SelectionEngine.candidate_indices_
   kernel`` into ``geo_topk_fused``, under volunteer churn, for six probe
   ticks; then one 100,000-user x 65,536-node query through
   ``ops.geo_topk``'s default dispatch, which must take the tiled pair.
   Launch counts are zeroed just before and read just after.

The main-path run is traced with ``torch.profiler`` (device activity
only) for the card's busy time.  The script then times each kernel (CUDA
events, warmed up) and its plain version at the main path's shapes,
times the untiled kernel against the tiled pair over a grid of users x
nodes and node tiles (the measurement behind ``ops.geo_topk``'s layout
rule), prints one ``{"kernels": [...]}`` line, and ends with
``{"ok": true, "device": {...}}``.  Any failure raises: the
exit code is then non-zero and no result line is printed.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TOL = 1e-5
METRO = (44.97, -93.22)
SERVICE = "detect"
N_USERS = 100_000
N_NODES = 1_000
BIG_NODES = 65_536
PROBE_MS = 2000.0
N_TICKS = 6
# the layout grid (phase_layout); its last cell is the largest query
LAYOUT_USERS = (1_024, 4_096, 16_384, N_USERS)
LAYOUT_NODES = (1_024, 2_048, 4_096, 8_192, 16_384, 32_768, BIG_NODES)
LAYOUT_TILES = (1_024, 2_048, 4_096, 8_192, 16_384)

# H100 SXM peaks (NVIDIA data sheet and Hopper whitepaper; 132 SMs at a
# 1.98 GHz boost clock), each operation type at its own rate:
#   fp32: the published 67 TFLOP/s counts an FMA as two operations; the
#     kernels are built with -fmad=false, so one operation per lane-cycle:
#     128 lanes/SM -> 33.5 T op/s
#   int32: 64 lanes/SM -> 16.7 T op/s
#   HBM3: 3.35 TB/s
PEAK_FP32_OPS = 67e12 / 2
PEAK_INT32_OPS = 64 * 132 * 1.98e9
PEAK_BYTES = 3.35e12
# operations per (user, node) pair, (int32, fp32), as the plain version
# states them:
#   prefix counts: valid test (fp32); xor, then 4 levels x (compare, add)
#   selection: valid test + one top-k compare (fp32); xor, shift, compare
#   scoring (pairs that pass the filter only): 2 sub, 7 mul, 2 halvings,
#     2 squares, 2 sin, 1 cos (the user's cos is per user), clip (2), sqrt,
#     asin, x12742, /10, +1, 1/x, 3 weight mul, 2 add = 29 fp32
PREFIX_OPS = (9, 1)
SELECT_OPS = (3, 2)
SCORE_OPS = 29
REPLACES = {
    "geo_topk_fused": "src/repro/kernels/geo_topk/kernel.py:121",
    "prefix_count": "src/repro/kernels/geo_topk/kernel.py:181",
    "geo_topk_tiled": "src/repro/kernels/geo_topk/kernel.py:203",
    "topk_merge": "src/repro/kernels/geo_topk/kernel.py:242",
}
SOURCE = "src/repro_torch/csrc/geo_topk.cu"


def ptxas_summary(log: str):
    """One line per compiled kernel from ``nvcc -Xptxas=-v`` output:
    name<list width>, registers and spill stores."""
    rows, name = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function .*?(geo_topk_fused|"
                      r"prefix_count|geo_topk_tiled|topk_merge)_kernel"
                      r"(?:ILi(\d+)E)?", ln)
        if m:
            name = m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m and name:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            rows.append(f"{name}: {m.group(1)} registers, {spill} B spill "
                        "stores")
            name = None
    return rows


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def load_port():
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch
    if Path(repro_torch.__file__).resolve().parent != ROOT / "src" / \
            "repro_torch":
        fail(f"repro_torch imported from {repro_torch.__file__}, not this "
             "checkout")


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def fleet_query(n_users, n_nodes, seed, n_pad=None, spread=0.5):
    """Numpy query over a metro fleet (``bench_client_scale``'s layout),
    node rows zero-padded to ``n_pad`` with valid = 0."""
    import numpy as np

    from repro_torch.core import geohash
    from repro_torch.kernels.geo_topk import ops
    rng = np.random.default_rng(seed)
    ulat = METRO[0] + rng.uniform(-spread, spread, n_users)
    ulon = METRO[1] + rng.uniform(-spread, spread, n_users)
    nlat = METRO[0] + rng.uniform(-spread, spread, n_nodes)
    nlon = METRO[1] + rng.uniform(-spread, spread, n_nodes)
    n_pad = n_pad or n_nodes
    pad = n_pad - n_nodes
    valid = np.concatenate([np.ones(n_nodes), np.zeros(pad)])
    z = np.zeros(pad)
    return ops.pack_inputs(
        ulat, ulon, rng.integers(0, 3, n_users),
        geohash.encode_batch(ulat, ulon, 9),
        np.concatenate([nlat, z]), np.concatenate([nlon, z]),
        np.concatenate([rng.uniform(0, 1, n_nodes), z]),
        np.concatenate([rng.integers(0, 3, n_nodes), z.astype(int)]),
        geohash.encode_batch(np.concatenate([nlat, z]),
                             np.concatenate([nlon, z]), 9), valid)


def users_of(packed, sel):
    return packed._replace(user_lat=packed.user_lat[sel].contiguous(),
                           user_lon=packed.user_lon[sel].contiguous(),
                           user_net=packed.user_net[sel].contiguous(),
                           user_code20=packed.user_code20[sel].contiguous())


def matching_pairs(counts, packed, need) -> int:
    """Pairs that pass each user's chosen filter (what scoring needs)."""
    import torch
    n_valid = int((packed.node_valid > 0).sum())
    ok = counts >= need
    first = torch.where(ok.any(1), ok.int().argmax(1), -1)
    pick = counts.gather(1, first.clamp(min=0)[:, None])[:, 0]
    return int(torch.where(first >= 0, pick, n_valid).sum())


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------

def max_abs_err(a, b) -> float:
    import torch
    same = (a == b)                        # equal infinities count as 0
    d = torch.where(same, torch.zeros_like(a), (a - b).abs())
    return float(d.max()) if d.numel() else 0.0


def check_topk(name, s, i, rs, ri, packed, need) -> float:
    """Scores within TOL; indices equal except flips between nodes the
    plain version scores within TOL of each other."""
    from repro_torch.kernels.geo_topk import ref
    err = max_abs_err(s, rs)
    if s.shape != rs.shape or err > TOL:
        fail(f"{name}: scores differ by {err:.3e} (shape {tuple(s.shape)} "
             f"vs {tuple(rs.shape)})")
    flips = (i != ri).nonzero()
    if flips.numel():
        users = flips[:, 0].unique()
        rows = ref.score_matrix(*users_of(packed, users), need=need)
        pos = {int(u): r for r, u in enumerate(users.tolist())}
        n = rows.shape[1]
        for f in flips.tolist():
            u, ks, rs_ = f[0], int(i[tuple(f)]), int(ri[tuple(f)])
            row = rows[pos[u]]
            margin = (float((row[ks] - row[rs_]).abs())
                      if 0 <= ks < n and 0 <= rs_ < n else float("inf"))
            print(f"  flip {name} user {u} slot {tuple(f[1:])}: kernel "
                  f"{ks} plain {rs_} margin {margin:.3e}")
            if margin > TOL:
                fail(f"{name}: index flip with margin {margin:.3e} > {TOL}")
    print(f"  {name}: max|dscore| {err:.3e}, {len(flips)} flips")
    return err


def check_case(label, packed, k, node_tile=None):
    """One query through the kernels named by the layout, each held
    against its plain version; returns the largest score error seen per
    kernel."""
    import torch

    from repro_torch.kernels.geo_topk import kernel, ref
    need = min(4, packed.node_lat.shape[0])
    errs = {}
    rs, ri = ref.geo_topk_reference(*packed, k=k, need=need)
    if node_tile is None:
        s, i = kernel.geo_topk_fused(packed, k=k, need=need)
        torch.cuda.synchronize()
        errs["geo_topk_fused"] = check_topk(f"{label} fused", s, i, rs, ri,
                                            packed, need)
        return errs
    counts = kernel.prefix_count(packed.user_code20, packed.node_code20,
                                 packed.node_valid, node_tile=node_tile)
    want = ref.prefix_counts_reference(packed.user_code20,
                                       packed.node_code20, packed.node_valid)
    torch.cuda.synchronize()
    if not torch.equal(counts, want):
        fail(f"{label}: prefix counts differ in "
             f"{int((counts != want).sum())} entries")
    print(f"  {label} prefix_count: exact")
    errs["prefix_count"] = 0.0
    ps, pi = kernel.geo_topk_tiled(packed, counts, k=k, need=need,
                                   node_tile=node_tile)
    rps, rpi = ref.partial_topk_reference(*packed, want, k=k, need=need,
                                          node_tile=node_tile)
    torch.cuda.synchronize()
    u = ps.shape[0]
    errs["geo_topk_tiled"] = check_topk(
        f"{label} tiled", ps.view(u, -1), pi.view(u, -1),
        rps.view(u, -1), rpi.view(u, -1), packed, need)
    s, i = kernel.topk_merge(ps, pi, k=k)
    ms, mi = ref.topk_merge_reference(ps, pi, k)
    torch.cuda.synchronize()
    if not (torch.equal(s, ms) and torch.equal(i, mi)):
        fail(f"{label}: topk_merge differs from its plain version on the "
             "same partial lists")
    print(f"  {label} topk_merge: exact")
    errs["topk_merge"] = 0.0
    check_topk(f"{label} tiled pair", s, i, rs, ri, packed, need)
    return errs


def phase_kernels(dev):
    import numpy as np

    from repro_torch.kernels.geo_topk import ops
    print("== phase 2: kernels against their plain versions", flush=True)
    errs = {}

    def note(e):
        for key, v in e.items():
            errs[key] = max(errs.get(key, 0.0), v)

    fleet = ops.inputs_from_numpy(fleet_query(N_USERS, N_NODES, 1, 1024),
                                  dev)
    for k in (3, 64):
        note(check_case(f"fleet U={N_USERS} N=1024 k={k}", fleet, k))
    big = ops.inputs_from_numpy(fleet_query(4096, BIG_NODES, 2), dev)
    note(check_case(f"tiled U=4096 N={BIG_NODES} k=8", big, 8,
                    node_tile=ops.DEFAULT_NODE_TILE))
    ragged = ops.inputs_from_numpy(fleet_query(130, 257, 3), dev)
    note(check_case("ragged U=130 N=257 k=8", ragged, 8))
    note(check_case("ragged U=130 N=257 k=8 tile=128", ragged, 8, 128))
    tie = fleet_query(8, 384, 5)
    for fld in (4, 5, 6, 8):               # lat, lon, free, code20
        tie[fld][125:132] = tie[fld][126]
    tie[7][:, 125:132] = tie[7][:, 126:127]
    tie = ops.inputs_from_numpy(tie, dev)
    note(check_case("tile-edge clones untiled", tie, 6))
    note(check_case("tile-edge clones tile=128", tie, 6, 128))
    dead = fleet_query(12, 512, 10)
    dead = ops.inputs_from_numpy(dead[:9] + (np.zeros(512, np.float32),),
                                 dev)
    note(check_case("all-invalid untiled", dead, 3))
    note(check_case("all-invalid tile=128", dead, 3, 128))
    return errs


# ---------------------------------------------------------------------------
# main path
# ---------------------------------------------------------------------------

def metro_system(seed: int, device):
    """``bench_client_scale._system`` in the port: 1,000 nodes, one
    running replica each, selection on the card."""
    import numpy as np

    from repro_torch.core.app_manager import ServiceSpec, Task
    from repro_torch.core.beacon import ArmadaSystem, detection_image
    from repro_torch.core.cluster import NodeSpec, Topology
    rng = np.random.default_rng(seed)
    nets = ("wifi", "ethernet", "lte")
    nodes = {}
    for i in range(N_NODES):
        nodes[f"N{i}"] = NodeSpec(
            f"N{i}",
            (METRO[0] + float(rng.uniform(-0.5, 0.5)),
             METRO[1] + float(rng.uniform(-0.5, 0.5))),
            proc_ms=float(rng.uniform(10, 30)),
            slots=int(rng.integers(4, 17)),
            dedicated=bool(rng.random() < 0.2),
            net_type=nets[int(rng.integers(len(nets)))])
    sys_ = ArmadaSystem(Topology(nodes, {}), seed=seed, trace_enabled=False,
                        include_cloud_compute=False, device=device)
    sys_.am.services[SERVICE] = ServiceSpec(SERVICE, detection_image())
    sys_.am.tasks[SERVICE] = []
    sys_.am.users[SERVICE] = []
    for i, cap in enumerate(sys_.captains.values()):
        t = Task(f"{SERVICE}/t{i}", SERVICE, captain=cap, status="running",
                 ready_at=0.0)
        cap.tasks[t.task_id] = t
        sys_.am.tasks[SERVICE].append(t)
    sys_.am.autoscale_enabled = False
    return sys_


def phase_main_path(dev):
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.churn import ChurnModel
    from repro_torch.kernels.geo_topk import kernel, ops, ref
    print("== phase 3: main path", flush=True)
    sys_ = metro_system(0, dev)
    rng = np.random.default_rng(1)
    locs = np.stack([METRO[0] + rng.uniform(-0.5, 0.5, N_USERS),
                     METRO[1] + rng.uniform(-0.5, 0.5, N_USERS)], axis=1)
    pool = sys_.make_client_pool(
        SERVICE, locs=locs, nets="wifi", transport="fluid",
        probe_period_ms=PROBE_MS, frame_interval_ms=1000.0,
        selection_backend="geo_topk", tick="host", record_samples=False)
    eng = sys_.am.engine
    refreshes = []
    inner = eng.candidate_indices_kernel

    def counted(*a, **kw):                 # one call = one refresh
        refreshes.append(len(a[2]))
        return inner(*a, **kw)

    eng.candidate_indices_kernel = counted
    sys_.sim.at(0.0, pool.start)
    churn = ChurnModel(sys_.sim, sys_.captains,
                       volunteer_mttf_ms=40 * PROBE_MS, mttr_ms=5 * PROBE_MS)
    churn.start()

    # the run is traced (device activity only) for the card's busy time
    kernel.reset_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sys_.sim.run(until=(N_TICKS - 1) * PROBE_MS)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    path_launches = dict(kernel.LAUNCHES)
    dev_ms = device_time_ms(prof)

    # the 65,536-node query through the default dispatch
    big = ops.inputs_from_numpy(fleet_query(N_USERS, BIG_NODES, 4), dev)
    before = dict(kernel.LAUNCHES)
    t1 = time.perf_counter()
    bs, bi = ops.geo_topk(big, k=8)
    torch.cuda.synchronize()
    big_ms = (time.perf_counter() - t1) * 1e3
    launches = dict(kernel.LAUNCHES)
    took = {n: launches[n] - before[n] for n in launches}

    ticks = pool.ticks_run
    if ticks < 5:
        fail(f"main path ran {ticks} ticks, need >= 5")
    if not refreshes or path_launches["geo_topk_fused"] != len(refreshes):
        fail(f"geo_topk_fused launched {path_launches['geo_topk_fused']} "
             f"times for {len(refreshes)} candidate refreshes")
    if any(path_launches[n] for n in ("prefix_count", "geo_topk_tiled",
                                      "topk_merge")):
        fail(f"1,000-node main path launched tiled kernels: {path_launches}")
    if took != {"geo_topk_fused": 0, "prefix_count": 1,
                "geo_topk_tiled": 1, "topk_merge": 1}:
        fail(f"65,536-node query did not take the tiled pair: {took}")
    leaves = sum(1 for e in churn.events if e["kind"] == "leave")
    mean_ms = pool.mean_latency()
    n_tasks = len(sys_.am.tasks[SERVICE])
    if not (np.isfinite(mean_ms) and mean_ms > 0 and pool.requests_sent > 0
            and leaves > 0 and pool.failovers > 0
            and pool.cand_task.max() < n_tasks
            and (pool.active[pool.ticking] >= 0).mean() > 0.99):
        fail(f"main path output implausible: mean {mean_ms}, requests "
             f"{pool.requests_sent}, leaves {leaves}, failovers "
             f"{pool.failovers}")
    phases = {k: round(v / ticks, 3) for k, v in sorted(pool.phase_ms.items())}
    print(f"  {N_USERS} users x {N_NODES} nodes, {ticks} ticks, "
          f"{len(refreshes)} refreshes ({sum(refreshes)} user rows), "
          f"geo_topk_fused launches {path_launches['geo_topk_fused']}")
    print(f"  ms/tick {wall_ms / ticks:.3f}  phase ms/tick {phases}")
    print(f"  requests_sent {pool.requests_sent}  req/s "
          f"{pool.requests_sent / (wall_ms / 1e3):.0f}  failovers "
          f"{pool.failovers}  node leaves {leaves}  mean_latency "
          f"{mean_ms:.3f} ms")
    busy_ms = sum(dev_ms.values())
    fused_dev_ms = sum(v for key, v in dev_ms.items()
                       if "geo_topk_fused" in key)
    sel_ms = pool.phase_ms.get("selection", 0.0)
    if busy_ms > 0:
        print(f"  device (torch.profiler): busy {busy_ms:.3f} ms of "
              f"{wall_ms:.3f} ms wall, idle {1 - busy_ms / wall_ms:.6f}; "
              f"geo_topk_fused {fused_dev_ms:.3f} ms = "
              f"{fused_dev_ms / sel_ms:.6f} of the selection phase")
        for key, v in sorted(dev_ms.items(), key=lambda kv: -kv[1])[:8]:
            print(f"    {v:10.3f} ms  {key[:90]}")
    else:
        print("  device (torch.profiler): no device time recorded — "
              "busy/idle share not measured")

    # the outputs are right: the final state's query, kernel vs plain
    run_ix, packed = eng.prepare_kernel_inputs(
        SERVICE, sys_.am.tasks[SERVICE], locs, pool.net_ix)
    k = min(3, run_ix.size)
    s, i = kernel.geo_topk_fused(packed, k=k, need=min(4, run_ix.size))
    rs, ri = ref.geo_topk_reference(*packed, k=k, need=min(4, run_ix.size))
    check_topk("main-path final state", s, i, rs, ri, packed,
               min(4, run_ix.size))
    if bs.shape != (N_USERS, 8) or not torch.isfinite(bs).all() or \
            int(bi.min()) < 0 or int(bi.max()) >= BIG_NODES:
        fail("65,536-node query output malformed")
    sub = torch.arange(0, N_USERS, 97, device=dev)
    rs, ri = ref.geo_topk_reference(*users_of(big, sub), k=8, need=4)
    check_topk("65,536-node query (every 97th user)", bs[sub], bi[sub], rs,
               ri, users_of(big, sub), 4)
    print(f"  65,536-node query: {big_ms:.3f} ms wall, tiled pair")
    main = {"ms_per_tick": wall_ms / ticks, "ticks": ticks,
            "refreshes": len(refreshes), "phase_ms_per_tick": phases,
            "requests_sent": pool.requests_sent,
            "failovers": pool.failovers, "node_leaves": leaves,
            "mean_latency_ms": mean_ms, "big_query_wall_ms": big_ms,
            "wall_ms": wall_ms, "device_busy_ms": busy_ms or None,
            "fused_device_ms": fused_dev_ms or None,
            "selection_ms": sel_ms}
    return launches, main


def device_time_ms(prof) -> dict:
    """Device time (ms) per event name of a ``torch.profiler`` run."""
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
        if us:
            out[ev.key] = us / 1e3
    return out


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def time_ms(fn, iters: int, warm: int = 2) -> float:
    import torch
    for _ in range(warm):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def bound_ms(int_ops: float, fp_ops: float, bytes_: float):
    """The least time for the work: the larger of its int32 operations,
    its fp32 operations (each at its own peak) and its bytes."""
    t_ops = max(int_ops / PEAK_INT32_OPS, fp_ops / PEAK_FP32_OPS)
    t_bytes = bytes_ / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def phase_timing(dev, errs, launches):
    import torch

    from repro_torch.kernels.geo_topk import kernel, ops, ref
    print("== timing at the main path's shapes", flush=True)
    rows = []

    def row(name, ms, plain_ms, int_ops, fp_ops, bytes_):
        b, by = bound_ms(int_ops, fp_ops, bytes_)
        rows.append({"name": name, "route": "cuda", "source": SOURCE,
                     "replaces": REPLACES[name],
                     "launches": launches[name],
                     "max_abs_err": errs[name], "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
                     "library_ms": None, "int32_ops": int_ops,
                     "fp32_ops": fp_ops, "bytes": bytes_})
        print(f"  {name}: {ms:.4f} ms (plain {plain_ms:.4f} ms, bound "
              f"{b:.4f} ms by {by}; {int_ops:.4g} int32 + {fp_ops:.4g} "
              f"fp32 ops, {bytes_:.4g} bytes)")

    def pair_ops(pairs, per_pair, scored):
        return (pairs * sum(p[0] for p in per_pair),
                pairs * sum(p[1] for p in per_pair) + scored * SCORE_OPS)

    # untiled, as each refresh of the 1,000-node main path calls it
    q = ops.inputs_from_numpy(fleet_query(N_USERS, N_NODES, 1, 1024), dev)
    u, n, m, k = N_USERS, 1024, q.node_aff.shape[0], 3
    counts = ref.prefix_counts_reference(q.user_code20, q.node_code20,
                                         q.node_valid)
    pairs = matching_pairs(counts, q, 4)
    ms = time_ms(lambda: kernel.geo_topk_fused(q, k=k, need=4), 20)
    plain = time_ms(lambda: ref.geo_topk_reference(*q, k=k, need=4), 3)
    row("geo_topk_fused", ms, plain,
        *pair_ops(u * n, (PREFIX_OPS, SELECT_OPS), pairs),
        u * 16 + n * (20 + 4 * m) + u * k * 8)

    # the tiled pair, as the 65,536-node query calls it
    q = ops.inputs_from_numpy(fleet_query(N_USERS, BIG_NODES, 4), dev)
    u, n, k, nt = N_USERS, BIG_NODES, 8, ops.DEFAULT_NODE_TILE
    t = -(-n // nt)
    chunks = [slice(lo, min(lo + 4096, u)) for lo in range(0, u, 4096)]

    def plain_counts():
        return torch.cat([ref.prefix_counts_reference(
            q.user_code20[c], q.node_code20, q.node_valid) for c in chunks])

    counts = plain_counts()
    pairs = matching_pairs(counts, q, 4)
    ms = time_ms(lambda: kernel.prefix_count(
        q.user_code20, q.node_code20, q.node_valid, node_tile=nt), 5)
    plain = time_ms(plain_counts, 1, warm=1)
    row("prefix_count", ms, plain, *pair_ops(u * n, (PREFIX_OPS,), 0),
        u * 4 + n * 8 + u * 16)

    def plain_tiled():
        return [ref.partial_topk_reference(*users_of(q, c), counts[c], k=k,
                                           need=4, node_tile=nt)
                for c in chunks]

    ms = time_ms(lambda: kernel.geo_topk_tiled(q, counts, k=k, need=4,
                                               node_tile=nt), 3)
    plain = time_ms(plain_tiled, 1, warm=1)
    row("geo_topk_tiled", ms, plain,
        *pair_ops(u * n, (SELECT_OPS,), pairs),
        u * 32 + n * (20 + 4 * m) + u * t * k * 8)

    ps, pi = kernel.geo_topk_tiled(q, counts, k=k, need=4, node_tile=nt)
    ms = time_ms(lambda: kernel.topk_merge(ps, pi, k=k), 10)
    plain = time_ms(lambda: ref.topk_merge_reference(ps, pi, k), 3)
    # one score compare (fp32) and one index compare (int32) per entry
    row("topk_merge", ms, plain, u * t * k, u * t * k,
        u * t * k * 8 + u * k * 8)
    return rows


def phase_layout(dev):
    """The two layouts against each other, the measurement behind
    ``ops.geo_topk``'s rule: ``geo_topk_fused`` and the tiled pair (at
    ``DEFAULT_NODE_TILE``) over a grid of (users, nodes), then the tiled
    pair's node tile at 100,000 x 65,536.  k = 8."""
    from repro_torch.kernels.geo_topk import kernel, ops
    print("== layouts: untiled vs tiled pair (k = 8)", flush=True)
    out = []
    for u in LAYOUT_USERS:
        for n in LAYOUT_NODES:
            q = ops.inputs_from_numpy(fleet_query(u, n, 6), dev)
            iters = max(3, min(50, int(4e9 // (u * n))))
            fused = time_ms(lambda: kernel.geo_topk_fused(q, k=8, need=4),
                            iters)
            tiled = time_ms(lambda: ops.geo_topk(
                q, k=8, need=4, node_tile=ops.DEFAULT_NODE_TILE), iters)
            out.append({"users": u, "nodes": n, "fused_ms": fused,
                        "tiled_ms": tiled,
                        "tile": ops.DEFAULT_NODE_TILE})
            print(f"  U={u} N={n}: fused {fused:.4f} ms, tiled pair "
                  f"{tiled:.4f} ms", flush=True)
    tiles = {}
    for nt in LAYOUT_TILES:          # q is the grid's last, largest query
        tiles[nt] = time_ms(lambda: ops.geo_topk(q, k=8, need=4,
                                                 node_tile=nt), 3)
        print(f"  U={u} N={n} tile {nt}: tiled pair {tiles[nt]:.4f} ms",
              flush=True)
    return {"grid": out, "tiles_at": [u, n], "tile_ms": tiles}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device — this run needs one card",
              file=sys.stderr)
        return 2
    load_port()
    from repro_torch.kernels.geo_topk import kernel
    torch.backends.cuda.matmul.allow_tf32 = False   # plain version: exact
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    print("== phase 1: card and build", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    info = kernel.build()
    print(f"  built {Path(info['path']).name} in {info['seconds']:.2f} s")
    for ln in ptxas_summary(info["log"]):
        print(f"  ptxas {ln}")

    errs = phase_kernels(dev)
    launches, main_stats = phase_main_path(dev)
    rows = phase_timing(dev, errs, launches)
    layout = phase_layout(dev)
    kernel.reset_launches()

    print(json.dumps({"layout": layout}))
    print(json.dumps({"main_path": main_stats}))
    print(f"== done in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
