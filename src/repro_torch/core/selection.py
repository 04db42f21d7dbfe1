"""Batched, region-sharded performance-aware edge selection (paper
§3.1-3.2, Algorithm 1).

The paper's 2-step selection scores each running replica per user:

    score = w1 * free_resources + w2 * net_affinity + w3 * proximity

after an adaptive-precision geohash proximity filter, and scales the
control plane by replicating Beacon per coarse geographic region so each
replica tracks only nearby nodes.  ``SelectionEngine`` implements both
halves on arrays:

* **Global view** — per-service node arrays (lat/lon, Morton geohash
  codes, net-type index, cloud/dedicated flags) are cached per replica-set
  fingerprint and rebuilt only on change (captain join / task spawn /
  cancel — detected lazily and by explicit ``invalidate`` calls);
  per-query dynamic state (running mask, free-slot fractions) is one O(N)
  sweep amortized over the whole user batch.
* **Region shards** (``shard_precision=1..4``) — the replica set is
  partitioned by Morton-code prefix into per-shard ``_ServiceArrays``
  (``_ShardSet``), each with its *own* ``packed_static`` device cache, so
  a replica-set change in one region leaves every other shard's device
  arrays untouched (``_Shard.adopt`` carries them across rebuilds).  A
  query routes each user chunk to its home-region shard and scores only
  that shard's nodes with the proximity filter restricted to precisions
  ``p >= shard_precision``.  Because geohash cells nest, a user's p-cell
  for ``p >= shard_precision`` lies entirely inside their home shard, so
  in-shard hit counts equal global hit counts and a satisfied user's
  filter level, mask and scores are *exactly* the unsharded engine's.
  Users the in-shard widening cannot satisfy (the **border band**: near a
  shard boundary, in a sparse region, or needing the global no-filter
  fallback) escalate to a cross-shard pass over the adjacent shards'
  union (the full node set), which reproduces the unsharded computation
  verbatim.  Per-shard (U, k) index matrices are merged back in global
  task-position space — within a shard, tasks keep ascending global
  order, so score ties resolve exactly like the unsharded stable argsort.
  Per-shard scoring cost is O(U·N/S + border overlap) instead of O(U·N).
* ``candidate_list`` serves the existing single-user API;
  ``candidate_lists`` scores a U×N matrix and returns per-user top-k in
  one shot (used by ``Beacon.query_service_batch`` and the autoscaler).
* The scoring can optionally run through the fused
  ``repro_torch.kernels.geo_topk`` op on the engine's ``device`` (the
  hand-written CUDA kernels on the card, the plain PyTorch version on the
  CPU): ``candidate_indices_device`` returns tensors on that device, and
  the padded node half of the query is cached per node-epoch
  (``packed_static``) so only (U,)-sized user arrays and two (N,)
  dynamic vectors move per tick.  The region-sharded device path is not
  ported yet (ROADMAP "Region-sharded and incremental refresh on
  device"); sharded engines serve the numpy path.

* **Beacon fault domains** — a ``BeaconSet`` (``repro_torch.core.beacon``)
  pushes control-plane state into the engine via ``set_beacon_routing``:
  an *ownership map* (dead region -> nearest live region; ``_ShardSet``
  groups and routes through it, merging the dead domain's tasks into the
  adopting shard and handing its users off — the multi-Beacon handoff)
  and a *hidden set* (nodes whose registration died with their Beacon;
  a dynamic schedulable-mask input with zero cache/jit impact).  While
  nothing is hidden the owner-mapped engine remains decision-identical
  to the unsharded one — nesting still holds for merged shards
  (tests/test_beacon_failover.py).

``candidate_list_scalar`` preserves the pre-refactor scalar scorer
verbatim; parity tests (``tests/test_selection.py``,
``tests/test_sharded_selection.py``) pin the engine's ranking against it
and the sharded engine against the unsharded one, including cross-shard
border ties; ``benchmarks/bench_sharded_selection.py`` measures the 1/S
scaling.
"""
from __future__ import annotations

import itertools
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import geohash

# scoring weights (paper Algorithm 1): resources, network affinity, proximity
W_RESOURCE = 0.5
W_AFFINITY = 0.2
W_PROXIMITY = 0.3

# data-locality preference (paper §3.4 in-situ data access): bonus for nodes
# within DATA_LOCAL_RADIUS_KM of an alive Cargo replica of the service's
# store.  Folded into the free-fraction vector (scaled by 1/W_RESOURCE) in
# ``_ServiceArrays.dynamic_state`` — the single dynamic-input injection point
# shared by the numpy, geo_topk-kernel and fused-device tick paths — so all
# three stay decision-identical without touching kernel code.  Off (exact
# pre-existing scores) unless a CargoManager pushed placements for the
# service via ``SelectionEngine.set_data_locality``.
W_DATA = 0.15
DATA_LOCAL_RADIUS_KM = 50.0

# queueing-aware load term (serving-aware data plane): penalty for nodes
# whose serving profile reports expected queueing delay.  free_fraction
# clamps at 0 once the backlog exceeds the slot count, so under
# saturation proximity decides and users keep piling onto drowning
# nodes; this term keeps growing with the backlog
# (min(queue_ms / QUEUE_NORM_MS, 1)), letting scoring tell a
# slightly-busy node from a saturated one.  Folded into the
# free-fraction vector in ``_ServiceArrays.dynamic_state`` exactly like
# the data-locality bonus — one injection point, all four tick paths
# (numpy, geo_topk kernel, fused device, mesh) stay decision-identical.
# Off (exact pre-existing scores) unless enabled per service via
# ``SelectionEngine.set_queueing_awareness``.
W_QUEUE = 0.2
QUEUE_NORM_MS = 250.0

PROXIMITY_PRECISION = 4       # max geohash chars the proximity filter uses
MIN_PROXIMITY_HITS = 4        # widen the cell until this many replicas hit
CODE_PRECISION = 9            # full-precision Morton codes (45 bits)

# net-type affinity (same table the scalar path used); unknown types score
# the scalar path's 0.5 default via the trailing "other" row/column.
NET_TYPES = ("ethernet", "wifi", "lte", "other")
NET_INDEX = {n: i for i, n in enumerate(NET_TYPES)}
_NET_AFFINITY = {
    ("ethernet", "ethernet"): 1.0, ("ethernet", "wifi"): 0.7,
    ("wifi", "ethernet"): 0.7, ("wifi", "wifi"): 0.6,
    ("lte", "lte"): 0.5, ("lte", "wifi"): 0.4, ("wifi", "lte"): 0.4,
    ("lte", "ethernet"): 0.5, ("ethernet", "lte"): 0.5,
}
AFFINITY_TABLE = np.full((len(NET_TYPES), len(NET_TYPES)), 0.5)
for (_a, _b), _v in _NET_AFFINITY.items():
    AFFINITY_TABLE[NET_INDEX[_a], NET_INDEX[_b]] = _v


def net_index(net_type: str) -> int:
    return NET_INDEX.get(net_type, NET_INDEX["other"])


def parse_nets(user_nets, n_users: int) -> np.ndarray:
    """Coerce a net-type spec to an (U,) int64 index array: a single
    string (applied to every user), a pre-mapped integer sequence (list,
    tuple or ndarray), or a sequence of net-type strings.

    Pre-mapped indices are validated against ``NET_TYPES`` — a plain
    Python list of ints used to fall through the string branch and map
    every entry to "other" silently."""
    if isinstance(user_nets, str):
        return np.full(n_users, net_index(user_nets), np.int64)
    arr = np.asarray(user_nets)
    if np.issubdtype(arr.dtype, np.integer):
        nets = arr.astype(np.int64)
        if nets.size and (nets.min() < 0 or nets.max() >= len(NET_TYPES)):
            raise ValueError(
                f"net index out of range [0, {len(NET_TYPES)}): "
                f"{nets[(nets < 0) | (nets >= len(NET_TYPES))][:5]}")
    else:
        nets = np.asarray([net_index(n) for n in user_nets], np.int64)
    if len(nets) != n_users:
        raise ValueError(
            f"user_nets has {len(nets)} entries for {n_users} users")
    return nets


def _score_rows(lat, lon, net_idx, free, users, nets) -> np.ndarray:
    """Unfiltered (U, N) float64 Algorithm-1 scores for a user chunk
    against node attribute rows.  Single source for the numpy scoring
    arithmetic — the global and per-shard scorers must stay bit-identical
    for the sharded engine's decision parity to hold."""
    d = geohash.distance_km_batch(users[:, 0:1], users[:, 1:2],
                                  lat[None, :], lon[None, :])
    prox = 1.0 / (1.0 + d / 10.0)
    aff = AFFINITY_TABLE[net_idx[None, :], nets[:, None]]
    return (W_RESOURCE * free[None, :] + W_AFFINITY * aff
            + W_PROXIMITY * prox)


def _rank_local(scores: np.ndarray, local: np.ndarray, k: int
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Stable descending rank of filtered scores: ``(order, n_local)``.
    The stable argsort matches Python's stable sort on score ties —
    shared by the global and per-shard scorers so cross-shard merges
    tie-break identically."""
    masked = np.where(local, scores, -np.inf)
    order = np.argsort(-masked, axis=1, kind="stable")[:, :k]
    return order, local.sum(axis=1)


# ---------------------------------------------------------------------------
# Pre-refactor scalar scorer (reference for parity tests and benchmarks)
# ---------------------------------------------------------------------------

def candidate_list_scalar(tasks: Sequence[object], user_loc, user_net: str,
                          top_n: int = 3) -> List[object]:
    """The seed repo's ``ApplicationManager.candidate_list``, verbatim."""
    running = [t for t in tasks
               if t.status == "running" and t.captain is not None
               and t.captain.alive]
    if not running:
        return []
    items = [(t.task_id, t.captain.spec.loc) for t in running]
    local_ids = set(geohash.proximity_search(
        user_loc, items, precision=PROXIMITY_PRECISION))
    local = [t for t in running if t.task_id in local_ids] or running

    def score(t) -> float:
        c = t.captain
        resources = c.free_fraction()
        aff = _NET_AFFINITY.get((c.spec.net_type, user_net), 0.5)
        d = geohash.distance_km(c.spec.loc[0], c.spec.loc[1],
                                user_loc[0], user_loc[1])
        prox = 1.0 / (1.0 + d / 10.0)
        return W_RESOURCE * resources + W_AFFINITY * aff + W_PROXIMITY * prox

    local.sort(key=score, reverse=True)
    return local[:top_n]


# ---------------------------------------------------------------------------
# Cached per-service arrays
# ---------------------------------------------------------------------------

class PackedStatic(NamedTuple):
    """Device-resident node half of a geo_topk query, zero-padded to a
    ``node_pad`` multiple so churn never changes the kernels' shapes
    (padded rows have ``valid = 0``).  Static between replica-set changes
    — cached per node-epoch and device on the owning ``_ServiceArrays``
    (free fractions and validity are per-tick dynamic and travel
    separately)."""
    n: int                    # real task count (rows beyond are padding)
    n_pad: int
    lat: torch.Tensor         # (n_pad,) f32
    lon: torch.Tensor         # (n_pad,) f32
    aff: torch.Tensor         # (M, n_pad) f32 affinity columns
    code20: torch.Tensor      # (n_pad,) i32
    cloud: torch.Tensor       # (n_pad,) f32 — 1.0 = cloud replica


def padded_len(n: int, node_pad: int) -> int:
    """Rows of the kernels' padded node layout for ``n`` tasks."""
    return max(node_pad, -(-n // node_pad) * node_pad)


_EPOCH = itertools.count(1)


class _ServiceArrays:
    """Static (between replica-set changes) arrays over one task list."""

    def __init__(self, tasks: Sequence[object]):
        self.tasks = list(tasks)
        self.fingerprint = _fingerprint(tasks)
        self.epoch = next(_EPOCH)       # bumps on every rebuild
        self._packed: Dict[tuple, PackedStatic] = {}
        self._local_bits: Dict[tuple, np.ndarray] = {}
        n = len(self.tasks)
        self.lat = np.empty(n)
        self.lon = np.empty(n)
        self.net_idx = np.empty(n, np.int64)
        self.cloud = np.zeros(n, bool)
        self.dedicated = np.zeros(n, bool)
        self.node_ids: List[Optional[str]] = [None] * n
        for i, t in enumerate(self.tasks):
            if t.captain is None:
                self.lat[i] = self.lon[i] = 0.0
                self.net_idx[i] = NET_INDEX["other"]
            else:
                self.lat[i], self.lon[i] = t.captain.spec.loc
                self.net_idx[i] = net_index(t.captain.spec.net_type)
                self.cloud[i] = t.captain.spec.is_cloud
                self.dedicated[i] = t.captain.spec.dedicated
                self.node_ids[i] = t.captain.node_id
        self.codes = geohash.encode_batch(self.lat, self.lon, CODE_PRECISION)

    def alive_mask(self) -> np.ndarray:
        """(T,) bool: task has a live captain (status ignored — matches the
        scalar client's connection-break liveness check)."""
        return np.fromiter(
            (t.captain is not None and t.captain.alive for t in self.tasks),
            bool, count=len(self.tasks))

    def locality_bits(self, locs: tuple) -> np.ndarray:
        """(T,) float64 data-locality bits: 1.0 where the task's node sits
        within ``DATA_LOCAL_RADIUS_KM`` of any of the given Cargo replica
        locations.  Depends only on static node positions, so it is cached
        per replica-location tuple on this view."""
        bits = self._local_bits.get(locs)
        if bits is None:
            if not locs:
                bits = np.zeros(len(self.tasks))
            else:
                pts = np.asarray(locs, np.float64).reshape(-1, 2)
                d = geohash.distance_km_batch(
                    self.lat[:, None], self.lon[:, None],
                    pts[None, :, 0], pts[None, :, 1])
                bits = (d.min(axis=1) <= DATA_LOCAL_RADIUS_KM
                        ).astype(np.float64)
            self._local_bits[locs] = bits
        return bits

    def dynamic_state(self, hidden=None, locality=None, queueing=None
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """(mask, free): alive+running mask and free-slot fractions.

        ``hidden`` names nodes no live Beacon currently knows (their fault
        domain's Beacon died and the heartbeat replay has not reached a
        surviving replica yet): they stay alive on the data plane — warm
        connections and in-flight frames are untouched — but drop out of
        the schedulable mask, so selection cannot hand them to new users
        until they re-register.

        ``locality`` is an optional ``(replica_locs, weight)`` pair from
        ``SelectionEngine.set_data_locality``: the data-locality bonus is
        folded into ``free`` here, scaled by ``1/W_RESOURCE`` so the final
        Algorithm-1 score gains exactly ``weight`` per data-local node.

        ``queueing`` is an optional ``(weight, norm_ms)`` pair from
        ``SelectionEngine.set_queueing_awareness``: each captain's
        expected queueing delay (heartbeat ``queue_ms``, from its serving
        profile's backlog) is normalized to ``min(queue_ms / norm_ms, 1)``
        and subtracted the same way, so a saturated node loses up to
        ``weight`` score even after ``free_fraction`` has clamped at 0.

        This is the single injection point every tick path (numpy scorer,
        geo_topk kernel, fused device tick, mesh) draws its dynamic node
        state from — folding the terms here keeps them decision-identical
        by construction."""
        n = len(self.tasks)
        mask = np.zeros(n, bool)
        free = np.zeros(n)
        queue_ms = np.zeros(n) if queueing is not None else None
        for i, t in enumerate(self.tasks):
            c = t.captain
            if t.status == "running" and c is not None and c.alive \
                    and not (hidden and c.node_id in hidden):
                mask[i] = True
                free[i] = c.free_fraction()
                if queue_ms is not None:
                    queue_ms[i] = c.queueing_delay_ms()
        if locality is not None:
            locs, weight = locality
            free = free + (weight / W_RESOURCE) * self.locality_bits(locs) \
                * mask
        if queueing is not None:
            weight, norm_ms = queueing
            free = free - (weight / W_RESOURCE) \
                * np.minimum(queue_ms / max(norm_ms, 1e-9), 1.0) * mask
        return mask, free

    def packed_static(self, node_pad: int = 256,
                      device="cuda") -> PackedStatic:
        """Kernel-ready padded node tensors on ``device``, built once per
        node-epoch (i.e. once per replica-set change) and cached on this
        view — repacking from numpy used to happen on every tick."""
        device = torch.device(device)
        cached = self._packed.get((node_pad, device))
        if cached is not None:
            return cached
        from repro_torch.kernels.geo_topk.ops import code20
        n = len(self.tasks)
        n_pad = padded_len(n, node_pad)

        def pad(x, dtype):
            out = np.zeros(n_pad, dtype)
            out[:n] = x
            return torch.from_numpy(out).to(device)

        aff = np.zeros((AFFINITY_TABLE.shape[0], n_pad), np.float32)
        aff[:, :n] = AFFINITY_TABLE[self.net_idx, :].T
        packed = PackedStatic(
            n=n, n_pad=n_pad,
            lat=pad(self.lat, np.float32),
            lon=pad(self.lon, np.float32),
            aff=torch.from_numpy(aff).to(device),
            code20=pad(code20(self.codes), np.int32),
            cloud=pad(self.cloud, np.float32))
        self._packed[(node_pad, device)] = packed
        return packed

    def padded_sched(self, mask: np.ndarray, free: np.ndarray,
                     node_pad: int = 256
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """(free_p, sched) in the kernel's padded layout, from an
        already-computed ``dynamic_state`` sweep (the single source for
        this padding — callers that did the O(N) sweep themselves must
        not restate it)."""
        n = len(self.tasks)
        n_pad = padded_len(n, node_pad)
        free_p = np.zeros(n_pad, np.float32)
        free_p[:n] = free
        sched = np.zeros(n_pad, np.float32)
        sched[:n] = mask
        return free_p, sched

    def padded_dynamic(self, node_pad: int = 256, hidden=None,
                       locality=None, queueing=None
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Per-tick (free, valid_sched, valid_alive) padded to match
        ``packed_static``: fp32 free fractions (data-locality bonus and
        queueing-delay penalty folded in when ``locality`` / ``queueing``
        are set — see ``dynamic_state``), schedulable mask (running +
        alive + Beacon-visible — what selection scores) and alive mask
        (what the client data plane may still talk to; control-plane
        ``hidden`` does NOT touch it)."""
        mask, free = self.dynamic_state(hidden, locality, queueing)
        free_p, sched = self.padded_sched(mask, free, node_pad)
        alive = np.zeros(free_p.shape[0], bool)
        alive[:len(self.tasks)] = self.alive_mask()
        return free_p, sched, alive


def _fingerprint(tasks: Sequence[object]) -> Tuple:
    return tuple((t.task_id, None if t.captain is None
                  else t.captain.node_id) for t in tasks)


# ---------------------------------------------------------------------------
# Region shards (paper §3.1: per-region Beacon replicas)
# ---------------------------------------------------------------------------

class _Shard:
    """One Morton-prefix region of a service's replica set: a child
    ``_ServiceArrays`` over the shard's tasks plus the mapping back to
    global task-list positions (``ix``, ascending — so per-shard stable
    sorts tie-break exactly like the global one)."""

    def __init__(self, code: int, ix: np.ndarray, tasks: Sequence[object]):
        self.code = int(code)
        self.ix = ix
        self.arrays = _ServiceArrays(tasks)
        self._task_ix_pad: Dict[int, np.ndarray] = {}

    def adopt(self, prev: "_Shard"):
        """Carry the device-resident caches over from a predecessor whose
        membership fingerprint is identical — a replica-set change in
        another region must not repack this shard's node arrays."""
        self.arrays._packed = prev.arrays._packed
        self.arrays.epoch = prev.arrays.epoch
        self._task_ix_pad = prev._task_ix_pad

    def task_ix_padded(self, node_pad: int = 256) -> np.ndarray:
        """(n_pad,) int32 global task positions, -1 beyond the shard —
        the local→global index map for kernel-path top-k results, padded
        exactly like ``packed_static`` so churn never changes jit shapes."""
        out = self._task_ix_pad.get(node_pad)
        if out is None:
            n = len(self.ix)
            out = np.full(padded_len(n, node_pad), -1, np.int32)
            out[:n] = self.ix
            self._task_ix_pad[node_pad] = out
        return out

    def padded_dynamic(self, mask: np.ndarray, free: np.ndarray,
                       node_pad: int = 256
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """Per-tick (free, sched) for this shard, sliced from the parent
        O(N) sweep and padded to the shard's kernel layout."""
        return self.arrays.padded_sched(mask[self.ix], free[self.ix],
                                        node_pad)


class _ShardSet:
    """Partition of one service's task list by Morton-code prefix at
    ``precision`` chars.  Rebuilt when the parent view changes, but
    shards whose own membership is unchanged adopt their predecessor's
    device caches — invalidation is effectively routed to the one shard
    whose region actually changed.

    ``owner`` maps home region codes to the region whose Beacon replica
    currently *serves* them (Beacon fault domains — a dead domain's
    regions are re-pointed at the nearest live Beacon).  Grouping and
    routing both apply the map, so a failed domain's tasks merge into
    the adopting Beacon's shard and its users hand off to the same shard
    — decision-identical to the unsharded engine by the same nesting
    argument: an owner-mapped user's ``p >= precision`` cells still lie
    entirely inside their (merged) shard."""

    def __init__(self, parent: _ServiceArrays, precision: int,
                 prev: Optional["_ShardSet"] = None,
                 owner: Optional[Dict[int, int]] = None,
                 owner_version: int = 0):
        self.parent_epoch = parent.epoch
        self.precision = precision
        self.owner = dict(owner) if owner else None
        self.owner_version = owner_version
        shift = 5 * (CODE_PRECISION - precision)
        shard_code = self._apply_owner(parent.codes >> shift)
        prev_by_code = {}
        diffable = prev is not None and prev.precision == precision
        if diffable:
            prev_by_code = {s.code: s for s in prev.shards}
        self.shards: List[_Shard] = []
        # refresh-epoch attribution: serving codes whose membership
        # actually changed across this rebuild (failed adopt, new shard,
        # vanished shard); None when there is no predecessor to diff
        # against (initial build / teardown) — the engine marks globally
        changed: List[int] = []
        for code in np.unique(shard_code):
            ix = np.nonzero(shard_code == code)[0]
            sh = _Shard(code, ix, [parent.tasks[i] for i in ix])
            old = prev_by_code.pop(int(code), None)
            if old is not None and len(old.ix) == len(ix) \
                    and old.arrays.fingerprint == sh.arrays.fingerprint \
                    and np.array_equal(old.ix, ix):
                sh.adopt(old)
            else:
                changed.append(int(code))
            self.shards.append(sh)
        changed.extend(prev_by_code)          # vanished shards
        self.changed_codes: Optional[List[int]] = changed if diffable \
            else None

    def _apply_owner(self, codes: np.ndarray) -> np.ndarray:
        """Map prefix codes through the Beacon ownership table (identity
        for regions whose own Beacon is alive).  Vectorized over the
        unique codes — the table is tiny, the arrays are not."""
        if not self.owner:
            return codes
        uq, inv = np.unique(codes, return_inverse=True)
        mapped = np.asarray([self.owner.get(int(c), int(c)) for c in uq],
                            np.int64)
        return mapped[inv]

    def route(self, u_codes: np.ndarray) -> np.ndarray:
        """(U,) serving-shard prefix code per user (full-precision codes):
        the home-region prefix mapped through Beacon ownership — a user
        whose home Beacon is down routes to the adopting live Beacon's
        merged shard (the multi-Beacon handoff path)."""
        return self._apply_owner(
            u_codes >> np.int64(5 * (CODE_PRECISION - self.precision)))


def assign_shards_to_devices(counts: Sequence[int], n_devices: int
                             ) -> Tuple[List[int], List[int]]:
    """Greedy LPT bin-pack of region shards onto mesh devices by user
    count: heaviest shard first onto the least-loaded device.  Returns
    ``(assignment, load)`` — a device index per shard and the resulting
    per-device user counts.  Deterministic (ties break on ascending
    shard / device index), so every host computes the same placement;
    the mesh tick driver consumes it to build its block permutation."""
    order = sorted(range(len(counts)), key=lambda i: (-counts[i], i))
    load = [0] * n_devices
    assign = [0] * len(counts)
    for i in order:
        d = min(range(n_devices), key=lambda j: (load[j], j))
        assign[i] = d
        load[d] += counts[i]
    return assign, load


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

class SelectionEngine:
    """Batched Algorithm 1 over cached per-service arrays.  ``device`` is
    where the geo_topk-backed queries score (``"cuda"`` by default: the
    hand-written kernels; ``"cpu"``: the plain PyTorch version); the
    numpy queries run on the host either way."""

    def __init__(self, *, top_n: int = 3, user_chunk: int = 8192,
                 shard_precision: Optional[int] = None, device="cuda"):
        device = torch.device(device)
        if device.type not in ("cpu", "cuda"):
            raise ValueError(f"device must be cpu or cuda, not {device}")
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "SelectionEngine(device='cuda') needs a CUDA device and "
                "none is available — pass device='cpu' for the plain "
                "PyTorch path")
        self.device = device
        if shard_precision is not None and not \
                1 <= shard_precision <= PROXIMITY_PRECISION:
            raise ValueError(
                f"shard_precision must be in [1, {PROXIMITY_PRECISION}] "
                f"(got {shard_precision}) — shards are aligned to the "
                "proximity filter's geohash cells")
        self.top_n = top_n
        self.user_chunk = user_chunk        # bounds the U×N score matrices
        self.shard_precision = shard_precision
        self._cache: Dict[str, _ServiceArrays] = {}
        self._shard_cache: Dict[str, _ShardSet] = {}
        # Beacon fault domains (set by a BeaconSet): region -> serving
        # region for domains whose Beacon is down, plus the nodes no live
        # Beacon currently knows.  ``owner_version`` bumps on every
        # ownership change so shard sets (and the fused tick's static
        # routing) rebuild exactly once per handoff/re-home.
        self.hidden_nodes: frozenset = frozenset()
        self._owner: Optional[Dict[int, int]] = None
        self.owner_version = 0
        # client-side Beacon discovery latency (set by an ArmadaSystem):
        # the probe loop charges this window on bootstrap and whenever a
        # user's serving region changes (Beacon handoff/re-home) before
        # refreshing candidates from the new Beacon
        self.discovery_ms = 0.0
        # data-locality preference (set by a CargoManager): per-service
        # (replica_locs, weight) — a purely dynamic input like ``hidden``,
        # folded into the free-fraction vector so every tick path scores
        # it identically (no jit-shape or cache impact)
        self.data_locality: Dict[str, Tuple[tuple, float]] = {}
        # queueing-aware load term (serving-aware data plane): per-service
        # (weight, norm_ms) — like data_locality a purely dynamic input,
        # folded into the free-fraction vector at the single injection
        # point so every tick path scores it identically
        self.queueing: Dict[str, Tuple[float, float]] = {}
        # incremental-refresh epoch channel: a monotonic counter per
        # serving-region prefix code, bumped whenever that region's
        # schedulable node set (membership, ownership, visibility) may
        # have changed, plus a global counter for events that cannot be
        # attributed to a region (locality change, unsharded rebuilds,
        # full invalidation).  ``ClientPool._RefreshTracker`` diffs these
        # against its last-seen snapshot to decide which users to rescore.
        self.region_epoch: Dict[int, int] = {}
        self.epoch_all = 0

    # ------------------------------------------------- region dirty epochs

    def mark_all_dirty(self) -> None:
        """Bump the global refresh epoch: every user's candidates may be
        stale (events with no region attribution)."""
        self.epoch_all += 1

    def mark_regions_dirty(self, codes) -> None:
        """Bump the refresh epoch of the given *home*-region prefix codes
        (mapped through Beacon ownership, so a dead region's mark lands on
        the merged serving shard its users actually route to).  Serving
        codes are fixed points of the map, so callers may pass either."""
        owner = self._owner
        for c in codes:
            c = int(c)
            if owner:
                c = owner.get(c, c)
            self.region_epoch[c] = self.region_epoch.get(c, 0) + 1

    # ------------------------------------------------------------- caching

    def set_data_locality(self, service_id: str, replica_locs,
                          weight: float = W_DATA) -> None:
        """Data-placement update from a ``CargoManager``: the (lat, lon)
        locations of the service's alive Cargo replicas.  Nodes within
        ``DATA_LOCAL_RADIUS_KM`` of any replica gain ``weight`` on their
        Algorithm-1 score, so failover and handoff prefer nodes that can
        reach the service's store in situ (paper §3.4).  Pass an empty /
        None ``replica_locs`` to clear the preference."""
        prev = self.data_locality.get(service_id)
        if not replica_locs:
            self.data_locality.pop(service_id, None)
        else:
            self.data_locality[service_id] = (
                tuple(tuple(map(float, p)) for p in replica_locs),
                float(weight))
        if self.data_locality.get(service_id) != prev:
            # the preference shifts scores everywhere within radius of any
            # replica — no region attribution, mark globally
            self.mark_all_dirty()

    def set_queueing_awareness(self, service_id: str,
                               weight: float = W_QUEUE,
                               norm_ms: float = QUEUE_NORM_MS) -> None:
        """Enable the queueing-aware load term for a service: every
        captain's expected queueing delay (its serving profile's backlog,
        ``Captain.queueing_delay_ms``) is normalized against ``norm_ms``
        and subtracts up to ``weight`` from the Algorithm-1 score — so
        selection keeps differentiating nodes after their free fraction
        has clamped at 0 (batch slots saturated).  Pass a falsy
        ``weight`` to disable (exact pre-existing scores)."""
        prev = self.queueing.get(service_id)
        if not weight:
            self.queueing.pop(service_id, None)
        else:
            self.queueing[service_id] = (float(weight), float(norm_ms))
        if self.queueing.get(service_id) != prev:
            # backlog is per-node state with no region attribution —
            # enabling/disabling shifts scores fleet-wide
            self.mark_all_dirty()

    def set_beacon_routing(self, owner, hidden,
                           dirty_regions=None) -> None:
        """Control-plane routing update from a ``BeaconSet``.

        ``owner`` maps home region codes (Morton prefixes at
        ``shard_precision``) to the region whose live Beacon serves them;
        identity entries are dropped.  An ownership change bumps
        ``owner_version`` — shard sets rebuild lazily on the next query,
        with unchanged regions adopting their device caches, so a Beacon
        handoff never triggers a global rebuild.  ``hidden`` names nodes
        whose registration is lost (failed domain, heartbeat replay
        pending): a purely *dynamic* input — it flows through the
        schedulable mask without touching cached arrays or jit shapes."""
        owner = {int(k): int(v) for k, v in (owner or {}).items()
                 if int(k) != int(v)} or None
        if owner != self._owner:
            self._owner = owner
            self.owner_version += 1
        hidden = frozenset(hidden)
        hidden_changed = hidden != self.hidden_nodes
        self.hidden_nodes = hidden
        # refresh epochs: ``dirty_regions`` is the caller's attribution of
        # which regions' node visibility changed (a BeaconSet diffs its
        # serving map).  A visibility change without attribution must
        # still dirty *someone* — fall back to the global epoch.
        if dirty_regions:
            self.mark_regions_dirty(dirty_regions)
        elif hidden_changed and dirty_regions is None:
            self.mark_all_dirty()

    def invalidate(self, service_id: Optional[str] = None):
        """Drop cached node arrays (replica set changed).  A per-service
        invalidate keeps that service's shard set: the next query diffs
        per-shard fingerprints and rebuilds only the shards whose
        membership actually changed (the others adopt their device
        caches), so invalidation is region-routed.  A full
        ``invalidate()`` releases everything, shard sets included —
        the teardown path."""
        if service_id is None:
            self._cache.clear()
            self._shard_cache.clear()
            self.mark_all_dirty()
        else:
            self._cache.pop(service_id, None)

    def _arrays(self, service_id: str,
                tasks: Sequence[object]) -> _ServiceArrays:
        arr = self._cache.get(service_id)
        if arr is None or arr.fingerprint != _fingerprint(tasks):
            arr = _ServiceArrays(tasks)
            self._cache[service_id] = arr
            if self.shard_precision is None:
                # unsharded engines have no region diff — any replica-set
                # change dirties the whole population (the sharded path
                # attributes the change per shard in ``_shards`` below)
                self.mark_all_dirty()
        return arr

    def _shards(self, service_id: str, arr: _ServiceArrays) -> _ShardSet:
        cur = self._shard_cache.get(service_id)
        if cur is None or cur.parent_epoch != arr.epoch \
                or cur.precision != self.shard_precision \
                or cur.owner_version != self.owner_version:
            cur = _ShardSet(arr, self.shard_precision, prev=cur,
                            owner=self._owner,
                            owner_version=self.owner_version)
            self._shard_cache[service_id] = cur
            if cur.changed_codes is None:
                self.mark_all_dirty()
            elif cur.changed_codes:
                self.mark_regions_dirty(cur.changed_codes)
        return cur

    def shard_view(self, service_id: str,
                   tasks: Sequence[object]) -> Optional[_ShardSet]:
        """Current region partition of the replica set (None when the
        engine is unsharded) — the fused tick's window into the shard
        layout."""
        if self.shard_precision is None:
            return None
        return self._shards(service_id, self._arrays(service_id, tasks))

    # ------------------------------------------------------------- queries

    def candidate_list(self, service_id: str, tasks: Sequence[object],
                       user_loc, user_net: str,
                       top_n: Optional[int] = None) -> List[object]:
        """Single-user Algorithm 1 — same ranking as the scalar scorer."""
        return self.candidate_lists(service_id, tasks, [user_loc],
                                    [user_net], top_n=top_n)[0]

    def candidate_lists(self, service_id: str, tasks: Sequence[object],
                        user_locs, user_nets, top_n: Optional[int] = None,
                        ) -> List[List[object]]:
        """Batched Algorithm 1: per-user top-k over a U×N score matrix.

        ``user_locs``: sequence of (lat, lon); ``user_nets``: sequence of
        net-type strings (or a single string applied to every user).
        Returns one ranked Task list per user.  (Materializing wrapper over
        ``candidate_indices`` — the ClientPool stays in index space.)
        """
        idx = self.candidate_indices(service_id, tasks, user_locs,
                                     user_nets, top_n=top_n)
        task_seq = list(tasks)
        return [[task_seq[j] for j in row if j >= 0] for row in idx]

    def candidate_indices(self, service_id: str, tasks: Sequence[object],
                          user_locs, user_nets,
                          top_n: Optional[int] = None) -> np.ndarray:
        """Batched Algorithm 1 in index space: ``(U, k)`` int32 matrix of
        ranked positions into ``tasks``, right-padded with -1.  Same
        ranking as ``candidate_lists`` without materializing Python lists
        (the ``ClientPool`` hot path)."""
        k = top_n or self.top_n
        users = np.asarray(user_locs, np.float64).reshape(-1, 2)
        u_total = len(users)
        nets = parse_nets(user_nets, u_total)
        arr = self._arrays(service_id, tasks)
        mask, free = arr.dynamic_state(self.hidden_nodes,
                                       self.data_locality.get(service_id),
                                       self.queueing.get(service_id))
        run_ix = np.nonzero(mask)[0]
        out = np.full((u_total, k), -1, np.int32)   # always (U, k)
        if run_ix.size == 0:
            return out
        kk = min(k, run_ix.size)
        if self.shard_precision is not None:
            self._indices_sharded(service_id, arr, mask, free, run_ix,
                                  users, nets, kk, out)
            return out
        for lo in range(0, u_total, self.user_chunk):
            hi = min(lo + self.user_chunk, u_total)
            out[lo:hi, :kk] = self._score_chunk(arr, run_ix, free[run_ix],
                                                users[lo:hi], nets[lo:hi],
                                                kk)
        return out

    def _indices_sharded(self, service_id: str, arr: _ServiceArrays,
                         mask: np.ndarray, free: np.ndarray,
                         run_ix: np.ndarray, users: np.ndarray,
                         nets: np.ndarray, kk: int, out: np.ndarray):
        """Region-sharded Algorithm 1: each user chunk scores only its
        home-region shard; users the in-shard proximity widening cannot
        satisfy (the border band) escalate to one cross-shard pass over
        the full node set.  Fills ``out`` in place — decision-identical
        to the unsharded chunk loop (see the module docstring for the
        nesting argument)."""
        need = min(MIN_PROXIMITY_HITS, run_ix.size)
        u_codes = geohash.encode_batch(users[:, 0], users[:, 1],
                                       CODE_PRECISION)
        shards = self._shards(service_id, arr)
        u_shard = shards.route(u_codes)
        sat_all = np.zeros(len(users), bool)
        for sh in shards.shards:
            sel = np.nonzero(u_shard == sh.code)[0]
            if sel.size == 0:
                continue
            run_local = np.nonzero(mask[sh.ix])[0]
            if run_local.size == 0:
                continue            # nothing running here: all border
            free_sub = free[sh.ix][run_local]
            for lo in range(0, sel.size, self.user_chunk):
                s = sel[lo:lo + self.user_chunk]
                idx, sat = self._score_shard_chunk(
                    sh, run_local, free_sub, users[s], nets[s],
                    u_codes[s], kk, need)
                rows = s[sat]
                out[rows, :kk] = idx[sat]
                sat_all[rows] = True
        border = np.nonzero(~sat_all)[0]
        for lo in range(0, border.size, self.user_chunk):
            b = border[lo:lo + self.user_chunk]
            out[b, :kk] = self._score_chunk(arr, run_ix, free[run_ix],
                                            users[b], nets[b], kk)

    def _score_shard_chunk(self, sh: _Shard, run_local: np.ndarray,
                           free: np.ndarray, users: np.ndarray,
                           nets: np.ndarray, u_codes: np.ndarray,
                           k: int, need: int
                           ) -> Tuple[np.ndarray, np.ndarray]:
        """One user chunk against one shard, proximity filter restricted
        to ``p >= shard_precision``.  Returns ``(idx, sat)``: (U, k)
        global task positions (-1 padded) and the per-user satisfied
        mask.  Unsatisfied rows carry no result — the caller escalates
        them to the cross-shard border pass.  ``need`` is the *global*
        running-replica hit target, so a satisfied user's filter level is
        exactly the unsharded engine's."""
        child = sh.arrays
        n = run_local.size
        u = len(users)
        n_codes = child.codes[run_local]
        local = np.zeros((u, n), bool)          # no fallback in-shard
        done = np.zeros(u, bool)
        for p in range(PROXIMITY_PRECISION, self.shard_precision - 1, -1):
            shift = 5 * (CODE_PRECISION - p)
            eq = (u_codes[:, None] >> shift) == (n_codes[None, :] >> shift)
            use = (eq.sum(axis=1) >= need) & ~done
            local = np.where(use[:, None], eq, local)
            done |= use

        scores = _score_rows(child.lat[run_local], child.lon[run_local],
                             child.net_idx[run_local], free, users, nets)
        kk = min(k, n)
        order, n_local = _rank_local(scores, local, kk)
        idx = np.full((u, k), -1, np.int32)
        idx[:, :kk] = sh.ix[run_local[order]].astype(np.int32)
        idx[np.arange(k)[None, :] >= np.minimum(k, n_local)[:, None]] = -1
        return idx, done

    def _score_chunk(self, arr: _ServiceArrays, run_ix: np.ndarray,
                     free: np.ndarray, users: np.ndarray,
                     nets: np.ndarray, k: int) -> np.ndarray:
        n = run_ix.size
        u = len(users)
        n_lat = arr.lat[run_ix]
        n_lon = arr.lon[run_ix]
        n_codes = arr.codes[run_ix]
        n_net = arr.net_idx[run_ix]
        u_codes = geohash.encode_batch(users[:, 0], users[:, 1],
                                       CODE_PRECISION)

        # adaptive-precision proximity filter: for p = 4..1, keep replicas
        # sharing the first p geohash chars; accept the first p with enough
        # hits, else no filter (exact ``proximity_search`` semantics).
        # One (U, N) compare at a time keeps peak memory at a single tile.
        need = min(MIN_PROXIMITY_HITS, n)
        local = np.ones((u, n), bool)                 # fallback: no filter
        done = np.zeros(u, bool)
        for p in range(PROXIMITY_PRECISION, 0, -1):
            shift = 5 * (CODE_PRECISION - p)
            eq = (u_codes[:, None] >> shift) == (n_codes[None, :] >> shift)
            use = (eq.sum(axis=1) >= need) & ~done
            local = np.where(use[:, None], eq, local)
            done |= use

        scores = _score_rows(n_lat, n_lon, n_net, free, users, nets)
        order, n_local = _rank_local(scores, local, k)
        idx = run_ix[order].astype(np.int32)
        idx[np.arange(k)[None, :] >= np.minimum(k, n_local)[:, None]] = -1
        return idx

    def service_view(self, service_id: str,
                     tasks: Sequence[object]) -> _ServiceArrays:
        """Cached per-task attribute arrays (lat/lon, net, cloud/dedicated
        flags, node ids) for the current replica set — the ClientPool's
        window into task attributes without touching Task objects."""
        return self._arrays(service_id, tasks)

    # --------------------------------------------------- kernel-backed path

    def prepare_kernel_inputs(self, service_id: str,
                              tasks: Sequence[object], user_locs,
                              user_nets):
        """Pack the current replica set + a user batch into the flat
        tensors ``repro_torch.kernels.geo_topk`` consumes, on the engine's
        device (see its docstring for the meaning of the 20-bit codes).
        Returns ``(run_ix, GeoTopKInputs)``."""
        from repro_torch.kernels.geo_topk.ops import (inputs_from_numpy,
                                                      pack_inputs)
        users = np.asarray(user_locs, np.float64).reshape(-1, 2)
        nets = parse_nets(user_nets, len(users))
        arr = self._arrays(service_id, tasks)
        mask, free = arr.dynamic_state(self.hidden_nodes,
                                       self.data_locality.get(service_id),
                                       self.queueing.get(service_id))
        run_ix = np.nonzero(mask)[0]
        u_codes = geohash.encode_batch(users[:, 0], users[:, 1],
                                       CODE_PRECISION)
        return run_ix, inputs_from_numpy(pack_inputs(
            users[:, 0], users[:, 1], nets, u_codes,
            arr.lat[run_ix], arr.lon[run_ix], free[run_ix],
            arr.net_idx[run_ix], arr.codes[run_ix]), self.device)

    def candidate_lists_kernel(self, service_id: str,
                               tasks: Sequence[object], user_locs,
                               user_nets, top_n: Optional[int] = None
                               ) -> List[List[object]]:
        """Batched selection through the fused geo_topk op on the
        engine's device.  Same top-k semantics as ``candidate_lists``."""
        from repro_torch.kernels.geo_topk.ops import geo_topk
        k = top_n or self.top_n
        run_ix, packed = self.prepare_kernel_inputs(service_id, tasks,
                                                    user_locs, user_nets)
        if run_ix.size == 0:
            return [[] for _ in range(len(packed.user_lat))]
        scores, idx = geo_topk(packed, k=min(k, run_ix.size))
        scores = scores.cpu().numpy()
        idx = idx.cpu().numpy()
        arr = self._cache[service_id]
        return [[arr.tasks[run_ix[j]] for j, s in zip(row_i, row_s)
                 if np.isfinite(s) and s > -1e29]
                for row_i, row_s in zip(idx, scores)]

    def candidate_indices_device(self, service_id: str,
                                 tasks: Sequence[object], user_locs,
                                 user_nets, top_n: Optional[int] = None,
                                 node_pad: int = 256):
        """Batched Algorithm 1 on the engine's device, no numpy
        materialization: returns ``(scores, idx)`` tensors of shape
        ``(U, k_eff)``, ``k_eff = min(top_n, running replicas)`` — ``idx``
        in task-position space with padding/filtered entries scoring
        ``NEG`` (callers keep entries with ``score > -1e29``).  Returns
        ``None`` when no replica is running.

        The node half of the query comes from the per-epoch
        ``packed_static`` cache (device-resident, zero-padded to a
        ``node_pad`` multiple so churn never changes the kernels' shapes);
        only the (U,) user arrays and two (n_pad,) dynamic vectors cross
        the host→device boundary per call.  fp32 scoring — ranking may
        differ from the float64 numpy path at exact-tie resolution.
        """
        from repro_torch.kernels.geo_topk.ops import (GeoTopKInputs, geo_topk,
                                                      pack_user_inputs,
                                                      to_device)
        k = top_n or self.top_n
        users = np.asarray(user_locs, np.float64).reshape(-1, 2)
        nets = parse_nets(user_nets, len(users))
        arr = self._arrays(service_id, tasks)
        mask, free = arr.dynamic_state(self.hidden_nodes,
                                       self.data_locality.get(service_id),
                                       self.queueing.get(service_id))
        n_run = int(mask.sum())
        if n_run == 0:
            return None
        u_codes = geohash.encode_batch(users[:, 0], users[:, 1],
                                       CODE_PRECISION)
        k_eff = min(k, n_run)
        need = min(MIN_PROXIMITY_HITS, n_run)
        if self.shard_precision is not None:
            return self._indices_device_sharded()
        st = arr.packed_static(node_pad, self.device)
        free_p, sched = arr.padded_sched(mask, free, node_pad)
        user_half = to_device(
            pack_user_inputs(users[:, 0], users[:, 1], nets, u_codes),
            self.device)
        free_t, sched_t = to_device((free_p, sched), self.device)
        packed = GeoTopKInputs(*user_half, st.lat, st.lon, free_t, st.aff,
                               st.code20, sched_t)
        return geo_topk(packed, k=k_eff, need=need)

    def _indices_device_sharded(self):
        """The JAX package's region-sharded kernel path (per-shard
        ``geo_topk_shard`` + one cross-shard border pass) is not ported
        yet."""
        raise NotImplementedError(
            "region-sharded geo_topk selection is not ported to the "
            "PyTorch package yet (ROADMAP: \"Region-sharded and incremental "
            "refresh on device\") — use the numpy backend with "
            "shard_precision, or an unsharded engine")

    def candidate_indices_kernel(self, service_id: str,
                                 tasks: Sequence[object], user_locs,
                                 user_nets, top_n: Optional[int] = None,
                                 node_pad: int = 256) -> np.ndarray:
        """``candidate_indices`` through the fused geo_topk op — the
        ClientPool's high-throughput refresh path (fluid transport).
        Materializing wrapper over ``candidate_indices_device``: only the
        (U, k) index matrix comes back to the host."""
        k = top_n or self.top_n
        u_total = np.asarray(user_locs, np.float64).reshape(-1, 2).shape[0]
        res = self.candidate_indices_device(
            service_id, tasks, user_locs, user_nets, top_n=top_n,
            node_pad=node_pad)
        if res is None:
            return np.full((u_total, k), -1, np.int32)
        scores, idx = res
        out = torch.where(scores > -1e29, idx, -1).to(torch.int32)
        out = out.cpu().numpy()
        k_eff = out.shape[1]
        if k_eff < k:
            out = np.concatenate(
                [out, np.full((u_total, k - k_eff), -1, np.int32)],
                axis=1)
        return out
