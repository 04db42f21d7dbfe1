"""Vectorized client pool: U live users as structure-of-arrays state.

The paper's evaluation is client-driven — 2-step selection, periodic
probing with per-candidate latency EMAs, two-round confirmed switches,
and zero-downtime failover.  ``repro_torch.core.client.Client`` runs one user
per Python object; this module runs the whole population through shared
array state so the end-to-end simulator scales to 100k+ users
(``benchmarks/bench_client_scale.py``).

Layering:

* **Pure policy functions** (`ema_fold`, `switch_decide`,
  `failover_pick`, `mode_filter`) — the client-side half of the paper's
  algorithms as array transforms over SoA state.  They are shared
  verbatim by the scalar ``Client`` (U=1 rows) and the pool, and take an
  ``xp`` module; the port runs them under numpy on the host tick (the
  fused device tick that would run them on tensors is not ported yet —
  ROADMAP "Fused device tick").
* **``ClientPool``** — SoA state (candidate index matrix, per-(user,
  node) EMA table, pending-switch/downtime arrays, per-user mode codes
  for the paper's six baselines) driven by pool-level simulator events:
  one ``candidate_indices`` call and one vectorized EMA/switch update
  per probe tick for the entire population.

Two data-plane transports:

* ``transport="events"`` — every request still rides the per-request
  ``Captain.arrive`` path, and all RNG draws happen in exactly the order
  U scalar ``Client`` objects would make them (batched via
  ``Simulator.jitter_batch``, which is bit-identical to sequential
  draws).  A pool in this mode reproduces scalar clients **bit-for-bit**
  — samples, EMA trajectories, and switch decisions
  (tests/test_client_pool.py pins this on the paper's Fig. 8/10
  scenarios).  The control plane (selection, switch, failover decisions)
  is vectorized; the data plane stays event-accurate.
* ``transport="fluid"`` — requests are aggregated per node per tick
  through ``Captain.arrive_batch``: a fluid multi-slot queue model gives
  every request a queueing delay from the node's backlog trajectory, and
  EMAs are folded in vectorized arrival-order rounds.  Statistically
  faithful (not bit-for-bit) and scales to 100k users × 1k nodes.

The fluid transport runs its probe tick on the host (``tick="host"``:
numpy policy update, optionally geo_topk-backed selection, whose scoring
runs on the engine's device through the hand-written CUDA kernels).  The
JAX package's fused device tick (``tick="device"``) and its mesh variant
(``mesh=...``) are not ported yet and raise ``NotImplementedError``
(ROADMAP "Fused device tick" and "Mesh tick across GPUs").

When the ``SelectionEngine`` is region-sharded (``shard_precision`` on
the ``ApplicationManager``/``ArmadaSystem``), the host tick
routes each user chunk to its home-region shard transparently through
the engine's numpy sharded query path; decisions stay identical to the
unsharded pool (the sharded geo_topk path is not ported yet).
The same routing carries the multi-Beacon handoff: when a region's
Beacon fault domain fails (``ArmadaSystem.fail_beacon``), the engine's
ownership map re-points that region at the nearest live Beacon, so the
pool's batched refresh hands the affected users off to the adopting
shard without any per-user bookkeeping, and re-homes them when the
Beacon recovers.  Nodes whose
registration died with the Beacon drop out of the schedulable mask (a
dynamic input — no jit-shape change) until their heartbeat replay
lands; the data plane keeps serving actives throughout.

Scalar-parity notes (events transport) — the pool intentionally mirrors
seed-code quirks so equivalence is exact: a user whose *initial*
candidate query is empty retries at 500 ms but never activates (no frame
loop, no probe tick); a user whose whole candidate set dies re-enters
initial selection *and* gains a second probe-tick chain; connection-break
notifications replay in warm-connection insertion order.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import geohash
from repro_torch.core.captain import Request
from repro_torch.core.selection import net_index

# Step-1 wide candidate list size: baselines filter the WIDE list before
# trimming to TopN, so a "dedicated-only" client can't leak onto volunteer
# nodes.  Shared by the scalar Client and the pool path (keeps baseline
# filters consistent — previously hardcoded at client.py:95).
WIDE_TOP_N = 64

RECONNECT_DELAY_MS = 2000.0

# paper baselines (client.py module docstring); array state keeps these as
# int8 codes so a single pool can mix modes per user
MODES = ("armada", "geo", "dedicated", "cloud", "reconnect", "edge2cloud")
MODE_INDEX = {m: i for i, m in enumerate(MODES)}
(MODE_ARMADA, MODE_GEO, MODE_DEDICATED, MODE_CLOUD, MODE_RECONNECT,
 MODE_EDGE2CLOUD) = range(6)


@dataclass
class LatencySample:
    t: float
    ms: float
    node: str
    is_probe: bool = False


# ---------------------------------------------------------------------------
# Pure policy functions (shared by scalar Client and ClientPool)
# ---------------------------------------------------------------------------

def ema_fold(prev, ms, alpha: float, xp=np):
    """One latency-EMA step per row; NaN ``prev`` means no prior sample
    (``Client._on_response`` semantics, same operand order bit-for-bit)."""
    has = ~xp.isnan(prev)
    return xp.where(has, alpha * ms + (1 - alpha) * prev, ms)


def switch_decide(cand_task, cand_ema, active_task, active_ema,
                  pending_task, pend_ema, pend_alive, margin: float, xp=np):
    """Two-round confirmed switch (``Client._maybe_switch``, vectorized).

    Rows are users; ``cand_task`` is a (U, C) int array padded with -1,
    ``cand_ema`` the matching EMA values (NaN unknown), ``active_task``
    the current task per user (-1 none), ``active_ema`` the active
    node's EMA (NaN if unknown).  ``pending_task`` is the task a first
    better-round nominated (-1 none); the caller supplies the pending
    target's current standing — ``pend_ema`` from its EMA table (NaN no
    sample) and ``pend_alive`` (False when -1 or the task died) —
    because the pending target is judged on its OWN merit, not through
    the candidate list.

    Round 1 nominates the instantaneous EMA-argmin; round 2 confirms
    against the NOMINATED task — "is my pending target still better
    than my active?" — not against a fresh argmin, and not through
    candidate-list membership.  Both stricter rules starve convergence
    with hundreds of near-tied candidates: load-feedback in the
    scoring rotates the candidate set every tick, so the nomination
    never reappears (neither as argmin nor as a member) and no user can
    ever leave a drowned node (the bench_serving_selection thin-node
    case).  A pending target that went stale — dead or no longer
    margin-better — falls back to a fresh nomination.

    Returns ``(confirm, target_task, new_pending)``: users to switch,
    the task to switch to (the confirmed pending target for confirmed
    rows, the fresh argmin otherwise), and the updated pending state.
    Pure in ``xp`` — runs under numpy or jax.numpy unchanged.
    """
    valid = cand_task >= 0
    known = valid & ~xp.isnan(cand_ema)
    eligible = valid.any(axis=1) & known.any(axis=1) & (active_task >= 0)
    masked = xp.where(known, cand_ema, xp.inf)
    best_slot = xp.argmin(masked, axis=1)
    rows = xp.arange(cand_task.shape[0])
    best_ema = masked[rows, best_slot]
    best_task = cand_task[rows, best_slot]
    better = (eligible & (best_task != active_task)
              & ~xp.isnan(active_ema) & (best_ema < margin * active_ema))
    # round 2: the pending nomination confirms on its own merit.  NOT
    # gated on ``eligible`` — under full rotation this tick's fresh
    # candidates are all still unprobed (every EMA NaN), and requiring a
    # known candidate would block confirmation forever
    has_pend = (pending_task >= 0) & pend_alive & ~xp.isnan(pend_ema)
    confirm = (has_pend & (pending_task != active_task)
               & (active_task >= 0) & ~xp.isnan(active_ema)
               & (pend_ema < margin * active_ema))
    target_task = xp.where(confirm, pending_task, best_task)
    new_pending = xp.where(
        confirm, -1, xp.where(better, best_task,
                              xp.where(eligible, -1, pending_task)))
    return confirm, target_task, new_pending


def failover_pick(cand_task, cand_ema, xp=np):
    """Post-break target: best known-EMA candidate, else the first
    remaining candidate, else -1 (``Client.on_connection_break``'s armada
    branch).  Returns the winning slot per row."""
    valid = cand_task >= 0
    known = valid & ~xp.isnan(cand_ema)
    masked = xp.where(known, cand_ema, xp.inf)
    best = xp.argmin(masked, axis=1)
    first = xp.argmax(valid, axis=1)
    slot = xp.where(known.any(axis=1), best, first)
    return xp.where(valid.any(axis=1), slot, -1)


def compact_rows(values: np.ndarray, keep: np.ndarray,
                 width: Optional[int] = None) -> np.ndarray:
    """Per-row left-compaction: kept entries of ``values`` slide left in
    order, rows are right-padded with -1 and truncated to ``width``."""
    u, w = values.shape
    width = w if width is None else width
    rank = keep.cumsum(axis=1) - 1
    out = np.full((u, width), -1, np.int32)
    take = keep & (rank < width)
    rows, cols = np.nonzero(take)
    out[rows, rank[rows, cols]] = values[rows, cols]
    return out


def mode_filter(wide_idx: np.ndarray, modes: np.ndarray, top_n: int,
                task_cloud: np.ndarray, task_dedicated: np.ndarray,
                task_lat: np.ndarray, task_lon: np.ndarray,
                user_lat: np.ndarray, user_lon: np.ndarray) -> np.ndarray:
    """Baseline filters over the WIDE list, then trim to TopN
    (``Client._apply_mode_filter`` + ``[:top_n]``, vectorized).

    ``wide_idx``: (U, W) ranked task indices padded with -1; attribute
    arrays are indexed by task.  Returns (U, top_n) padded with -1,
    preserving rank order.
    """
    u, _ = wide_idx.shape
    valid = wide_idx >= 0
    safe = np.where(valid, wide_idx, 0)
    keep = valid.copy()

    is_ded = modes == MODE_DEDICATED
    if is_ded.any():
        ded_ok = valid & task_dedicated[safe] & ~task_cloud[safe]
        use = is_ded & ded_ok.any(axis=1)          # "ded or cands"
        keep = np.where(use[:, None], ded_ok, keep)
    is_cloud = modes == MODE_CLOUD
    if is_cloud.any():
        keep = np.where(is_cloud[:, None], valid & task_cloud[safe], keep)
    is_geo = modes == MODE_GEO
    if is_geo.any():
        # same argument order as the scalar path: distance(node, user)
        d = geohash.distance_km_batch(task_lat[safe], task_lon[safe],
                                      user_lat[:, None], user_lon[:, None])
        d = np.where(valid, d, np.inf)
        g = np.argmin(d, axis=1)
        rows = np.arange(u)
        geo_keep = np.zeros_like(keep)
        geo_keep[rows, g] = valid[rows, g]
        keep = np.where(is_geo[:, None], geo_keep, keep)

    return compact_rows(wide_idx, keep, top_n)


# ---------------------------------------------------------------------------
# Per-(user, node) EMA table
# ---------------------------------------------------------------------------

class _EmaTable:
    """Fixed-width per-user map node -> EMA, grown on demand.

    Mirrors ``Client.ema`` (a per-user dict): NaN value == key absent
    (``pop`` NaNs the value but keeps the slot, so a node that returns
    later reuses it — semantically identical to dict pop + re-insert).
    Memory is O(U * distinct-nodes-ever-probed-per-user), not O(U * N).
    """

    def __init__(self, n_users: int, k0: int = 8):
        self.nodes = np.full((n_users, k0), -1, np.int32)
        self.vals = np.full((n_users, k0), np.nan)

    def _grow(self):
        u, k = self.nodes.shape
        self.nodes = np.concatenate(
            [self.nodes, np.full((u, k), -1, np.int32)], axis=1)
        self.vals = np.concatenate(
            [self.vals, np.full((u, k), np.nan)], axis=1)

    def ensure(self, rows: np.ndarray, nodes: np.ndarray):
        """Reserve a slot for (row, node).  Rows must be unique."""
        if rows.size == 0:
            return
        eq = self.nodes[rows] == nodes[:, None]
        miss = ~eq.any(axis=1)
        while miss.any():
            sub = self.nodes[rows[miss]]
            free = sub == -1
            if not free.any(axis=1).all():
                self._grow()
                continue
            self.nodes[rows[miss], free.argmax(axis=1)] = nodes[miss]
            break

    def get(self, rows: np.ndarray, nodes: np.ndarray) -> np.ndarray:
        """EMA per (row, node); NaN when absent."""
        if rows.size == 0:
            return np.empty(0)
        eq = self.nodes[rows] == nodes[:, None]
        v = self.vals[rows, eq.argmax(axis=1)]
        return np.where(eq.any(axis=1), v, np.nan)

    def get_matrix(self, rows: np.ndarray, node_mat: np.ndarray) -> np.ndarray:
        out = np.empty(node_mat.shape)
        for c in range(node_mat.shape[1]):
            out[:, c] = self.get(rows, node_mat[:, c])
        return out

    def fold(self, rows: np.ndarray, nodes: np.ndarray, ms: np.ndarray,
             alpha: float):
        """Apply one EMA step per (row, node) pair.  (row, node) pairs must
        be unique within one call; rows may repeat with distinct nodes."""
        if rows.size == 0:
            return
        # allocate any missing slots one unique-row batch at a time
        eq = self.nodes[rows] == nodes[:, None]
        miss = np.nonzero(~eq.any(axis=1))[0]
        while miss.size:
            uniq, first = np.unique(rows[miss], return_index=True)
            self.ensure(uniq, nodes[miss[first]])
            handled = np.zeros(miss.size, bool)
            handled[first] = True
            miss = miss[~handled]
        eq = self.nodes[rows] == nodes[:, None]
        slots = eq.argmax(axis=1)
        prev = self.vals[rows, slots]
        self.vals[rows, slots] = ema_fold(prev, ms, alpha)

    def pop(self, rows: np.ndarray, node: int):
        """``ema.pop(node_id, None)`` for every row."""
        if rows.size == 0:
            return
        eq = self.nodes[rows] == node
        vals = self.vals[rows]
        vals[eq] = np.nan
        self.vals[rows] = vals

    def as_dict(self, row: int, node_ids: List[str]) -> Dict[str, float]:
        out = {}
        for n, v in zip(self.nodes[row], self.vals[row]):
            if n >= 0 and not np.isnan(v):
                out[node_ids[n]] = float(v)
        return out


# synthetic base-RTT model constants — the fused device tick
# (core/fused_tick.py) recomputes this model on device from these same
# values, so edit them here, not there
RTT_LAST_MILE_MS = 6.0
RTT_MS_PER_KM = 0.05
RTT_CLOUD_PENALTY_MS = 55.0


def default_rtt_model(user_lat, user_lon, node_lat, node_lon, node_cloud):
    """Synthetic base RTT for users without explicit Topology entries:
    last-mile floor + propagation by great-circle distance, plus a transit
    penalty into the cloud."""
    d = geohash.distance_km_batch(user_lat, user_lon, node_lat, node_lon)
    return RTT_LAST_MILE_MS + RTT_MS_PER_KM * d \
        + np.where(node_cloud, RTT_CLOUD_PENALTY_MS, 0.0)


# ---------------------------------------------------------------------------
# Incremental refresh
# ---------------------------------------------------------------------------

class _RefreshTracker:
    """Host-side dirty-set bookkeeping for incremental candidate refresh
    (``ClientPool(refresh_period_ms=...)``).

    A user is rescored only when it is *dirty*:

    * **region epoch** — its serving shard's node set changed (churn
      recovery, autoscale spawn, hidden/ownership/locality change):
      diffed from ``SelectionEngine.region_epoch`` / ``epoch_all``;
    * **route change** — Beacon handoff / re-home moved the user to a
      different serving shard (``owner_version`` diff of routed codes);
    * **pool event** — its candidate set or active replica was touched
      by a connection break (``mark``), or it lost every candidate;
    * **staleness** — its per-user refresh deadline fired.  Deadlines
      are staggered over ``STAGGER`` deterministic phase lanes so a
      population never rescores in one burst, and re-armed only when
      the user is *actually* refreshed — a deadline deferred by a
      discovery window (masks compose by AND) fires exactly once.

    One tracker instance drives every tick path (numpy, geo_topk
    kernel, fused device tick, mesh): the mask is computed host-side
    from the same inputs, so the paths stay decision-identical.
    """

    STAGGER = 64

    def __init__(self, pool: "ClientPool", period_ms: float):
        self.pool = pool
        self.period = float(period_ms)
        u = pool.n_users
        self.marks = np.zeros(u, bool)
        lane = (np.arange(u) % self.STAGGER) + 1
        self.next_refresh = pool.sim.now \
            + self.period * lane / float(self.STAGGER)
        self._seen_all: Optional[int] = None
        self._seen_region: Dict[int, int] = {}
        self._routes: Optional[np.ndarray] = None
        self._route_owner_version = -1
        # stats for benchmarks: per-tick dirty counts (post-gating) and
        # device sparse-capacity overflows (fell back to the dense scan)
        self.dirty_counts: List[int] = []
        self.fallbacks = 0

    def mark(self, users) -> None:
        self.marks[users] = True

    def note_refreshed(self, refreshed, now: float) -> None:
        """``refreshed`` users were rescored this tick: clear their event
        marks and re-arm their staleness deadlines."""
        self.marks[refreshed] = False
        self.next_refresh[refreshed] = now + self.period

    def dirty_mask(self, now: float) -> np.ndarray:
        """(U,) bool — users whose candidates may be stale.  Forces the
        engine's lazy view/shard rebuild *before* reading epochs, so the
        host and device paths observe identical marks no matter which
        rebuilt last."""
        pool = self.pool
        eng = pool.am.engine
        pool._view()
        sv = eng.shard_view(pool.service_id,
                            pool.am.tasks.get(pool.service_id, ())) \
            if eng.shard_precision is not None else None
        dirty = self.marks.copy()
        if sv is not None and \
                eng.owner_version != self._route_owner_version:
            routes = sv.route(pool._user_codes())
            if self._routes is not None:
                dirty |= routes != self._routes
            self._routes = routes
            self._route_owner_version = eng.owner_version
        engine_dirty = self._engine_dirty(eng)
        if engine_dirty is True:
            dirty[:] = True
        elif engine_dirty is not False:
            dirty |= engine_dirty
        dirty |= self.next_refresh <= now
        return dirty

    def _engine_dirty(self, eng):
        """Epoch diff vs the last-seen snapshot: False / True (all) / a
        (U,) bool mask of users routed to a bumped region."""
        if self._seen_all is None:
            # first tick: adopt the epochs that produced the initial
            # selection — nothing is stale yet
            self._seen_all = eng.epoch_all
            self._seen_region = dict(eng.region_epoch)
            return False
        if eng.epoch_all != self._seen_all:
            self._seen_all = eng.epoch_all
            self._seen_region = dict(eng.region_epoch)
            return True
        changed = [c for c, e in eng.region_epoch.items()
                   if self._seen_region.get(c, 0) != e]
        if not changed:
            return False
        self._seen_region = dict(eng.region_epoch)
        if self._routes is None:
            return True
        return np.isin(self._routes,
                       np.asarray(changed, self._routes.dtype))


# ---------------------------------------------------------------------------
# ClientPool
# ---------------------------------------------------------------------------

class ClientPool:
    """U users of one service as SoA state driven by pool-level events.

    ``client_ids`` names Topology endpoints (locations/net types/RTTs come
    from the topology, exactly like scalar clients); alternatively pass
    ``locs`` (U, 2) and ``nets`` for synthetic populations at scales where
    materializing per-user NodeSpecs is wasteful (RTTs then come from
    ``rtt_model``).

    All users start together (``pool.start()`` — one simulator event); for
    staggered cohorts, use several pools.
    """

    def __init__(self, sim, topo, am, service_id: str, *,
                 client_ids: Optional[Sequence[str]] = None,
                 locs=None, nets="wifi", mode="armada",
                 frame_interval_ms: float = 0.0,
                 probe_period_ms: float = 2000.0, ema_alpha: float = 0.4,
                 switch_margin: float = 0.95, workload_scale: float = 1.0,
                 transport: str = "events",
                 selection_backend: str = "numpy",
                 tick: str = "host",
                 rtt_model: Callable = default_rtt_model,
                 record_samples: bool = True,
                 latency_hist: bool = False,
                 shard_border_cap: Optional[int] = None,
                 ema_slots: Optional[int] = None,
                 mesh=None,
                 refresh_period_ms: Optional[float] = None,
                 refresh_cap: Optional[int] = None,
                 data_profile=None):
        if transport not in ("events", "fluid"):
            raise ValueError(f"unknown transport {transport!r}")
        if data_profile is not None and transport != "fluid":
            raise ValueError(
                "data_profile=... folds a per-window Cargo access term "
                "into the fluid latency model — the events transport "
                "models per-request I/O through Cargo.read/write instead")
        if refresh_period_ms is not None:
            if transport != "fluid":
                raise ValueError(
                    "refresh_period_ms=... (incremental refresh) needs "
                    "transport='fluid' — the events transport derives its "
                    "probe sends from the refresh plan, so skipping a "
                    "refresh would skip probing too")
            if refresh_period_ms <= 0:
                raise ValueError("refresh_period_ms must be > 0")
        if tick == "device" or mesh is not None or refresh_cap is not None:
            raise NotImplementedError(
                "tick='device' / mesh=... / refresh_cap=... run the fused "
                "device tick, which the PyTorch port does not have yet "
                "(ROADMAP: \"Fused device tick\", then \"Mesh tick across "
                "GPUs\") — use tick='host'")
        if selection_backend not in ("numpy", "geo_topk"):
            raise ValueError(
                f"unknown selection_backend {selection_backend!r}")
        if selection_backend == "geo_topk" and transport == "events":
            raise ValueError("geo_topk backend is fp32 — only the "
                             "statistical fluid transport may use it")
        if tick != "host":
            raise ValueError(f"unknown tick {tick!r}")
        if transport == "fluid" and not \
                0 < frame_interval_ms <= probe_period_ms:
            # scalar semantics for interval 0 are back-to-back saturating
            # frames (an unbounded train the fluid window can't model), and
            # an interval longer than the window floors to zero frames —
            # refuse both rather than silently send probes only
            raise ValueError(
                "fluid transport needs 0 < frame_interval_ms <= "
                "probe_period_ms")
        self.sim = sim
        self.topo = topo
        self.am = am
        self.service_id = service_id
        self.transport = transport
        self.selection_backend = selection_backend
        self.tick_mode = tick
        self.frame_interval = frame_interval_ms
        self.probe_period = probe_period_ms
        self.alpha = ema_alpha
        self.switch_margin = switch_margin
        self.workload_scale = workload_scale
        self.rtt_model = rtt_model
        self.record_samples = record_samples
        # device-tick knobs (shard border rows, EMA node slots): accepted
        # for call-site parity with the JAX package, unused by the host
        # tick, as there
        self.shard_border_cap = shard_border_cap
        self.ema_slots = ema_slots
        # incremental candidate refresh: rescore only dirty users, at
        # most every refresh_period_ms per user (None = every tick, the
        # bit-for-bit historical semantics)
        self.refresh_period = refresh_period_ms
        self._rt: Optional[_RefreshTracker] = None
        # in-situ data plane: per-request Cargo access profile
        # (``repro_torch.core.storage.cargo_manager.DataProfile``).  Every tick
        # path folds the same host-computed per-user ``data_ms`` into the
        # frame latency model — see ``_data_node_ms``
        self.data_profile = data_profile
        self._data_reps = None          # (nearest, reps) of the last tick
        # client-side Beacon discovery (engine.discovery_ms): bootstrap
        # pays one window before the first selection; a handoff charges
        # per-user windows that gate candidate refreshes only
        self._discovered = False
        self._disc_until: Optional[np.ndarray] = None
        self._disc_route: Optional[np.ndarray] = None
        self._disc_codes: Optional[np.ndarray] = None
        self._disc_owner_version = -1

        if client_ids is not None:
            self.client_ids: Optional[List[str]] = list(client_ids)
            self.locs = np.asarray(
                [topo.nodes[c].loc for c in self.client_ids], np.float64)
            self.net_ix = np.asarray(
                [net_index(topo.nodes[c].net_type) for c in self.client_ids],
                np.int64)
        else:
            self.client_ids = None
            self.locs = np.asarray(locs, np.float64).reshape(-1, 2)
            if isinstance(nets, str):
                self.net_ix = np.full(len(self.locs), net_index(nets),
                                      np.int64)
            else:
                self.net_ix = np.asarray(
                    [net_index(n) for n in nets], np.int64)
        self.n_users = len(self.locs)
        u = self.n_users
        if isinstance(mode, str):
            self.modes = np.full(u, MODE_INDEX[mode], np.int8)
        else:
            self.modes = np.asarray([MODE_INDEX[m] for m in mode], np.int8)

        top_n = am.top_n
        self.top_n = top_n
        self.running = np.zeros(u, bool)
        self.ticking = np.zeros(u, bool)        # main probe-tick membership
        self.cand_task = np.full((u, top_n), -1, np.int32)
        self.active = np.full(u, -1, np.int32)
        self.pending = np.full(u, -1, np.int32)
        self.downtime_until = np.zeros(u)
        self.ema_tab = _EmaTable(u)

        # node registry: node_id string <-> small int, + captain handles
        self._node_of: Dict[str, int] = {}
        self._node_ids: List[str] = []
        self._node_caps: List[object] = []
        # warm-connection mirror: node idx -> ordered {user: None}; replay
        # order for break notifications == scalar insertion order
        self._conn: Dict[int, Dict[int, None]] = {}
        self._watched: set = set()              # fluid: captains we joined
        self._rtt_cache: Dict[Tuple[int, int], float] = {}

        # per-task derived arrays, rebuilt when the replica set fingerprint
        # changes (tracked by SelectionEngine's service_view cache)
        self._last_view = None
        self.task_node = np.empty(0, np.int32)

        # metrics
        self.switch_t: List[float] = []
        self.switch_user: List[int] = []
        self.switch_from: List[str] = []
        self.switch_to: List[str] = []
        self.sample_u: List[int] = []
        self.sample_t: List[float] = []
        self.sample_ms: List[float] = []
        self.sample_node: List[int] = []
        self.sample_probe: List[bool] = []
        # fluid aggregates
        self.frame_count = np.zeros(u, np.int64)
        self.frame_sum = np.zeros(u)
        self.requests_sent = 0
        self.ticks_run = 0
        self.failovers = 0
        self._fluid_buf: List[Tuple] = []       # (users, nodes, ms, rounds)
        # frame-latency histogram (latency_hist=True): log-spaced bins
        # 1 ms .. ~100 s, ~5% wide — tail quantiles / SLO-violation
        # fractions at population scale without per-sample records.  The
        # top decade exists for saturation studies: a drowned node's
        # fluid backlog reaches tens of seconds, and p99 must resolve
        # there rather than clip at the final edge.
        # Fed by the fluid transport's flush and the device tick's
        # per-window latency stash (bench_serving_selection).
        self._lat_edges: Optional[np.ndarray] = None
        self._lat_hist: Optional[np.ndarray] = None
        if latency_hist:
            self._lat_edges = np.concatenate(
                [[0.0], np.logspace(0.0, 5.0, 230), [np.inf]])
            self._lat_hist = np.zeros(self._lat_edges.size - 1, np.int64)
        # per-phase wall time (ms) accumulated across ticks, so benchmark
        # runs can attribute where a tick goes (selection / policy /
        # transport on the host tick; fused_tick / transport on device)
        self.phase_ms: Dict[str, float] = {}

    # ------------------------------------------------------------- control

    def phase_add(self, name: str, t0: float) -> None:
        """Accumulate wall time since ``t0`` under phase ``name``."""
        self.phase_ms[name] = self.phase_ms.get(name, 0.0) \
            + (time.perf_counter() - t0) * 1e3

    def start(self):
        """Start every user (one simulator event; schedule with
        ``sim.at(t, pool.start)`` like a scalar client's ``start``)."""
        dms = float(getattr(self.am.engine, "discovery_ms", 0.0))
        if dms > 0 and not self._discovered:
            # bootstrap Beacon discovery: one window before the first
            # selection can be requested (previously free)
            self._discovered = True
            self.sim.after(dms, self.start)
            return
        self.running[:] = True
        self.am.user_join(self.service_id, self)
        if self.refresh_period is not None:
            self._rt = _RefreshTracker(self, self.refresh_period)
        sel = np.arange(self.n_users)
        if self.transport == "events":
            plan = self._refresh(sel, initial=True)
            self._dispatch(plan)
            if self.ticking.any():
                self.sim.after(self.probe_period, self._probe_tick)
        else:
            self._start_fluid(sel)

    def stop(self, users: Optional[Sequence[int]] = None):
        if self.transport == "fluid":
            self._flush_fluid()             # don't drop the open window
        if users is None:
            self.running[:] = False
        else:
            stopped = np.asarray(users)
            self.running[stopped] = False
            # release the cohort's warm connections (scalar Client.stop
            # discards its connections immediately)
            gone = set(int(u) for u in stopped)
            for nix in list(self._conn):
                d = self._conn[nix]
                for u in gone:
                    d.pop(u, None)
                if not d:
                    del self._conn[nix]
                    cap = self._node_caps[nix]
                    if cap is not None:
                        cap.connections.discard(self)
        if not self.running.any():
            self.am.user_leave(self.service_id, self)
            for nix, d in self._conn.items():
                d.clear()
                self._node_caps[nix].connections.discard(self)
            for nix in self._watched:          # fluid-transport watches
                cap = self._node_caps[nix]
                if cap is not None:
                    cap.connections.discard(self)
            self._watched.clear()

    # ------------------------------------------------------ registry/views

    def _view(self):
        tasks = self.am.tasks.get(self.service_id, ())
        view = self.am.engine.service_view(self.service_id, tasks)
        if view is not self._last_view:
            self._last_view = view
            tn = np.full(len(view.tasks), -1, np.int32)
            for i, nid in enumerate(view.node_ids):
                if nid is not None:
                    tn[i] = self._node_ix(nid, view.tasks[i].captain)
            self.task_node = tn
        return view

    def _node_ix(self, node_id: str, captain) -> int:
        ix = self._node_of.get(node_id)
        if ix is None:
            ix = len(self._node_ids)
            self._node_of[node_id] = ix
            self._node_ids.append(node_id)
            self._node_caps.append(captain)
        elif captain is not None:
            self._node_caps[ix] = captain
        return ix

    def _base_rtts(self, users: np.ndarray, tasks: np.ndarray) -> np.ndarray:
        """Unjittered RTT per (user, task) pair."""
        nodes = self.task_node[tasks]
        if self.client_ids is not None:
            out = np.empty(len(users))
            for i, (u, n) in enumerate(zip(users, nodes)):
                key = (int(u), int(n))
                v = self._rtt_cache.get(key)
                if v is None:
                    v = self.topo.rtt(self.client_ids[u], self._node_ids[n])
                    self._rtt_cache[key] = v
                out[i] = v
            return out
        view = self._last_view
        safe = np.where(tasks >= 0, tasks, 0)
        return self.rtt_model(self.locs[users, 0], self.locs[users, 1],
                              view.lat[safe], view.lon[safe],
                              view.cloud[safe])

    # --------------------------------------------- candidate refresh (both)

    def _refresh(self, sel: np.ndarray, *, initial: bool = False,
                 activate_first: bool = False) -> List[Tuple]:
        """Candidate refresh for users ``sel``: ONE batched selection call,
        vectorized mode filter, warm-connection bookkeeping, EMA slot
        reservation.  Returns the send plan — ``(user, probe_tasks,
        frame_task)`` tuples in user order — which ``_dispatch`` turns
        into requests with scalar-identical RNG draw order.
        """
        sel = np.asarray(sel)
        sel = sel[self.running[sel]]                # scalar: if not running
        if sel.size == 0:
            return []
        nets = self.net_ix[sel]
        # baseline filters need the WIDE list; the armada-family modes are
        # a pure trim, so top_n suffices (identical result, k/WIDE the work)
        filtering = np.isin(self.modes[sel],
                            (MODE_GEO, MODE_DEDICATED, MODE_CLOUD))
        wide_k = WIDE_TOP_N if filtering.any() else self.top_n
        if self.selection_backend == "geo_topk":
            wide = self.am.engine.candidate_indices_kernel(
                self.service_id, self.am.tasks.get(self.service_id, ()),
                self.locs[sel], nets, top_n=wide_k)
        else:
            wide = self.am.candidate_indices(
                self.service_id, self.locs[sel], nets, top_n=wide_k)
        view = self._view()
        new = mode_filter(wide, self.modes[sel], self.top_n, view.cloud,
                          view.dedicated, view.lat, view.lon,
                          self.locs[sel, 0], self.locs[sel, 1])

        old = self.cand_task[sel]
        if self.transport == "events":
            self._update_connections(sel, old, new)
        else:
            self._watch_nodes(new)
        self.cand_task[sel] = new

        # reserve EMA slots for every (user, candidate-node) pair so later
        # vectorized folds never race on allocation
        for c in range(new.shape[1]):
            has = new[:, c] >= 0
            if has.any():
                self.ema_tab.ensure(sel[has],
                                    self.task_node[new[has, c]])

        empty = ~(new >= 0).any(axis=1)
        if empty.any():
            # scalar: sim.after(500, _refresh_candidates) — non-initial, so
            # an initially-empty user never activates (quirk kept for
            # parity); one pool event carries the whole subset in order
            self.sim.after(500.0, self._retry, sel[empty].tolist())
        found = sel[~empty]
        if found.size == 0:
            return []

        if initial:
            # provisional best by base RTT until probes return
            cand = self.cand_task[found]
            valid = cand >= 0
            safe = np.where(valid, cand, 0)
            flat_rtt = self._base_rtts(
                np.repeat(found, cand.shape[1]), safe.ravel()
            ).reshape(cand.shape)
            flat_rtt = np.where(valid, flat_rtt, np.inf)
            best = np.argmin(flat_rtt, axis=1)
            self.active[found] = cand[np.arange(len(found)), best]
            self.ticking[found] = True
        if activate_first:
            cand = self.cand_task[found]
            self.active[found] = cand[:, 0]
        if self.transport != "events":
            return []                       # fluid: traffic is per-tick
        plan: List[Tuple] = []
        for u in found:
            probes = [int(t) for t in self.cand_task[u] if t >= 0]
            frame = int(self.active[u]) if (initial or activate_first) else -1
            plan.append((int(u), probes, frame))
        return plan

    def _update_connections(self, sel, old, new):
        """Mirror scalar warm-connection bookkeeping per user, preserving
        the insertion order scalar clients would produce."""
        for i, u in enumerate(sel):
            u = int(u)
            new_set = {int(t) for t in new[i] if t >= 0}
            for t in old[i]:
                if t >= 0 and t not in new_set:
                    self._conn_discard(u, int(t))
            for t in new[i]:
                if t >= 0:
                    self._conn_add(u, int(t))

    def _conn_add(self, u: int, task: int):
        nix = int(self.task_node[task])
        if nix < 0 or self._node_caps[nix] is None:
            return
        d = self._conn.setdefault(nix, {})
        if not d:
            self._node_caps[nix].connections.add(self)
        d[u] = None

    def _conn_discard(self, u: int, task: int):
        nix = int(self.task_node[task])
        d = self._conn.get(nix)
        if d is not None:
            d.pop(u, None)

    def _watch_nodes(self, new):
        """Fluid transport: join the break-notification list of every
        captain hosting a candidate (affected users are computed from the
        candidate matrix at break time — no per-user bookkeeping)."""
        self.watch_node_indices(np.unique(self.task_node[new[new >= 0]]))

    def watch_node_indices(self, nixes):
        """Watch captains by node index (fused-tick driver entry point)."""
        for nix in nixes:
            nix = int(nix)
            if nix >= 0 and nix not in self._watched:
                cap = self._node_caps[nix]
                if cap is not None:
                    cap.connections.add(self)
                    self._watched.add(nix)

    def _retry(self, users: List[int]):
        plan = self._refresh(np.asarray(users, np.int64))
        self._dispatch(plan)

    # ------------------------------------------------- events-mode driving

    def _dispatch(self, plan: List[Tuple]):
        """Turn a send plan into per-request events.  The jitter draws for
        all requests happen in ONE ``jitter_batch`` whose element order is
        exactly the scalar clients' sequential draw order."""
        if not plan or self.transport != "events":
            return
        view = self._last_view
        metas: List[Tuple[int, int, bool]] = []
        for u, probes, frame in plan:
            for t in probes:
                cap = view.tasks[t].captain
                if cap is None or not cap.alive:   # scalar: skip, no draw
                    continue
                metas.append((u, t, True))
            if frame >= 0:
                cap = view.tasks[frame].captain
                if cap is not None and cap.alive:
                    metas.append((u, frame, False))
        if not metas:
            return
        us = np.array([m[0] for m in metas])
        ts = np.array([m[1] for m in metas])
        rtts = self.sim.jitter_batch(self._base_rtts(us, ts), 0.08)
        now = self.sim.now
        for (u, t, is_probe), rtt in zip(metas, rtts):
            task = view.tasks[t]
            rtt = float(rtt)
            req = Request(client=self, task_id=task.task_id, sent_at=now,
                          rtt=rtt, node_id=task.captain.node_id,
                          proc_scale=self.workload_scale,
                          is_probe=is_probe, on_done=self._on_response_ev,
                          user_ix=u)
            self.sim.at(now + rtt / 2, task.captain.arrive, req)
            self.requests_sent += 1

    def _probe_tick(self):
        sel = np.nonzero(self.running & self.ticking)[0]
        if sel.size == 0:
            return                               # all chains dead
        self._dispatch(self._refresh(sel))
        self._switch_step(sel)
        self.ticks_run += 1
        self.sim.after(self.probe_period, self._probe_tick)

    def _aux_tick(self, users: List[int]):
        """Extra per-cohort probe chain (scalar grows one whenever a user
        re-enters initial selection after total candidate loss)."""
        alive = [u for u in users if self.running[u]]
        if not alive:
            return
        sel = np.asarray(alive, np.int64)
        self._dispatch(self._refresh(sel))
        self._switch_step(sel)
        self.sim.after(self.probe_period, self._aux_tick, alive)

    def _switch_step(self, sel: np.ndarray):
        """One vectorized two-round switch update for ``sel``."""
        sel = sel[self.running[sel]]
        if sel.size == 0:
            return
        cand = self.cand_task[sel]
        safe = np.where(cand >= 0, cand, 0)
        cand_node = np.where(cand >= 0, self.task_node[safe], -1)
        cand_ema = self.ema_tab.get_matrix(sel, cand_node)
        act = self.active[sel]
        act_node = np.where(act >= 0, self.task_node[
            np.where(act >= 0, act, 0)], -1)
        act_ema = np.where(act >= 0, self.ema_tab.get(sel, act_node), np.nan)
        pend = self.pending[sel]
        pend_safe = np.where(pend >= 0, pend, 0)
        pend_node = np.where(pend >= 0, self.task_node[pend_safe], -1)
        pend_ema = np.where(pend >= 0, self.ema_tab.get(sel, pend_node),
                            np.nan)
        pend_alive = (pend >= 0) & self._view().alive_mask()[pend_safe]
        confirm, target, new_pending = switch_decide(
            cand, cand_ema, act, act_ema, pend, pend_ema, pend_alive,
            self.switch_margin)
        self.pending[sel] = new_pending
        if confirm.any():
            rows = np.nonzero(confirm)[0]
            users = sel[rows]
            to_task = target[rows]
            now = self.sim.now
            for u, frm, to in zip(users, act_node[rows],
                                  self.task_node[to_task]):
                self.switch_t.append(now)
                self.switch_user.append(int(u))
                self.switch_from.append(self._node_ids[frm])
                self.switch_to.append(self._node_ids[to])
            self.active[users] = to_task

    def _on_response_ev(self, req: Request):
        u = req.user_ix
        if not self.running[u]:
            return
        ms = self.sim.now - req.sent_at
        nix = self._node_of[req.node_id]
        row = np.array([u])
        self.ema_tab.fold(row, np.array([nix]), np.array([ms]), self.alpha)
        if self.record_samples:
            self.sample_u.append(u)
            self.sample_t.append(self.sim.now)
            self.sample_ms.append(ms)
            self.sample_node.append(nix)
            self.sample_probe.append(req.is_probe)
        if req.is_probe:
            return
        self.frame_count[u] += 1
        self.frame_sum[u] += ms
        if self.frame_interval > 0:
            self.sim.after(self.frame_interval, self._send_frame_ev, u)
        else:
            self._send_frame_ev(u)

    def _send_frame_ev(self, u: int):
        if not self.running[u] or self.active[u] < 0:
            return
        t = int(self.active[u])
        # _last_view is safe here without a fingerprint re-check: task
        # lists only append, so position t keeps naming the same Task the
        # active index was assigned from (scalar clients likewise hold the
        # Task object itself) — keeps the per-frame path O(1)
        view = self._last_view
        cap = view.tasks[t].captain
        if cap is None or not cap.alive:
            return
        rtt = self.sim.jitter(
            float(self._base_rtts(np.array([u]), np.array([t]))[0]), 0.08)
        req = Request(client=self, task_id=view.tasks[t].task_id,
                      sent_at=self.sim.now, rtt=rtt, node_id=cap.node_id,
                      proc_scale=self.workload_scale, is_probe=False,
                      on_done=self._on_response_ev, user_ix=u)
        self.sim.at(self.sim.now + rtt / 2, cap.arrive, req)
        self.requests_sent += 1

    # ---------------------------------------------------------- failover

    def on_connection_break(self, node_id: str):
        """A node with warm connections failed.  One notification covers
        the whole pool; users are replayed in warm-connection insertion
        order — the order U scalar clients would have been notified in."""
        nix = self._node_of.get(node_id)
        if nix is None:
            return
        if self._rt is not None:
            # dirty-mark every user whose candidate set or active replica
            # touched the dead node.  Computed on the host mirrors on
            # every path (the device mirrors are post-last-tick state), so
            # the mark set is identical host == device — a superset of the
            # fused program's own death hit, never a miss
            safe_c = np.where(self.cand_task >= 0, self.cand_task, 0)
            c_hit = (self.cand_task >= 0) & (self.task_node[safe_c] == nix)
            safe_a = np.where(self.active >= 0, self.active, 0)
            a_hit = (self.active >= 0) & (self.task_node[safe_a] == nix)
            self._rt.mark(self.running & (c_hit.any(axis=1) | a_hit))
        if self.transport == "events":
            order = [u for u in self._conn.pop(nix, {}) if self.running[u]]
        else:
            self._watched.discard(nix)
            cand_hit = (self.cand_task >= 0) & (
                self.task_node[np.where(self.cand_task >= 0,
                                        self.cand_task, 0)] == nix)
            act = self.active
            act_hit = (act >= 0) & (self.task_node[
                np.where(act >= 0, act, 0)] == nix)
            order = np.nonzero(self.running & (cand_hit.any(axis=1)
                                               | act_hit))[0].tolist()
        if not order:
            return
        rows = np.asarray(order, np.int64)
        self.ema_tab.pop(rows, nix)

        view = self._view()
        t_alive = view.alive_mask()
        cand = self.cand_task[rows]
        keep = (cand >= 0) & t_alive[np.where(cand >= 0, cand, 0)]
        # compact surviving candidates, preserving rank order
        self.cand_task[rows] = compact_rows(cand, keep)

        act = self.active[rows]
        act_dead = (act < 0) | ~t_alive[np.where(act >= 0, act, 0)]
        if not act_dead.any():
            return
        m = self.modes[rows]
        is_rec = act_dead & (m == MODE_RECONNECT)
        is_e2c = act_dead & (m == MODE_EDGE2CLOUD)
        cloud_task = self._first_cloud_task(view) if is_e2c.any() else -1
        if cloud_task < 0:
            is_e2c[:] = False                     # fall through to armada
        is_arm = act_dead & ~is_rec & ~is_e2c

        now = self.sim.now
        # reconnect baseline: drop, wait, re-query (Fig 10a)
        if is_rec.any():
            rec = rows[is_rec]
            self.active[rec] = -1
            self.downtime_until[rec] = now + RECONNECT_DELAY_MS
            self.sim.after(RECONNECT_DELAY_MS, self._reconnect_batch,
                           rec.tolist())
        # edge-to-cloud baseline: jump onto the cloud replica (Fig 10b)
        if is_e2c.any():
            e2c = rows[is_e2c]
            self.active[e2c] = cloud_task
            self.ema_tab.ensure(e2c, np.full(e2c.size, int(
                self.task_node[cloud_task])))
            self.failovers += int(is_e2c.sum())
        # armada: instant switch to the best remaining warm candidate
        arm_rows = rows[is_arm]
        arm_frame = np.full(arm_rows.size, -1, np.int64)
        arm_empty: List[int] = []
        if arm_rows.size:
            cand = self.cand_task[arm_rows]
            safe = np.where(cand >= 0, cand, 0)
            cand_node = np.where(cand >= 0, self.task_node[safe], -1)
            slot = failover_pick(cand, self.ema_tab.get_matrix(arm_rows,
                                                               cand_node))
            has = slot >= 0
            picked = cand[np.arange(arm_rows.size), np.where(has, slot, 0)]
            self.active[arm_rows[has]] = picked[has]
            arm_frame[has] = picked[has]
            arm_empty = arm_rows[~has].tolist()
            self.failovers += int(has.sum())

        if self.transport == "fluid":
            # fluid data plane resumes at the next tick; re-run initial
            # selection then for users who lost every candidate
            if arm_empty:
                self.sim.after(0.0, self._retry_fluid, arm_empty)
            return

        # events: replay frame sends / re-initialization in user order
        empties = set(arm_empty)
        empty_plan: Dict[int, Tuple] = {}
        if empties:
            esel = np.asarray(sorted(empties, key=order.index), np.int64)
            # _refresh(initial) marks users as main-chain members; restore —
            # scalar users keep whatever chains they had and gain one NEW
            # chain (the aux cohort below), phase-locked to this break
            was_ticking = self.ticking[esel].copy()
            sub = self._refresh(esel, initial=True)
            self.ticking[esel] = was_ticking
            empty_plan = {p[0]: p for p in sub}
            revived = [p[0] for p in sub]
            if revived:
                self.sim.after(self.probe_period, self._aux_tick, revived)
        arm_set = {int(u): f for u, f in zip(arm_rows, arm_frame)}
        e2c_set = set(rows[is_e2c].tolist())
        plan: List[Tuple] = []
        for u in order:
            if u in e2c_set:
                self._conn_add(u, cloud_task)
                plan.append((u, [], cloud_task))
            elif u in empties:
                if u in empty_plan:
                    plan.append(empty_plan[u])
            elif u in arm_set and arm_set[u] >= 0:
                plan.append((u, [], int(arm_set[u])))
        self._dispatch(plan)

    def _first_cloud_task(self, view) -> int:
        for i, t in enumerate(view.tasks):
            if (t.status == "running" and t.captain is not None
                    and view.cloud[i]):
                return i
        return -1

    def _reconnect_batch(self, users: List[int]):
        sel = np.asarray(users, np.int64)
        if self.transport == "events":
            self._dispatch(self._refresh(sel, activate_first=True))
        else:
            sel = sel[self.running[sel]]
            if sel.size:
                self._refresh(sel, activate_first=True)

    # -------------------------------------------------- fluid-mode driving

    def _start_fluid(self, sel: np.ndarray):
        self._refresh(sel, initial=True)
        self._tick_fluid(first=True)

    def _tick_fluid(self, first: bool = False):
        now = self.sim.now
        t0 = time.perf_counter()
        self._flush_fluid()
        self.phase_add("policy", t0)
        sel = np.nonzero(self.running & self.ticking)[0]
        if sel.size:
            if not first:
                if self._rt is not None:
                    t0 = time.perf_counter()
                    dirty = self._rt.dirty_mask(now)
                    self.phase_add("refresh_track", t0)
                else:
                    dirty = None
                t0 = time.perf_counter()
                r_ok = self._discovery_refresh_mask()
                r_sel = sel if r_ok is None else sel[r_ok[sel]]
                if dirty is not None:
                    # incremental: refresh only the dirty subset (the
                    # discovery gate above composes by AND — a deferred
                    # user stays marked and refreshes when it opens)
                    r_sel = r_sel[dirty[r_sel]]
                    self._rt.dirty_counts.append(int(r_sel.size))
                if r_sel.size:
                    self._refresh(r_sel)
                    if dirty is not None:
                        self._rt.note_refreshed(r_sel, now)
                self.phase_add("selection", t0)
            t0 = time.perf_counter()
            self._switch_step(sel)
            self.phase_add("policy", t0)
            t0 = time.perf_counter()
            self._traffic_fluid(sel, now)
            self.phase_add("transport", t0)
            self.ticks_run += 1
        if (self.running & self.ticking).any():
            self.sim.after(self.probe_period, self._tick_fluid)

    def _traffic_fluid(self, sel: np.ndarray, now: float):
        """One window of probe + frame traffic, aggregated per node through
        ``Captain.arrive_batch``'s fluid queue model."""
        view = self._last_view
        window = self.probe_period
        t_alive = view.alive_mask()

        cand = self.cand_task[sel]
        ok = (cand >= 0) & t_alive[np.where(cand >= 0, cand, 0)]
        p_rows, p_cols = np.nonzero(ok)
        p_users = sel[p_rows]
        p_tasks = cand[p_rows, p_cols]
        p_tau = np.zeros(p_users.size)

        act = self.active[sel]
        f_ok = (act >= 0) & t_alive[np.where(act >= 0, act, 0)] \
            & (self.frame_interval > 0)
        n_f = int(window // self.frame_interval) \
            if self.frame_interval > 0 else 0
        f_sel = sel[f_ok]
        f_act = act[f_ok]
        f_users = np.repeat(f_sel, n_f)
        f_tasks = np.repeat(f_act, n_f)
        f_tau = np.tile((np.arange(n_f) + 0.5) * self.frame_interval,
                        f_sel.size)

        users = np.concatenate([p_users, f_users])
        tasks = np.concatenate([p_tasks, f_tasks]).astype(np.int64)
        taus = np.concatenate([p_tau, f_tau])
        if users.size == 0:
            return
        nodes = self.task_node[tasks]

        # per-node fluid admission (one arrive_batch per node with traffic)
        counts = np.bincount(nodes, minlength=len(self._node_ids))
        work0 = np.zeros(len(self._node_ids))
        net_rate = np.zeros(len(self._node_ids))
        slots = np.ones(len(self._node_ids))
        proc = np.zeros(len(self._node_ids))
        for nix in np.nonzero(counts)[0]:
            cap = self._node_caps[nix]
            w0, in_rate, cap_rate = cap.arrive_batch(
                int(counts[nix]), self.workload_scale, window, now)
            work0[nix] = w0
            net_rate[nix] = in_rate - cap_rate
            slots[nix] = max(cap.spec.slots, 1)
            proc[nix] = cap.request_ms()    # serving-profile unit time

        wait = np.maximum(0.0, work0[nodes] + net_rate[nodes] * taus) \
            / slots[nodes]
        rtt = self.sim.jitter_batch(self._base_rtts(users, tasks), 0.08)
        proc_ms = self.sim.jitter_batch(
            proc[nodes] * self.workload_scale, 0.06)
        back = self.sim.jitter_batch(rtt / 2, 0.08)
        lat = rtt / 2 + wait + np.maximum(proc_ms, 0.1) + back
        data = self._data_node_ms()
        if data is not None:
            # in-situ data access rides the frame (request) path only —
            # probes stay pure network/queue measurements
            f_nodes = nodes[p_users.size:]
            lat[p_users.size:] += data[f_nodes]
            self._charge_reads(f_nodes, window)
        self.requests_sent += users.size

        is_probe = np.zeros(users.size, bool)
        is_probe[:p_users.size] = True
        rounds = f_tau_index(p_users.size, f_sel.size, n_f)
        self._fluid_buf.append((users, nodes, lat, is_probe, rounds))

    def _flush_fluid(self):
        """Fold the previous window's responses into the EMA table in
        vectorized arrival-order rounds: probes first, then frame k for
        every user (k = 1..n_f) — each round touches unique (user, node)
        pairs, so one ``fold`` per round reproduces sequential EMA
        semantics exactly."""
        if not self._fluid_buf:
            return
        for users, nodes, lat, is_probe, rounds in self._fluid_buf:
            pr = is_probe
            # two replicas co-located on one captain give a user two probes
            # to the SAME node — split those into occurrence-rank rounds so
            # fold() never sees a duplicate (user, node) pair
            p_rank = _dup_rank(users[pr].astype(np.int64)
                               * len(self._node_ids) + nodes[pr])
            for k in range(int(p_rank.max()) + 1 if p_rank.size else 0):
                m = p_rank == k
                self.ema_tab.fold(users[pr][m], nodes[pr][m], lat[pr][m],
                                  self.alpha)
            fr = ~pr
            if fr.any():
                f_users, f_nodes, f_lat = users[fr], nodes[fr], lat[fr]
                f_round = rounds[fr]
                for k in range(int(f_round.max()) + 1):
                    m = f_round == k
                    self.ema_tab.fold(f_users[m], f_nodes[m], f_lat[m],
                                      self.alpha)
                np.add.at(self.frame_count, f_users, 1)
                np.add.at(self.frame_sum, f_users, f_lat)
                if self._lat_hist is not None:
                    self._lat_hist += np.histogram(
                        f_lat, bins=self._lat_edges)[0]
        self._fluid_buf.clear()

    def _retry_fluid(self, users: List[int]):
        sel = np.asarray(users, np.int64)
        self._refresh(sel, initial=True)

    # --------------------------------------------- in-situ data plane (fluid)

    def _data_node_ms(self) -> Optional[np.ndarray]:
        """(n_nodes,) per-NODE Cargo access latency for this window, or
        None when the pool has no ``data_profile`` (or the service no
        alive placement).  Computed host-side once per tick from each
        node's nearest alive replica + measured read EMA
        (``CargoManager.data_ms_for_nodes``) and gathered per user by
        active node — the same single-injection idiom as the queueing
        fold, so host, geo_topk, device, and mesh ticks consume
        identical values by construction."""
        if self.data_profile is None:
            return None
        cm = getattr(self.am, "cargo_manager", None)
        if cm is None or not self._node_ids:
            return None
        n = len(self._node_ids)
        lats = np.zeros(n)
        lons = np.zeros(n)
        has_loc = np.zeros(n, bool)
        for i, cap in enumerate(self._node_caps):
            if cap is not None:
                lats[i], lons[i] = cap.spec.loc
                has_loc[i] = True
        out = cm.data_ms_for_nodes(self.service_id, self.data_profile,
                                   lats, lons)
        if out is None:
            self._data_reps = None
            return None
        ms, nearest, reps = out
        self._data_reps = (nearest, reps)
        # nodes without a captain handle never serve frames; zero them so
        # a stray gather can't inject a garbage latency
        return np.where(has_loc, ms, 0.0)

    def _charge_reads(self, f_nodes: np.ndarray, window: float):
        """Report this window's aggregated frame reads to the Cargo
        Manager: each frame charges ``reads_per_request`` reads to the
        nearest replica of its serving node (the read-throughput signal
        behind hot-store auto-scaling)."""
        reads = float(self.data_profile.reads_per_request)
        if self._data_reps is None or reads <= 0 or f_nodes.size == 0:
            return
        nearest, reps = self._data_reps
        counts = np.bincount(nearest[f_nodes], minlength=len(reps)) * reads
        self.am.cargo_manager.note_read_load(self.service_id, reps,
                                             counts, window)

    def _user_codes(self) -> np.ndarray:
        """Full-precision Morton codes of the user locations (cached) —
        shared by the discovery gate and the refresh tracker's routing."""
        if self._disc_codes is None:
            from repro_torch.core.selection import CODE_PRECISION
            self._disc_codes = geohash.encode_batch(
                self.locs[:, 0], self.locs[:, 1], CODE_PRECISION)
        return self._disc_codes

    def _discovery_refresh_mask(self) -> Optional[np.ndarray]:
        """(U,) bool gate for the candidate refresh, or None when Beacon
        discovery is free (``engine.discovery_ms == 0``).  A user whose
        serving region changed (Beacon handoff / re-home, detected via
        ``owner_version``) must re-discover its Beacon first: candidate
        refreshes are suppressed until ``now + discovery_ms`` while
        probes and frames keep flowing to the stale candidates — the
        same gate feeds both the host tick and the fused device tick."""
        eng = self.am.engine
        dms = float(getattr(eng, "discovery_ms", 0.0))
        if dms <= 0:
            return None
        if eng.owner_version != self._disc_owner_version:
            view = eng.shard_view(self.service_id,
                                  self.am.tasks.get(self.service_id, ()))
            if view is not None:
                route = view.route(self._user_codes())
                if self._disc_route is not None:
                    changed = route != self._disc_route
                    if changed.any():
                        if self._disc_until is None:
                            self._disc_until = np.zeros(self.n_users)
                        self._disc_until[changed] = self.sim.now + dms
                self._disc_route = route
            self._disc_owner_version = eng.owner_version
        if self._disc_until is None or \
                not (self._disc_until > self.sim.now).any():
            return None
        return self._disc_until <= self.sim.now

    # ------------------------------------------------------------- metrics

    def reset_stats(self):
        """Zero the aggregate frame stats (and the latency histogram when
        enabled) — call at a measurement-window start on aggregate-only
        (fluid / record_samples=False) pools.  bench_serving_selection
        resets at flash-crowd end so tail quantiles describe the
        recovery phase selection actually controls, not the flash whose
        pile-up predates any load signal."""
        self._flush_fluid()                 # open window belongs to the past
        self.frame_count[:] = 0
        self.frame_sum[:] = 0.0
        if self._lat_hist is not None:
            self._lat_hist[:] = 0

    def active_locs(self) -> np.ndarray:
        """(k, 2) locations of running users (ApplicationManager's
        autoscale user-grouping protocol)."""
        return self.locs[self.running]

    def data_local_fraction(self, users=None) -> float:
        """Fraction of the given users (default: all) whose ACTIVE
        replica sits within ``DATA_LOCAL_RADIUS_KM`` of one of the
        service's Cargo replicas — the in-situ-data-access success rate
        (paper §3.4).  nan when the service has no data-locality entry
        in the engine or none of the users is active."""
        entry = self.am.engine.data_locality.get(self.service_id)
        if entry is None:
            return float("nan")
        locs, _ = entry
        view = self._view()
        bits = view.locality_bits(locs)
        act = self.active if users is None \
            else self.active[np.asarray(users, np.int64)]
        ok = act >= 0
        if not ok.any():
            return float("nan")
        return float(bits[act[ok]].mean())

    @property
    def dirty_counts(self) -> Optional[List[int]]:
        """Per-tick refreshed-user counts under incremental refresh
        (``None`` when ``refresh_period_ms`` is unset)."""
        return self._rt.dirty_counts if self._rt is not None else None

    def active_node(self, u: int) -> Optional[str]:
        t = int(self.active[u])
        if t < 0:
            return None
        return self._last_view.node_ids[t] if self._last_view else None

    def ema_of(self, u: int) -> Dict[str, float]:
        if self.transport == "fluid":
            self._flush_fluid()         # match device-tick flush semantics
        return self.ema_tab.as_dict(u, self._node_ids)

    def samples_of(self, u: int) -> List[LatencySample]:
        return [LatencySample(t, ms, self._node_ids[n], p)
                for uu, t, ms, n, p in zip(
                    self.sample_u, self.sample_t, self.sample_ms,
                    self.sample_node, self.sample_probe) if uu == u]

    def switches_of(self, u: int) -> List[dict]:
        return [{"t": t, "from": f, "to": to}
                for t, uu, f, to in zip(self.switch_t, self.switch_user,
                                        self.switch_from, self.switch_to)
                if uu == u]

    def mean_latency(self, u: Optional[int] = None,
                     since: float = 0.0) -> float:
        if self.transport == "fluid" or not self.record_samples:
            self._flush_fluid()             # include the open window
            if since > 0.0:
                raise ValueError(
                    "mean_latency(since=...) needs per-sample records — "
                    "aggregate-only pools track whole-run means (call "
                    "reset_stats() at the window start instead)")
            if u is None:
                tot = self.frame_count.sum()
                return float(self.frame_sum.sum() / tot) if tot else \
                    float("nan")
            c = self.frame_count[u]
            return float(self.frame_sum[u] / c) if c else float("nan")
        us = np.asarray(self.sample_u)
        if us.size == 0:
            return float("nan")
        ts = np.asarray(self.sample_t)
        ms = np.asarray(self.sample_ms)
        pr = np.asarray(self.sample_probe)
        m = ~pr & (ts >= since)
        if u is not None:
            m &= us == u
        return float(ms[m].mean()) if m.any() else float("nan")

    def _hist_sync(self) -> np.ndarray:
        if self._lat_hist is None:
            raise ValueError("pool was built without latency_hist=True")
        self._flush_fluid()
        return self._lat_hist

    def latency_quantile(self, q: float) -> float:
        """Approximate frame-latency quantile (e.g. ``q=0.99`` for p99)
        from the log-spaced histogram — the upper edge of the bin the
        quantile falls in (≤5% bin width).  Needs ``latency_hist=True``."""
        hist = self._hist_sync()
        cum = np.cumsum(hist)
        if cum[-1] == 0:
            return float("nan")
        i = int(np.searchsorted(cum, q * cum[-1]))
        return float(self._lat_edges[min(i + 1, self._lat_edges.size - 2)])

    def slo_violation_fraction(self, slo_ms: float) -> float:
        """Fraction of frame responses whose latency exceeded ``slo_ms``
        (counted over bins whose lower edge is ≥ ``slo_ms`` — snap the
        SLO to a bin edge for exact accounting)."""
        hist = self._hist_sync()
        tot = hist.sum()
        if tot == 0:
            return float("nan")
        bad = hist[self._lat_edges[:-1] >= slo_ms].sum()
        return float(bad / tot)


def _dup_rank(keys: np.ndarray) -> np.ndarray:
    """Occurrence index of each element among equal keys, preserving
    input order (0 for the first occurrence, 1 for the second, ...)."""
    if keys.size == 0:
        return keys
    order = np.argsort(keys, kind="stable")
    sorted_keys = keys[order]
    new_grp = np.empty(keys.size, bool)
    new_grp[0] = True
    new_grp[1:] = sorted_keys[1:] != sorted_keys[:-1]
    pos = np.arange(keys.size)
    starts = np.maximum.accumulate(np.where(new_grp, pos, 0))
    rank = np.empty(keys.size, np.int64)
    rank[order] = pos - starts
    return rank


def f_tau_index(n_probes: int, n_frame_users: int, n_f: int) -> np.ndarray:
    """Frame-round indices aligned with ``_traffic_fluid``'s request
    layout: after ``n_probes`` probe entries, frames are laid out user-major
    (user0 frame0..k, user1 frame0..k, ...)."""
    return np.concatenate([np.zeros(n_probes, np.int64),
                           np.tile(np.arange(n_f), n_frame_users)])
