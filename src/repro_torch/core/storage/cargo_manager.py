"""Cargo Manager (paper §3.4.1): storage registration, 2-step data-access-
point selection, and storage auto-scaling.

Store_Register allocates THREE data replicas near the service's expected
locations; Cargo_Discover hands a Captain a geo-ranked candidate list and
the Captain probes them (the same 2-step idea as service selection).  When
compute auto-scaling spawns replicas far from existing data, the manager
cascades a new data replica onto a nearby Cargo.

Data-locality feedback into selection (paper §3.4 in-situ data access):
whenever a service's replica placement changes — registration, storage
auto-scaling, a Cargo death, or a handoff re-placement — the manager
pushes the alive replica locations into the ``SelectionEngine``
(``set_data_locality``), so every tick path prefers compute nodes within
``DATA_LOCAL_RADIUS_KM`` of the service's store.  ``on_domain_handoff``
is the control-plane hook: when a Beacon partition or failure re-homes a
domain's users to an adopting region, the manager re-places a data
replica near that region so the handed-off users can land data-local.

Data plane (``DataProfile`` / ``data_ms_for_nodes``): a ``ClientPool``
built with a per-service data profile folds a per-user Cargo access term
into its request-latency model on every tick path.  The manager computes
the per-NODE cost — nearest-alive-replica hop (the synthetic RTT model
shared with the pool) + the replica's measured read EMA inflated by its
load, plus the write path's consistency cost (strong = synchronous
fan-out to the slowest peer) — and the pool gathers it per user by
active node.  The pool charges its aggregated per-window reads back
through ``note_read_load``; a replica whose read throughput crosses
``HOT_READ_RATE`` triggers storage auto-scaling the way hot Captains
trigger compute auto-scaling.

Capacity and in-flight bookkeeping: ``_rank_by_location`` filters on the
LIVE ``used_mb`` (kept current by ``Cargo._put``), in-flight copies are
tracked so concurrent handoffs can't double-place a replica, and a Cargo
whose stores outgrow its volume gets its largest multi-replica store
migrated off (``on_capacity_exceeded``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core import geohash
from repro_torch.core.cluster import Topology
from repro_torch.core.selection import DATA_LOCAL_RADIUS_KM, W_DATA
from repro_torch.core.sim import Simulator
from repro_torch.core.storage.cargo import WRITE_MS, Cargo, record_mb

# reads/s on one replica before the manager splits the load onto a new
# replica nearby (storage auto-scaling's hot-store trigger)
HOT_READ_RATE = 200.0


@dataclass(frozen=True)
class DataProfile:
    """Per-request Cargo access of one service's serving path: how many
    reads/writes a request issues and under which consistency mode.
    Consumed by ``ClientPool(data_profile=...)`` through
    ``CargoManager.data_ms_for_nodes``."""
    reads_per_request: float = 1.0
    writes_per_request: float = 0.0
    consistency: str = "eventual"          # "strong" | "eventual"

    def __post_init__(self):
        if self.consistency not in ("strong", "eventual"):
            raise ValueError(
                f"unknown consistency {self.consistency!r}")


class CargoManager:
    def __init__(self, sim: Simulator, topo: Topology, *,
                 replicas: int = 3, top_n: int = 3,
                 locality_weight: float = W_DATA):
        self.sim = sim
        self.topo = topo
        self.replicas = replicas
        self.top_n = top_n
        self.locality_weight = locality_weight
        self.cargos: Dict[str, Cargo] = {}
        self.placements: Dict[str, List[Cargo]] = {}    # service -> replicas
        self.specs: Dict[str, object] = {}
        self.engine = None              # SelectionEngine (attach_engine)
        # in-flight bulk copies: service -> {target node_id: reason} —
        # consulted by placement so two concurrent handoffs (or a handoff
        # racing autoscale) can never double-place the same replica
        self._inflight: Dict[str, Dict[str, str]] = {}
        # Cargos with a capacity migration in flight (re-entry guard)
        self._evicting: set = set()

    # --------------------------------------------------------- registration

    def attach_engine(self, engine):
        """Wire the selection engine that receives data-locality pushes
        (done by ``ArmadaSystem``); replays current placements so a late
        attach is equivalent to an early one."""
        self.engine = engine
        for service_id in self.placements:
            self._push_locality(service_id)

    def _push_locality(self, service_id: str):
        """Publish the service's alive replica locations as a selection
        score preference (no-op until an engine is attached)."""
        if self.engine is None:
            return
        locs = tuple(sorted(
            (float(c.spec.loc[0]), float(c.spec.loc[1]))
            for c in self.placements.get(service_id, ()) if c.alive))
        self.engine.set_data_locality(service_id, locs,
                                      weight=self.locality_weight)

    def cargo_join(self, cargo: Cargo):
        self.cargos[cargo.node_id] = cargo
        cargo.capacity_cb = self.on_capacity_exceeded
        self.sim.log("cargo_join", node=cargo.node_id)

    def on_cargo_fail(self, cargo: Cargo):
        """A Cargo died: its replicas stop contributing data locality
        (``cargo_discover`` already skips dead nodes per call)."""
        for service_id, reps in self.placements.items():
            if any(c is cargo for c in reps):
                self._push_locality(service_id)

    def _rank_by_location(self, loc, need_mb: float,
                          exclude=()) -> List[Cargo]:
        ok = [c for c in self.cargos.values()
              if c.alive and c.node_id not in exclude
              and (c.capacity_mb - c.used_mb) >= need_mb]
        ok.sort(key=lambda c: geohash.distance_km(
            c.spec.loc[0], c.spec.loc[1], loc[0], loc[1]))
        return ok

    def store_register(self, spec,
                       initial: Optional[Dict[str, bytes]] = None):
        """Allocate three replicas near the service's expected location."""
        loc = spec.locations[0] if spec.locations else (0.0, 0.0)
        ranked = self._rank_by_location(loc, spec.storage_capacity_mb)
        chosen = ranked[:self.replicas]
        for c in chosen:
            c.provision(spec.service_id, chosen, initial)
        self.placements[spec.service_id] = chosen
        self.specs[spec.service_id] = spec
        self.sim.log("store_register", service=spec.service_id,
                     cargos=[c.node_id for c in chosen])
        self._push_locality(spec.service_id)
        return chosen

    # ------------------------------------------------------------ discovery

    def cargo_discover(self, service_id: str, captain_loc) -> List[Cargo]:
        """Step 1: candidate list of data access points for a Captain."""
        reps = [c for c in self.placements.get(service_id, ())
                if c.alive]
        reps.sort(key=lambda c: geohash.distance_km(
            c.spec.loc[0], c.spec.loc[1], captain_loc[0], captain_loc[1]))
        return reps[:self.top_n]

    # ------------------------------------------------------------ data plane

    def data_ms_for_nodes(self, service_id: str, profile: DataProfile,
                          lats: np.ndarray, lons: np.ndarray):
        """Vectorized per-node Cargo access cost for the pool's request-
        latency fold: for each compute-node location, the nearest alive
        replica's hop (same synthetic last-mile + distance RTT model the
        pool uses for users) plus its load-inflated measured read EMA,
        and the write path's consistency cost.

        Returns ``(ms, nearest, reps)`` — ``ms`` (N,) float per node,
        ``nearest`` (N,) index into ``reps`` (the alive replica each
        node would read from, for read-load charging) — or ``None`` when
        the service has no alive placement."""
        from repro_torch.core.client_pool import (RTT_CLOUD_PENALTY_MS,
                                            RTT_LAST_MILE_MS, RTT_MS_PER_KM)
        reps = [c for c in self.placements.get(service_id, ()) if c.alive]
        if not reps:
            return None
        r_lat = np.asarray([c.spec.loc[0] for c in reps])
        r_lon = np.asarray([c.spec.loc[1] for c in reps])
        r_cloud = np.asarray([bool(c.spec.is_cloud) for c in reps])
        d = geohash.distance_km_batch(
            np.asarray(lats)[:, None], np.asarray(lons)[:, None],
            r_lat[None, :], r_lon[None, :])
        hop = RTT_LAST_MILE_MS + RTT_MS_PER_KM * d \
            + np.where(r_cloud[None, :], RTT_CLOUD_PENALTY_MS, 0.0)
        nearest = np.argmin(hop, axis=1)
        rtt = hop[np.arange(hop.shape[0]), nearest]
        read_ms = np.asarray([c.effective_read_ms() for c in reps])
        ms = profile.reads_per_request * (rtt + read_ms[nearest])
        if profile.writes_per_request > 0:
            sync = np.zeros(len(reps))
            if profile.consistency == "strong":
                # synchronous fan-out: the ack waits for the slowest peer
                for i, c in enumerate(reps):
                    sync[i] = max(
                        (self.topo.rtt(c.node_id, p.node_id) + WRITE_MS
                         for p in c.peers.get(service_id, ()) if p.alive),
                        default=0.0)
            ms = ms + profile.writes_per_request \
                * (rtt + WRITE_MS + sync[nearest])
        return ms, nearest, reps

    def note_read_load(self, service_id: str, reps: List[Cargo],
                       counts: np.ndarray, window_ms: float):
        """Charge one fluid window's aggregated reads (``counts`` aligned
        with ``reps``) and trigger hot-store auto-scaling when a replica's
        read throughput crosses ``HOT_READ_RATE``."""
        hot = None
        for c, n in zip(reps, counts):
            c.note_reads(float(n), window_ms)
            if c.read_rate > HOT_READ_RATE and \
                    (hot is None or c.read_rate > hot.read_rate):
                hot = c
        spec = self.specs.get(service_id)
        if hot is not None and spec is not None:
            # split the hot replica's read load: one more access point in
            # its locale (the hot replica itself doesn't count as "near")
            self._ensure_replica_near(spec, hot.spec.loc, "hot-read",
                                      split_from=hot)

    # --------------------------------------------------------- auto-scaling

    def _ensure_replica_near(self, spec, loc, reason: str, *,
                             split_from: Optional[Cargo] = None) -> bool:
        """Place one more data replica near ``loc`` unless an alive
        replica — or an in-flight copy — is already within
        ``DATA_LOCAL_RADIUS_KM``.  The copy is asynchronous
        (bulk-transfer model); locality re-publishes when it lands.
        ``split_from`` (hot-store scaling) exempts the overloaded
        replica from the nearby check so its locale gains a second
        access point.  Returns True when a copy was started."""
        service_id = spec.service_id
        reps = self.placements.get(service_id, [])
        if not reps:
            return False
        inflight = self._inflight.setdefault(service_id, {})
        near = [c for c in reps if c.alive and c is not split_from] \
            + [self.cargos[nid] for nid in inflight if nid in self.cargos]
        nearest = min(
            (geohash.distance_km(c.spec.loc[0], c.spec.loc[1],
                                 loc[0], loc[1]) for c in near),
            default=float("inf"))
        if nearest <= DATA_LOCAL_RADIUS_KM:      # close enough / in flight
            return False
        ranked = self._rank_by_location(
            loc, spec.storage_capacity_mb,
            exclude=[c.node_id for c in reps] + list(inflight))
        if not ranked:
            return False
        new = ranked[0]
        src = next((c for c in reps if c.alive), None)
        if src is None:
            # no alive source: refuse rather than fabricate recovered
            # data from a dead Cargo's in-memory store
            self.sim.log("storage_scale_failed", service=service_id,
                         node=new.node_id, reason="no-alive-source")
            return False
        inflight[new.node_id] = reason
        data = dict(src.stores.get(service_id, {}))
        hop = self.topo.rtt(src.node_id, new.node_id)
        xfer = len(data) * 1.0e-3 + hop          # bulk copy model

        def _done():
            self._inflight.get(service_id, {}).pop(new.node_id, None)
            group = self.placements.get(service_id, [])
            if any(c is new for c in group):     # raced a re-placement
                return
            if not new.alive:
                self.sim.log("storage_scale_failed", service=service_id,
                             node=new.node_id, reason="target-died")
                return
            group = group + [new]
            new.provision(service_id, group, data)
            for c in group:
                c.peers[service_id] = [p for p in group if p is not c]
            self.placements[service_id] = group
            self.sim.log("storage_scale", service=service_id,
                         node=new.node_id, reason=reason)
            self._push_locality(service_id)

        self.sim.after(xfer, _done)
        return True

    def on_new_task(self, spec, task):
        """Compute layer grew: ensure low-latency data access nearby."""
        self._ensure_replica_near(spec, task.captain.spec.loc, "autoscale")

    def on_domain_handoff(self, loc) -> int:
        """A Beacon handoff (partition or failure) re-homed a domain's
        users near ``loc`` (the adopting region's centroid): re-place a
        data replica for every registered store that has none nearby, so
        post-handoff requests can land data-local.  Returns the number of
        copies started."""
        return sum(self._ensure_replica_near(self.specs[sid], loc,
                                             "handoff")
                   for sid in sorted(self.placements))

    # ------------------------------------------------------------- capacity

    def on_capacity_exceeded(self, cargo: Cargo):
        """A write pushed ``cargo`` past its volume: migrate its largest
        store that has another alive replica onto a Cargo with room,
        then drop the local copy.  A store this Cargo holds the only
        alive copy of is never evicted (the overflow is logged and
        tolerated — dropping it would lose data)."""
        if cargo.node_id in self._evicting or not cargo.alive:
            return
        victim = None
        for sid, store in cargo.stores.items():
            others = [c for c in self.placements.get(sid, ())
                      if c.alive and c is not cargo]
            if not others:
                continue
            mb = sum(record_mb(k, v) for k, v in store.items())
            if victim is None or mb > victim[1]:
                victim = (sid, mb, others)
        if victim is None:
            self.sim.log("storage_evict_failed", node=cargo.node_id,
                         reason="sole-replica")
            return
        sid, mb, others = victim
        self._evicting.add(cargo.node_id)
        inflight = self._inflight.setdefault(sid, {})
        ranked = self._rank_by_location(
            cargo.spec.loc, mb,
            exclude=[c.node_id for c in self.placements.get(sid, ())]
            + list(inflight))
        src = others[0]
        if not ranked:
            # nowhere to migrate: shed the local copy anyway when at
            # least two other alive replicas keep the store redundant
            if len(others) >= 2:
                self._drop_replica(sid, cargo, reason="capacity")
            else:
                self.sim.log("storage_evict_failed", node=cargo.node_id,
                             reason="no-capacity")
            self._evicting.discard(cargo.node_id)
            return
        new = ranked[0]
        inflight[new.node_id] = "capacity"
        data = dict(src.stores.get(sid, {}))
        xfer = len(data) * 1.0e-3 + self.topo.rtt(src.node_id, new.node_id)

        def _done():
            self._inflight.get(sid, {}).pop(new.node_id, None)
            self._evicting.discard(cargo.node_id)
            group = [c for c in self.placements.get(sid, [])
                     if c is not cargo]
            if new.alive and not any(c is new for c in group):
                group = group + [new]
                new.provision(sid, group, data)
            self._drop_replica(sid, cargo, reason="capacity",
                               group=group)

        self.sim.after(xfer, _done)

    def _drop_replica(self, sid: str, cargo: Cargo, *, reason: str,
                      group: Optional[List[Cargo]] = None):
        """Remove ``cargo`` from a service's replica group (capacity
        eviction): drop the store, re-link peers, republish locality."""
        if group is None:
            group = [c for c in self.placements.get(sid, [])
                     if c is not cargo]
        cargo.drop_store(sid)
        for c in group:
            c.peers[sid] = [p for p in group if p is not c]
        self.placements[sid] = group
        self.sim.log("storage_evict", service=sid, node=cargo.node_id,
                     reason=reason)
        self._push_locality(sid)
