"""Beacon (paper §3.1): the entry point(s), plus system assembly.

``ArmadaSystem`` wires Simulator + Topology + Spinner + ApplicationManager
+ CargoManager and exposes the three interaction surfaces the paper gives
Beacon: application deployment, user service discovery, and resource
registration.

Beacon fault domains (paper "Armada is robust", beyond the single
immortal control plane): with ``shard_precision`` set, a ``BeaconSet``
runs one ``Beacon`` replica per coarse geohash region — the same regions
the ``SelectionEngine`` shards by — and each replica owns its region's
node registrations and (through the engine's per-region ``_ShardSet``)
its shard's node arrays.  Killing a replica (``fail_beacon``) loses its
registration state:

* its nodes become control-plane *hidden* — alive on the data plane
  (warm connections and in-flight frames continue) but unschedulable —
  until each Captain's heartbeat replay re-registers it with the
  nearest live Beacon;
* its *users* hand off: the engine's ownership map re-points the dead
  region at the adopting Beacon, so every batched tick path (numpy,
  kernel, fused device) routes those user chunks to the adopting
  Beacon's merged shard, with the existing border-band escalation
  covering cross-domain queries;
* on ``recover_beacon`` the ownership map reverts (users re-home
  immediately — the adopted nodes stay visible through the surviving
  replica until they re-home at their next heartbeat).

Network partitions (split-brain) are a separate fault from replica
death: ``BeaconSet.partition`` cuts one or more regions' replicas off
from the majority WITHOUT killing them.  A partitioned replica keeps
accepting registrations and (staged) deployments from the Captains on
its side, so registration state *diverges*; the majority re-homes the
cut domain's users through the same ownership map a failure uses.
``heal`` merges the divergent logs — last-writer-wins on heartbeat
sequence for node registrations, staged task spawns applied or dropped
as conflicts — and reverts ownership with a single engine push (at most
one fused-tick retrace).  See ``docs/partition_tolerance.md``.

See ``docs/beacon_fault_domains.md`` for the ownership/handoff map and
``benchmarks/bench_beacon_failover.py`` for the measured unavailability
window.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from repro_torch.core import geohash
from repro_torch.core.app_manager import ApplicationManager, ServiceSpec
from repro_torch.core.captain import Captain
from repro_torch.core.client import Client
from repro_torch.core.client_pool import ClientPool
from repro_torch.core.cluster import Topology
from repro_torch.core.sim import Simulator
from repro_torch.core.spinner import Image, Spinner
from repro_torch.core.storage.cargo import Cargo
from repro_torch.core.storage.cargo_manager import CargoManager

HEARTBEAT_MS = 1000.0      # Captain -> Beacon heartbeat period (replay lag)
RECONCILE_BASE_MS = 50.0       # heal: fixed log-exchange round trip
RECONCILE_PER_ENTRY_MS = 0.5   # heal: per divergence-log-entry merge cost


class BeaconUnavailableError(RuntimeError):
    """The addressed Beacon replica is down (its fault domain failed).

    Batched pool queries never see this — the ``BeaconSet`` ownership map
    hands their region off to the nearest live replica inside the
    selection engine — but direct calls against a dead replica fail
    loudly instead of serving stale registration state."""


class Beacon:
    """Request router: forwards to the right handler component.

    One instance is either the global entry point (``region=None``, the
    unsharded system) or a per-region replica inside a ``BeaconSet``
    (``region`` = Morton prefix code of its fault domain).  A replica
    owns the node registrations of its domain (``registered_nodes``);
    killing it loses that state until heartbeat replay rebuilds it on a
    surviving replica."""

    def __init__(self, am: ApplicationManager, spinner: Spinner,
                 cargo_manager: CargoManager, *,
                 region: Optional[int] = None,
                 region_str: Optional[str] = None):
        self.am = am
        self.spinner = spinner
        self.cargo_manager = cargo_manager
        self.region = region
        self.region_str = region_str
        self.alive = True
        self.registered_nodes: Dict[str, Captain] = {}
        # ---- split-brain state (only a BeaconSet replica uses these) ----
        self.partitioned = False
        # divergence log: registrations accepted while cut off
        self.reg_log: List[dict] = []
        # node -> last registration sequence this replica saw (LWW merge)
        self.hb_last: Dict[str, int] = {}
        # deploys accepted while cut off, applied (or dropped) at heal
        self.pending_tasks: List[object] = []

    def _check_alive(self):
        if not self.alive:
            raise BeaconUnavailableError(
                f"Beacon replica {self.region_str or self.region!r} is "
                "down — route through BeaconSet.beacon_for (pools hand "
                "off automatically via the engine's ownership map)")

    # the three public surfaces (paper §3.1)
    def deploy_application(self, spec: ServiceSpec, **kw):
        self._check_alive()
        return self.am.deploy_service(spec, **kw)

    def query_service(self, service_id: str, user_loc, user_net: str):
        self._check_alive()
        return self.am.candidate_list(service_id, user_loc, user_net)

    def query_service_batch(self, service_id: str, user_locs, user_nets):
        """Batched service discovery: one vectorized selection pass over a
        whole user population; returns one ranked Task list per user."""
        self._check_alive()
        return self.am.candidate_lists(service_id, user_locs, user_nets)

    def query_service_indices(self, service_id: str, user_locs, user_nets):
        """Index-space batched discovery for pools: (U, k) int32 positions
        into the service's task list, padded with -1."""
        self._check_alive()
        return self.am.candidate_indices(service_id, user_locs, user_nets)

    def register_node(self, captain: Captain, runtime: str = "armada"):
        self._check_alive()
        self.registered_nodes[captain.node_id] = captain
        return self.spinner.captain_join(captain, runtime)

    def register_task(self, task):
        """Out-of-band replica spawn through this entry point.  A
        partitioned replica cannot reach the global engine state, so it
        *stages* the spawn in its divergence log; the heal-time
        reconciliation applies it (or drops it as a conflict if the
        majority side placed the same service on that Captain
        meanwhile)."""
        self._check_alive()
        if self.partitioned:
            self.pending_tasks.append(task)
            self.am.sim.log("partition_stage", region=self.region_str,
                            task=task.task_id)
            return task
        self.am.register_task(task)
        return task

    def register_cargo(self, cargo: Cargo):
        self._check_alive()
        return self.cargo_manager.cargo_join(cargo)


class BeaconSet:
    """Per-region Beacon replicas as injectable fault domains.

    Each replica serves one Morton-prefix region at the engine's
    ``shard_precision``.  The set maintains two pieces of control-plane
    state and pushes both into the ``SelectionEngine`` on every change
    (``set_beacon_routing``):

    * the **ownership map** — home region -> serving region.  Identity
      while a region's own Beacon is alive; on ``fail`` the dead domain
      is re-pointed at the nearest live replica (haversine between
      region cell centers, lowest code on ties), which merges its shard
      arrays and serves its users' queries (the handoff path).  Reverts
      on ``recover``.
    * the **hidden set** — nodes whose registration was lost with their
      Beacon and has not been replayed yet.  Each Captain re-registers
      with the serving replica at its next heartbeat (staggered over
      ``heartbeat_ms`` on the ``sim.substream("beacon")`` stream, so
      injection never shifts data-plane RNG); visibility converges
      node-by-node with no global rebuild.

    ``events`` records the full fail/replay/recover timeline —
    ``benchmarks/bench_beacon_failover.py`` derives the
    selection-unavailability window from it.
    """

    def __init__(self, sim: Simulator, am: ApplicationManager,
                 spinner: Spinner, cargo_manager: CargoManager, *,
                 shard_precision: int,
                 heartbeat_ms: float = HEARTBEAT_MS):
        self.sim = sim
        self.am = am
        self.spinner = spinner
        self.cargo_manager = cargo_manager
        self.precision = int(shard_precision)
        self.heartbeat_ms = heartbeat_ms
        self.replicas: Dict[int, Beacon] = {}
        self.home: Dict[str, int] = {}      # node -> home region code
        # node -> region whose live Beacon knows it (None = lost/hidden)
        self.serving: Dict[str, Optional[int]] = {}
        self.events: List[dict] = []
        self._centroids: Dict[int, tuple] = {}
        # ---------------- split-brain (partition) state -----------------
        # region code -> reachability group id (>0); absent = majority (0)
        self.partition_of: Dict[int, int] = {}
        self._next_gid = 1
        # node -> global monotonic registration sequence (LWW clock)
        self.hb_seq: Dict[str, int] = {}
        self._heal_pending: set = set()
        # last-pushed visibility map (node -> (serving, group)) — diffed
        # in ``_push`` to attribute refresh-epoch marks to regions
        self._last_serving: Optional[Dict[str, tuple]] = None

    # ---------------------------------------------------------- regions

    def region_code(self, region) -> int:
        """Coerce a region spec to a Morton prefix code: a base32 geohash
        prefix (exactly ``shard_precision`` chars), a prefix code int, or
        a (lat, lon) location."""
        if isinstance(region, str):
            if len(region) != self.precision:
                raise ValueError(
                    f"region prefix {region!r} must be exactly "
                    f"{self.precision} geohash chars")
            return geohash.str_to_code(region)
        if isinstance(region, (int, np.integer)):
            return int(region)
        lat, lon = region
        return int(geohash.encode_batch(
            np.asarray([lat]), np.asarray([lon]), self.precision)[0])

    def region_str(self, code: int) -> str:
        return geohash.code_to_str(int(code), self.precision)

    def _centroid(self, code: int) -> tuple:
        c = self._centroids.get(code)
        if c is None:
            lat, lon, _, _ = geohash.decode(self.region_str(code))
            c = (lat, lon)
            self._centroids[code] = c
        return c

    def replica(self, code: int) -> Beacon:
        rep = self.replicas.get(int(code))
        if rep is None:
            rep = Beacon(self.am, self.spinner, self.cargo_manager,
                         region=int(code),
                         region_str=self.region_str(code))
            self.replicas[int(code)] = rep
        return rep

    def live_regions(self) -> List[int]:
        return [c for c, r in self.replicas.items() if r.alive]

    def busiest_region(self) -> str:
        """Geohash prefix of the region homing the most Captains —
        killing it maximizes the blast radius (the canonical
        fault-injection target; ties break on the lowest code so the
        benchmark and the test harness always kill the same domain)."""
        counts: Dict[int, int] = {}
        for code in self.home.values():
            counts[code] = counts.get(code, 0) + 1
        if not counts:
            raise ValueError("busiest_region: no Captains registered")
        return self.region_str(max(sorted(counts), key=lambda c: counts[c]))

    def _coerce_regions(self, regions) -> List[int]:
        """A region spec, a (lat, lon) pair, or an iterable of either —
        normalized to a list of prefix codes."""
        if isinstance(regions, (str, int, np.integer)):
            return [self.region_code(regions)]
        regions = list(regions)
        if (len(regions) == 2
                and all(isinstance(x, (float, np.floating))
                        for x in regions)):
            return [self.region_code(tuple(regions))]   # one (lat, lon)
        return [self.region_code(r) for r in regions]

    def group_of(self, code: int) -> int:
        """Reachability group of a region: 0 = majority, >0 = the
        partition group it was cut into."""
        return self.partition_of.get(int(code), 0)

    def owner_of(self, code: int, group: int = 0) -> Optional[int]:
        """The region whose live Beacon serves ``code``'s domain *within
        a reachability group*: itself while up and in-group, else the
        nearest live in-group region (ties -> lowest code); None when the
        group has no live Beacon.  ``group=0`` (the majority side) is
        what user routing and the engine ownership map use; a partitioned
        Captain resolves against its own side's group."""
        code = int(code)
        rep = self.replicas.get(code)
        if rep is not None and rep.alive and self.group_of(code) == group:
            return code
        live = [c for c in self.live_regions() if self.group_of(c) == group]
        if not live:
            return None
        lat, lon = self._centroid(code)
        return min(live, key=lambda c: (geohash.distance_km(
            lat, lon, *self._centroid(c)), c))

    def beacon_for(self, loc) -> Beacon:
        """The replica serving a location — home if alive, else the
        nearest live one on the same side of any partition (a bootstrap
        lookup from inside a cut-off region reaches that side's replica,
        not the unreachable majority)."""
        code = self.region_code(tuple(loc))
        owner = self.owner_of(code, group=self.group_of(code))
        if owner is None:
            raise BeaconUnavailableError(
                "no live Beacon replica in any region")
        return self.replica(owner)

    # ----------------------------------------------------- registration

    def _record(self, rep: Beacon, node_id: str):
        """Stamp a registration on ``rep`` with the next global sequence
        number (the LWW clock for heal-time merges); while the replica is
        partitioned the entry also lands in its divergence log."""
        seq = self.hb_seq.get(node_id, 0) + 1
        self.hb_seq[node_id] = seq
        rep.hb_last[node_id] = seq
        if rep.partitioned:
            rep.reg_log.append({"t": self.sim.now, "node": node_id,
                                "seq": seq})

    def register_node(self, captain: Captain, runtime: str = "armada"):
        """Home a Captain in its region's fault domain and register it
        with the replica currently serving that domain.  A Captain
        joining inside a partitioned region registers with its side's
        replica — it stays hidden from the majority until heal."""
        code = self.region_code(tuple(captain.spec.loc))
        self.replica(code)                  # domain exists even if empty
        self.home[captain.node_id] = code
        group = self.group_of(code)
        owner = self.owner_of(code, group=group)
        if owner is None:
            self.serving[captain.node_id] = None
            self._push()
            return None
        rep = self.replica(owner)
        self.serving[captain.node_id] = owner
        dt = rep.register_node(captain, runtime)
        self._record(rep, captain.node_id)
        if group != 0:
            rng = self.sim.substream("beacon")
            self.sim.after(float(rng.uniform(0.0, self.heartbeat_ms)),
                           self._partition_heartbeat,
                           captain.node_id, group)
        self._push()
        return dt

    # -------------------------------------------------- fail / recover

    def fail(self, region):
        """Kill a region's Beacon replica: its registration state is
        lost (nodes it served go hidden until heartbeat replay lands
        them on the serving replica) and its users hand off to the
        nearest live Beacon through the engine ownership map."""
        code = self.region_code(region)
        rep = self.replicas.get(code)
        if rep is None or not rep.alive:
            known = sorted(self.region_str(c) for c in self.live_regions())
            raise ValueError(
                f"fail_beacon: no live Beacon for region "
                f"{self.region_str(code)!r} (live: {known})")
        rep.alive = False
        rep.registered_nodes.clear()
        if code in self.partition_of:
            # a partitioned replica dying collapses the split-brain into
            # a plain failure: its divergence log dies with it
            self.partition_of.pop(code, None)
            self._heal_pending.discard(code)
            rep.partitioned = False
            rep.reg_log.clear()
            rep.pending_tasks.clear()
        self.sim.log("beacon_fail", region=rep.region_str)
        self.events.append({"t": self.sim.now, "kind": "beacon_fail",
                            "region": rep.region_str})
        lost = sorted(n for n, s in self.serving.items() if s == code)
        rng = self.sim.substream("beacon")
        for node in lost:
            self.serving[node] = None
            # replay at the Captain's next heartbeat (uniform phase)
            self.sim.after(float(rng.uniform(0.0, self.heartbeat_ms)),
                           self._reregister, node)
        owner = self.owner_of(code, group=0)
        if owner is not None:
            # the adopting region inherits this domain's users — give
            # them a nearby data replica too (no-op without stores)
            self.cargo_manager.on_domain_handoff(self._centroid(owner))
        self._push()

    def recover(self, region):
        """Bring a region's Beacon back.  Ownership (and user routing)
        reverts immediately; its nodes re-home from the adopting replica
        at their next heartbeat — they stay visible through the adopter
        meanwhile, so recovery has no second unavailability dip."""
        code = self.region_code(region)
        rep = self.replicas.get(code)
        if rep is None or rep.alive:
            raise ValueError(
                f"recover_beacon: Beacon for region "
                f"{self.region_str(code)!r} is not down")
        rep.alive = True
        self.sim.log("beacon_recover", region=rep.region_str)
        self.events.append({"t": self.sim.now, "kind": "beacon_recover",
                            "region": rep.region_str})
        rng = self.sim.substream("beacon")
        for node in sorted(n for n, h in self.home.items()
                           if h == code and self.serving.get(n) != code):
            self.sim.after(float(rng.uniform(0.0, self.heartbeat_ms)),
                           self._rehome, node)
        self._push()

    # ------------------------------------------------ partition / heal

    def partition(self, regions) -> int:
        """Cut one or more regions' replicas off from the majority
        (split-brain) WITHOUT killing them.  Returns the reachability
        group id.

        Majority side: the cut domains' users hand off through the
        ownership map exactly like a failure, their nodes go hidden, and
        the ``CargoManager`` re-places data replicas near each adopting
        region.  Minority side: each cut replica keeps serving its own
        Captains — registrations and staged deploys accumulate in its
        divergence log until ``heal``."""
        codes = self._coerce_regions(regions)
        for code in codes:
            rep = self.replicas.get(code)
            if rep is None or not rep.alive:
                known = sorted(self.region_str(c)
                               for c in self.live_regions())
                raise ValueError(
                    f"partition: no live Beacon for region "
                    f"{self.region_str(code)!r} (live: {known})")
            if code in self.partition_of:
                raise ValueError(
                    f"partition: region {self.region_str(code)!r} is "
                    "already partitioned — heal it first")
        majority = [c for c in self.live_regions()
                    if c not in self.partition_of and c not in codes]
        if not majority:
            raise ValueError(
                "partition: refusing to cut off every majority region — "
                "at least one live group-0 Beacon must remain")
        gid = self._next_gid
        self._next_gid += 1
        rng = self.sim.substream("beacon")
        for code in codes:
            self.partition_of[code] = gid
            rep = self.replicas[code]
            rep.partitioned = True
            self.sim.log("beacon_partition", region=rep.region_str,
                         group=gid)
            self.events.append({"t": self.sim.now,
                                "kind": "beacon_partition",
                                "region": rep.region_str, "group": gid})
        cut = set(codes)
        for node, home in sorted(self.home.items()):
            cur = self.serving.get(node)
            if home in cut:
                # the Captain is physically on the minority side: its
                # heartbeats reach only its home replica from now on.
                # If a majority adopter was serving it, that adopter
                # keeps a now-stale record (divergence, resolved by LWW
                # at heal).
                rep = self.replicas[home]
                cap = self.spinner.captains.get(node)
                if cap is not None:
                    rep.registered_nodes[node] = cap
                self.serving[node] = home
                self._record(rep, node)
                self.sim.after(
                    float(rng.uniform(0.0, self.heartbeat_ms)),
                    self._partition_heartbeat, node, gid)
            elif cur in cut:
                # majority-side Captain adopted by a now-cut replica:
                # unreachable — hidden until heartbeat replay lands it
                # on a majority Beacon (the minority keeps its stale
                # record for LWW).
                self.serving[node] = None
                self.sim.after(
                    float(rng.uniform(0.0, self.heartbeat_ms)),
                    self._reregister, node)
        for code in codes:
            owner = self.owner_of(code, group=0)
            if owner is not None:
                self.cargo_manager.on_domain_handoff(
                    self._centroid(owner))
        self._push()
        return gid

    def _partition_heartbeat(self, node_id: str, gid: int):
        """Minority-side heartbeat: while the partition holds, a cut-off
        Captain keeps refreshing its registration on its home replica,
        advancing its LWW sequence (so at heal the side that actually
        heard the node last wins the merge)."""
        home = self.home.get(node_id)
        if home is None or self.partition_of.get(home) != gid:
            return                          # healed / collapsed meanwhile
        rep = self.replicas.get(home)
        if rep is None or not rep.alive:
            return
        cap = self.spinner.captains.get(node_id)
        if cap is not None and cap.alive:
            rep.registered_nodes[node_id] = cap
            self.serving[node_id] = home
            self._record(rep, node_id)
        self.sim.after(self.heartbeat_ms, self._partition_heartbeat,
                       node_id, gid)

    def heal(self, regions=None) -> float:
        """Reconnect partitioned regions (all of them by default).  The
        replicas first exchange divergence logs — a latency of
        ``RECONCILE_BASE_MS + RECONCILE_PER_ENTRY_MS × divergence`` —
        then ``_reconcile`` merges state and reverts ownership in one
        engine push.  Until the merge lands, routing still treats the
        regions as cut (that window IS the reconciliation latency the
        benchmark measures).  Returns the scheduled exchange delay."""
        if regions is None:
            codes = sorted(self.partition_of)
        else:
            codes = self._coerce_regions(regions)
        if not codes:
            raise ValueError("heal: no region is partitioned")
        for code in codes:
            if code not in self.partition_of:
                raise ValueError(
                    f"heal: region {self.region_str(code)!r} is not "
                    "partitioned")
            if code in self._heal_pending:
                raise ValueError(
                    f"heal: region {self.region_str(code)!r} is already "
                    "reconciling")
        divergence = sum(
            len(self.replicas[c].reg_log)
            + len(self.replicas[c].pending_tasks) for c in codes)
        delay = RECONCILE_BASE_MS + RECONCILE_PER_ENTRY_MS * divergence
        self._heal_pending.update(codes)
        self.sim.log("beacon_heal",
                     regions=[self.region_str(c) for c in codes],
                     divergence=divergence)
        self.events.append({"t": self.sim.now, "kind": "beacon_heal",
                            "regions": [self.region_str(c)
                                        for c in codes],
                            "divergence": divergence})
        self.sim.after(delay, self._reconcile, codes, self.sim.now)
        return delay

    def _reconcile(self, codes: List[int], heal_t: float):
        """Merge a healed partition's divergent state back into the
        majority:

        * node registrations — last-writer-wins on the heartbeat
          sequence: whichever replica heard the node most recently keeps
          it, every other holder drops its stale record;
        * staged task spawns — applied through the ApplicationManager
          (one engine invalidation each, shapes stay within the node
          pad) unless the Captain died or the majority placed the same
          service there meanwhile (a conflict, dropped and logged).

        One ``_push`` at the end reverts ownership and un-hides the
        minority's nodes: at most one fused-tick retrace per heal."""
        lww = conflicts = applied = 0
        divergence = sum(
            len(self.replicas[c].reg_log)
            + len(self.replicas[c].pending_tasks) for c in codes)
        for code in codes:
            rep = self.replicas[code]
            rep.partitioned = False
            self.partition_of.pop(code, None)
            self._heal_pending.discard(code)
        for code in codes:
            rep = self.replicas[code]
            for node in sorted(rep.registered_nodes):
                holders = [(c, r) for c, r in self.replicas.items()
                           if r.alive and node in r.registered_nodes]
                if len(holders) <= 1:
                    continue
                winner_code, winner = max(
                    holders, key=lambda cr: (cr[1].hb_last.get(node, 0),
                                             -cr[0]))
                for c, r in holders:
                    if r is not winner:
                        r.registered_nodes.pop(node, None)
                self.serving[node] = winner_code
                lww += 1
            for task in rep.pending_tasks:
                cap = task.captain
                if cap is None or not cap.alive:
                    conflicts += 1
                    self.sim.log("reconcile_conflict", task=task.task_id,
                                 reason="captain_dead")
                    continue
                existing = self.am.tasks.get(task.service_id, ())
                if any(t.captain is cap and t.status == "running"
                       for t in existing):
                    conflicts += 1
                    self.sim.log("reconcile_conflict", task=task.task_id,
                                 reason="duplicate_placement")
                    continue
                task.status = "running"
                task.ready_at = self.sim.now
                cap.tasks[task.task_id] = task
                self.am.register_task(task)
                applied += 1
            rep.reg_log.clear()
            rep.pending_tasks.clear()
        latency = self.sim.now - heal_t
        self.sim.log("beacon_reconcile",
                     regions=[self.region_str(c) for c in codes],
                     divergence=divergence, lww=lww,
                     conflicts=conflicts, staged=applied,
                     latency_ms=latency)
        self.events.append({"t": self.sim.now, "kind": "beacon_reconcile",
                            "regions": [self.region_str(c)
                                        for c in codes],
                            "divergence": divergence, "lww": lww,
                            "conflicts": conflicts, "staged": applied,
                            "latency_ms": latency})
        self._push()

    def _reregister(self, node_id: str):
        """Heartbeat replay: a Captain that lost its Beacon registers
        with the replica currently serving its home domain."""
        if self.serving.get(node_id) is not None:
            return                          # already replayed elsewhere
        cap = self.spinner.captains.get(node_id)
        if cap is None:
            return                          # node left the cluster for good
        if not cap.alive:
            # the node itself is churned out right now; its heartbeats
            # resume when it recovers — keep polling at heartbeat cadence
            self.sim.after(self.heartbeat_ms, self._reregister, node_id)
            return
        home = self.home[node_id]
        target = self.owner_of(home, group=self.group_of(home))
        if target is None:                  # still no live Beacon: retry
            self.sim.after(self.heartbeat_ms, self._reregister, node_id)
            return
        rep = self.replica(target)
        rep.registered_nodes[node_id] = cap
        self.serving[node_id] = target
        self._record(rep, node_id)
        self.sim.log("beacon_reregister", node=node_id,
                     region=rep.region_str)
        self.events.append({"t": self.sim.now, "kind": "reregister",
                            "node": node_id, "region": rep.region_str})
        self._push()

    def _rehome(self, node_id: str):
        """Post-recovery heartbeat: move a Captain's registration from
        the adopting replica back to its (now live) home Beacon."""
        home = self.home[node_id]
        rep = self.replicas.get(home)
        if rep is None or not rep.alive:
            return                          # home died again meanwhile
        cur = self.serving.get(node_id)
        if cur == home:
            return
        cap = self.spinner.captains.get(node_id)
        if cap is None:
            return                          # left the cluster for good
        if not cap.alive:
            # node is churned out right now — don't touch its adopted
            # registration (it must stay non-hidden for when it returns);
            # re-home at a later heartbeat instead
            self.sim.after(self.heartbeat_ms, self._rehome, node_id)
            return
        if cur is not None:
            cross = self.group_of(cur) != self.group_of(home)
            if not cross:
                self.replica(cur).registered_nodes.pop(node_id, None)
            # across a partition the adopter is unreachable: its stale
            # record stays until heal-time LWW drops it
        rep.registered_nodes[node_id] = cap
        self.serving[node_id] = home
        self._record(rep, node_id)
        self.events.append({"t": self.sim.now, "kind": "rehome",
                            "node": node_id, "region": rep.region_str})
        self._push()

    # ------------------------------------------------------- engine push

    def hidden_nodes(self) -> frozenset:
        """Nodes invisible to majority-side selection: registration lost
        (``serving is None``) or only reachable through a partitioned
        replica (serving region's group != 0)."""
        return frozenset(n for n, s in self.serving.items()
                         if s is None or self.group_of(s) != 0)

    def ownership(self) -> Dict[int, int]:
        """Non-identity region -> serving-region entries: dead domains
        AND partitioned domains (whose users the majority re-homes the
        same way); regions with no live majority owner are omitted —
        their nodes are hidden anyway and their users fall to the border
        pass."""
        out = {}
        for code, rep in self.replicas.items():
            if rep.alive and self.group_of(code) == 0:
                continue
            owner = self.owner_of(code, group=0)
            if owner is not None:
                out[code] = owner
        return out

    def _push(self):
        # attribute node-visibility changes to regions for the engine's
        # incremental-refresh epochs: any node whose serving entry moved
        # (registered, lost, re-registered, re-homed) dirties its home
        # region and both serving regions — exactly the shards whose
        # schedulable set the change can touch
        vis = {n: (s, self.group_of(s) if s is not None else -1)
               for n, s in self.serving.items()}
        regions = set()
        if self._last_serving is not None:
            for n in vis.keys() | self._last_serving.keys():
                if vis.get(n) != self._last_serving.get(n):
                    for r in (self.home.get(n),
                              vis.get(n, (None,))[0],
                              self._last_serving.get(n, (None,))[0]):
                        if r is not None:
                            regions.add(r)
        self._last_serving = vis
        self.am.engine.set_beacon_routing(self.ownership(),
                                          self.hidden_nodes(),
                                          dirty_regions=sorted(regions))

    def convergence_ms(self, fail_t: float) -> float:
        """Selection-unavailability window of the failure at ``fail_t``:
        time until the last lost Captain re-registered (after which every
        pre-failure node is schedulable again).  Bounded at the NEXT
        ``beacon_fail`` event, so replays belonging to a later, unrelated
        failure never inflate this window."""
        replays = []
        for e in self.events:
            if e["t"] < fail_t:
                continue
            if e["kind"] == "beacon_fail" and e["t"] > fail_t:
                break                       # a later failure's replays
            if e["kind"] == "reregister":
                replays.append(e["t"])
        return (max(replays) - fail_t) if replays else float("nan")


class ArmadaSystem:
    """Fully wired Armada instance over a Topology.  ``device`` is where
    the selection engine's geo_topk queries run: ``"cuda"`` (the default)
    launches the hand-written kernels and needs a card; ``"cpu"`` runs
    their plain PyTorch versions."""

    def __init__(self, topo: Topology, *, seed: int = 0,
                 compute_nodes: Optional[List[str]] = None,
                 cargo_nodes: Optional[List[str]] = None,
                 include_cloud_compute: bool = True,
                 trace_enabled: bool = True,
                 shard_precision: Optional[int] = None,
                 beacon_heartbeat_ms: float = HEARTBEAT_MS,
                 discovery_ms: float = 0.0,
                 device="cuda"):
        self.sim = Simulator(seed=seed, trace_enabled=trace_enabled)
        self.topo = topo
        self.spinner = Spinner(self.sim, topo)
        self.cargo_manager = CargoManager(self.sim, topo)
        self.am = ApplicationManager(self.sim, topo, self.spinner,
                                     self.cargo_manager,
                                     shard_precision=shard_precision,
                                     device=device)
        # storage placements feed the selection score (data locality)
        self.cargo_manager.attach_engine(self.am.engine)
        # client-side Beacon discovery window: charged by every
        # ClientPool on bootstrap and on handoff-driven re-discovery
        self.discovery_ms = float(discovery_ms)
        self.am.engine.discovery_ms = self.discovery_ms
        self.beacon = Beacon(self.am, self.spinner, self.cargo_manager)
        # region-sharded systems get per-region Beacon fault domains; the
        # global facade above still serves deployment/bootstrap calls
        self.beacons: Optional[BeaconSet] = None
        if shard_precision is not None:
            self.beacons = BeaconSet(self.sim, self.am, self.spinner,
                                     self.cargo_manager,
                                     shard_precision=shard_precision,
                                     heartbeat_ms=beacon_heartbeat_ms)
        self.captains: Dict[str, Captain] = {}
        self.cargos: Dict[str, Cargo] = {}

        names = compute_nodes if compute_nodes is not None else [
            n for n, s in topo.nodes.items() if s.proc_ms > 0]
        for name in names:
            spec = topo.nodes[name]
            if spec.is_cloud and not include_cloud_compute:
                continue
            cap = Captain(self.sim, topo, spec)
            self.captains[name] = cap
            if self.beacons is not None:
                self.beacons.register_node(cap)
            else:
                self.beacon.register_node(cap)
        for name in (cargo_nodes or []):
            cg = Cargo(self.sim, topo, topo.nodes[name])
            self.cargos[name] = cg
            self.beacon.register_cargo(cg)

    # ------------------------------------------------------------- helpers

    def make_client(self, client_id: str, service_id: str, **kw) -> Client:
        return Client(self.sim, self.topo, self.am, client_id, service_id,
                      **kw)

    def make_client_pool(self, service_id: str, **kw) -> ClientPool:
        """Vectorized population: pass ``client_ids=[...]`` for Topology
        endpoints (scalar-parity events transport) or ``locs=(U, 2)`` for
        synthetic users (fluid transport at scale)."""
        return ClientPool(self.sim, self.topo, self.am, service_id, **kw)

    def ensure_cloud_replica(self, service_id: str):
        """The paper's cloud baseline assumes an always-available cloud
        deployment; Armada's own scheduler never places on the cloud.
        Registration routes through ``ApplicationManager.register_task``
        so the selection engine's device-resident node caches are
        invalidated like any other replica-set change (appending to
        ``am.tasks`` directly would leave a stale ``packed_static`` to
        whatever path skips the lazy fingerprint check)."""
        from repro_torch.core.app_manager import Task
        cloud = next((c for c in self.captains.values()
                      if c.spec.is_cloud), None)
        if cloud is None:
            return None
        task = Task(f"{service_id}/cloud", service_id, captain=cloud,
                    status="running", ready_at=self.sim.now)
        cloud.tasks[task.task_id] = task
        self.am.register_task(task)
        return task

    def fail_node(self, name: str, at_ms: float):
        """Schedule a node failure.  Unknown names raise immediately;
        failing a node that is already down when the event fires raises
        instead of silently re-running ``Captain.fail``'s no-op branch —
        the scenario author almost certainly meant a different node or
        forgot a recovery (``ChurnModel`` drives overlapping churn with
        its own alive guard and is unaffected)."""
        if name not in self.captains:
            known = sorted(self.captains)
            raise ValueError(
                f"fail_node: unknown node {name!r} — known compute nodes: "
                f"{known[:8]}{'...' if len(known) > 8 else ''}")
        self.sim.at(at_ms, self._fail_captain, name)

    def _fail_captain(self, name: str):
        cap = self.captains[name]
        if not cap.alive:
            raise RuntimeError(
                f"fail_node({name!r}): node is already failed at "
                f"t={self.sim.now:.1f} ms — schedule a recovery first, "
                "or use ChurnModel for overlapping fail/recover cycles")
        cap.fail()

    def fail_beacon(self, region, at_ms: float):
        """Schedule a Beacon fault-domain failure (``region``: geohash
        prefix string at shard_precision, prefix code, or (lat, lon))."""
        if self.beacons is None:
            raise RuntimeError(
                "fail_beacon needs Beacon fault domains — construct "
                "ArmadaSystem with shard_precision to get a BeaconSet")
        self.sim.at(at_ms, self.beacons.fail, region)

    def recover_beacon(self, region, at_ms: float):
        if self.beacons is None:
            raise RuntimeError(
                "recover_beacon needs Beacon fault domains — construct "
                "ArmadaSystem with shard_precision to get a BeaconSet")
        self.sim.at(at_ms, self.beacons.recover, region)

    def partition_beacon(self, regions, at_ms: float) -> "PartitionHandle":
        """Schedule a split-brain: cut ``regions`` (one spec or a list)
        off from the majority at ``at_ms``.  Region specs are validated
        at schedule time (liveness is checked when the event fires).
        Returns a handle whose ``heal_at(ms)`` schedules the heal."""
        if self.beacons is None:
            raise RuntimeError(
                "partition_beacon needs Beacon fault domains — construct "
                "ArmadaSystem with shard_precision to get a BeaconSet")
        self.beacons._coerce_regions(regions)    # parse errors fail now
        self.sim.at(at_ms, self.beacons.partition, regions)
        return PartitionHandle(self, regions)

    def fail_cargo(self, name: str, at_ms: float):
        """Schedule a Cargo node failure — same contract as
        ``fail_node``: unknown names raise immediately, failing an
        already-dead Cargo raises when the event fires."""
        if name not in self.cargos:
            known = sorted(self.cargos)
            raise ValueError(
                f"fail_cargo: unknown cargo {name!r} — known cargo "
                f"nodes: {known[:8]}{'...' if len(known) > 8 else ''}")
        self.sim.at(at_ms, self._fail_cargo, name)

    def _fail_cargo(self, name: str):
        cg = self.cargos[name]
        if not cg.alive:
            raise RuntimeError(
                f"fail_cargo({name!r}): cargo is already failed at "
                f"t={self.sim.now:.1f} ms — the scenario author almost "
                "certainly meant a different node")
        cg.fail()
        self.cargo_manager.on_cargo_fail(cg)


class PartitionHandle:
    """Ticket returned by ``ArmadaSystem.partition_beacon``: remembers
    which regions were cut so the matching heal is one call."""

    def __init__(self, system: "ArmadaSystem", regions):
        self.system = system
        self.regions = regions

    def heal_at(self, at_ms: float):
        self.system.sim.at(at_ms, self.system.beacons.heal, self.regions)
        return self


def detection_image() -> Image:
    """The paper's object-detection service image (~480 MB, 6 layers)."""
    return Image("detector", [("base", 120.0), ("cuda-lite", 140.0),
                              ("py", 60.0), ("deps", 90.0),
                              ("weights", 60.0), ("app", 10.0)])


def facerec_image() -> Image:
    return Image("facerec", [("base", 120.0), ("py", 60.0),
                             ("dlib", 110.0), ("weights", 45.0),
                             ("app", 10.0)])
