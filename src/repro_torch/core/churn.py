"""Online churn analysis + stability-aware scheduling (beyond-paper).

The paper's stated next step (§8): "carry out an online churn analysis to
quantify the volunteer node stability, which will play an essential part
in the placement process."  This module implements it:

* ``ChurnModel`` drives volunteer node failures/recoveries in the
  simulator from per-node exponential lifetime distributions (dedicated
  nodes get ~20× the volunteer MTTF).
* ``StabilityTracker`` observes join/leave events ONLINE and maintains a
  per-node stability score — the posterior-mean availability of an
  exponential up/down process with a Beta(2,1) prior (new nodes start
  optimistic-but-uncertain, exactly the paper's "quantify volunteer
  stability" need).
* ``stability_policy`` plugs the score into Spinner as a weighted sorting
  policy, so replicas of latency-critical services prefer stable nodes —
  measurably fewer failovers per client at equal latency
  (tests/test_churn.py).
* ``BeaconChurnModel`` extends churn to the control plane itself: it
  drives ``BeaconSet`` fault-domain failures/recoveries (multi-Beacon
  handoff + heartbeat replay) the same way ``ChurnModel`` drives node
  churn.
* ``PartitionChurnModel`` drives split-brain cuts and heals
  (``BeaconSet.partition``/``heal``) — divergence and reconciliation
  under stochastic network partitions instead of crashes.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.core.captain import Captain
from repro_torch.core.sim import Simulator
from repro_torch.core.spinner import SchedulePolicy, Spinner


@dataclass
class NodeChurnStats:
    joins: int = 0
    leaves: int = 0
    up_ms: float = 0.0
    down_ms: float = 0.0
    last_change: float = 0.0
    up_now: bool = True


class StabilityTracker:
    """Online availability estimation from observed churn events."""

    def __init__(self, sim: Simulator, prior_up: float = 2.0,
                 prior_down: float = 1.0):
        self.sim = sim
        self.stats: Dict[str, NodeChurnStats] = {}
        self.prior_up = prior_up
        self.prior_down = prior_down

    def _get(self, node: str) -> NodeChurnStats:
        if node not in self.stats:
            self.stats[node] = NodeChurnStats(last_change=self.sim.now)
        return self.stats[node]

    def on_join(self, node: str):
        s = self._get(node)
        if not s.up_now:
            s.down_ms += self.sim.now - s.last_change
        s.joins += 1
        s.up_now = True
        s.last_change = self.sim.now

    def on_leave(self, node: str):
        s = self._get(node)
        if s.up_now:
            s.up_ms += self.sim.now - s.last_change
        s.leaves += 1
        s.up_now = False
        s.last_change = self.sim.now

    def availability(self, node: str) -> float:
        """Posterior-mean availability in [0, 1]; optimistic prior."""
        s = self.stats.get(node)
        if s is None:
            return self.prior_up / (self.prior_up + self.prior_down)
        up = s.up_ms + (self.sim.now - s.last_change if s.up_now else 0.0)
        down = s.down_ms + (0.0 if s.up_now else
                            self.sim.now - s.last_change)
        # scale observations to pseudo-counts (1 count per 10 s observed)
        k_up = up / 10_000.0 + self.prior_up
        k_down = down / 10_000.0 + self.prior_down
        # each leave event is strong evidence of instability
        k_down += (s.leaves if s else 0)
        return k_up / (k_up + k_down)

    def mttf_ms(self, node: str) -> Optional[float]:
        """Observed mean-time-to-failure, if any failures were seen."""
        s = self.stats.get(node)
        if not s or s.leaves == 0:
            return None
        up = s.up_ms + (self.sim.now - s.last_change if s.up_now else 0.0)
        return up / s.leaves


def stability_policy(tracker: StabilityTracker,
                     weight: float = 0.35) -> SchedulePolicy:
    """Spinner sorting policy: prefer nodes with high posterior
    availability (paper §3.3.1 'customized' policy slot)."""
    return SchedulePolicy(
        "stability",
        lambda captain, ctx: tracker.availability(captain.node_id),
        weight)


class ChurnModel:
    """Exponential up/down process per node, driven in virtual time."""

    def __init__(self, sim: Simulator, captains: Dict[str, Captain],
                 tracker: Optional[StabilityTracker] = None, *,
                 volunteer_mttf_ms: float = 60_000.0,
                 dedicated_mttf_ms: float = 1_200_000.0,
                 mttr_ms: float = 20_000.0,
                 unstable: tuple = ()):
        self.sim = sim
        self.captains = captains
        self.tracker = tracker
        self.volunteer_mttf = volunteer_mttf_ms
        self.dedicated_mttf = dedicated_mttf_ms
        self.mttr = mttr_ms
        self.unstable = set(unstable)
        self.events: List[dict] = []

    def _mttf(self, cap: Captain) -> float:
        base = self.dedicated_mttf if cap.spec.dedicated else \
            self.volunteer_mttf
        if cap.node_id in self.unstable:
            base *= 0.25
        return base

    def start(self):
        for cap in self.captains.values():
            if cap.spec.is_cloud:
                continue
            self._schedule_failure(cap)

    def _schedule_failure(self, cap: Captain):
        dt = float(self.sim.rng.exponential(self._mttf(cap)))
        self.sim.after(dt, self._fail, cap)

    def _fail(self, cap: Captain):
        if not cap.alive:
            return
        cap.fail()
        self.events.append({"t": self.sim.now, "node": cap.node_id,
                            "kind": "leave"})
        if self.tracker:
            self.tracker.on_leave(cap.node_id)
        self.sim.after(float(self.sim.rng.exponential(self.mttr)),
                       self._recover, cap)

    def _recover(self, cap: Captain):
        cap.recover()
        self.events.append({"t": self.sim.now, "node": cap.node_id,
                            "kind": "join"})
        if self.tracker:
            self.tracker.on_join(cap.node_id)
        self._schedule_failure(cap)


class BeaconChurnModel:
    """Control-plane churn: exponential fail/recover cycles per Beacon
    fault domain (paper "Armada is robust" — users must survive
    control-plane loss, not just node churn).

    Drives ``BeaconSet.fail``/``recover`` in virtual time from per-region
    exponential lifetimes, on the ``sim.substream("beacon_churn")`` RNG
    stream so enabling it never shifts data-plane jitter draws.  With
    ``spare_last`` (default) a failure that would kill the final live
    Beacon is skipped and rescheduled — total control-plane loss is an
    explicit scenario (``BeaconSet.fail`` by hand), not a default one.
    """

    def __init__(self, sim: Simulator, beacon_set, *,
                 mttf_ms: float = 600_000.0, mttr_ms: float = 30_000.0,
                 spare_last: bool = True, regions: tuple = ()):
        self.sim = sim
        self.beacons = beacon_set
        self.mttf = mttf_ms
        self.mttr = mttr_ms
        self.spare_last = spare_last
        self.regions = tuple(regions)       # default: every known domain
        self.events: List[dict] = []

    def start(self):
        rng = self.sim.substream("beacon_churn")
        codes = [self.beacons.region_code(r) for r in self.regions] \
            or list(self.beacons.replicas)
        for code in sorted(codes):
            self._schedule_failure(code, rng)

    def _schedule_failure(self, code: int, rng):
        self.sim.after(float(rng.exponential(self.mttf)),
                       self._fail, code, rng)

    def _fail(self, code: int, rng):
        rep = self.beacons.replicas.get(code)
        if rep is None:
            return
        if not rep.alive:
            # failed manually in the meantime: skip this cycle but keep
            # the region's churn process alive (a silent early return
            # would end its churn for the rest of the run)
            self._schedule_failure(code, rng)
            return
        if self.spare_last and len(self.beacons.live_regions()) <= 1:
            self._schedule_failure(code, rng)   # skip: last Beacon standing
            return
        self.beacons.fail(code)
        self.events.append({"t": self.sim.now, "kind": "beacon_fail",
                            "region": self.beacons.region_str(code)})
        self.sim.after(float(rng.exponential(self.mttr)),
                       self._recover, code, rng)

    def _recover(self, code: int, rng):
        rep = self.beacons.replicas.get(code)
        if rep is None:
            return
        if not rep.alive:                   # still down: our recovery
            self.beacons.recover(code)
            self.events.append({"t": self.sim.now, "kind": "beacon_recover",
                                "region": self.beacons.region_str(code)})
        # recovered manually or by us — either way the cycle continues
        self._schedule_failure(code, rng)


class PartitionChurnModel:
    """Stochastic split-brain: exponential partition/heal cycles per
    Beacon fault domain, the network-cut analogue of
    ``BeaconChurnModel``'s replica crashes.

    Runs on the ``sim.substream("partition_churn")`` RNG stream so
    enabling it never shifts data-plane jitter draws.  With
    ``spare_majority`` (default) a cut that would leave no live
    majority-side Beacon is skipped and rescheduled — ``BeaconSet``
    rejects such cuts anyway, and churn should never abort a run.  Each
    partition heals after an exponential ``heal_ms`` unless the replica
    failed or was healed manually meanwhile (the group-id check makes
    the heal idempotent against manual interference)."""

    def __init__(self, sim: Simulator, beacon_set, *,
                 mtbp_ms: float = 600_000.0, heal_ms: float = 30_000.0,
                 spare_majority: bool = True, regions: tuple = ()):
        self.sim = sim
        self.beacons = beacon_set
        self.mtbp = mtbp_ms                 # mean time between partitions
        self.heal = heal_ms
        self.spare_majority = spare_majority
        self.regions = tuple(regions)       # default: every known domain
        self.events: List[dict] = []

    def start(self):
        rng = self.sim.substream("partition_churn")
        codes = [self.beacons.region_code(r) for r in self.regions] \
            or list(self.beacons.replicas)
        for code in sorted(codes):
            self._schedule_cut(code, rng)

    def _schedule_cut(self, code: int, rng):
        self.sim.after(float(rng.exponential(self.mtbp)),
                       self._cut, code, rng)

    def _live_majority_without(self, code: int) -> int:
        return sum(1 for c in self.beacons.live_regions()
                   if c != code and c not in self.beacons.partition_of)

    def _cut(self, code: int, rng):
        b = self.beacons
        rep = b.replicas.get(code)
        if rep is None:
            return
        if (not rep.alive or code in b.partition_of
                or (self.spare_majority
                    and self._live_majority_without(code) < 1)):
            # dead, already cut, or would empty the majority: skip this
            # cycle but keep the region's churn process alive
            self._schedule_cut(code, rng)
            return
        gid = b.partition(code)
        self.events.append({"t": self.sim.now, "kind": "partition",
                            "region": b.region_str(code), "group": gid})
        self.sim.after(float(rng.exponential(self.heal)),
                       self._heal, code, gid, rng)

    def _heal(self, code: int, gid: int, rng):
        b = self.beacons
        if b.partition_of.get(code) == gid and code not in b._heal_pending:
            b.heal(code)
            self.events.append({"t": self.sim.now, "kind": "heal",
                                "region": b.region_str(code)})
        # else: replica died (partition collapsed) or healed manually
        self._schedule_cut(code, rng)


def data_locality_policy(cargo_manager, service_id: str,
                         topo, weight: float = 0.3) -> SchedulePolicy:
    """Paper §3.3.1 'customized' policy: data-dependent workloads prefer
    Captains near the service's Cargo replicas (pairs with
    CargoManager.cargo_discover on the read path)."""
    def score(captain, ctx) -> float:
        reps = [c for c in cargo_manager.placements.get(service_id, ())
                if c.alive]
        if not reps:
            return 0.5
        best = min(topo.rtt(captain.node_id, c.node_id) for c in reps)
        return 1.0 / (1.0 + best / 20.0)
    return SchedulePolicy("data_locality", score, weight)
