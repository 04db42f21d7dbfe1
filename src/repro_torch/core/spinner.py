"""Spinner: the Armada scheduler / compute resource manager (paper §3.3.1).

Filter policies run sequentially (geo-proximity with adaptive radius,
resource availability); sorting policies combine via weighted scores
(resource-aware, Docker/weight-layer-aware, locality, custom).  After each
placement the un-selected candidates are told to PREFETCH the image layers
— the paper's trick for fast future auto-scaling (Fig. 9a).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core import geohash
from repro_torch.core.captain import Captain
from repro_torch.core.cluster import Topology
from repro_torch.core.sim import Simulator

PULL_BANDWIDTH_MBPS = 50.0         # layer pull throughput
CONTAINER_START_MS = 300.0
REGISTRATION_MS = 150.0            # lightweight Captain handshake (Fig. 9b)
K3S_REGISTRATION_MS = 350.0        # measured-in-paper comparisons
K8S_REGISTRATION_MS = 1070.0


@dataclass
class Image:
    image_id: str
    layers: List[Tuple[str, float]]          # (layer_id, size MB)

    @property
    def total_mb(self) -> float:
        return sum(mb for _, mb in self.layers)


@dataclass
class SchedulePolicy:
    name: str
    score: Callable[[Captain, dict], float]  # captain, context -> [0, 1]
    weight: float


class Spinner:
    def __init__(self, sim: Simulator, topo: Topology):
        self.sim = sim
        self.topo = topo
        self.captains: Dict[str, Captain] = {}
        self.policies: List[SchedulePolicy] = [
            SchedulePolicy("resource", self._score_resource, 0.4),
            SchedulePolicy("docker", self._score_docker, 0.3),
            SchedulePolicy("locality", self._score_locality, 0.3),
        ]
        self.prefetch_on_deploy = True
        self.deploy_log: List[dict] = []

    # --------------------------------------------------------- registration

    def captain_join(self, captain: Captain,
                     runtime: str = "armada") -> float:
        """Register a node; returns registration latency (Fig. 9b)."""
        base = {"armada": REGISTRATION_MS, "k3s": K3S_REGISTRATION_MS,
                "k8s": K8S_REGISTRATION_MS}[runtime]
        dt = self.sim.jitter(base, 0.1) + self.topo.rtt(
            captain.node_id, "Cloud") / 2
        captain.registered_at = self.sim.now + dt
        self.captains[captain.node_id] = captain
        self.sim.log("captain_join", node=captain.node_id, ms=dt)
        return dt

    def captain_update(self, node_id: str):
        pass                                   # heartbeats read on demand

    # ------------------------------------------------------------- policies

    @staticmethod
    def _score_resource(c: Captain, ctx: dict) -> float:
        # free *task slots* (placement) blended with live load (runtime)
        slot_free = max(0.0, 1.0 - len(c.tasks) / max(c.spec.slots, 1))
        return 0.6 * slot_free + 0.4 * c.free_fraction()

    @staticmethod
    def _score_docker(c: Captain, ctx: dict) -> float:
        image: Image = ctx["image"]
        if not image.layers:
            return 1.0
        have = sum(mb for lid, mb in image.layers if lid in c.spec.layers)
        return have / image.total_mb

    def _score_locality(self, c: Captain, ctx: dict) -> float:
        loc = ctx["location"]
        d = geohash.distance_km(c.spec.loc[0], c.spec.loc[1], loc[0], loc[1])
        return 1.0 / (1.0 + d / 10.0)

    def new_policy(self, policy: SchedulePolicy):
        self.policies.append(policy)

    # ------------------------------------------------------------ scheduling

    def _geo_filter(self, cands: List[Captain], loc,
                    radius_km: float = 30.0) -> List[Captain]:
        while True:
            hits = [c for c in cands if geohash.distance_km(
                c.spec.loc[0], c.spec.loc[1], loc[0], loc[1]) <= radius_km]
            if hits or radius_km > 50_000:
                return hits
            radius_km *= 2

    def select_captain(self, image: Image, location,
                       *, allow_busy: bool = True,
                       exclude: Tuple[str, ...] = (),
                       policy_filter: Optional[Callable] = None,
                       selection: str = "armada") -> Optional[Captain]:
        cands = [c for c in self.captains.values()
                 if c.alive and c.node_id not in exclude
                 and not c.spec.is_cloud]
        if policy_filter is not None:
            cands = [c for c in cands if policy_filter(c)]
        cands = self._geo_filter(cands, location)
        # resource filter: prefer captains with a free task slot
        with_slot = [c for c in cands if len(c.tasks) < c.spec.slots]
        cands = with_slot or (cands if allow_busy else [])
        if not cands:
            return None
        ctx = {"image": image, "location": location}
        if selection == "random":
            return cands[int(self.sim.rng.integers(len(cands)))]
        if selection == "anti-affinity":
            # avoid nodes already running this image's tasks
            empty = [c for c in cands if not c.tasks]
            pool = empty or cands
            return max(pool, key=lambda c: c.free_fraction())
        scored = [(sum(p.weight * p.score(c, ctx) for p in self.policies), c)
                  for c in cands]
        scored.sort(key=lambda x: -x[0])
        return scored[0][1]

    def deploy_task(self, task, image: Image, location,
                    selection: str = "armada",
                    on_ready: Optional[Callable] = None,
                    policy_filter: Optional[Callable] = None
                    ) -> Optional[float]:
        """Task_Deploy: place + pull + start. Returns deployment latency."""
        captain = self.select_captain(image, location, selection=selection,
                                      policy_filter=policy_filter)
        if captain is None:
            return None
        missing = sum(mb for lid, mb in image.layers
                      if lid not in captain.spec.layers)
        pull_ms = missing / PULL_BANDWIDTH_MBPS * 1000.0
        dt = self.sim.jitter(pull_ms + CONTAINER_START_MS, 0.05)
        task.captain = captain
        task.status = "deploying"
        captain.tasks[task.task_id] = task        # claim the slot now

        def _ready():
            if not captain.alive:
                task.status = "failed"
                captain.tasks.pop(task.task_id, None)
                return
            captain.spec.layers.update(l for l, _ in image.layers)
            task.status = "running"
            task.ready_at = self.sim.now
            if on_ready is not None:
                on_ready(task)

        self.sim.after(dt, _ready)
        self.deploy_log.append({
            "t": self.sim.now, "task": task.task_id,
            "node": captain.node_id, "ms": dt, "selection": selection,
            "pulled_mb": missing})
        if self.prefetch_on_deploy and selection == "armada":
            self._prefetch_losers(image, location, captain)
        return dt

    def _prefetch_losers(self, image: Image, location, winner: Captain):
        for c in self.captains.values():
            if c is winner or not c.alive or c.spec.is_cloud:
                continue
            missing = [l for l, _ in image.layers if l not in c.spec.layers]
            if not missing:
                continue
            mb = sum(m for l, m in image.layers if l in missing)
            self.sim.after(mb / PULL_BANDWIDTH_MBPS * 1000.0,
                           c.spec.layers.update, set(missing))

    def cancel_task(self, task):
        if task.captain is not None:
            task.captain.tasks.pop(task.task_id, None)
        task.status = "cancelled"
