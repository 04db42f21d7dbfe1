"""Application Manager (paper §3.2): service lifecycle, the candidate-list
half of 2-step selection (Algorithm 1), and demand-driven auto-scaling.

Selection runs through the batched ``SelectionEngine``
(``repro_torch.core.selection``): ``candidate_list`` keeps the single-user API,
``candidate_lists`` scores a whole user batch against the replica set in
one vectorized pass (exposed as ``Beacon.query_service_batch``).

Auto-scaling: 3 replicas at deploy time (fault-tolerance floor), then more
wherever real users concentrate — the AM groups active users by reduced-
precision geohash (batch Morton encoding, one pass over all users) and
asks Spinner for capacity in overloaded regions.  One *global* autoscale
tick batches the capacity probe across every deployed service (a single
Morton pass over all users of all services) and plans multi-replica
spawns per overloaded region in one pass, instead of one task per tick
per region per service.

User tracking accepts both scalar ``Client`` objects and vectorized
``ClientPool``s: anything exposing ``active_locs() -> (k, 2) ndarray``
contributes its whole population to the demand grouping.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import geohash
from repro_torch.core.cluster import Topology
from repro_torch.core.selection import SelectionEngine
from repro_torch.core.sim import Simulator
from repro_torch.core.spinner import Image, Spinner

REGION_PRECISION = 3            # coarse geohash cells for autoscale grouping
MAX_SPAWN_PER_REGION = 3        # multi-replica planning cap per tick


@dataclass
class ServiceSpec:
    service_id: str
    image: Image
    workload_scale: float = 1.0            # × node per-frame reference time
    locations: List[Tuple[float, float]] = field(default_factory=list)
    need_storage: bool = False
    storage_capacity_mb: float = 100.0
    consistency: str = "eventual"          # "strong" | "eventual"
    data_source: str = "Cloud"
    min_replicas: int = 3


@dataclass
class Task:
    task_id: str
    service_id: str
    captain: Optional[object] = None
    status: str = "pending"
    ready_at: Optional[float] = None


class ApplicationManager:
    def __init__(self, sim: Simulator, topo: Topology, spinner: Spinner,
                 cargo_manager=None, *, top_n: int = 3,
                 scale_check_s: float = 2.0,
                 overload_ratio: float = 1.5,
                 shard_precision: Optional[int] = None,
                 device="cuda"):
        self.sim = sim
        self.topo = topo
        self.spinner = spinner
        self.cargo_manager = cargo_manager
        self.top_n = top_n
        self.scale_check_s = scale_check_s
        self.overload_ratio = overload_ratio
        self.services: Dict[str, ServiceSpec] = {}
        self.tasks: Dict[str, List[Task]] = {}
        self.users: Dict[str, List[object]] = {}
        self._ids = itertools.count()
        self.autoscale_enabled = True
        self.scale_events: List[dict] = []
        # shard_precision partitions selection state by coarse geohash
        # region (paper §3.1's per-region Beacon replicas); queries and
        # invalidations are routed per shard inside the engine; ``device``
        # is where the engine's geo_topk scoring runs
        self.engine = SelectionEngine(top_n=top_n,
                                      shard_precision=shard_precision,
                                      device=device)
        self._autoscale_scheduled = False

    # ----------------------------------------------------------- deployment

    def deploy_service(self, spec: ServiceSpec, selection: str = "armada"):
        self.services[spec.service_id] = spec
        self.tasks[spec.service_id] = []
        self.users[spec.service_id] = []
        locs = spec.locations or [next(iter(
            self.spinner.captains.values())).spec.loc]
        for i in range(spec.min_replicas):
            self._spawn_task(spec, locs[i % len(locs)], selection)
        if spec.need_storage and self.cargo_manager is not None:
            self.cargo_manager.store_register(spec)
        self._schedule_autoscale(spec.service_id)

    def _spawn_task(self, spec: ServiceSpec, location,
                    selection: str = "armada") -> Optional[Task]:
        task = Task(f"{spec.service_id}/t{next(self._ids)}", spec.service_id)
        # Beacon-scoped scheduling: a partitioned / dead fault domain's
        # captains are hidden from selection — keep autoscale from landing
        # replicas on nodes this Beacon group cannot reach.
        hidden = self.engine.hidden_nodes
        pf = (lambda c: c.node_id not in hidden) if hidden else None
        dt = self.spinner.deploy_task(task, spec.image, location,
                                      selection=selection,
                                      on_ready=self._task_ready,
                                      policy_filter=pf)
        if dt is None:
            return None
        self.tasks[spec.service_id].append(task)
        self.engine.invalidate(spec.service_id)
        return task

    def register_task(self, task: Task):
        """Out-of-band task insertion (cloud baseline replicas, benchmark
        fixtures): append to the service's task list AND route through
        engine invalidation, so device-resident ``packed_static`` caches
        rebuild for the affected region instead of relying on the lazy
        fingerprint check alone."""
        self.tasks.setdefault(task.service_id, []).append(task)
        self.engine.invalidate(task.service_id)

    def _task_ready(self, task: Task):
        self.sim.log("task_ready", task=task.task_id,
                     node=task.captain.node_id)
        # storage layer follows compute expansion (paper §3.4 auto-scaling)
        spec = self.services[task.service_id]
        if spec.need_storage and self.cargo_manager is not None:
            self.cargo_manager.on_new_task(spec, task)

    # ----------------------------------------------- service discovery (Alg 1)

    def candidate_list(self, service_id: str, user_loc, user_net: str,
                       top_n: Optional[int] = None) -> List[Task]:
        """Step 1 of 2-step selection: score nearby running replicas."""
        return self.engine.candidate_list(
            service_id, self.tasks.get(service_id, ()), user_loc, user_net,
            top_n=top_n)

    def candidate_lists(self, service_id: str, user_locs, user_nets,
                        top_n: Optional[int] = None) -> List[List[Task]]:
        """Batched Algorithm 1: one vectorized U×N scoring pass, per-user
        top-k.  ``user_nets`` may be a single net-type string."""
        return self.engine.candidate_lists(
            service_id, self.tasks.get(service_id, ()), user_locs,
            user_nets, top_n=top_n)

    def candidate_indices(self, service_id: str, user_locs, user_nets,
                          top_n: Optional[int] = None):
        """Index-space batched Algorithm 1: ``(U, k)`` int32 positions into
        ``self.tasks[service_id]``, padded with -1 (the ClientPool path —
        no Task-list materialization)."""
        return self.engine.candidate_indices(
            service_id, self.tasks.get(service_id, ()), user_locs,
            user_nets, top_n=top_n)

    # -------------------------------------------------------------- users

    def user_join(self, service_id: str, client):
        self.users[service_id].append(client)

    def user_leave(self, service_id: str, client):
        if client in self.users.get(service_id, ()):
            self.users[service_id].remove(client)

    # ---------------------------------------------------------- auto-scaling

    def _schedule_autoscale(self, service_id: Optional[str] = None):
        """One global tick covers every service (``service_id`` kept for
        API compatibility; the first deployment arms the loop)."""
        if self._autoscale_scheduled:
            return
        self._autoscale_scheduled = True
        self.sim.after(self.scale_check_s * 1000.0, self._autoscale_tick)

    def _autoscale_tick(self):
        self._autoscale_scheduled = False
        if not self.services:
            return
        if self.autoscale_enabled:
            self._autoscale_all()
        self._schedule_autoscale()

    def _capacity(self, tasks: List[Task]) -> int:
        seen, cap = set(), 0
        for t in tasks:
            if t.captain and t.captain.alive and t.status == "running" \
                    and t.captain.node_id not in seen:
                seen.add(t.captain.node_id)
                cap += t.captain.spec.slots
            elif t.status == "deploying":
                cap += 1                      # in-flight capacity
        return cap

    def _service_user_locs(self, service_id: str) -> np.ndarray:
        """(k, 2) locations of every active user of a service — scalar
        clients contribute one row, ClientPools their whole population."""
        parts = []
        for c in self.users.get(service_id, ()):
            if hasattr(c, "active_locs"):
                locs = c.active_locs()
                if len(locs):
                    parts.append(np.asarray(locs, np.float64))
            else:
                parts.append(np.asarray([c.loc], np.float64))
        if not parts:
            return np.empty((0, 2))
        return np.concatenate(parts, axis=0)

    def _autoscale_all(self):
        """Demand-driven scaling for ALL services in one batched pass.

        The capacity probe is batched across services: user locations of
        every service are Morton-encoded in one ``encode_batch`` call
        (likewise for placed tasks), then each overloaded (service,
        region) cell gets a multi-replica spawn plan — enough capacity to
        clear the overload ratio, capped at ``MAX_SPAWN_PER_REGION`` per
        tick so demand spikes can't stampede the scheduler.
        """
        sids, u_parts, t_parts, placed_by_sid = [], [], [], {}
        for sid in self.services:
            locs = self._service_user_locs(sid)
            if not len(locs):
                continue
            placed = [t for t in self.tasks[sid]
                      if t.captain is not None
                      and t.status in ("running", "deploying")]
            sids.append(sid)
            u_parts.append(locs)
            placed_by_sid[sid] = placed
            t_parts.append(np.asarray(
                [t.captain.spec.loc for t in placed], np.float64)
                if placed else np.empty((0, 2)))
        if not sids:
            return
        # ONE Morton pass over all users / all placed tasks of all services
        all_users = np.concatenate(u_parts, axis=0)
        all_tasks = np.concatenate(t_parts, axis=0)
        u_codes_all = geohash.encode_batch(all_users[:, 0], all_users[:, 1],
                                           REGION_PRECISION)
        t_codes_all = geohash.encode_batch(all_tasks[:, 0], all_tasks[:, 1],
                                           REGION_PRECISION)
        u_bounds = np.cumsum([0] + [len(p) for p in u_parts])
        t_bounds = np.cumsum([0] + [len(p) for p in t_parts])
        for i, sid in enumerate(sids):
            self._autoscale_service(
                sid, u_parts[i], u_codes_all[u_bounds[i]:u_bounds[i + 1]],
                placed_by_sid[sid],
                t_codes_all[t_bounds[i]:t_bounds[i + 1]])

    def _autoscale_service(self, service_id: str, user_locs: np.ndarray,
                           user_codes: np.ndarray, placed: List[Task],
                           t_codes: np.ndarray):
        spec = self.services[service_id]
        region_codes, first_seen, inverse, counts = np.unique(
            user_codes, return_index=True, return_inverse=True,
            return_counts=True)
        n_regions = len(region_codes)
        loc_sums = np.zeros((n_regions, 2))
        np.add.at(loc_sums, inverse, user_locs)
        code_to_region = {int(c): r for r, c in enumerate(region_codes)}
        task_buckets: List[List[Task]] = [[] for _ in region_codes]
        for t, tc in zip(placed, t_codes):
            r = code_to_region.get(int(tc))
            if r is not None:
                task_buckets[r].append(t)
        # visit regions in first-user order (the pre-refactor dict grouping
        # order), so spawn contention resolves exactly as before
        for r in np.argsort(first_seen, kind="stable"):
            code = region_codes[r]
            n_users = int(counts[r])
            cap = self._capacity(task_buckets[r]) or 1e-9
            if n_users / cap <= self.overload_ratio:
                continue
            # multi-replica plan: close the whole capacity deficit in one
            # pass (each spawned replica claims its node slot immediately,
            # so consecutive spawns spread across captains)
            deficit = int(np.ceil(n_users / self.overload_ratio - cap))
            n_spawn = max(1, min(deficit, MAX_SPAWN_PER_REGION))
            centroid = (float(loc_sums[r, 0]) / n_users,
                        float(loc_sums[r, 1]) / n_users)
            spawned = 0
            for _ in range(n_spawn):
                if self._spawn_task(spec, centroid) is None:
                    break
                spawned += 1
            if spawned:
                gh = geohash.code_to_str(int(code), REGION_PRECISION)
                self.scale_events.append(
                    {"t": self.sim.now, "service": service_id,
                     "region": gh, "users": n_users, "cap": cap,
                     "spawned": spawned})
                self.sim.log("autoscale_up", service=service_id,
                             region=gh, n=spawned)

    # ------------------------------------------------------------ shrink

    def scale_down(self, service_id: str):
        spec = self.services[service_id]
        tasks = [t for t in self.tasks[service_id] if t.status == "running"]
        if len(tasks) <= spec.min_replicas:
            return
        # only probe captains that are still alive — a failed captain's
        # queue is gone, so load() would report a bogus idle node — and
        # still Beacon-visible: a node whose fault domain's Beacon died
        # looks idle (its users handed off) but cannot be reached by the
        # control plane; reclaiming it would destroy the very replicas
        # the heartbeat replay is about to bring back
        hidden = self.engine.hidden_nodes
        idle = [t for t in tasks
                if t.captain is not None and t.captain.alive
                and t.captain.node_id not in hidden
                and t.captain.load() == 0]
        if idle:
            victim = idle[-1]
            self.spinner.cancel_task(victim)
            self.engine.invalidate(service_id)
            self.sim.log("autoscale_down", task=victim.task_id)
