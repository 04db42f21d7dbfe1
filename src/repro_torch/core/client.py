"""Armada client SDK (paper §4): 2-step selection + multi-connection FT.

Step 2 of service selection happens HERE: the client probes every candidate
with a real (small) request and keeps an EMA of end-to-end latency per
candidate.  The best candidate serves the workload; probing repeats
periodically and asynchronously, so overload and churn show up in the EMAs
and trigger switches.  All TopN connections stay warm — on a connection
break the client flips to the second-best candidate with zero downtime.

``mode`` selects the paper's baselines:
  armada      2-step selection + probing + failover (the system)
  geo         always the geographically closest node
  dedicated   dedicated nodes only (D6/A/B/C), probing within them
  cloud       cloud only
  reconnect   armada selection, but on failure waits + re-queries (Fig 10a)
  edge2cloud  armada selection, but fails over to cloud (Fig 10b)

Scalar-vs-pool responsibility map
---------------------------------
This class drives ONE user through per-request simulator events; the
population-scale path is ``repro_torch.core.client_pool.ClientPool`` (SoA
arrays, one selection call + one vectorized EMA/switch update per tick).
The *policy* — what to probe, when to switch, where to fail over — lives
in ``client_pool``'s pure array functions and is shared by both:

  =====================  ==========================  ====================
  concern                scalar ``Client``           ``ClientPool``
  =====================  ==========================  ====================
  event loop             per-user heap events        pool-level tick
  wide-list size         ``WIDE_TOP_N`` (shared)     ``WIDE_TOP_N``
  baseline filters       ``mode_filter`` (U=1 row)   ``mode_filter``
  latency EMAs           ``ema_fold`` (U=1 row)      ``ema_fold`` batched
  two-round switches     ``switch_decide`` (U=1)     ``switch_decide``
  break failover         inline (this file)          ``failover_pick``
  transport              ``Captain.arrive``          events | fluid batch
  =====================  ==========================  ====================

A pool with ``transport="events"`` reproduces U scalar Clients
bit-for-bit (tests/test_client_pool.py); keep this class as the readable
reference and parity oracle.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.app_manager import ApplicationManager, Task
from repro_torch.core.captain import Request
from repro_torch.core.client_pool import (LatencySample, MODE_INDEX,
                                    RECONNECT_DELAY_MS, WIDE_TOP_N,
                                    ema_fold, mode_filter, switch_decide)
from repro_torch.core.cluster import Topology
from repro_torch.core.sim import Simulator


class Client:
    def __init__(self, sim: Simulator, topo: Topology,
                 am: ApplicationManager, client_id: str, service_id: str,
                 *, mode: str = "armada", frame_interval_ms: float = 0.0,
                 probe_period_ms: float = 2000.0, ema_alpha: float = 0.4,
                 switch_margin: float = 0.95, workload_scale: float = 1.0,
                 proc_scale_override: Optional[float] = None):
        self.sim = sim
        self.topo = topo
        self.am = am
        self.client_id = client_id
        self.service_id = service_id
        self.mode = mode
        self.loc = topo.nodes[client_id].loc
        self.net = topo.nodes[client_id].net_type
        self.frame_interval = frame_interval_ms
        self.probe_period = probe_period_ms
        self.alpha = ema_alpha
        self.switch_margin = switch_margin
        self.workload_scale = workload_scale

        self.candidates: List[Task] = []
        self.ema: Dict[str, float] = {}
        self.active: Optional[Task] = None
        self.running = False
        self.samples: List[LatencySample] = []
        self.switches: List[dict] = []
        self.downtime_until = 0.0
        self._pending_switch: Optional[Task] = None  # two-round confirmation

    # ------------------------------------------------------------- control

    def start(self):
        self.running = True
        self.am.user_join(self.service_id, self)
        self._refresh_candidates(initial=True)

    def stop(self):
        self.running = False
        self.am.user_leave(self.service_id, self)
        for t in self.candidates:
            if t.captain is not None:
                t.captain.connections.discard(self)

    # -------------------------------------------------- candidate handling

    def _task_node(self, t: Task) -> str:
        return t.captain.node_id

    def _refresh_candidates(self, initial: bool = False):
        if not self.running:
            return
        # mode baselines filter the WIDE list, then trim to TopN — otherwise
        # a "dedicated-only" client would leak onto volunteer nodes
        wide = self.am.candidate_list(self.service_id, self.loc, self.net,
                                      top_n=WIDE_TOP_N)
        cands = self._apply_mode_filter(wide)[:self.am.top_n]
        # keep warm connections to every candidate
        for t in self.candidates:
            if t not in cands and t.captain is not None:
                t.captain.connections.discard(self)
        for t in cands:
            if t.captain is not None:
                t.captain.connections.add(self)
        self.candidates = cands
        if not cands:
            self.sim.after(500.0, self._refresh_candidates)
            return
        # step 2: probe every candidate
        for t in cands:
            self._send(t, is_probe=True)
        if initial:
            # pick provisional best by RTT until probes return
            self.active = min(
                cands, key=lambda t: self.topo.rtt(self.client_id,
                                                   self._task_node(t)))
            self._send_frame()
            self.sim.after(self.probe_period, self._probe_tick)

    def _apply_mode_filter(self, cands: List[Task]) -> List[Task]:
        """Baseline filter over the wide list — the shared ``mode_filter``
        array policy applied to a single-user row."""
        if not cands:
            return list(cands)
        out = mode_filter(
            np.arange(len(cands), dtype=np.int32)[None, :],
            np.array([MODE_INDEX.get(self.mode, MODE_INDEX["armada"])],
                     np.int8),
            len(cands),
            np.array([t.captain.spec.is_cloud for t in cands]),
            np.array([t.captain.spec.dedicated for t in cands]),
            np.array([t.captain.spec.loc[0] for t in cands]),
            np.array([t.captain.spec.loc[1] for t in cands]),
            np.array([self.loc[0]]), np.array([self.loc[1]]))
        return [cands[j] for j in out[0] if j >= 0]

    def _probe_tick(self):
        if not self.running:
            return
        self._refresh_candidates()
        self._maybe_switch()
        self.sim.after(self.probe_period, self._probe_tick)

    def _maybe_switch(self):
        """Switch to a better candidate only when the pending nomination
        still beats the active EMA by the margin one probe round later —
        damps the herd oscillation naive probing causes after mass
        failures without starving when the candidate list churns.
        Decision logic is the shared ``switch_decide`` array policy on a
        U=1 row; the pending target's EMA/liveness are looked up directly
        so it confirms even after dropping off the candidate list."""
        if not self.candidates:
            return
        cands = self.candidates
        nodes = [self._task_node(t) for t in cands]
        cur = None if self.active is None else self._task_node(self.active)
        # slot ids stand in for task identity; active/pending tasks
        # outside the candidate list get sentinel ids no slot can equal
        try:
            a_ix = next(i for i, t in enumerate(cands) if t is self.active)
        except StopIteration:
            a_ix = -1 if self.active is None else len(cands)
        p = self._pending_switch
        try:
            p_ix = -1 if p is None else next(
                i for i, t in enumerate(cands) if t is p)
        except StopIteration:
            p_ix = len(cands) + 1
        pend_ema = (np.nan if p is None
                    else self.ema.get(self._task_node(p), np.nan))
        pend_alive = (p is not None and p.captain is not None
                      and p.captain.alive)
        confirm, target, new_pending = switch_decide(
            np.arange(len(nodes), dtype=np.int64)[None, :],
            np.array([[self.ema.get(n, np.nan) for n in nodes]]),
            np.array([a_ix]),
            np.array([np.nan if cur is None
                      else self.ema.get(cur, np.nan)]),
            np.array([p_ix]), np.array([pend_ema]),
            np.array([pend_alive]), self.switch_margin)
        np_ix = int(new_pending[0])
        self._pending_switch = (None if np_ix < 0
                                else cands[np_ix] if np_ix < len(cands)
                                else p)
        if confirm[0]:
            t_ix = int(target[0])
            best = cands[t_ix] if t_ix < len(cands) else p
            self.switches.append({"t": self.sim.now, "from": cur,
                                  "to": self._task_node(best)})
            self.active = best

    # ------------------------------------------------------------ traffic

    def _send(self, task: Task, is_probe: bool):
        if task.captain is None or not task.captain.alive:
            return
        node = task.captain.node_id
        rtt = self.sim.jitter(self.topo.rtt(self.client_id, node), 0.08)
        req = Request(client=self, task_id=task.task_id,
                      sent_at=self.sim.now, rtt=rtt, node_id=node,
                      proc_scale=self.workload_scale, is_probe=is_probe,
                      on_done=self._on_response)
        self.sim.after(rtt / 2, task.captain.arrive, req)

    def _send_frame(self):
        if not self.running or self.active is None:
            return
        self._send(self.active, is_probe=False)

    def _on_response(self, req: Request):
        if not self.running:
            return
        ms = self.sim.now - req.sent_at
        node = req.node_id
        prev = self.ema.get(node, np.nan)
        self.ema[node] = float(ema_fold(
            np.array([prev]), np.array([ms]), self.alpha)[0])
        if req.is_probe:
            self.samples.append(LatencySample(self.sim.now, ms, node, True))
            return
        self.samples.append(LatencySample(self.sim.now, ms, node))
        if self.frame_interval > 0:
            self.sim.after(self.frame_interval, self._send_frame)
        else:
            self._send_frame()

    # ------------------------------------------------------- fault handling

    def on_connection_break(self, node_id: str):
        """A warm connection broke (node failed/left)."""
        if not self.running:
            return
        self.ema.pop(node_id, None)
        dead = [t for t in self.candidates
                if t.captain is None or not t.captain.alive]
        for t in dead:
            self.candidates.remove(t)
        active_died = (self.active is None or self.active.captain is None
                       or not self.active.captain.alive)
        if not active_died:
            return
        if self.mode == "reconnect":
            # baseline: tear down, wait, re-query the control plane
            self.active = None
            self.downtime_until = self.sim.now + RECONNECT_DELAY_MS

            def _reconnect():
                self._refresh_candidates()
                if self.candidates:
                    self.active = self.candidates[0]
                    self._send_frame()
            self.sim.after(RECONNECT_DELAY_MS, _reconnect)
            return
        if self.mode == "edge2cloud":
            cloud = [t for t in self.am.tasks[self.service_id]
                     if t.status == "running" and t.captain is not None
                     and t.captain.spec.is_cloud]
            if cloud:
                self.active = cloud[0]
                cloud[0].captain.connections.add(self)
                self._send_frame()
                return
        # armada: instant switch to the best remaining warm candidate
        if self.candidates:
            known = [t for t in self.candidates
                     if self._task_node(t) in self.ema]
            self.active = min(
                known, key=lambda t: self.ema[self._task_node(t)]) \
                if known else self.candidates[0]
            self._send_frame()            # zero downtime: next frame flows
        else:
            self._refresh_candidates(initial=True)

    # ------------------------------------------------------------- metrics

    def mean_latency(self, since: float = 0.0) -> float:
        xs = [s.ms for s in self.samples if not s.is_probe and s.t >= since]
        return sum(xs) / len(xs) if xs else float("nan")
