"""Captain: an Armada edge compute node (paper §3.3.2).

Hosts service replicas (tasks), processes offloaded frames through a
``slots``-server queue, reports load/layers via heartbeats, and notifies
warm-connected clients on failure (the multi-connection strategy's break
signal).  Per-request processing time comes from the captain's
serving profile (``request_ms`` — the served model's calibrated
frame/decode time × node speed × service workload scale × jitter; the
port has no serving plane yet, so profiles are duck-typed objects with
that interface); nodes without an attached profile
keep the historical synthetic draw ``spec.proc_ms × scale`` exactly.
Heartbeats additionally carry serving occupancy, the expected queueing
delay (consumed by SelectionEngine's queueing-aware load term), and the
real-mode measured decode EMA.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.cluster import NodeSpec, Topology
from repro_torch.core.sim import Simulator


@dataclass
class Request:
    client: "object"              # repro_torch.core.client.Client / ClientPool
    task_id: str
    sent_at: float
    rtt: float
    node_id: str = ""
    proc_scale: float = 1.0
    is_probe: bool = False
    on_done: Optional[Callable] = None
    storage_ops: int = 0          # cargo reads/writes piggybacked (facerec)
    user_ix: int = -1             # pool user index (events transport)


class ConnectionSet:
    """Insertion-ordered set of warm connections.

    Failure notifications draw RNG (the failover frame's jitter), so their
    order must be deterministic and reproducible across processes — a plain
    ``set`` of client objects iterates in id()-hash order, which varies
    run to run.  Backing the set with a dict preserves the order clients
    opened their connections, which is also the order the vectorized
    ``ClientPool`` replays them in.
    """

    def __init__(self):
        self._d: Dict[object, None] = {}

    def add(self, obj):
        self._d[obj] = None

    def discard(self, obj):
        self._d.pop(obj, None)

    def clear(self):
        self._d.clear()

    def __iter__(self):
        return iter(self._d)

    def __len__(self):
        return len(self._d)

    def __contains__(self, obj):
        return obj in self._d


class Captain:
    def __init__(self, sim: Simulator, topo: Topology, spec: NodeSpec):
        self.sim = sim
        self.topo = topo
        self.spec = spec
        self.node_id = spec.node_id
        self.alive = True
        self.tasks: Dict[str, "object"] = {}         # task_id -> Task
        # serving profile (ServingProfile interface) — the
        # latency model behind this node.  None = synthetic: request time
        # is spec.proc_ms, read live so topology-level proc_ms rescaling
        # keeps working
        self.profile = spec.profile
        self.connections = ConnectionSet()
        self.queue: List[Request] = []
        self.busy = 0
        self.processed = 0
        self.registered_at: Optional[float] = None
        # fluid data plane (ClientPool batched transport): pending work in
        # proc-milliseconds, drained at ``slots`` work-ms per wall-ms
        self.fluid_work = 0.0
        self.fluid_updated = 0.0

    # ------------------------------------------------------------- status

    def request_ms(self, proc_scale: float = 1.0) -> float:
        """Effective per-request service time (ms) through the serving
        profile — ``spec.proc_ms * proc_scale`` when no profile is
        attached.  Linear in ``proc_scale`` by contract: the fused
        device tick bakes ``request_ms(1.0)`` into a static per-node
        scalar and multiplies by the workload scale on device."""
        if self.profile is None:
            return self.spec.proc_ms * proc_scale
        return self.profile.request_ms(proc_scale)

    def load(self) -> float:
        return (self.busy + len(self.queue) + self._fluid_requests()) \
            / max(self.spec.slots, 1)

    def free_fraction(self) -> float:
        return max(0.0, 1.0 - self.load())

    def queueing_delay_ms(self) -> float:
        """Expected wait (ms) for a request arriving now: backlog ahead
        of it (events queue + lazily-drained fluid work) over the node's
        drain capacity.  Unlike ``free_fraction`` — which clamps at 0
        once the backlog exceeds the slot count — this keeps growing
        with the backlog, so the selection engine's queueing-aware load
        term can tell a slightly-busy node from a drowning one."""
        unit = self.request_ms()
        work = (len(self.queue) + self._fluid_requests()) * unit
        return work / max(self.spec.slots, 1)

    def heartbeat(self) -> Dict:
        p = self.profile
        return {"node": self.node_id, "load": self.load(),
                "layers": set(self.spec.layers), "alive": self.alive,
                "tasks": list(self.tasks),
                # serving-aware data plane: occupancy + expected queueing
                # delay feed the engine's queueing-aware scoring;
                # decode_ms surfaces the real-mode measured decode/frame
                # EMA (None for surrogate/synthetic nodes)
                "model": p.model_id if p is not None else "synthetic",
                "occupancy": min(1.0, self.load()),
                "queue_ms": self.queueing_delay_ms(),
                "decode_ms": p.measured_ms() if p is not None else None}

    # ------------------------------------------------------------ serving

    def arrive(self, req: Request):
        if not self.alive:
            return                       # connection break handles clients
        if self.busy < self.spec.slots:
            self._start(req)
        else:
            self.queue.append(req)

    def _start(self, req: Request):
        self.busy += 1
        proc = self.sim.jitter(self.request_ms(req.proc_scale), 0.06)
        self.sim.after(max(proc, 0.1), self._finish, req)

    def _finish(self, req: Request):
        if not self.alive:
            return
        self.busy -= 1
        self.processed += 1
        if self.queue:
            self._start(self.queue.pop(0))
        back = self.sim.jitter(req.rtt / 2, 0.08)
        if req.on_done is not None:
            self.sim.after(back, req.on_done, req)

    # ----------------------------------------------- fluid batched serving

    def _fluid_requests(self) -> float:
        """Fluid backlog expressed in request-equivalents (for ``load``).

        Read-only lazy drain: a node that stopped receiving batches must
        not report its last committed backlog forever (selection would
        deprioritize it permanently and ``scale_down`` could never reclaim
        it)."""
        if self.fluid_work <= 0.0:
            return 0.0
        dt = self.sim.now - self.fluid_updated
        work = self.fluid_work - self.spec.slots * dt if dt > 0 \
            else self.fluid_work
        return max(0.0, work) / max(self.request_ms(), 1e-9)

    def drain_fluid(self, now: float):
        """Lazily drain the fluid backlog up to ``now`` (capacity =
        ``slots`` work-ms per wall-ms).  ``fluid_updated`` never moves
        backwards — capacity already credited to a committed window must
        not be credited again by a second batch in the same window."""
        dt = now - self.fluid_updated
        if dt > 0:
            self.fluid_work = max(
                0.0, self.fluid_work - self.spec.slots * dt)
            self.fluid_updated = now

    def arrive_batch(self, n_requests: float, proc_scale: float,
                     window_ms: float, now: float
                     ) -> Tuple[float, float, float]:
        """Admit a tick's worth of pool traffic as fluid work.

        ``n_requests`` requests of ``request_ms(proc_scale)`` work each,
        uniformly spread over ``[now, now + window_ms)``.  Returns
        ``(work0, in_rate, cap_rate)`` — the backlog at window start (ms of
        work), the arrival work rate, and the drain rate — from which the
        caller computes per-request queueing delays vectorized:
        ``wait(tau) = max(0, work0 + (in_rate - cap_rate) * tau) / slots``.

        The terminal backlog is committed immediately, and drain capacity
        is credited only for wall-time not yet accounted — overlapping
        batches from several pools stack their work without double-counting
        the node's capacity over the shared window.
        """
        self.drain_fluid(now)
        work0 = self.fluid_work
        work_in = n_requests * self.request_ms() * proc_scale
        cap_rate = float(self.spec.slots)
        in_rate = work_in / max(window_ms, 1e-9)
        end = now + window_ms
        credit = max(0.0, end - max(self.fluid_updated, now))
        self.fluid_work = max(0.0, work0 + work_in - cap_rate * credit)
        self.fluid_updated = max(self.fluid_updated, end)
        self.processed += int(n_requests)
        return work0, in_rate, cap_rate

    # ------------------------------------------------------------ failure

    def fail(self):
        """Node churn: volunteer leaves / crashes. Warm connections break
        immediately (the paper's zero-downtime switch signal)."""
        if not self.alive:
            return
        self.alive = False
        self.queue.clear()
        self.busy = 0
        self.fluid_work = 0.0
        self.sim.log("node_fail", node=self.node_id)
        for client in list(self.connections):
            self.sim.after(0.1, client.on_connection_break, self.node_id)
        self.connections.clear()

    def recover(self):
        self.alive = True
        self.sim.log("node_recover", node=self.node_id)
