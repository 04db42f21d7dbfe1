"""Cargo: an Armada edge storage node (paper §3.4.2).

Holds replicated key-value stores per service (face descriptors:
<ID 8 bytes, 128×8-byte vector>), serves reads/writes with network+lookup
latency, and propagates updates to its replica peers in a cascade.
Consistency:

* strong   — a write acks only after ALL replicas applied it (the
             synchronous fan-out makes loosely-coupled volunteers slow,
             Fig. 12b)
* eventual — a write acks after the local apply; propagation cascades
             asynchronously (Fig. 13)

Capacity accounting: ``used_mb`` tracks the *live* byte size of every
record in every store — provisioning, client writes, and replica
propagation all route through the same accounting, so the Cargo
Manager's placement filter ranks on what a volume actually holds, not
on its provision-time size.  When a write pushes ``used_mb`` past the
volume (``spec.storage_gb``), the manager-installed ``capacity_cb``
fires and eviction/migration takes over (``CargoManager``).

Load instrumentation for the in-situ data plane: every served read
folds its lookup service time into ``read_ema`` (the "measured read
EMA" the vectorized pool's per-user ``data_ms`` term consumes), and
fluid-transport pools charge their aggregated per-window read counts
through ``note_reads`` — ``read_rate`` (reads/s) is what lets hot
stores trigger storage auto-scaling the way hot Captains trigger
compute auto-scaling.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

from repro_torch.core.cluster import NodeSpec, Topology
from repro_torch.core.sim import Simulator

LOOKUP_MS = 2.0          # descriptor match against 1000-entry store
WRITE_MS = 1.5
RECORD_BYTES = 8 + 128 * 8
TIMEOUT_MS = 250.0       # client-side give-up on an unresponsive Cargo
READ_EMA_ALPHA = 0.3     # measured read-service-time fold
READ_RATE_ALPHA = 0.5    # per-window read-throughput fold
# utilization clamp for the effective read time: a drowned store reports
# at most 10x its base lookup, never a divide-by-zero blow-up
_UTIL_CAP = 0.9


def record_mb(key: str, value: bytes) -> float:
    """Live size of one store record: 8-byte ID + the value bytes."""
    return (8 + len(value)) / 1e6


class CargoUnavailableError(RuntimeError):
    """The addressed Cargo node is down: the request timed out.  Delivered
    to the caller's ``on_error`` callback (or signalled through ``on_done``
    when none was given) so Captains can retry against another replica
    from their ``cargo_discover`` candidate list instead of hanging."""


class Cargo:
    def __init__(self, sim: Simulator, topo: Topology, spec: NodeSpec):
        self.sim = sim
        self.topo = topo
        self.spec = spec
        self.node_id = spec.node_id
        self.alive = True
        self.stores: Dict[str, Dict[str, bytes]] = {}
        self.peers: Dict[str, List["Cargo"]] = {}     # per-service replicas
        self.used_mb: float = 0.0
        # measured read service time (EMA over served lookups) and read
        # throughput (reads/s, folded per fluid window) — the data-plane
        # inputs to ``CargoManager.data_ms_for_nodes`` / hot-store scaling
        self.read_ema: float = LOOKUP_MS
        self.read_rate: float = 0.0
        self.reads_total: int = 0
        # installed by ``CargoManager.cargo_join``: fired when a write or
        # propagation pushes ``used_mb`` past the volume capacity
        self.capacity_cb: Optional[Callable[["Cargo"], None]] = None

    # ------------------------------------------------------------- control

    @property
    def capacity_mb(self) -> float:
        return self.spec.storage_gb * 1024.0

    def provision(self, service_id: str, peers: List["Cargo"],
                  initial: Optional[Dict[str, bytes]] = None):
        old = self.stores.get(service_id)
        if old is not None:          # re-provision replaces, not stacks
            self.used_mb -= sum(record_mb(k, v) for k, v in old.items())
        store = dict(initial or {})
        self.stores[service_id] = store
        self.peers[service_id] = [p for p in peers if p is not self]
        self.used_mb += sum(record_mb(k, v) for k, v in store.items())

    def drop_store(self, service_id: str):
        """Evict a whole store (capacity migration): accounting shrinks
        with the dropped records."""
        store = self.stores.pop(service_id, None)
        if store is not None:
            self.used_mb -= sum(record_mb(k, v) for k, v in store.items())
        self.peers.pop(service_id, None)

    def fail(self):
        self.alive = False
        self.sim.log("cargo_fail", node=self.node_id)

    # ------------------------------------------------------- accounting

    def stored_mb(self) -> float:
        """Recomputed live size of every record — the accounting
        invariant ``used_mb`` must track incrementally."""
        return sum(record_mb(k, v)
                   for s in self.stores.values() for k, v in s.items())

    def check_capacity_invariant(self):
        got = self.stored_mb()
        if abs(got - self.used_mb) > 1e-9:
            raise AssertionError(
                f"cargo {self.node_id}: used_mb={self.used_mb!r} has "
                f"drifted from the live store size {got!r}")

    def _put(self, service_id: str, key: str, value: bytes):
        """Apply one record (client write or replica propagation) WITH
        capacity accounting — the only mutation path for store content
        after provisioning."""
        store = self.stores.setdefault(service_id, {})
        old = store.get(key)
        store[key] = value
        self.used_mb += record_mb(key, value) \
            - (record_mb(key, old) if old is not None else 0.0)
        if self.capacity_cb is not None and self.used_mb > self.capacity_mb:
            self.capacity_cb(self)

    # ------------------------------------------------------ load signals

    def note_reads(self, n: float, window_ms: float):
        """Charge ``n`` fluid-transport reads over one ``window_ms``
        probe window (vectorized pools aggregate per tick instead of
        issuing per-request ``read`` events)."""
        if window_ms <= 0:
            return
        rate = n * 1e3 / window_ms
        self.read_rate = READ_RATE_ALPHA * rate \
            + (1 - READ_RATE_ALPHA) * self.read_rate
        self.reads_total += int(n)

    def effective_read_ms(self) -> float:
        """Measured read service time inflated by load: utilization
        ``rate * service_time`` stretches the lookup the way a busy
        single-server queue would, clamped at 10x."""
        util = min(self.read_rate * self.read_ema / 1e3, _UTIL_CAP)
        return self.read_ema / (1.0 - util)

    # ---------------------------------------------------------------- I/O

    def _timeout(self, t0: float, op: str, key: str, on_error, fallback):
        """Deliver an explicit dead-node failure after the client-side
        timeout: ``on_error(CargoUnavailableError)`` when the caller gave
        one, else ``fallback`` (a sentinel through ``on_done`` — the
        caller must never hang on a dead Cargo)."""
        def _fire():
            self.sim.log("cargo_timeout", node=self.node_id, op=op, key=key)
            if on_error is not None:
                on_error(CargoUnavailableError(
                    f"cargo {self.node_id} is down ({op} {key!r} timed "
                    f"out after {self.sim.now - t0:.1f} ms)"))
            else:
                fallback()
        self.sim.after(max(0.0, t0 + TIMEOUT_MS - self.sim.now), _fire)

    def read(self, service_id: str, key: str, requester_id: str,
             on_done: Callable, on_error: Optional[Callable] = None):
        """Latency = RTT + lookup.  on_done(value, ms).

        A dead Cargo (at request time or mid-flight) times out after
        ``TIMEOUT_MS``: ``on_error(CargoUnavailableError)`` when given,
        else ``on_done(None, ms)`` — never a silent hang."""
        rtt = self.sim.jitter(self.topo.rtt(requester_id, self.node_id), 0.08)
        t0 = self.sim.now

        def _fail():
            self._timeout(t0, "read", key, on_error,
                          lambda: on_done(None, self.sim.now - t0))

        if not self.alive:
            _fail()
            return

        lookup = self.sim.jitter(LOOKUP_MS, 0.2)

        def _lookup():
            if not self.alive:
                _fail()
                return
            val = self.stores.get(service_id, {}).get(key)
            # served: fold the measured service time + count the read
            self.read_ema = READ_EMA_ALPHA * lookup \
                + (1 - READ_EMA_ALPHA) * self.read_ema
            self.reads_total += 1
            self.sim.after(rtt / 2, lambda: on_done(val, self.sim.now - t0))

        self.sim.after(rtt / 2 + lookup, _lookup)

    def write(self, service_id: str, key: str, value: bytes,
              requester_id: str, consistency: str, on_done: Callable,
              on_error: Optional[Callable] = None):
        """Write + replicate.  on_done(ms).

        A dead Cargo times out after ``TIMEOUT_MS``:
        ``on_error(CargoUnavailableError)`` when given, else
        ``on_done(nan)`` (a nan latency marks the failed write) — never a
        silent hang."""
        rtt = self.sim.jitter(self.topo.rtt(requester_id, self.node_id), 0.08)
        t0 = self.sim.now

        def _fail():
            self._timeout(t0, "write", key, on_error,
                          lambda: on_done(float("nan")))

        if not self.alive:
            _fail()
            return

        def _apply():
            if not self.alive:
                _fail()
                return
            self._put(service_id, key, value)
            peers = [p for p in self.peers.get(service_id, ()) if p.alive]
            if consistency == "strong":
                if not peers:
                    self.sim.after(rtt / 2,
                                   lambda: on_done(self.sim.now - t0))
                    return
                pending = {"n": len(peers)}

                def _acked():
                    pending["n"] -= 1
                    if pending["n"] == 0:
                        self.sim.after(rtt / 2,
                                       lambda: on_done(self.sim.now - t0))

                for p in peers:
                    self._propagate(service_id, key, value, p, _acked)
            else:
                # eventual: ack now, cascade in the background
                self.sim.after(rtt / 2, lambda: on_done(self.sim.now - t0))
                if peers:
                    self._propagate(service_id, key, value, peers[0],
                                    lambda: None,
                                    cascade=peers[1:])

        self.sim.after(rtt / 2 + self.sim.jitter(WRITE_MS, 0.2), _apply)

    def _propagate(self, service_id: str, key: str, value: bytes,
                   peer: "Cargo", on_acked: Callable,
                   cascade: Optional[List["Cargo"]] = None):
        hop = self.sim.jitter(self.topo.rtt(self.node_id, peer.node_id), 0.1)

        def _arrive():
            if not peer.alive:
                # skip the dead replica but keep cascading from here —
                # returning without forwarding used to orphan every
                # replica downstream of one dead peer
                if cascade:
                    self._propagate(service_id, key, value, cascade[0],
                                    lambda: None, cascade=cascade[1:])
                on_acked()
                return
            peer._put(service_id, key, value)
            if cascade:
                peer._propagate(service_id, key, value, cascade[0],
                                lambda: None, cascade=cascade[1:])
            on_acked()

        self.sim.after(hop + self.sim.jitter(WRITE_MS, 0.2), _arrive)
