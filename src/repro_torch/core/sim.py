"""Discrete-event simulator: virtual clock, event heap, seeded RNG.

The paper's experiments run 5-15 users against 3-7 nodes for minutes of
wall time; the simulator reproduces them in milliseconds, deterministically.
Latencies are virtual; the *compute* latencies are calibrated against real
jitted step times of the service models (benchmarks/bench_heterogeneity.py).
"""
from __future__ import annotations

import heapq
import itertools
import warnings
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np


@dataclass(order=True)
class _Event:
    time: float
    seq: int
    fn: Callable = field(compare=False)
    args: tuple = field(compare=False, default=())
    cancelled: bool = field(compare=False, default=False)


class Simulator:
    def __init__(self, seed: int = 0, trace_enabled: bool = True):
        self.now = 0.0
        self._heap: List[_Event] = []
        self._seq = itertools.count()
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self._substreams: Dict[str, np.random.Generator] = {}
        # large-scale runs (100k+ users) disable tracing so the trace list
        # doesn't grow without bound; benchmarks keep the default
        self.trace_enabled = trace_enabled
        self.trace: List[Dict[str, Any]] = []
        self.truncated = False          # last run() hit max_events

    # ------------------------------------------------------------- events

    def at(self, t: float, fn: Callable, *args) -> _Event:
        assert t >= self.now - 1e-9, (t, self.now)
        ev = _Event(t, next(self._seq), fn, args)
        heapq.heappush(self._heap, ev)
        return ev

    def after(self, dt: float, fn: Callable, *args) -> _Event:
        return self.at(self.now + dt, fn, *args)

    def cancel(self, ev: _Event):
        ev.cancelled = True

    def run(self, until: Optional[float] = None, max_events: int = 10_000_000):
        """Drain the heap up to ``until``.  Returns the event count and sets
        ``self.truncated`` when the run stopped at ``max_events`` with work
        still pending — a capped run must not be mistaken for a converged
        one (benchmarks read the flag; a warning is also emitted)."""
        n = 0
        self.truncated = False
        while self._heap and n < max_events:
            if until is not None and self._heap[0].time > until:
                break
            ev = heapq.heappop(self._heap)
            if ev.cancelled:
                continue
            self.now = ev.time
            ev.fn(*ev.args)
            n += 1
        if self._heap and n >= max_events and (
                until is None or self._heap[0].time <= until):
            self.truncated = True
            self.log("run_truncated", events=n,
                     pending=len(self._heap))
            warnings.warn(
                f"Simulator.run stopped at max_events={max_events} with "
                f"{len(self._heap)} events pending (t={self.now:.1f}) — "
                "results beyond this point are incomplete", RuntimeWarning,
                stacklevel=2)
        if until is not None:
            self.now = max(self.now, until)
        return n

    # -------------------------------------------------------------- trace

    def log(self, kind: str, **kw):
        if self.trace_enabled:
            self.trace.append({"t": self.now, "kind": kind, **kw})

    def jitter(self, base: float, frac: float = 0.1) -> float:
        """Multiplicative noise around ``base`` (deterministic via rng)."""
        return float(base * (1.0 + frac * self.rng.standard_normal()))

    def substream(self, name: str) -> np.random.Generator:
        """Named RNG stream forked deterministically from the seed.

        Control-plane injections (Beacon failures, heartbeat-replay
        stagger) draw here instead of ``self.rng`` so they never shift
        the data-plane jitter sequence — a run with an injected failure
        stays draw-for-draw comparable to the same run without it, and
        host/device tick runs that consume ``rng`` in pinned order stay
        in lockstep when failures are added."""
        gen = self._substreams.get(name)
        if gen is None:
            import zlib
            gen = np.random.default_rng(
                np.random.SeedSequence([self.seed & 0xFFFFFFFF,
                                        zlib.crc32(name.encode())]))
            self._substreams[name] = gen
        return gen

    def jitter_batch(self, base: np.ndarray, frac: float = 0.1) -> np.ndarray:
        """Vectorized ``jitter``: one draw per element, bit-identical to the
        same number of sequential ``jitter`` calls (numpy Generator fills
        arrays from the same bit stream), so batched senders stay on the
        scalar path's RNG sequence."""
        base = np.asarray(base, np.float64)
        return base * (1.0 + frac * self.rng.standard_normal(base.size)
                       .reshape(base.shape))
