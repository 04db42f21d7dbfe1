"""Cluster topology: node specs, network model, and the paper's testbeds.

``real_world()`` reproduces Table 5(a)/6(a): five volunteer nodes V1-V5
around campus, one dedicated 4-slot server D6, and AWS us-east as Cloud.
``emulation()`` reproduces Table 5(b)/6(b): nodes A/B/C in three cities
100-150 miles apart.  Pairwise base RTTs are set so the paper's end-to-end
tables fall out (e2e = RTT + queue + processing); jitter is added by the
simulator at request time.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------


@dataclass
class NodeSpec:
    node_id: str
    loc: Tuple[float, float]                    # (lat, lon)
    proc_ms: float                              # per-frame on the ref model
    slots: int = 1                              # parallel service replicas
    dedicated: bool = False
    net_type: str = "wifi"                      # wifi | ethernet | lte
    storage_gb: float = 2.0
    layers: set = field(default_factory=set)    # artifact chunks present
    is_cloud: bool = False
    # served-model latency profile (any object with the ServingProfile
    # interface; the port has no serving plane yet) — None = synthetic
    # node whose per-request time is proc_ms exactly
    profile: Optional[object] = None


@dataclass
class Topology:
    nodes: Dict[str, NodeSpec]
    rtt_base: Dict[Tuple[str, str], float]      # one-way pairs (sym applied)
    default_rtt: float = 30.0

    def rtt(self, a: str, b: str) -> float:
        if a == b:
            return 0.5
        return self.rtt_base.get((a, b),
                                 self.rtt_base.get((b, a), self.default_rtt))

    def add_endpoint(self, node_id: str, loc, rtts: Dict[str, float],
                     net_type: str = "wifi"):
        """Register a user endpoint (no compute) with explicit RTTs."""
        self.nodes[node_id] = NodeSpec(node_id, loc, proc_ms=0.0,
                                       net_type=net_type)
        for other, ms in rtts.items():
            self.rtt_base[(node_id, other)] = ms


# ---------------------------------------------------------------------------
# Paper testbeds
# ---------------------------------------------------------------------------

_CAMPUS = (44.9740, -93.2277)                   # UMN
_US_EAST = (39.0438, -77.4874)


def _near(base, dlat, dlon):
    return (base[0] + dlat, base[1] + dlon)


def real_world() -> Topology:
    """Table 5(a): V1-V5 volunteers (<5 mi), D6 dedicated (4 slots), Cloud."""
    nodes = {
        "V1": NodeSpec("V1", _near(_CAMPUS, 0.020, 0.010), 24.0),
        "V2": NodeSpec("V2", _near(_CAMPUS, -0.030, 0.020), 32.0),
        "V3": NodeSpec("V3", _near(_CAMPUS, 0.010, -0.040), 31.0),
        "V4": NodeSpec("V4", _near(_CAMPUS, -0.050, -0.030), 45.0),
        "V5": NodeSpec("V5", _near(_CAMPUS, 0.060, 0.040), 49.0),
        "D6": NodeSpec("D6", _CAMPUS, 30.0, slots=4, dedicated=True,
                       net_type="ethernet"),
        "Cloud": NodeSpec("Cloud", _US_EAST, 34.0, slots=64, dedicated=True,
                          net_type="ethernet", is_cloud=True,
                          storage_gb=1000.0),
    }
    # Base one-way RTTs for the paper's three probe users (Table 6a minus
    # Table 5a processing times).
    rtt = {}
    table6a = {
        "C1": {"V1": 14, "V2": 15, "V3": 18, "V4": 20, "V5": 23, "D6": 12,
               "Cloud": 73},
        "C2": {"V1": 19, "V2": 3, "V3": 25, "V4": 13, "V5": 12, "D6": 14,
               "Cloud": 68},
        "C3": {"V1": 25, "V2": 18, "V3": 14, "V4": 14, "V5": 22, "D6": 12,
               "Cloud": 78},
    }
    topo = Topology(nodes, rtt)
    locs = {"C1": _near(_CAMPUS, 0.018, 0.012),
            "C2": _near(_CAMPUS, -0.028, 0.018),
            "C3": _near(_CAMPUS, 0.008, -0.036)}
    for cid, r in table6a.items():
        topo.add_endpoint(cid, locs[cid], r)
    # node-to-node RTTs (cargo reads/propagation, image prefetch).
    # Volunteer<->volunteer links ride residential uplinks (25-45 ms);
    # task-node->cargo rows are reverse-engineered from Table 7.
    rtt.update({
        ("V3", "V1"): 19.0, ("V3", "V2"): 23.0, ("V3", "D6"): 29.0,
        ("V4", "V1"): 21.0, ("V4", "V2"): 21.0, ("V4", "D6"): 31.0,
        ("V5", "V1"): 38.0, ("V5", "V2"): 36.0, ("V5", "D6"): 16.0,
        ("V1", "V2"): 32.0, ("V1", "D6"): 18.0, ("V2", "D6"): 20.0,
        ("V4", "V5"): 34.0, ("V3", "V4"): 30.0, ("V3", "V5"): 36.0,
        ("V1", "V5"): 38.0, ("V2", "V5"): 36.0, ("V2", "V4"): 28.0,
        ("V1", "V4"): 30.0, ("V2", "V3"): 23.0,
    })
    for v, ms in (("V1", 62.0), ("V2", 64.0), ("V3", 59.0), ("V4", 60.0),
                  ("V5", 58.0), ("D6", 56.0)):
        rtt[(v, "Cloud")] = ms
    return topo


def campus_users(topo: Topology, n: int, seed: int = 0) -> List[str]:
    """Recruit ``n`` heterogeneous users around campus (§6.3.1, 15 users)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    users = []
    for i in range(n):
        uid = f"U{i}"
        loc = _near(_CAMPUS, float(rng.uniform(-0.06, 0.06)),
                    float(rng.uniform(-0.06, 0.06)))
        rtts = {}
        for v in ("V1", "V2", "V3", "V4", "V5"):
            rtts[v] = float(rng.uniform(8, 28))
        rtts["D6"] = float(rng.uniform(8, 18))
        rtts["Cloud"] = float(rng.uniform(65, 95))
        topo.add_endpoint(uid, loc, rtts)
        users.append(uid)
    return users


_CITY_A = (44.9740, -93.2277)
_CITY_B = (44.0121, -92.4802)                   # ~100 mi
_CITY_C = (43.5391, -96.7311)                   # ~150 mi


def emulation() -> Topology:
    """Table 5(b)/6(b): cities A/B/C, users co-located with the nodes."""
    nodes = {
        "A": NodeSpec("A", _CITY_A, 23.0, slots=2, dedicated=True,
                      net_type="ethernet"),
        "B": NodeSpec("B", _CITY_B, 34.0, slots=1, dedicated=True,
                      net_type="ethernet"),
        "C": NodeSpec("C", _CITY_C, 58.0, slots=1, dedicated=True,
                      net_type="ethernet"),
        "Cloud": NodeSpec("Cloud", _US_EAST, 34.0, slots=64, dedicated=True,
                          net_type="ethernet", is_cloud=True,
                          storage_gb=1000.0),
    }
    rtt = {("A", "B"): 35.0, ("A", "C"): 38.0, ("B", "C"): 30.0,
           ("A", "Cloud"): 72.0, ("B", "Cloud"): 66.0, ("C", "Cloud"): 70.0}
    topo = Topology(nodes, rtt)
    table6b = {
        "User_A": {"A": 8, "B": 29, "C": 31, "Cloud": 74},
        "User_B": {"A": 40, "B": 13, "C": 25, "Cloud": 68},
        "User_C": {"A": 28, "B": 34, "C": 1, "Cloud": 77},
    }
    locs = {"User_A": _CITY_A, "User_B": _CITY_B, "User_C": _CITY_C}
    for uid, r in table6b.items():
        topo.add_endpoint(uid, locs[uid], r)
    return topo


def city_user(topo: Topology, city: str, ix: int) -> str:
    """Add another user at a given emulation city."""
    uid = f"User_{city}{ix}"
    base = {"A": {"A": 8, "B": 29, "C": 31, "Cloud": 74},
            "B": {"A": 40, "B": 13, "C": 25, "Cloud": 68},
            "C": {"A": 28, "B": 34, "C": 1, "Cloud": 77}}[city]
    locs = {"A": _CITY_A, "B": _CITY_B, "C": _CITY_C}
    topo.add_endpoint(uid, locs[city], dict(base))
    return uid
