"""Armada control plane: the paper's contribution (§2-§4).

Beacon (entry point) -> Application Manager (registry + auto-scaling) ->
Spinner (scheduler) -> Captains (compute nodes), plus the Cargo storage
layer and the client SDK (2-step performance-aware selection,
multi-connection fault tolerance).  A discrete-event simulator (sim.py)
provides the WAN latency / churn environment.  This is the PyTorch port's
copy of the JAX package's control plane; the serving plane is not ported
yet (ROADMAP), so captains carry no serving profile here.
"""
from repro_torch.core.sim import Simulator  # noqa: F401
