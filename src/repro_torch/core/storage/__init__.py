"""Armada storage layer: Cargo nodes + Cargo manager (paper §3.4)."""
from repro_torch.core.storage.cargo import Cargo  # noqa: F401
from repro_torch.core.storage.cargo_manager import CargoManager  # noqa: F401
