"""Offline checks of the port's artifacts (counterpart of the store half of
``repro.analysis``)."""
from repro_torch.analysis.store import StoreFinding, StoreReport, verify_store

__all__ = ["StoreFinding", "StoreReport", "verify_store"]
