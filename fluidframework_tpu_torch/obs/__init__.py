"""Observability of the port: the heat ledger the pool's migration
policy reads (``obs.heat``)."""
from .heat import HeatLedger

__all__ = ["HeatLedger"]
