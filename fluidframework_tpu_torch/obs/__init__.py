"""Observability of the port, copies of the reference's ``obs``
modules: the op-trace hop table and ``stamp`` (``obs.trace``), the
process-wide metrics registry (``obs.metrics``), the flight recorder
(``obs.flight_recorder``), the heat ledger and its device-time
attribution (``obs.heat``), the continuous host profiler and the
torch.profiler / NVTX device-trace hooks (``obs.profiler``), and the
fleet timeline (``obs.timeline``)."""
from .flight_recorder import FlightRecorder
from .heat import HeatLedger, attribute_round, usage_ledger
from .metrics import REGISTRY, MetricsRegistry
from .profiler import ContinuousProfiler, device_trace
from .timeline import TIMELINE_KINDS, FleetTimeline
from .trace import CANONICAL_HOPS, hop_name, stamp

__all__ = [
    "CANONICAL_HOPS", "ContinuousProfiler", "FleetTimeline",
    "FlightRecorder", "HeatLedger", "MetricsRegistry", "REGISTRY",
    "TIMELINE_KINDS", "attribute_round", "device_trace", "hop_name",
    "stamp", "usage_ledger",
]
