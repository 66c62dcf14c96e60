"""Observability of the port, copies of the reference's ``obs``
modules: the op-trace hop table and ``stamp`` (``obs.trace``), the
process-wide metrics registry (``obs.metrics``), the flight recorder
(``obs.flight_recorder``), the heat ledger and its device-time
attribution (``obs.heat``), the continuous host profiler and the
torch.profiler / NVTX device-trace hooks (``obs.profiler``), the
fleet timeline (``obs.timeline``), the SLO engine (``obs.slo``), the
OTLP span export of the hop tables (``obs.spans``), the fleet-merged
registry view (``obs.federation``), and the shutdown path that flushes
the telemetry aggregators (``register_closeable`` / ``shutdown``)."""
from __future__ import annotations

import weakref

from .federation import FederatedView
from .flight_recorder import FlightRecorder
from .heat import HeatLedger, attribute_round, usage_ledger
from .metrics import REGISTRY, MetricsRegistry, get_registry
from .profiler import ContinuousProfiler, device_trace
from .slo import Objective, SloEngine
from .spans import (
    FileSpanExporter,
    op_to_otlp,
    otlp_to_hops,
    timeline_to_otlp,
)
from .timeline import TIMELINE_KINDS, FleetTimeline
from .trace import (
    CANONICAL_HOPS,
    breakdown,
    format_breakdown,
    hop_name,
    stamp,
    total_ms,
)

__all__ = [
    "CANONICAL_HOPS", "ContinuousProfiler", "FederatedView",
    "FileSpanExporter", "FleetTimeline", "FlightRecorder",
    "HeatLedger", "MetricsRegistry", "Objective", "REGISTRY",
    "SloEngine", "TIMELINE_KINDS", "attribute_round", "breakdown",
    "device_trace", "format_breakdown", "get_registry", "hop_name",
    "op_to_otlp", "otlp_to_hops", "register_closeable", "shutdown",
    "stamp", "timeline_to_otlp", "total_ms", "usage_ledger",
]

# ----------------------------------------------------------------------
# shutdown path: telemetry aggregators (SampledTelemetryHelper and
# friends) register here so their TAIL measurements flush at teardown
# instead of being silently dropped — weakrefs, so registration never
# extends an owner's lifetime.

_closeables: "weakref.WeakSet" = weakref.WeakSet()


def register_closeable(obj) -> None:
    """Register an object with a ``close()`` method to be closed (and
    thereby flushed) by :func:`shutdown`."""
    _closeables.add(obj)


def shutdown() -> None:
    """Close every registered aggregator (idempotent; close() on these
    is required to be re-entrant safe)."""
    for obj in list(_closeables):
        obj.close()
    # closed objects may be re-registered by a later session; keep the
    # set — close() is idempotent on all registrants by contract
