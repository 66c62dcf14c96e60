"""Service-side structured telemetry: Lumber/Lumberjack.

Reference: server/routerlicious/packages/services-telemetry —
``Lumber`` (src/lumber.ts:23): one metric with properties, timing and
success/failure outcome; ``Lumberjack`` (src/lumberjack.ts:21): the
factory with pluggable engines (sinks).
"""
from __future__ import annotations

import time
from enum import Enum
from typing import Any, Optional


class LumberType(Enum):
    METRIC = "metric"
    LOG = "log"


class Lumber:
    """lumber.ts:23 — one unit of service telemetry."""

    def __init__(self, event_name: str, lumber_type: LumberType,
                 engines: list, properties: Optional[dict] = None):
        self.event_name = event_name
        self.type = lumber_type
        self._engines = engines
        self.properties: dict[str, Any] = dict(properties or {})
        self.start_time = time.time()
        self.duration_ms: Optional[float] = None
        self.successful: Optional[bool] = None
        self.message: Optional[str] = None
        self._emitted = False

    def set_property(self, key: str, value: Any) -> "Lumber":
        self.properties[key] = value
        return self

    def success(self, message: str = "") -> None:
        self._complete(True, message)

    def error(self, message: str = "",
              exception: Optional[BaseException] = None) -> None:
        if exception is not None:
            self.properties["exception"] = repr(exception)
        self._complete(False, message)

    def _complete(self, successful: bool, message: str) -> None:
        if self._emitted:
            # A double-completion is a caller bug, but the old
            # ``assert`` guard vanished under ``python -O`` (silent
            # double emit) and crashed the service path otherwise
            # (interpreter-dependent behavior either way). Record it
            # LOUDLY as its own error event instead: the first
            # emission stands, the duplicate becomes evidence.
            from ..obs import metrics as _metrics

            _metrics.REGISTRY.counter(
                "telemetry_lumber_double_emit_total",
                "Lumber success()/error() called after completion",
            ).inc()
            dup = Lumber(
                f"{self.event_name}:doubleEmit", LumberType.LOG,
                self._engines, dict(self.properties),
            )
            dup.properties["firstOutcome"] = self.successful
            dup.properties["secondOutcome"] = successful
            dup._emitted = True
            dup.duration_ms = 0.0
            dup.successful = False
            dup.message = (
                f"lumber {self.event_name!r} completed twice "
                f"(second message: {message!r})"
            )
            for engine in self._engines:
                engine.emit(dup)
            return
        self._emitted = True
        self.duration_ms = (time.time() - self.start_time) * 1000
        self.successful = successful
        self.message = message
        for engine in self._engines:
            engine.emit(self)


class Lumberjack:
    """lumberjack.ts:21 — engine registry + metric factory."""

    def __init__(self, engines: Optional[list] = None,
                 global_properties: Optional[dict] = None):
        self.engines = list(engines or [])
        self.global_properties = dict(global_properties or {})

    def add_engine(self, engine) -> None:
        self.engines.append(engine)

    def new_metric(self, event_name: str,
                   properties: Optional[dict] = None) -> Lumber:
        return Lumber(
            event_name, LumberType.METRIC, self.engines,
            {**self.global_properties, **(properties or {})},
        )

    def log(self, event_name: str, message: str = "",
            properties: Optional[dict] = None) -> None:
        lumber = Lumber(
            event_name, LumberType.LOG, self.engines,
            {**self.global_properties, **(properties or {})},
        )
        lumber.success(message)


class InMemoryLumberjackEngine:
    """Test/engine double (services-telemetry test engines)."""

    def __init__(self) -> None:
        self.emitted: list[Lumber] = []

    def emit(self, lumber: Lumber) -> None:
        self.emitted.append(lumber)

    def events_named(self, event_name: str) -> list[Lumber]:
        return [l for l in self.emitted if l.event_name == event_name]
