"""Client telemetry: logger hierarchy, performance spans, sampling.

Reference: packages/utils/telemetry-utils/src/logger.ts —
``ChildLogger`` (:274) namespace prefixing, ``MultiSinkLogger``
(:357), ``TaggedLoggerAdapter`` (:227), ``MockLogger``
(mockLogger.ts) for tests, ``PerformanceEvent`` spans (:410),
``SampledTelemetryHelper`` (sampledTelemetryHelper.ts).

Events are plain dicts with reserved keys: ``category``
("generic" | "performance" | "error"), ``eventName``.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Optional


class TelemetryLogger:
    """Base sink: hosts subclass or pass ``send_fn``."""

    def __init__(self, send_fn: Optional[Callable[[dict], None]] = None,
                 properties: Optional[dict] = None):
        self._send_fn = send_fn
        self.properties = dict(properties or {})

    def send(self, event: dict) -> None:
        out = {**self.properties, **event}
        out.setdefault("category", "generic")
        if self._send_fn is not None:
            self._send_fn(out)

    # convenience wrappers (logger.ts sendTelemetryEvent etc.)

    def send_telemetry_event(self, event_name: str, **props: Any) -> None:
        self.send({"eventName": event_name, **props})

    def send_error_event(self, event_name: str,
                         error: Optional[BaseException] = None,
                         **props: Any) -> None:
        if error is not None:
            props["error"] = repr(error)
        self.send({"eventName": event_name, "category": "error", **props})

    def send_performance_event(self, event_name: str,
                               duration_ms: float, **props: Any) -> None:
        self.send({
            "eventName": event_name, "category": "performance",
            "duration": duration_ms, **props,
        })


class ChildLogger(TelemetryLogger):
    """logger.ts:274 — prefixes event names with a namespace and
    forwards to the parent."""

    def __init__(self, parent: TelemetryLogger, namespace: str,
                 properties: Optional[dict] = None):
        super().__init__(None, properties)
        self.parent = parent
        self.namespace = namespace

    def send(self, event: dict) -> None:
        out = {**self.properties, **event}
        name = out.get("eventName", "")
        out["eventName"] = f"{self.namespace}:{name}" if name else (
            self.namespace
        )
        self.parent.send(out)


class MultiSinkLogger(TelemetryLogger):
    """logger.ts:357 — fan out to several sinks."""

    def __init__(self, sinks: Optional[list[TelemetryLogger]] = None):
        super().__init__(None)
        self.sinks = list(sinks or [])

    def add_sink(self, sink: TelemetryLogger) -> None:
        self.sinks.append(sink)

    def send(self, event: dict) -> None:
        for sink in self.sinks:
            sink.send(dict(event))


class TaggedTelemetryLogger(TelemetryLogger):
    """logger.ts:227 TaggedLoggerAdapter — redacts values whose keys
    are tagged as user content before forwarding."""

    def __init__(self, parent: TelemetryLogger,
                 tagged_keys: Optional[set[str]] = None):
        super().__init__(None)
        self.parent = parent
        self.tagged_keys = set(tagged_keys or ())

    def send(self, event: dict) -> None:
        out = {
            k: ("REDACTED" if k in self.tagged_keys else v)
            for k, v in event.items()
        }
        self.parent.send(out)


class MockLogger(TelemetryLogger):
    """mockLogger.ts — captures events for assertions."""

    def __init__(self) -> None:
        self.events: list[dict] = []
        super().__init__(self.events.append)

    def matches(self, expected: list[dict]) -> bool:
        """Expected events appear in order (subset-match per event)."""
        idx = 0
        for event in self.events:
            if idx >= len(expected):
                break
            if all(event.get(k) == v for k, v in expected[idx].items()):
                idx += 1
        return idx >= len(expected)


class PerformanceEvent:
    """logger.ts:410 — a timed span; use as a context manager. On
    exception the event reports ``cancel`` with the error.

    ``emit_start=True`` additionally emits ``<name>_start`` when the
    span OPENS (the reference's PerformanceEvent.start), so a
    long-running span is visible in the event stream before it ends —
    without it, a span that hangs (the ack-deadline shape) leaves no
    telemetry at all until the timeout fires."""

    def __init__(self, logger: TelemetryLogger, event_name: str,
                 emit_start: bool = False, **props: Any):
        self.logger = logger
        self.event_name = event_name
        self.emit_start = emit_start
        self.props = props
        self._start = None

    def __enter__(self) -> "PerformanceEvent":
        self._start = time.monotonic()
        if self.emit_start:
            self.logger.send({
                "eventName": f"{self.event_name}_start",
                "category": "performance",
                **self.props,
            })
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        duration_ms = (time.monotonic() - self._start) * 1000
        if exc is None:
            self.logger.send_performance_event(
                f"{self.event_name}_end", duration_ms, **self.props
            )
        else:
            self.logger.send_error_event(
                f"{self.event_name}_cancel", exc,
                duration=duration_ms, **self.props,
            )


class SampledTelemetryHelper:
    """sampledTelemetryHelper.ts — aggregate N measurements into one
    event (count/min/max/mean duration).

    Use as a context manager (or call :meth:`close`) so a TAIL of
    fewer than ``sample_every`` measurements flushes at teardown
    instead of being silently dropped — a short-lived container used
    to lose every measurement under the threshold. The obs shutdown
    path (``obs.shutdown``) closes registered
    helpers the same way."""

    def __init__(self, logger: TelemetryLogger, event_name: str,
                 sample_every: int = 100):
        self.logger = logger
        self.event_name = event_name
        self.sample_every = sample_every
        self._durations: list[float] = []
        self.closed = False

    def measure(self, fn: Callable[[], Any]) -> Any:
        start = time.monotonic()
        try:
            return fn()
        finally:
            self.record((time.monotonic() - start) * 1000)

    def record(self, duration_ms: float) -> None:
        self._durations.append(duration_ms)
        if len(self._durations) >= self.sample_every:
            self.flush()

    def close(self) -> None:
        """Flush the tail; idempotent (safe to close again from the
        obs shutdown path after an owner already closed it)."""
        self.flush()
        self.closed = True

    def __enter__(self) -> "SampledTelemetryHelper":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    def flush(self) -> None:
        if not self._durations:
            return
        ds = self._durations
        self.logger.send_performance_event(
            self.event_name,
            duration_ms=sum(ds),
            count=len(ds),
            min=min(ds),
            max=max(ds),
            mean=sum(ds) / len(ds),
        )
        self._durations = []
