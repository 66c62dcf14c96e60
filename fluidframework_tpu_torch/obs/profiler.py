"""Continuous profiling: an always-on sampling host profiler plus
opt-in device-trace hooks.

The host half is a copy of the reference's ``ContinuousProfiler``: a
wall-clock thread sampler. A daemon thread wakes every ``interval_s``
(default 10ms), snapshots ``sys._current_frames()``, and attributes
each thread's top-of-stack frame to a COMPONENT derived from the
thread's name, so "where is the process spending its time, per
component" costs one dict walk per sample and no instrumentation on any
hot path. Aggregates ride the metrics registry
(``profiler_samples_total{component}``, ``profiler_overhead_pct``);
the newest samples sit in a bounded ring for full dumps. It never
touches the device.

Overhead is measured, not asserted: the sampler accounts every second
it spends sampling against the wall clock it ran for
(:attr:`ContinuousProfiler.overhead_fraction`).

The device half is opt-in (``FFTPU_DEVICE_TRACE=1``), the port's
counterpart of the reference's ``jax.profiler`` hooks:
:func:`device_trace` opens a ``torch.profiler.record_function`` range
around a device dispatch, and on a CUDA device also an NVTX range of
the same name, so a ``torch.profiler`` trace (or any NVTX-aware tool)
shows serving rounds by name; :func:`start_device_trace` /
:func:`stop_device_trace` drive a ``torch.profiler.profile`` over CPU
and CUDA activity that writes a Chrome trace. Disabled, every hook
costs one environment lookup and imports nothing — profiling never
adds a host<->device sync or an import tax to the dispatch loop.
"""
from __future__ import annotations

import os
import sys
import threading
import time
from collections import Counter, deque
from contextlib import contextmanager
from typing import IO, Optional, Sequence

from . import metrics as obs_metrics

_M_SAMPLES = obs_metrics.REGISTRY.counter(
    "profiler_samples_total",
    "host profiler stack samples per component",
    labelnames=("component",))
_M_OVERHEAD = obs_metrics.REGISTRY.gauge(
    "profiler_overhead_pct",
    "measured sampler overhead (time sampling / wall), percent")

# thread-name prefix -> component (the reference's table). First match
# wins; names are code-chosen so the label set stays bounded.
DEFAULT_COMPONENTS = (
    ("socket-recv", "driver-recv"),
    ("socket-dispatch", "driver-dispatch"),
    ("ingress-loop", "ingress"),
    ("serve-bench", "harness"),
    ("obs-profiler", "profiler"),
    ("MainThread", "main"),
)


def component_of(thread_name: str,
                 components: Sequence[tuple] = DEFAULT_COMPONENTS
                 ) -> str:
    for prefix, component in components:
        if thread_name.startswith(prefix):
            return component
    return "other"


class ContinuousProfiler:
    """The sampling host profiler. ``start()``/``stop()`` or use as a
    context manager; safe to leave always-on."""

    def __init__(self, interval_s: float = 0.01,
                 capacity: int = 8192,
                 components: Sequence[tuple] = DEFAULT_COMPONENTS,
                 name: str = "host"):
        if interval_s <= 0:
            raise ValueError("interval_s must be > 0")
        self.interval_s = interval_s
        self.components = tuple(components)
        self.name = name
        # newest samples, oldest dropped: (t, component, frame_key)
        self._ring: deque = deque(maxlen=capacity)
        self._counts: Counter = Counter()  # (component, frame_key)
        # registry flush bookkeeping: samples are counted locally in
        # the sampling loop and flushed to profiler_samples_total in
        # batches (stop()/summary()), NEVER per sample — a
        # per-sample inc would contend on the process-wide metrics
        # lock with the very serving threads being profiled, and the
        # contention would show up as profiler overhead
        self._flushed: Counter = Counter()
        self._lock = threading.Lock()
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.samples = 0
        self._sampling_s = 0.0   # time spent inside _sample_once
        self._started_at: Optional[float] = None
        self._wall_s = 0.0       # accumulated across start/stop spans

    # ------------------------------------------------------------------

    def start(self) -> "ContinuousProfiler":
        if self._thread is not None:
            return self
        self._stop_evt.clear()
        self._started_at = time.perf_counter()
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"obs-profiler-{self.name}",
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop_evt.set()
        self._thread.join(timeout=5.0)
        self._thread = None
        if self._started_at is not None:
            self._wall_s += time.perf_counter() - self._started_at
            self._started_at = None
        self._flush_registry()
        _M_OVERHEAD.set(round(100.0 * self.overhead_fraction, 4))

    def __enter__(self) -> "ContinuousProfiler":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    @property
    def running(self) -> bool:
        return self._thread is not None

    # ------------------------------------------------------------------

    def _loop(self) -> None:
        me = threading.get_ident()
        while not self._stop_evt.wait(self.interval_s):
            self._sample_once(skip_ident=me)

    def _sample_once(self, skip_ident: Optional[int] = None) -> None:
        t0 = time.perf_counter()
        names = {t.ident: t.name for t in threading.enumerate()}
        frames = sys._current_frames()
        now = time.time()
        with self._lock:
            self.samples += 1
            for ident, frame in frames.items():
                if ident == skip_ident:
                    continue
                component = component_of(
                    names.get(ident, "?"), self.components
                )
                code = frame.f_code
                key = (
                    f"{code.co_name} "
                    f"({os.path.basename(code.co_filename)}:"
                    f"{frame.f_lineno})"
                )
                self._counts[(component, key)] += 1
                self._ring.append((now, component, key))
        self._sampling_s += time.perf_counter() - t0

    def _flush_registry(self) -> None:
        """Push the locally-accumulated per-component sample counts
        into ``profiler_samples_total`` (delta against what was
        already flushed). Called from the batch entry points, off
        the sampling loop."""
        current = self.by_component()
        for component, count in current.items():
            delta = count - self._flushed[component]
            if delta > 0:
                self._flushed[component] = count
                _M_SAMPLES.labels(component=component).inc(delta)

    # ------------------------------------------------------------------

    @property
    def overhead_fraction(self) -> float:
        """Time spent sampling / wall time profiled (own-cost only;
        the end-to-end figure — including scheduler noise from the
        extra thread — is a run timed with the profiler on and off)."""
        wall = self._wall_s
        if self._started_at is not None:
            wall += time.perf_counter() - self._started_at
        return self._sampling_s / wall if wall > 0 else 0.0

    def top(self, n: int = 10,
            component: Optional[str] = None) -> list[dict]:
        """Top-of-stack aggregate, most-sampled first."""
        with self._lock:
            items = list(self._counts.items())
        if component is not None:
            items = [it for it in items if it[0][0] == component]
        items.sort(key=lambda it: (-it[1], it[0]))
        return [
            {"component": comp, "frame": key, "samples": count}
            for (comp, key), count in items[:n]
        ]

    def by_component(self) -> dict[str, int]:
        with self._lock:
            out: dict[str, int] = {}
            for (comp, _key), count in self._counts.items():
                out[comp] = out.get(comp, 0) + count
        return dict(sorted(out.items()))

    def summary(self) -> dict:
        # an always-on profiler is scraped via summary() without ever
        # stopping: flush here too so the registry aggregates track
        self._flush_registry()
        return {
            "samples": self.samples,
            "interval_s": self.interval_s,
            "by_component": self.by_component(),
            "top": self.top(10),
            "overhead_pct": round(100.0 * self.overhead_fraction, 4),
        }

    # ------------------------------------------------------------------

    def dump(self, reason: str = "", last: Optional[int] = None
             ) -> str:
        """Human-readable profile dump."""
        head = (
            f"profiler[{self.name}] dump ({reason or 'requested'}): "
            f"{self.samples} sample(s), "
            f"overhead {100.0 * self.overhead_fraction:.3f}%"
        )
        lines = [head]
        for comp, count in self.by_component().items():
            lines.append(f"  component {comp}: {count} samples")
        for row in self.top(last or 15):
            lines.append(
                f"    {row['samples']:6d}  [{row['component']}] "
                f"{row['frame']}"
            )
        return "\n".join(lines)

    def dump_to(self, reason: str = "",
                stream: Optional[IO[str]] = None,
                last: Optional[int] = None) -> str:
        text = self.dump(reason, last)
        print(text, file=stream or sys.stderr, flush=True)
        return text


# ======================================================================
# device-trace hooks (opt-in; never on the dispatch path by default)

# the profile that start_device_trace opened, and where it writes
_TRACE: dict = {"prof": None, "path": None}

# the Chrome trace's file name inside start_device_trace's logdir
TRACE_FILE = "device_trace.json"


def device_trace_enabled() -> bool:
    return os.environ.get("FFTPU_DEVICE_TRACE") == "1"


@contextmanager
def device_trace(name: str, device=None):
    """Name a device-dispatch window in the torch profiler's trace: a
    ``torch.profiler.record_function(name)`` range, and on a CUDA
    ``device`` an NVTX range of the same name as well. No-op (no import
    either) unless FFTPU_DEVICE_TRACE=1 — the sidecars wrap every
    dispatch in this, so the disabled path costs one env lookup per
    round. Neither range synchronizes with the device."""
    if not device_trace_enabled():
        yield
        return
    import torch

    with torch.profiler.record_function(name):
        if device is not None and torch.device(device).type == "cuda":
            with torch.cuda.nvtx.range(name):
                yield
        else:
            yield


def start_device_trace(logdir: str) -> bool:
    """Start a ``torch.profiler`` trace of CPU and (when a card is
    present) CUDA activity; :func:`stop_device_trace` writes it to
    ``logdir/device_trace.json``. Returns False when disabled; raises
    when a trace is already running."""
    if not device_trace_enabled():
        return False
    import torch

    if _TRACE["prof"] is not None:
        raise RuntimeError("a device trace is already running")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    _TRACE.update(prof=prof, path=os.path.join(logdir, TRACE_FILE))
    return True


def stop_device_trace() -> bool:
    """Stop the trace :func:`start_device_trace` opened and write its
    Chrome trace. Returns False when disabled or when none is
    running."""
    if not device_trace_enabled() or _TRACE["prof"] is None:
        return False
    prof, path = _TRACE["prof"], _TRACE["path"]
    _TRACE.update(prof=None, path=None)
    prof.__exit__(None, None, None)
    prof.export_chrome_trace(path)
    return True
