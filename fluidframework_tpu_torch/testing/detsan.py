"""detsan — a runtime clock/RNG sanitizer for the deterministic planes.

The dynamic half of the detcheck static pass
(analysis/determinism.py), completing the family-pair pattern
(concheck<->fluidsan): the static analyzer
proves, over the callgraph, that no deterministic-contract path reads
the wall clock or an unseeded RNG un-routed; detsan observes the
reads that actually happen and trips LOUDLY when one of them is
un-routed inside a deterministic-plane component. The differential
test (tests/test_detsan.py) drives the real chaos sweep and a
serve_bench slice and asserts every runtime-observed un-routed site
is either a static detcheck finding or a reviewed
``WALL_CLOCK_SINKS`` registry entry — a gap fails BY NAME as an
analyzer-resolution gap, never silently.

What gets patched (``install()``):

- ``time.time`` / ``time.monotonic`` / ``time.perf_counter``: every
  call records its CALL SITE (file:line, enclosing code object,
  component attributed from the current thread's name via the obs
  profiler's prefix table). A site is **routed** when the call
  expression at that line is NOT a direct ``time.*`` spelling — it
  arrived through an injected ``clock()`` parameter, which is exactly
  the provenance the static rule credits. An UN-ROUTED read inside a
  deterministic-plane component that is not a registered wall-clock
  sink trips: creation site + component + an obs FlightRecorder dump
  of the recent reads, counted in ``detsan_trips_total``.
- module-level ``random.*`` draws (``random.random``, ``uniform``,
  ``shuffle``, ...): these ride the process-global unseeded stream —
  ANY call from a deterministic-plane component trips (there is no
  routed form; the fix is an injected seeded ``random.Random``).
- ``random.Random``: creating an instance with NO seed from a
  deterministic-plane component trips (the creation site is the
  finding, matching the static ``unseeded-rng`` rule). Seeded
  construction — ``random.Random(seed)`` — is untouched.

``np.random`` is static-only coverage on purpose: numpy/jax create
RandomStates internally for legitimate reasons, and patching the
numpy module surface from a sanitizer is a cure worse than the
hazard. The static rule still gates repo code.

Stdlib/third-party call sites are ignored at the first branch (the
wrapper's fast path), so the patch is cheap enough to leave on for a
whole sanitized session — the pytest plugin
``testing/sanitize_plugin.py`` that installs fluidsan and jitsan
installs detsan and fails any test that trips. Code that imported a clock BY VALUE before install (``from
time import monotonic``) bypasses the patch; the repo imports the
modules, and the static rule covers the by-value spelling either way.
"""
from __future__ import annotations

import dataclasses
import os
import sys
import threading
import _thread
import time as _time_mod
import random as _random_mod
from typing import Optional

from ..obs import metrics as obs_metrics
from ..obs.flight_recorder import FlightRecorder
from ..obs.profiler import component_of

_TRIPS_TOTAL = obs_metrics.REGISTRY.counter(
    "detsan_trips_total",
    "detsan unrouted clock/RNG reads detected at runtime inside "
    "deterministic-plane components")

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))) + os.sep

# time-module attributes patched (the _ns variants and datetime are
# static-only: nothing in the repo calls them today, and the static
# rule fails the gate the day something does)
_WALL_ATTRS = ("time", "monotonic", "perf_counter")


def _rng_fns() -> tuple:
    """The module-level draws to patch, derived from the static
    rule's own registry so the two halves cannot drift (a draw added
    to detcheck's _GLOBAL_RNG_FNS is monitored at runtime from the
    same commit). Function-local import: testing may not depend on
    analysis at module level."""
    import random

    from ..analysis.determinism import _GLOBAL_RNG_FNS

    return tuple(sorted(
        n for n in _GLOBAL_RNG_FNS if hasattr(random, n)))


@dataclasses.dataclass
class SiteRecord:
    """One observed clock/RNG call site (aggregated across calls)."""

    relpath: str
    line: int
    func: str               # enclosing code object name
    kind: str               # "wall" | "rng" | "rng-unseeded"
    count: int = 0
    components: set = dataclasses.field(default_factory=set)


@dataclasses.dataclass
class Trip:
    """An un-routed clock/RNG read inside a deterministic-plane
    component."""

    relpath: str
    line: int
    func: str
    kind: str
    what: str               # e.g. "time.monotonic", "random.random"
    component: str
    thread_name: str
    flight_dump: str

    def describe(self) -> str:
        verb = {
            "wall": "un-routed wall-clock read",
            "rng": "process-global unseeded RNG draw",
            "rng-unseeded": "unseeded random.Random() creation",
        }[self.kind]
        return (
            f"{verb} ({self.what}) at {self.relpath}:{self.line} in "
            f"{self.func}() [component {self.component!r}, thread "
            f"{self.thread_name!r}] — a deterministic-contract "
            "component must route clocks through an injected "
            "``clock=`` and RNG through a seeded instance "
            "(docs/ANALYSIS.md detcheck), or register a reviewed "
            "telemetry sink in determinism.WALL_CLOCK_SINKS"
        )


class _State:
    def __init__(self) -> None:
        self.installed = 0
        self.sites: dict[tuple, SiteRecord] = {}
        self.trips: list[Trip] = []
        self.tripped_sites: set = set()
        self.recorder = FlightRecorder(256, name="detsan")
        self.orig_time: dict[str, object] = {}
        self.orig_rng: dict[str, object] = {}
        self.orig_random_cls = None
        # (abspath) -> frozenset of linenos with DIRECT time.* calls
        self.direct_lines: dict[str, frozenset] = {}


_STATE = _State()

# raw lock (never instrumented by fluidsan: allocated before/outside
# the patched factories, and bookkeeping under it never blocks)
_LOCK = _thread.allocate_lock()


class _Local(threading.local):
    def __init__(self) -> None:
        self.busy = False


_LOCAL = _Local()


# ---------------------------------------------------------------------------
# site classification


def _direct_wall_lines(abspath: str) -> frozenset:
    """Line numbers in ``abspath`` holding a DIRECT ``time.*`` /
    ``datetime.now``-family call (the un-routed spelling). A read
    observed at any OTHER line arrived through a variable — an
    injected ``clock()`` — which is the routing the static rule
    credits. Shares the resolution with detcheck so the two halves
    cannot drift (function-local import: testing may not depend on
    analysis at module level)."""
    cached = _STATE.direct_lines.get(abspath)
    if cached is not None:
        return cached
    import ast

    from ..analysis.core import import_aliases
    from ..analysis.determinism import wall_clock_calls_in

    lines: frozenset = frozenset()
    try:
        with open(abspath, encoding="utf-8") as f:
            tree = ast.parse(f.read(), filename=abspath)
    except (OSError, SyntaxError, ValueError):
        tree = None
    if tree is not None:
        aliases = import_aliases(tree, relative="skip")
        lines = frozenset(
            c.lineno for c in wall_clock_calls_in(tree, aliases))
    with _LOCK:
        _STATE.direct_lines[abspath] = lines
    return lines


def _in_runtime_scope(relpath: str) -> bool:
    if not relpath.startswith("fluidframework_tpu_torch/"):
        return False
    from ..analysis.determinism import DET_SCOPE_COMPONENTS

    parts = relpath.split("/")
    return any(p in DET_SCOPE_COMPONENTS for p in parts[:-1])


def _sink_registered(relpath: str, func: str) -> bool:
    from ..analysis.determinism import sink_registered

    # by_code_name: a frame only carries co_name, not the qualname
    return sink_registered(relpath, func, by_code_name=True)


# ---------------------------------------------------------------------------
# recording


def _record(kind: str, what: str, frame) -> None:
    fname = frame.f_code.co_filename
    if not fname.startswith(_REPO_ROOT):
        return
    ls = _LOCAL
    if ls.busy:
        return
    ls.busy = True
    try:
        rel = fname[len(_REPO_ROOT):].replace(os.sep, "/")
        line = frame.f_lineno
        func = frame.f_code.co_name
        tname = threading.current_thread().name
        component = component_of(tname)
        site = (rel, line, kind)
        with _LOCK:
            rec = _STATE.sites.get(site)
            if rec is None:
                rec = SiteRecord(rel, line, func, kind)
                _STATE.sites[site] = rec
            rec.count += 1
            rec.components.add(component)
        if not _in_runtime_scope(rel):
            return
        with _LOCK:
            _STATE.recorder.record(
                "read", what=what, site=f"{rel}:{line}",
                func=func, thread=tname,
            )
        if kind == "wall":
            if line not in _direct_wall_lines(fname):
                return              # routed through an injected clock
            if _sink_registered(rel, func):
                return              # reviewed telemetry sink
        trip = None
        with _LOCK:
            if site not in _STATE.tripped_sites:
                _STATE.tripped_sites.add(site)
                trip = Trip(
                    relpath=rel, line=line, func=func, kind=kind,
                    what=what, component=component,
                    thread_name=tname,
                    flight_dump=_STATE.recorder.dump(
                        reason=f"detsan {kind} trip"),
                )
                _STATE.trips.append(trip)
        if trip is not None:
            _TRIPS_TOTAL.inc()
            print(f"detsan: {trip.describe()}\n{trip.flight_dump}",
                  file=sys.stderr, flush=True)
    finally:
        ls.busy = False


def _caller_frame():
    try:
        return sys._getframe(2)
    except ValueError:  # pragma: no cover - no python caller
        return None


# ---------------------------------------------------------------------------
# wrappers


def _wrap_wall(name: str, original):
    what = f"time.{name}"

    def run():
        frame = _caller_frame()
        if frame is not None:
            _record("wall", what, frame)
        return original()

    run.__name__ = name
    run.__detsan_wrapped__ = original
    return run


def _wrap_rng(name: str, original):
    what = f"random.{name}"

    def run(*args, **kwargs):
        frame = _caller_frame()
        if frame is not None:
            _record("rng", what, frame)
        return original(*args, **kwargs)

    run.__name__ = name
    run.__detsan_wrapped__ = original
    return run


def _make_random_cls(original_cls):
    class DetsanRandom(original_cls):
        """random.Random that records unseeded creation from repo
        call sites (seeded construction is untouched)."""

        def __init__(self, x=None):
            if x is None:
                frame = None
                try:
                    frame = sys._getframe(1)
                except ValueError:  # pragma: no cover
                    pass
                if frame is not None:
                    _record("rng-unseeded", "random.Random()", frame)
            super().__init__(x)

    DetsanRandom.__name__ = "Random"
    DetsanRandom.__qualname__ = "Random"
    DetsanRandom.__detsan_wrapped__ = original_cls
    return DetsanRandom


# ---------------------------------------------------------------------------
# lifecycle


def install() -> None:
    """Patch the ``time`` and ``random`` module surfaces. Refcounted
    like fluidsan/jitsan (nested install/uninstall pairs are safe)."""
    with _LOCK:
        _STATE.installed += 1
        if _STATE.installed > 1:
            return
    for name in _WALL_ATTRS:
        original = getattr(_time_mod, name)
        _STATE.orig_time[name] = original
        setattr(_time_mod, name, _wrap_wall(name, original))
    for name in _rng_fns():
        original = getattr(_random_mod, name)
        _STATE.orig_rng[name] = original
        setattr(_random_mod, name, _wrap_rng(name, original))
    _STATE.orig_random_cls = _random_mod.Random
    _random_mod.Random = _make_random_cls(_STATE.orig_random_cls)
    reset()


def uninstall() -> None:
    with _LOCK:
        if _STATE.installed == 0:
            return
        _STATE.installed -= 1
        if _STATE.installed:
            return
    for name, original in _STATE.orig_time.items():
        setattr(_time_mod, name, original)
    for name, original in _STATE.orig_rng.items():
        setattr(_random_mod, name, original)
    if _STATE.orig_random_cls is not None:
        _random_mod.Random = _STATE.orig_random_cls
        _STATE.orig_random_cls = None
    _STATE.orig_time.clear()
    _STATE.orig_rng.clear()


def installed() -> bool:
    return _STATE.installed > 0


def reset() -> None:
    """Drop recorded sites/trips (the classification cache is keyed
    by file content location and survives — sources do not change
    mid-session)."""
    with _LOCK:
        _STATE.sites.clear()
        _STATE.trips.clear()
        _STATE.tripped_sites.clear()
        _STATE.recorder = FlightRecorder(256, name="detsan")


def trips() -> list[Trip]:
    with _LOCK:
        return list(_STATE.trips)


def observed_sites(kind: Optional[str] = None) -> list[SiteRecord]:
    with _LOCK:
        recs = list(_STATE.sites.values())
    if kind is not None:
        recs = [r for r in recs if r.kind == kind]
    return recs


def unrouted_wall_sites() -> list[SiteRecord]:
    """Observed wall-clock reads, inside deterministic-plane package
    components, whose call site is a DIRECT ``time.*`` spelling —
    the set the differential pins against detcheck findings plus the
    WALL_CLOCK_SINKS registry."""
    out = []
    for rec in observed_sites("wall"):
        if not _in_runtime_scope(rec.relpath):
            continue
        abspath = os.path.join(_REPO_ROOT, rec.relpath)
        if rec.line in _direct_wall_lines(abspath):
            out.append(rec)
    return out


def scoped_rng_sites() -> list[SiteRecord]:
    """Observed global-stream RNG draws / unseeded creations inside
    deterministic-plane package components (every one is a violation:
    there is no routed spelling for the global stream)."""
    return [
        rec for rec in observed_sites()
        if rec.kind in ("rng", "rng-unseeded")
        and _in_runtime_scope(rec.relpath)
    ]
