"""fluidsan — a runtime lockset sanitizer (lockdep for the repo).

The dynamic half of the concheck static pass
(analysis/concurrency.py): drop-in instrumented ``threading.Lock`` /
``threading.RLock`` wrappers record, per thread, the set of locks held
and every acquisition-order edge (lock B acquired while holding lock
A). When two concrete lock objects are ever taken in BOTH orders the
sanitizer trips LOUDLY — a potential-deadlock report with the edge
pair, both thread names, and a flight-recorder dump of the recent
acquire/release history attached — without needing the deadlock to
actually strike (lockdep's trick: order history persists, so the
second ordering trips even if the threads never interleave fatally).

Two identity granularities, on purpose:

- **trips** compare CONCRETE lock objects: ``X.lock -> Y._send_lock``
  on one instance pair and the reverse on a *different* pair is not a
  deadlock, so object identity keeps the trip signal precise;
- **edges()** aggregate to CREATION SITES (file:line of the
  ``threading.Lock()`` call) — the same class-level identity the
  static pass computes — so the differential test can assert every
  runtime-observed edge is a subset of concheck's static graph
  (tests/test_sanitizer.py; a gap there is an analyzer-resolution
  finding, not a silent miss).

Enable for a test session with the pytest plugin
``testing/sanitize_plugin.py`` (``-p
fluidframework_tpu_torch.testing.sanitize_plugin``: it installs the
wrapper before test modules import and fails any test that trips). ``install()`` patches the ``threading.Lock``/``RLock``
factories, so every lock created AFTER install is instrumented;
module-level locks created at import time stay raw (they are also the
short-critical-section kind the static pass classifies as fast).
"""
from __future__ import annotations

import dataclasses
import linecache
import os
import re
import sys
import threading
import _thread
from typing import Optional

from ..obs import metrics as obs_metrics
from ..obs.flight_recorder import FlightRecorder

_TRIPS_TOTAL = obs_metrics.REGISTRY.counter(
    "sanitizer_trips_total",
    "fluidsan lock-order inversions detected at runtime")

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# raw, never-instrumented lock for the sanitizer's own registry; all
# bookkeeping under it is lock-free python (dict/list/ring ops)
_REG_LOCK = _thread.allocate_lock()

_NAME_RE = re.compile(r"(?:self\.)?(\w+)\s*(?::[^=]+)?=")


@dataclasses.dataclass(frozen=True)
class Site:
    """Where a lock was created (the identity the static pass shares)."""

    relpath: str
    line: int
    name: str           # best-effort assignment-target hint

    def display(self) -> str:
        return f"{self.relpath}:{self.line}({self.name or '?'})"


@dataclasses.dataclass
class EdgeRecord:
    first_uid: int
    second_uid: int
    first_site: Site
    second_site: Site
    thread_name: str


@dataclasses.dataclass
class Trip:
    """One detected order inversion: this thread took ``second ->
    first`` after some thread had taken ``first -> second``."""

    first_site: Site
    second_site: Site
    thread_name: str            # the thread completing the inversion
    other_thread_name: str      # the thread that recorded the forward edge
    flight_dump: str

    def describe(self) -> str:
        return (
            f"lock-order inversion: {self.second_site.display()} "
            f"acquired before {self.first_site.display()} on thread "
            f"{self.thread_name!r}, but thread "
            f"{self.other_thread_name!r} acquired them in the "
            "opposite order — two threads taking both paths "
            "concurrently deadlock"
        )


class _State:
    def __init__(self) -> None:
        self.edges: dict = {}        # (uid_a, uid_b) -> EdgeRecord
        self.tripped: set = set()    # unordered uid pairs already reported
        self.trips: list = []
        self.recorder = FlightRecorder(256, name="fluidsan")
        self.uid_counter = 0
        self.installed = 0
        self.orig_lock = None
        self.orig_rlock = None


_STATE = _State()


class _Local(threading.local):
    def __init__(self) -> None:
        self.order: list = []        # lock wrappers, acquisition order
        self.depths: dict = {}       # uid -> reentrancy depth
        self.busy = False            # reentrancy guard for bookkeeping


_LOCAL = _Local()


def _creation_site() -> Site:
    frame = sys._getframe(2)
    here = os.path.abspath(__file__)
    while frame is not None:
        fname = frame.f_code.co_filename
        if os.path.abspath(fname) != here:
            break
        frame = frame.f_back
    if frame is None:  # pragma: no cover - interpreter internals
        return Site("<unknown>", 0, "")
    fname = frame.f_code.co_filename
    try:
        rel = os.path.relpath(fname, _REPO_ROOT).replace(os.sep, "/")
    except ValueError:  # pragma: no cover - other drive on windows
        rel = fname
    text = linecache.getline(fname, frame.f_lineno).strip()
    m = _NAME_RE.match(text)
    return Site(rel, frame.f_lineno, m.group(1) if m else "")


def _note_acquire(lock: "_SanBase") -> None:
    ls = _LOCAL
    if ls.busy:
        return
    depth = ls.depths.get(lock.uid, 0)
    ls.depths[lock.uid] = depth + 1
    if depth:
        return  # reentrant re-acquire: no new edges
    held = list(ls.order)
    ls.order.append(lock)
    ls.busy = True
    try:
        tname = threading.current_thread().name
        new_trips = []
        with _REG_LOCK:
            _STATE.recorder.record(
                "acquire", lock=lock.site.display(), thread=tname,
                held=[h.site.display() for h in held],
            )
            for h in held:
                edge = (h.uid, lock.uid)
                if edge not in _STATE.edges:
                    _STATE.edges[edge] = EdgeRecord(
                        h.uid, lock.uid, h.site, lock.site, tname)
                rev = _STATE.edges.get((lock.uid, h.uid))
                pair = frozenset((h.uid, lock.uid))
                if rev is not None and pair not in _STATE.tripped:
                    _STATE.tripped.add(pair)
                    trip = Trip(
                        first_site=rev.first_site,
                        second_site=rev.second_site,
                        thread_name=tname,
                        other_thread_name=rev.thread_name,
                        flight_dump=_STATE.recorder.dump(
                            reason="lock-order inversion"),
                    )
                    _STATE.trips.append(trip)
                    new_trips.append(trip)
        for trip in new_trips:
            _TRIPS_TOTAL.inc()
            print(f"fluidsan: {trip.describe()}\n{trip.flight_dump}",
                  file=sys.stderr, flush=True)
    finally:
        ls.busy = False


def _note_release(lock: "_SanBase") -> None:
    ls = _LOCAL
    if ls.busy:
        return
    depth = ls.depths.get(lock.uid, 0)
    if depth > 1:
        ls.depths[lock.uid] = depth - 1
        return
    ls.depths.pop(lock.uid, None)
    for i in range(len(ls.order) - 1, -1, -1):
        if ls.order[i] is lock:
            del ls.order[i]
            break
    ls.busy = True
    try:
        with _REG_LOCK:
            _STATE.recorder.record(
                "release", lock=lock.site.display(),
                thread=threading.current_thread().name,
            )
    finally:
        ls.busy = False


class _SanBase:
    """Common wrapper surface (context manager + acquire/release)."""

    __slots__ = ("_inner", "uid", "site")

    def __init__(self, inner, site: Optional[Site] = None):
        self._inner = inner
        with _REG_LOCK:
            _STATE.uid_counter += 1
            self.uid = _STATE.uid_counter
        self.site = site or _creation_site()

    def acquire(self, blocking: bool = True, timeout: float = -1):
        got = self._inner.acquire(blocking, timeout)
        if got:
            _note_acquire(self)
        return got

    def release(self) -> None:
        _note_release(self)
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def _at_fork_reinit(self) -> None:
        # threading._after_fork reinitializes every lock in the child
        # (the moira/broker tests fork server processes); without the
        # passthrough a fork with any instrumented lock alive dies
        self._inner._at_fork_reinit()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"<{type(self).__name__} {self.site.display()} "
                f"uid={self.uid}>")


class SanLock(_SanBase):
    __slots__ = ()


class SanRLock(_SanBase):
    __slots__ = ()

    # threading.Condition drives RLocks through this private trio;
    # implementing them keeps the per-thread lockset truthful across
    # Condition.wait's full-release/rerestore cycle
    def _release_save(self):
        ls = _LOCAL
        depth = ls.depths.pop(self.uid, 1)
        for i in range(len(ls.order) - 1, -1, -1):
            if ls.order[i] is self:
                del ls.order[i]
                break
        return (self._inner._release_save(), depth)

    def _acquire_restore(self, state) -> None:
        inner_state, depth = state
        self._inner._acquire_restore(inner_state)
        ls = _LOCAL
        ls.depths[self.uid] = depth
        ls.order.append(self)

    def _is_owned(self) -> bool:
        return self._inner._is_owned()

    def locked(self) -> bool:  # RLock grew .locked() only in 3.12
        owned = getattr(self._inner, "_is_owned", None)
        return owned() if owned else False


def _make_lock() -> SanLock:
    return SanLock(_STATE.orig_lock())


def _make_rlock() -> SanRLock:
    return SanRLock(_STATE.orig_rlock())


def install() -> None:
    """Patch ``threading.Lock``/``RLock`` so every lock created from
    now on is instrumented. Refcounted: nested install/uninstall pairs
    (a sanitizer unit test inside a sanitized session) are
    safe."""
    with _REG_LOCK:
        _STATE.installed += 1
        if _STATE.installed > 1:
            return
        _STATE.orig_lock = threading.Lock
        _STATE.orig_rlock = threading.RLock
    threading.Lock = _make_lock
    threading.RLock = _make_rlock


def uninstall() -> None:
    with _REG_LOCK:
        if _STATE.installed == 0:
            return
        _STATE.installed -= 1
        if _STATE.installed:
            return
    threading.Lock = _STATE.orig_lock
    threading.RLock = _STATE.orig_rlock


def installed() -> bool:
    return _STATE.installed > 0


def reset() -> None:
    """Drop recorded edges/trips (per-thread locksets of locks
    currently HELD are kept — they are live state, not history)."""
    with _REG_LOCK:
        _STATE.edges.clear()
        _STATE.tripped.clear()
        _STATE.trips.clear()
        _STATE.recorder = FlightRecorder(256, name="fluidsan")


def trips() -> list:
    with _REG_LOCK:
        return list(_STATE.trips)


def edge_records() -> list:
    with _REG_LOCK:
        return list(_STATE.edges.values())


def edges_by_site(repo_only: bool = True) -> set:
    """Observed acquisition-order edges aggregated to creation sites
    — the identity the static lock graph shares
    (analysis/concurrency.Analysis.lock_edges_by_site). Self-pairs
    (two instances from the same site) are kept: the static graph
    models them as one lock class too."""
    out = set()
    for rec in edge_records():
        a = (rec.first_site.relpath, rec.first_site.line)
        b = (rec.second_site.relpath, rec.second_site.line)
        if repo_only and not (
            a[0].startswith("fluidframework_tpu_torch/")
            and b[0].startswith("fluidframework_tpu_torch/")
        ):
            continue
        out.add((a, b))
    return out
