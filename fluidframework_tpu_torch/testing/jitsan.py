"""jitsan — the port's runtime launch-signature and donation sanitizer.

The counterpart of the reference's ``testing/jitsan.py``, with the same
surface (``install``, ``uninstall``, ``installed``, ``reset``,
``trips``, ``donation_events``, ``compile_counts``,
``publish_compiles``):

- **launch signatures**: eager torch compiles nothing per shape, so
  where the reference read XLA's per-root compile caches, jitsan counts
  the DISTINCT LAUNCH SIGNATURES per root while installed — the window
  kernel's (docs, capacity, window; its instantiation ``Q`` is a
  function of the capacity and adds none), the
  macro-step routes' (docs, capacity, K, window), ``compact``'s and
  ``pad_capacity``'s shapes, the mesh pool's (shards, rows, capacity,
  window) and its row moves', the tree plane's (route, docs, capacity)
  and its pad step's, and the sequence-sharded window's. Each count
  must stay within the bound ``ops/bucket_ladder.ladder_bounds`` (and
  ``tree_ladder_bounds``) gives for the route: one more means an
  unladdered call site reached the device with a shape the ladder does
  not hold. Only the outermost call counts (the pool's window kernel
  launches count under ``mesh_pool``). ``nvcc_builds()`` gives the
  window kernel's builds per source hash, which must be at most one per
  process. ``publish_compiles`` feeds the reference's
  ``jax_compiles_total{root}`` family, so the registry reads alike.
- **donation traps**: the donating twins (``apply_window_pingpong``,
  ``apply_window_chunked_pingpong``, ``apply_window_egwalker_pingpong``)
  consume their ``dead`` table, and ``shard_moves.migrate_rows`` its
  source. After such a dispatch the consumed table's tensor OBJECTS are
  retired: any torch operation that reads one raises ``RuntimeError`` at
  the read site (a ``TorchFunctionMode`` over the retired tensors, on
  the installing thread). The twins' outputs live in the retired
  storage but come back as new tensor objects (views), so they pass. A
  donated table that shares storage with a live input of the same
  dispatch records a :class:`Trip` (the twin then raises, as it does
  uninstalled).

It works on the CPU and on the card alike. Enable it with ``install()``
/ ``uninstall()`` (refcounted), or for a whole process with
``FFTPU_SANITIZE=1``: the sidecars call ``install_from_env()`` when they
are built.
"""
from __future__ import annotations

import dataclasses
import functools
import importlib
import inspect
import os
import sys
import threading
import weakref
from typing import Callable, Optional

import torch
from torch.overrides import TorchFunctionMode

from ..obs import metrics as obs_metrics

_M_COMPILES = obs_metrics.REGISTRY.counter(
    "jax_compiles_total",
    "XLA compilations per kernel jit root (distinct input "
    "signatures entering the root's jit cache)",
    labelnames=("root",),
)

_LOCK = threading.Lock()
_PKG = "fluidframework_tpu_torch"


def _window(batch) -> int:
    kind = batch["kind"] if isinstance(batch, dict) else batch.kind
    return int(kind.shape[-1])


def _b1(a) -> tuple:
    t = a["table"]
    return (t.docs, t.capacity, _window(a["batch"]))


def _macro(program: str) -> Callable:
    def sig(a) -> tuple:
        t = a["table"]
        return (t.docs, t.capacity, a["K"], _window(a[program]))
    return sig


def _sharded(a) -> tuple:
    t = a["table"]
    return (len(t.shards), t.rows_per_shard, t.capacity)


# (module, function) -> (root, root when ``dead`` is None, signature of
# the bound arguments, the donated argument or None)
_WRAPPED = {
    ("ops.merge_kernel", "apply_window"):
        ("apply_window", None, _b1, None),
    ("ops.merge_kernel", "apply_window_pingpong"):
        ("apply_window_pingpong", None, _b1, "dead"),
    ("ops.merge_kernel", "pad_capacity"):
        ("pad_capacity", None,
         lambda a: (a["table"].docs, a["table"].capacity,
                    a["new_capacity"]), None),
    ("ops.merge_kernel", "compact"):
        ("compact", None,
         lambda a: (a["table"].docs, a["table"].capacity), None),
    ("ops.merge_chunk", "apply_window_chunked"):
        ("chunked", None, _macro("chunked"), None),
    ("ops.merge_chunk", "apply_window_chunked_pingpong"):
        ("chunked_pingpong", "chunked", _macro("chunked"), "dead"),
    ("ops.event_graph", "apply_window_egwalker"):
        ("egwalker", None, _macro("prefix"), None),
    ("ops.event_graph", "apply_window_egwalker_pingpong"):
        ("egwalker_pingpong", "egwalker", _macro("prefix"), "dead"),
    ("parallel.mesh_pool", "apply_window_mesh_sharded"):
        ("mesh_pool", None,
         lambda a: (*_sharded(a), _window(a["batch"])), None),
    ("ops.shard_moves", "migrate_rows"):
        ("mesh_move", None, _sharded, "table"),
    ("parallel.seq_shard", "apply_window_seq_sharded"):
        ("seq_shard", None,
         lambda a: (a["table"].docs, a["table"].capacity,
                    _window(a["batch"]), a["mesh"].shape[a["seq_axis"]]),
         None),
    ("ops.tree_apply", "apply_tree_window"):
        ("tree_window", None,
         lambda a: (a["route"], a["table"].docs, a["table"].slots), None),
    ("ops.tree_apply", "pad_tree_capacity"):
        ("tree_pad", None,
         lambda a: (a["table"].docs, a["table"].slots, a["new_slots"]),
         None),
}

ROOTS = tuple(sorted({root for root, plain, _, _ in _WRAPPED.values()}
                     | {plain for _, plain, _, _ in _WRAPPED.values()
                        if plain is not None}))


@dataclasses.dataclass
class DonationEvent:
    """One donating dispatch jitsan consumed: ``retired`` tensors are
    now read traps."""

    root: str
    retired: int


@dataclasses.dataclass
class Trip:
    """A donated table that shares storage with a live input of the same
    dispatch: the twin would write its output over what it still
    reads."""

    root: str
    description: str

    def describe(self) -> str:
        return (f"jitsan: donated argument of {self.root} shares storage "
                f"with a live input of the same dispatch "
                f"({self.description})")


class _RetiredReadTrap(TorchFunctionMode):
    """Raises at any torch operation that is handed a retired tensor."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _STATE.retired:
            for t in _tensors((args, kwargs)):
                ref = _STATE.retired.get(id(t))
                if ref is not None and ref() is t:
                    raise RuntimeError(
                        f"jitsan: {getattr(func, '__name__', func)} reads a "
                        "tensor of a table donated to an earlier dispatch "
                        "(its storage now holds that dispatch's output)")
        return func(*args, **kwargs)


class _State:
    def __init__(self) -> None:
        self.installed = 0
        self.env_installed = False
        self.since_reset: dict[str, set] = {}
        self.ever: dict[str, set] = {}
        self.published: dict[str, int] = {}
        self.donations: list[DonationEvent] = []
        self.trips: list[Trip] = []
        self.originals: list[tuple] = []  # (module, attr, original)
        self.retired: dict[int, weakref.ref] = {}
        self.mode: Optional[_RetiredReadTrap] = None
        self.depth = threading.local()


_STATE = _State()


def _tensors(tree) -> list:
    """The tensors of nested tuples / lists / dicts (NamedTuple tables
    and batches included) and of doc-sharded tables."""
    out, stack = [], [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (tuple, list)):
            stack.extend(x)
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif hasattr(x, "shards"):
            stack.extend(x.shards)
    return out


def _storages(tensors) -> set:
    return {t.untyped_storage().data_ptr() for t in tensors
            if t.untyped_storage().nbytes()}


def _record(root: str, sig: tuple) -> None:
    with _LOCK:
        _STATE.since_reset.setdefault(root, set()).add(sig)
        _STATE.ever.setdefault(root, set()).add(sig)


def _retire(root: str, tensors: list) -> None:
    def forget(_ref, key):
        _STATE.retired.pop(key, None)

    with _LOCK:
        for t in tensors:
            key = id(t)
            _STATE.retired[key] = weakref.ref(
                t, functools.partial(forget, key=key))
        _STATE.donations.append(DonationEvent(root, len(tensors)))


def _rebind(out, ids: set):
    """``out`` with every tensor object in ``ids`` replaced by a view of
    itself: the same storage, a new object that is not retired."""
    if isinstance(out, torch.Tensor):
        return out.view(out.shape) if id(out) in ids else out
    if isinstance(out, tuple) and hasattr(out, "_fields"):
        return type(out)(*(_rebind(x, ids) for x in out))
    return out


def _wrap(fn, root: str, plain_root: Optional[str], sig: Callable,
          donated: Optional[str]):
    params = inspect.signature(fn)

    @functools.wraps(fn)
    def run(*args, **kwargs):
        depth = getattr(_STATE.depth, "n", 0)
        if depth:  # a nested call counts under the outermost root
            return fn(*args, **kwargs)
        bound = params.bind(*args, **kwargs)
        bound.apply_defaults()
        a = bound.arguments
        dead = a.get(donated) if donated else None
        name = root if donated is None or dead is not None else plain_root
        _record(name, sig(a))
        dead_tensors = []
        if dead is not None:
            dead_tensors = _tensors(dead)
            live = _tensors([v for k, v in a.items() if k != donated])
            if donated == "dead" and \
                    _storages(dead_tensors) & _storages(live):
                trip = Trip(root, f"{len(dead_tensors)} donated tensors, "
                                  f"{len(live)} live inputs")
                with _LOCK:
                    _STATE.trips.append(trip)
                print(trip.describe(), file=sys.stderr, flush=True)
        _STATE.depth.n = depth + 1
        try:
            out = fn(*args, **kwargs)
        finally:
            _STATE.depth.n = depth
        if dead_tensors:
            out = _rebind(out, {id(t) for t in dead_tensors})
            _retire(root, dead_tensors)
        return out

    run.__jitsan_wrapped__ = fn
    return run


def _patch_everywhere(mod_name: str, attr: str, wrapper) -> None:
    """Replace ``mod_name.attr`` AND every same-object import of it
    across the port's loaded modules (``from ..ops.merge_kernel import
    apply_window`` holds the function by value)."""
    original = getattr(sys.modules[mod_name], attr)
    for mod in list(sys.modules.values()):
        if mod is None or not getattr(mod, "__name__", "").startswith(_PKG):
            continue
        if getattr(mod, attr, None) is original:
            setattr(mod, attr, wrapper)
            with _LOCK:
                _STATE.originals.append((mod, attr, original))


# ---------------------------------------------------------------------------
# counts


def compile_counts() -> dict[str, int]:
    """Distinct launch signatures per root since ``install()`` /
    ``reset()``."""
    with _LOCK:
        return {root: len(_STATE.since_reset.get(root, ()))
                for root in ROOTS}


def publish_compiles() -> dict[str, int]:
    """Advance ``jax_compiles_total{root}`` to the distinct signatures
    seen per root in this process (monotone watermarks, so repeated calls
    never double-count) and return those totals."""
    with _LOCK:
        sizes = {root: len(_STATE.ever.get(root, ())) for root in ROOTS}
        deltas = {root: n - _STATE.published.get(root, 0)
                  for root, n in sizes.items()
                  if n > _STATE.published.get(root, 0)}
        _STATE.published.update({root: sizes[root] for root in deltas})
    for root, delta in deltas.items():
        _M_COMPILES.labels(root=root).inc(delta)
    return sizes


def nvcc_builds() -> dict[str, int]:
    """``nvcc`` builds of the window kernel this process made, per
    library file (named by the hash of its source and flags)."""
    from ..ops import cuda_merge

    return dict(cuda_merge.BUILDS)


# ---------------------------------------------------------------------------
# lifecycle


def install() -> None:
    """Arm the sanitizer: import the dispatch modules, wrap their entry
    points, and push the read trap on this thread. Refcounted (nested
    install/uninstall pairs are safe)."""
    with _LOCK:
        _STATE.installed += 1
        if _STATE.installed > 1:
            return
    for (mod_name, _attr) in _WRAPPED:
        importlib.import_module(f"{_PKG}.{mod_name}")
    for (mod_name, attr), (root, plain, sig, donated) in _WRAPPED.items():
        full = f"{_PKG}.{mod_name}"
        fn = getattr(sys.modules[full], attr)
        _patch_everywhere(full, attr, _wrap(fn, root, plain, sig, donated))
    _STATE.mode = _RetiredReadTrap()
    _STATE.mode.__enter__()
    reset()


def install_from_env() -> None:
    """``install()`` once per process when ``FFTPU_SANITIZE=1``; the
    sidecars call this when they are built."""
    if os.environ.get("FFTPU_SANITIZE") != "1" or _STATE.env_installed:
        return
    _STATE.env_installed = True
    install()


def uninstall() -> None:
    with _LOCK:
        if _STATE.installed == 0:
            return
        _STATE.installed -= 1
        if _STATE.installed:
            return
        originals = list(_STATE.originals)
        _STATE.originals.clear()
    for mod, attr, original in originals:
        setattr(mod, attr, original)
    # a module first imported AFTER install() bound the wrapper by value
    # and was never recorded above: sweep for such copies
    by_attr = {attr: original for _, attr, original in originals}
    for mod in list(sys.modules.values()):
        if mod is None or not getattr(mod, "__name__", "").startswith(_PKG):
            continue
        for attr, original in by_attr.items():
            cur = getattr(mod, attr, None)
            if getattr(cur, "__jitsan_wrapped__", None) is original:
                setattr(mod, attr, original)
    if _STATE.mode is not None:
        _STATE.mode.__exit__(None, None, None)
        _STATE.mode = None
    with _LOCK:
        _STATE.retired.clear()


def installed() -> bool:
    return _STATE.installed > 0


def reset() -> None:
    """Re-baseline the signature counts and drop the recorded donation
    events and trips (retired tensors stay retired: they are live
    traps, not history)."""
    with _LOCK:
        _STATE.since_reset = {}
        _STATE.donations.clear()
        _STATE.trips.clear()


def trips() -> list[Trip]:
    with _LOCK:
        return list(_STATE.trips)


def donation_events() -> list[DonationEvent]:
    with _LOCK:
        return list(_STATE.donations)
