"""heat — the cost-attribution ledger (per-key EWMA + usage columns).

A copy of the reference's ``obs/heat.py``. ``HeatLedger`` is a
deterministic, clock-injectable per-key EWMA with accumulator columns,
fed from two planes of the port:

- **device-time attribution** (``service/gpu_sidecar.py``): each
  dispatch round's wall-ms splits across the documents active that
  round, proportional to ops applied (counts come from the pack
  metadata the sidecar already built — a rollup at the ``_settle`` sync
  boundary, never per-op bookkeeping and never a device read);
- **placement** (``parallel/mesh_pool.py``): the migration heuristic's
  per-member EWMA.

Layout is SoA on purpose: keys map to rows in parallel float64 columns
(one ``heat`` column plus caller-named accumulator columns), so the EWMA
tick and the top-k are vectorized numpy passes. The EWMA update
``heat*decay + depth`` is two elementwise correctly-rounded float64 ops
— bit-identical to the reference's, so a pool fed the same dispatch
depths makes the same migration choices.

Determinism contract: same key/charge sequence => bit-identical heat
table and top-k. Ranking ties break by KEY (lexsort over (key rank,
-value)), never by hash order or insertion accident. Cardinality is
LRU-capped: the ledger holds at most ``max_keys`` keys; inserting past
the cap evicts the least-recently-WRITTEN key (reads don't reorder) and
counts it in ``heat_ledger_evictions_total``. Wall time never enters
any value: the injectable ``clock`` only stamps ``last_seen`` for dump
surfaces.

The ledger is charged at the sidecar's settle boundary and ticked in the
mesh pool's dispatch path, so its methods are pure host math
(``analysis/synccheck.py`` roots its dispatch-loop rule at them).
"""
from __future__ import annotations

import time
from collections import OrderedDict
from typing import Callable, Iterable, Mapping, Optional, Sequence

import numpy as np

from . import metrics as obs_metrics

# Aggregate families only — per-doc / per-tenant values live on the
# ledger instances (the obs convention: ids never become label
# values; exact per-key numbers are read off the owning object).
_DOC_MS_TOTAL = obs_metrics.REGISTRY.counter(
    "heat_doc_ms_total",
    "device-time milliseconds attributed to documents by the sidecar "
    "attribution plane (aggregate across all documents; per-document "
    "splits live on the HeatLedger, served via the heat frame)")
_EVICTIONS_TOTAL = obs_metrics.REGISTRY.counter(
    "heat_ledger_evictions_total",
    "HeatLedger keys evicted at the max_keys cardinality cap "
    "(LRU by last write, the qos scope-map discipline)")
_TENANT_DEVICE_MS_TOTAL = obs_metrics.REGISTRY.counter(
    "tenant_device_ms_total",
    "device-time milliseconds attributed to tenants (aggregate; "
    "per-tenant splits live on the usage HeatLedger)")

_GROW_MIN = 16


class HeatLedger:
    """Deterministic per-key EWMA + accumulator columns over SoA rows.

    ``columns`` names extra float64 accumulator columns charged via
    :meth:`charge` keyword arguments (e.g. a tenant-usage ledger
    carries ``ops_offered``/``bytes_in``/... next to its heat).
    """

    def __init__(self, columns: Sequence[str] = (),
                 max_keys: int = 4096,
                 decay: float = 0.8,
                 clock: Optional[Callable[[], float]] = None) -> None:
        if max_keys < 1:
            raise ValueError("max_keys must be >= 1")
        self.max_keys = int(max_keys)
        self.decay = float(decay)
        self.column_names: tuple[str, ...] = tuple(columns)
        if "heat" in self.column_names:
            raise ValueError("'heat' is the built-in EWMA column")
        self._clock = clock if clock is not None else time.monotonic
        # key -> row, in least-recently-WRITTEN-first order
        self._index: "OrderedDict" = OrderedDict()
        self._free: list[int] = []
        cap = min(_GROW_MIN, self.max_keys)
        self._heat = np.zeros(cap, dtype=np.float64)
        self._last_seen = np.zeros(cap, dtype=np.float64)
        self._cols: dict[str, np.ndarray] = {
            name: np.zeros(cap, dtype=np.float64)
            for name in self.column_names
        }
        self.evictions = 0

    # -- row management ------------------------------------------------

    def __len__(self) -> int:
        return len(self._index)

    def __contains__(self, key) -> bool:
        return key in self._index

    def keys(self) -> list:
        """Live keys, least-recently-written first."""
        return list(self._index)

    def _grow(self) -> None:
        cap = len(self._heat)
        new_cap = min(max(cap * 2, _GROW_MIN), self.max_keys)
        if new_cap <= cap:
            return
        for name in ("_heat", "_last_seen"):
            old = getattr(self, name)
            arr = np.zeros(new_cap, dtype=np.float64)
            arr[:cap] = old
            setattr(self, name, arr)
        for cname, old in self._cols.items():
            arr = np.zeros(new_cap, dtype=np.float64)
            arr[:cap] = old
            self._cols[cname] = arr

    def _row(self, key) -> int:
        """Row for ``key``, inserting (and possibly evicting) if new.

        Every call is a WRITE touch: the key moves to the
        most-recently-written end of the LRU order.
        """
        row = self._index.get(key)
        if row is not None:
            self._index.move_to_end(key)
            return row
        if len(self._index) >= self.max_keys:
            _victim, vrow = self._index.popitem(last=False)
            self._zero_row(vrow)
            self._free.append(vrow)
            self.evictions += 1
            _EVICTIONS_TOTAL.inc()
        if self._free:
            row = self._free.pop()
        else:
            row = len(self._index)
            if row >= len(self._heat):
                self._grow()
        self._index[key] = row
        return row

    def _zero_row(self, row: int) -> None:
        self._heat[row] = 0.0
        self._last_seen[row] = 0.0
        for arr in self._cols.values():
            arr[row] = 0.0

    # -- mutation ------------------------------------------------------

    def ewma_tick(self, keys: Iterable, depths: Mapping,
                  decay: Optional[float] = None) -> None:
        """One EWMA step over ``keys`` (which must be unique):
        ``heat[k] = heat[k]*decay + float(depths.get(k, 0))``.

        Vectorized over the rows: one correctly-rounded multiply, one
        correctly-rounded add per key.
        """
        d = self.decay if decay is None else decay
        klist = list(keys)
        if not klist:
            return
        n = len(klist)
        rows = np.fromiter((self._row(k) for k in klist),
                           dtype=np.int64, count=n)
        dep = np.fromiter((float(depths.get(k, 0)) for k in klist),
                          dtype=np.float64, count=n)
        self._heat[rows] = self._heat[rows] * np.float64(d) + dep
        self._last_seen[rows] = self._clock()

    def charge(self, key, ms: float = 0.0, **column_adds: float) -> None:
        """Accumulate ``ms`` onto ``key``'s heat (no decay — charges
        are monotone cost, the EWMA applies only at ticks) plus any
        named accumulator columns."""
        row = self._row(key)
        if ms:
            self._heat[row] += float(ms)
        for name, value in column_adds.items():
            self._cols[name][row] += float(value)
        self._last_seen[row] = self._clock()

    def pop(self, key, default: float = 0.0) -> float:
        row = self._index.pop(key, None)
        if row is None:
            return default
        value = float(self._heat[row])
        self._zero_row(row)
        self._free.append(row)
        return value

    # -- reads (never reorder the LRU) ---------------------------------

    def get(self, key, default: float = 0.0) -> float:
        row = self._index.get(key)
        if row is None:
            return default
        return float(self._heat[row])

    def column(self, key, name: str, default: float = 0.0) -> float:
        row = self._index.get(key)
        if row is None:
            return default
        return float(self._cols[name][row])

    def top_k(self, k: int, by: Optional[str] = None) -> list:
        """Top-``k`` ``(key, value)`` by the heat column (or accumulator
        column ``by``), descending; ties break ascending by key.

        Vectorized: one gather + one lexsort over (key rank, -value).
        Keys of one ledger must be mutually orderable (all str or all
        int in practice); a mixed population falls back to str order.
        """
        items = list(self._index.items())
        if not items or k <= 0:
            return []
        n = len(items)
        rows = np.fromiter((r for _, r in items), dtype=np.int64,
                           count=n)
        source = self._heat if by is None else self._cols[by]
        vals = source[rows]
        keys = [key for key, _ in items]
        try:
            karr = np.array(keys)
            if karr.dtype == object or karr.ndim != 1:
                raise TypeError
        except (TypeError, ValueError):
            karr = np.array([str(key) for key in keys])
        rank = np.argsort(karr, kind="stable")
        inv = np.empty(n, dtype=np.int64)
        inv[rank] = np.arange(n, dtype=np.int64)
        order = np.lexsort((inv, -vals))
        return [(items[int(i)][0], float(vals[int(i)]))
                for i in order[:k]]

    def snapshot(self) -> dict:
        """key -> {"heat": .., "last_seen": .., <column>: ..} — the
        dump/serving surface (NOT the hot path)."""
        out = {}
        for key, row in self._index.items():
            entry = {
                "heat": float(self._heat[row]),
                "last_seen": float(self._last_seen[row]),
            }
            for name, arr in self._cols.items():
                entry[name] = float(arr[row])
            out[key] = entry
        return out


# Column set of a tenant-usage ledger (the ingress rollup, a later layer
# of the port, and the sidecar's device-ms attribution). The ledger's built-in heat column carries
# attributed device-ms for the tenant, so "hot tenants" ranks by the
# same unit as "hot documents".
USAGE_COLUMNS = (
    "ops_offered",
    "ops_ticketed",
    "bytes_in",
    "bytes_out",
    "sheds",
    "summary_uploads",
    "device_ms",
)


def usage_ledger(max_keys: int = 1024,
                 clock: Optional[Callable[[], float]] = None
                 ) -> HeatLedger:
    """A tenant-usage ledger with the canonical column set."""
    return HeatLedger(columns=USAGE_COLUMNS, max_keys=max_keys,
                      clock=clock)


def attribute_round(ledger: Optional[HeatLedger],
                    counts: Mapping,
                    round_ms: float,
                    usage: Optional[HeatLedger] = None,
                    tenant_of: Optional[Callable] = None) -> float:
    """Split one dispatch round's ``round_ms`` across the documents in
    ``counts`` (doc -> ops applied that round), proportional to ops.

    The conservation invariant — sum of per-doc charges equals
    ``round_ms`` up to float rounding of the proportional split — is
    pinned by the tests. Returns the total ms charged.

    Called at the sidecar's ``_settle`` boundary only: the counts are
    host-side ints read off the pack metadata, never a device fetch.
    When ``usage``/``tenant_of`` are given, each doc's charge also
    rolls up to its tenant's ``device_ms``.
    """
    if ledger is None or round_ms <= 0.0:
        return 0.0
    total = 0
    for n in counts.values():
        total += n
    if total <= 0:
        return 0.0
    charged = 0.0
    scale = float(round_ms) / float(total)
    for doc, n in counts.items():
        if n <= 0:
            continue
        ms = float(n) * scale
        ledger.charge(doc, ms)
        charged += ms
        if usage is not None and tenant_of is not None:
            tenant = tenant_of(doc)
            if tenant:
                usage.charge(tenant, ms, device_ms=ms)
                _TENANT_DEVICE_MS_TOTAL.inc(ms)
    _DOC_MS_TOTAL.inc(charged)
    return charged
