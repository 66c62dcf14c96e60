"""Unified metrics registry: counters, gauges and histograms with
label sets, Prometheus-style text exposition and a flat view for deltas.

A copy of the reference's ``obs/metrics.py``, trimmed to what the port
uses: one process-wide :data:`REGISTRY` that the sidecars, the pools,
the heat ledger, the fault plane, the breaker, the profiler and the
sanitizer register their families in. Family, label and kind names are
the reference's letter for letter, so a dashboard reads both packages
alike.

Conventions: snake_case names, ``_total`` suffix on counters, ``_ms``
suffix on duration histograms, label sets small and bounded (never a
document id). Per-INSTANCE exact counts stay on the owning object
(``sidecar.grow_count``, ``sidecar.stats``); the registry is the
process-wide AGGREGATE view. Every update is host-side Python: nothing
here reads a device tensor.
"""
from __future__ import annotations

import threading
from typing import Optional, Sequence

# one lock for the whole module: registration is rare, updates are a
# single add under a short critical section (contention-free at the
# rates a Python service plane reaches)
_LOCK = threading.Lock()

# default duration buckets, in ms (sub-ms host packing up to
# multi-second stalls)
DEFAULT_BUCKETS_MS = (
    0.1, 0.5, 1.0, 5.0, 10.0, 50.0, 100.0, 500.0, 1000.0, 5000.0,
)


def _label_key(labelnames: Sequence[str], labels: dict) -> tuple:
    if set(labels) != set(labelnames):
        raise ValueError(
            f"labels {sorted(labels)} do not match declared "
            f"labelnames {sorted(labelnames)}"
        )
    return tuple(str(labels[name]) for name in labelnames)


def _escape_label_value(value: str) -> str:
    """Prometheus exposition format 0.0.4: label values escape
    backslash, double-quote and newline."""
    return (
        value.replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _escape_help(text: str) -> str:
    """HELP lines escape backslash and newline (quotes are legal)."""
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _render_labels(labelnames: Sequence[str], key: tuple) -> str:
    if not labelnames:
        return ""
    inner = ",".join(
        f'{name}="{_escape_label_value(value)}"'
        for name, value in zip(labelnames, key)
    )
    return "{" + inner + "}"


class _Child:
    """One (family, label-values) time series."""

    __slots__ = ("_value",)

    def __init__(self) -> None:
        self._value = 0.0

    @property
    def value(self) -> float:
        return self._value


class Counter(_Child):
    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        with _LOCK:
            self._value += amount


class Gauge(_Child):
    def set(self, value: float) -> None:
        with _LOCK:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with _LOCK:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        with _LOCK:
            self._value -= amount


class Histogram:
    """Cumulative-bucket histogram (Prometheus semantics)."""

    __slots__ = ("buckets", "counts", "count", "sum")

    def __init__(self, buckets: Sequence[float] = DEFAULT_BUCKETS_MS):
        self.buckets = tuple(sorted(buckets))
        self.counts = [0] * (len(self.buckets) + 1)  # +inf last
        self.count = 0
        self.sum = 0.0

    def observe(self, value: float) -> None:
        with _LOCK:
            self.count += 1
            self.sum += value
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    self.counts[i] += 1
                    break
            else:
                self.counts[-1] += 1

    @property
    def value(self) -> dict:
        cumulative = []
        running = 0
        for c in self.counts:
            running += c
            cumulative.append(running)
        return {
            "count": self.count,
            "sum": self.sum,
            "buckets": {
                ("+Inf" if i == len(self.buckets) else str(b)): c
                for (i, c), b in zip(
                    enumerate(cumulative),
                    list(self.buckets) + [None],
                )
            },
        }


_CHILD_TYPES = {"counter": Counter, "gauge": Gauge,
                "histogram": Histogram}


class _Family:
    """A named metric with a fixed label schema; children are the
    per-label-value series. With no labelnames the family proxies its
    single anonymous child, so ``registry.counter("x").inc()`` works
    without a ``labels()`` call."""

    def __init__(self, name: str, kind: str, help: str,
                 labelnames: Sequence[str],
                 buckets: Optional[Sequence[float]] = None):
        self.name = name
        self.kind = kind
        self.help = help
        self.labelnames = tuple(labelnames)
        self._buckets = buckets
        self._children: dict[tuple, object] = {}
        if not self.labelnames:
            self._children[()] = self._new_child()

    def _new_child(self):
        if self.kind == "histogram":
            return Histogram(self._buckets or DEFAULT_BUCKETS_MS)
        return _CHILD_TYPES[self.kind]()

    def labels(self, **labels):
        key = _label_key(self.labelnames, labels)
        with _LOCK:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._new_child()
        return child

    # no-label convenience proxies
    def _solo(self):
        if self.labelnames:
            raise ValueError(
                f"metric {self.name!r} declares labels "
                f"{self.labelnames}; call .labels(...) first"
            )
        return self._children[()]

    def inc(self, amount: float = 1.0) -> None:
        self._solo().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._solo().dec(amount)

    def set(self, value: float) -> None:
        self._solo().set(value)

    def observe(self, value: float) -> None:
        self._solo().observe(value)

    @property
    def value(self):
        return self._solo().value

    def series(self) -> dict[str, object]:
        with _LOCK:
            items = list(self._children.items())
        return {
            _render_labels(self.labelnames, key) or "": child
            for key, child in items
        }


class MetricsRegistry:
    """The family registry. Re-registering an existing name returns
    the SAME family (modules may be imported in any order and several
    instances share the aggregate series), but a kind or label-schema
    mismatch fails loudly — two definitions of one name is a bug."""

    def __init__(self) -> None:
        self._families: dict[str, _Family] = {}

    def _register(self, name: str, kind: str, help: str,
                  labelnames: Sequence[str],
                  buckets: Optional[Sequence[float]] = None) -> _Family:
        with _LOCK:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind or fam.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{fam.kind}{fam.labelnames}, not "
                        f"{kind}{tuple(labelnames)}"
                    )
                return fam
            fam = _Family(name, kind, help, labelnames, buckets)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> _Family:
        return self._register(name, "counter", help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> _Family:
        return self._register(name, "gauge", help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Optional[Sequence[float]] = None) -> _Family:
        return self._register(name, "histogram", help, labelnames,
                              buckets)

    def get(self, name: str) -> Optional[_Family]:
        """The registered family, or None."""
        with _LOCK:
            return self._families.get(name)

    # -- exposition ----------------------------------------------------

    def flat(self) -> dict[str, float]:
        """Flat scalar view for deltas: 'name{labels}' -> number
        (histograms flatten to _count/_sum)."""
        out: dict[str, float] = {}
        with _LOCK:
            families = list(self._families.values())
        for fam in families:
            for labels, child in fam.series().items():
                if isinstance(child, Histogram):
                    out[f"{fam.name}_count{labels}"] = child.count
                    out[f"{fam.name}_sum{labels}"] = child.sum
                else:
                    out[f"{fam.name}{labels}"] = child.value
        return out

    def delta(self, before: dict[str, float]) -> dict[str, float]:
        """Nonzero changes of the flat view since ``before`` (a prior
        ``flat()``)."""
        now = self.flat()
        out = {}
        for key, value in now.items():
            change = value - before.get(key, 0.0)
            if change:
                out[key] = change
        return out

    def render_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        lines: list[str] = []
        with _LOCK:
            families = list(self._families.values())
        for fam in sorted(families, key=lambda f: f.name):
            if fam.help:
                lines.append(
                    f"# HELP {fam.name} {_escape_help(fam.help)}"
                )
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            for labels, child in sorted(fam.series().items()):
                if isinstance(child, Histogram):
                    value = child.value
                    base = labels[:-1] + "," if labels else "{"
                    for bound, count in value["buckets"].items():
                        lines.append(
                            f'{fam.name}_bucket{base}le="{bound}"}} '
                            f"{count}"
                        )
                    lines.append(
                        f"{fam.name}_sum{labels} {value['sum']}"
                    )
                    lines.append(
                        f"{fam.name}_count{labels} {value['count']}"
                    )
                else:
                    lines.append(f"{fam.name}{labels} {child.value}")
        return "\n".join(lines) + "\n"


# THE process-wide registry: modules register families at import and
# bump them freely.
REGISTRY = MetricsRegistry()
