"""Metrics federation — one merged view over many node registries.

The registry (obs/metrics.py) is deliberately process-wide, but the
plane stopped being one process-shaped thing: the replicated
sequencer keeps leader + follower nodes, the partitioned plane keeps
per-partition workers, and an in-process multi-node harness (chaos,
test_replication) runs several of them side by side. This module is
the fleet half: a :class:`FederatedView` merges any number of node
registries (live references or wire snapshots) into ONE registry with
Prometheus-semantics merge rules, so every existing consumer —
``render_prometheus``, ``snapshot``, ``flat``/``delta``, and the SLO
engine — reads the whole plane through the surface it already knows.

Merge semantics, per family kind:

- **counter**: per-label-set SUM across nodes (a fleet total).
- **histogram**: bucket-wise merge — per-bucket counts, count and sum
  all add; bucket bounds must agree across nodes (same code registers
  the family everywhere), a mismatch fails loudly.
- **gauge**: gauges are node state, not fleet arithmetic — each
  node's series keeps its identity under an added ``node`` label
  (last write per (node, labels); a source series that already
  carries a ``node`` label is trusted as-is).

The merged output lives in ``view.registry`` (node id ``"fleet"``)
and is REWRITTEN IN PLACE by ``refresh()``: child objects keep their
identity across refreshes, which is exactly what lets an
``SloEngine(registry=view.registry, refresh=view.refresh)`` bind a
per-partition goodput objective once and grade the whole plane on
every tick (obs/slo.py).

Riding along, on the fleet registry itself: ``fleet_nodes`` (nodes
federated into the view) and ``fleet_snapshot_age_s`` (age of the
oldest merged snapshot — 0 while every node is a live registry;
clock-injectable, so deterministic under the step clock).

Served over the wire as the ``fleet-metrics`` ingress frame and the
``python -m fluidframework_tpu_torch.service --dump-fleet HOST:PORT`` CLI
(docs/OBSERVABILITY.md "Fleet observability").
"""
from __future__ import annotations

import re
import time
from typing import Callable, Optional

from . import metrics as obs_metrics
from .metrics import Histogram, MetricsRegistry

# inverse of metrics._render_labels: rendered label strings are the
# snapshot's series keys, and federation must re-key gauges by node —
# the escape rules are metrics._escape_label_value's, unescaped below
_LABEL_RE = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')


def _unescape(value: str) -> str:
    return re.sub(
        r"\\(.)",
        lambda m: "\n" if m.group(1) == "n" else m.group(1),
        value,
    )


def parse_labels(rendered: str) -> list[tuple[str, str]]:
    """``'{a="x",b="y"}'`` -> ``[("a","x"), ("b","y")]`` (order
    preserved — rendered order IS the family's labelname order)."""
    if not rendered:
        return []
    return [(k, _unescape(v)) for k, v in _LABEL_RE.findall(rendered)]


def _bucket_bound(key: str) -> float:
    return float("inf") if key == "+Inf" else float(key)


def _per_bucket(value: dict) -> dict[str, int]:
    """Histogram snapshot buckets are CUMULATIVE; merge needs
    per-bucket counts."""
    out = {}
    prev = 0
    for key in sorted(value["buckets"], key=_bucket_bound):
        c = value["buckets"][key]
        out[key] = c - prev
        prev = c
    return out


def merge_top_k(per_node: list, k: int) -> list:
    """Merge per-node top-k cuts (lists of ``[key, value]``) into one
    fleet cut: per-key SUM across nodes (a document attributed on two
    nodes costs their total), then the deterministic heat ordering —
    descending value, ties ascending by key. Feed it each node's full
    served cut; like any federated top-k it is exact only down to the
    per-node cut depth."""
    totals: dict = {}
    for entries in per_node:
        for key, value in entries:
            totals[key] = totals.get(key, 0.0) + float(value)
    order = sorted(totals.items(),
                   key=lambda kv: (-kv[1], str(kv[0])))
    return [[key, value] for key, value in order[:k]]


class FederatedView:
    """Leader + follower + partition-worker registries, one view.

    ``add_registry`` federates a LIVE registry (re-snapshotted on
    every refresh — age 0); ``add_snapshot`` federates a wire
    snapshot (a remote node's ``metrics`` frame payload) with its
    capture time, which is what ``fleet_snapshot_age_s`` measures.
    One node id, one source: re-adding a node replaces it."""

    def __init__(self, clock: Optional[Callable[[], float]] = None):
        self.clock = clock or time.time
        self._live: dict[str, MetricsRegistry] = {}
        self._static: dict[str, tuple[dict, float]] = {}
        # node -> {"docs": [[key, ms]...], "tenants": [[key, ms]...]}
        # (served heat cuts — see add_heat / heat_top_k)
        self._heat: dict[str, dict] = {}
        self.registry = MetricsRegistry(node="fleet")
        self._g_nodes = self.registry.gauge(
            "fleet_nodes", "node registries federated into this view")
        self._g_age = self.registry.gauge(
            "fleet_snapshot_age_s",
            "age of the oldest merged node snapshot (0 = all live)")

    # -- membership -----------------------------------------------------

    def add_registry(self, node: str,
                     registry: MetricsRegistry) -> None:
        if registry is self.registry:
            raise ValueError(
                "a FederatedView must not federate its own output "
                "registry (that feedback loop double-counts every "
                "refresh)")
        self._static.pop(node, None)
        self._live[node] = registry

    def add_snapshot(self, node: str, snapshot: dict,
                     captured_at: Optional[float] = None) -> None:
        self._live.pop(node, None)
        self._static[node] = (
            snapshot,
            self.clock() if captured_at is None else captured_at,
        )

    def nodes(self) -> list[str]:
        return sorted(set(self._live) | set(self._static))

    # -- heat (cost attribution, obs/heat.py) ---------------------------

    def add_heat(self, node: str, docs: list, tenants: list) -> None:
        """Federate one node's served heat cut (the ``docs`` /
        ``tenants`` lists of its ``heat`` frame). One node id, one
        cut: re-adding replaces, like add_registry/add_snapshot."""
        self._heat[node] = {
            "docs": [list(e) for e in docs],
            "tenants": [list(e) for e in tenants],
        }

    def heat_top_k(self, k: int = 10) -> dict:
        """The fleet heat view: per-key sums across every federated
        node cut, re-ranked by the deterministic heat ordering."""
        nodes = sorted(self._heat)
        return {
            "docs": merge_top_k(
                [self._heat[n]["docs"] for n in nodes], k),
            "tenants": merge_top_k(
                [self._heat[n]["tenants"] for n in nodes], k),
        }

    # -- the merge ------------------------------------------------------

    def refresh(self) -> dict:
        """Re-merge every node and rewrite ``self.registry`` in
        place; returns the merged snapshot (the fleet registry's
        ``snapshot()``, own fleet_* gauges included)."""
        now = self.clock()
        sources = [
            (node, reg.snapshot(), now)
            for node, reg in sorted(self._live.items())
        ] + [
            (node, snap, at)
            for node, (snap, at) in sorted(self._static.items())
        ]
        merged: dict[str, dict] = {}
        for node, snap, _at in sources:
            for name, fam in snap.items():
                entry = merged.setdefault(name, {
                    "type": fam["type"], "help": fam["help"],
                    "values": {},
                })
                if entry["type"] != fam["type"]:
                    raise ValueError(
                        f"family {name!r} registered as "
                        f"{entry['type']} on one node and "
                        f"{fam['type']} on {node!r} — two definitions "
                        "of one name is a bug (the registry's own "
                        "contract, fleet-wide)")
                self._merge_family(entry, fam, node, name)
        self._write_through(merged)
        self._g_nodes.set(len(sources))
        oldest = min((at for _, _, at in sources), default=now)
        self._g_age.set(max(0.0, now - oldest))
        return self.registry.snapshot()

    @staticmethod
    def _merge_family(entry: dict, fam: dict, node: str,
                      name: str) -> None:
        kind = fam["type"]
        for labels, value in fam["values"].items():
            if kind == "counter":
                entry["values"][labels] = (
                    entry["values"].get(labels, 0.0) + value)
            elif kind == "histogram":
                have = entry["values"].get(labels)
                if have is None:
                    entry["values"][labels] = {
                        "count": value["count"], "sum": value["sum"],
                        "per_bucket": _per_bucket(value),
                    }
                else:
                    if set(have["per_bucket"]) != set(value["buckets"]):
                        raise ValueError(
                            f"histogram {name!r}: bucket bounds "
                            f"disagree across nodes (node {node!r}) — "
                            "the same code must register the family "
                            "everywhere")
                    have["count"] += value["count"]
                    have["sum"] += value["sum"]
                    for key, c in _per_bucket(value).items():
                        have["per_bucket"][key] += c
            else:  # gauge: node state — keep per-node identity
                parsed = parse_labels(labels)
                if not any(k == "node" for k, _ in parsed):
                    parsed = [("node", node)] + parsed
                entry["values"][tuple(parsed)] = value

    def _write_through(self, merged: dict) -> None:
        """Write the merged values into the fleet registry IN PLACE
        (child identity survives refreshes — the SLO binding
        contract), then prune series/families the current merge no
        longer produces (a replaced node's ghost metrics must not be
        served forever). Direct child-value writes under the module
        lock are the registry's own reset() idiom."""
        written: set[tuple[str, tuple]] = set()
        for name, entry in merged.items():
            kind = entry["type"]
            if kind == "gauge":
                for parsed, value in entry["values"].items():
                    labelnames = tuple(k for k, _ in parsed)
                    fam = self.registry.gauge(
                        name, entry["help"], labelnames=labelnames)
                    child = fam.labels(**dict(parsed)) \
                        if labelnames else fam._solo()
                    child.set(value)
                    written.add((name, tuple(
                        v for _, v in parsed)))
                continue
            for labels, value in entry["values"].items():
                parsed = parse_labels(labels)
                labelnames = tuple(k for k, _ in parsed)
                written.add((name, tuple(v for _, v in parsed)))
                if kind == "counter":
                    fam = self.registry.counter(
                        name, entry["help"], labelnames=labelnames)
                    child = fam.labels(**dict(parsed)) \
                        if labelnames else fam._solo()
                    with obs_metrics._LOCK:
                        child._value = float(value)
                else:  # histogram
                    bounds = tuple(sorted(
                        (_bucket_bound(k)
                         for k in value["per_bucket"]
                         if k != "+Inf")))
                    fam = self.registry.histogram(
                        name, entry["help"], labelnames=labelnames,
                        buckets=bounds)
                    child = fam.labels(**dict(parsed)) \
                        if labelnames else fam._solo()
                    assert isinstance(child, Histogram)
                    by_bound = {
                        _bucket_bound(k): c
                        for k, c in value["per_bucket"].items()
                    }
                    with obs_metrics._LOCK:
                        child.count = value["count"]
                        child.sum = value["sum"]
                        child.counts = [
                            by_bound[b] for b in child.buckets
                        ] + [by_bound.get(float("inf"), 0)]
        self._prune(written)

    def _prune(self, written: set) -> None:
        """Drop fleet-registry series (and emptied families) the
        current merge did not produce: a node replaced by a snapshot
        without some family must not leave its old values being
        served forever. The view's own gauges are exempt. A pruned
        series a bound SLO objective still holds simply stops moving
        (its window deltas read zero) — the documented shape of
        binding to a family the fleet stopped exporting."""
        own = {"fleet_nodes", "fleet_snapshot_age_s"}
        with obs_metrics._LOCK:
            for name in list(self.registry._families):
                if name in own:
                    continue
                fam = self.registry._families[name]
                for key in list(fam._children):
                    if (name, key) not in written:
                        del fam._children[key]
                if not fam._children:
                    del self.registry._families[name]

    # -- convenience ----------------------------------------------------

    def counter_totals(self) -> dict[str, float]:
        """Flat fleet counter totals ('name{labels}' -> value) from a
        fresh refresh — what the chaos federation differential
        compares bit-for-bit across same-seed runs."""
        merged = self.refresh()
        out = {}
        for name, fam in merged.items():
            if fam["type"] != "counter":
                continue
            for labels, value in fam["values"].items():
                out[f"{name}{labels}"] = round(float(value), 9)
        return out
