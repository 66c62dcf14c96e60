"""Span export: the canonical hop tables as OTLP-shaped trace JSON.

``obs/trace.py`` already reconstructs a sequenced op's submit→ack
path as an ordered hop table; this module converts that table into
the OTLP JSON trace shape (resourceSpans → scopeSpans → spans, the
protobuf-JSON mapping the OpenTelemetry collector's file exporter
writes) so the path opens in standard trace viewers. No new
dependencies: the format is plain JSON.

Span model: one ROOT span covers the whole submit→ack; each hop k
becomes a child span named ``service:action`` whose window is
[previous hop, hop k] — the segment of the pipeline that ENDED at
that stamp, mirroring ``breakdown()``'s delta_ms attribution. Ids
are deterministic (sha256 over the op identity), so re-exporting the
same op yields byte-identical output and cross-process exports of
one op share a trace id.

Fidelity: OTLP times are integer unix nanos, but hop timestamps are
float seconds — converting through nanos alone would lose sub-ns
float precision and break round-trips. Every span therefore carries
the exact source timestamp in a ``fluid.timestamp`` attribute
(``repr`` of the float), and :func:`otlp_to_hops` reconstructs the
hop table EXACTLY from it (pinned by tests/test_spans.py). The nano
fields remain what viewers render.
"""
from __future__ import annotations

import hashlib
import json
from typing import Iterable, Optional

from ..protocol.messages import Trace
from .trace import breakdown, hop_name

SCOPE_NAME = "fluidframework_tpu.obs"
RESOURCE_SERVICE_NAME = "fluidframework-tpu"


def _hex_id(seed: str, nbytes: int) -> str:
    return hashlib.sha256(seed.encode("utf-8")).hexdigest()[: 2 * nbytes]


def trace_id_for(document_id: str, client_id: str, csn: int) -> str:
    """Deterministic 16-byte OTLP trace id for one op's journey."""
    return _hex_id(f"trace:{document_id}:{client_id}:{csn}", 16)


def _span_id(trace_id: str, index: int) -> str:
    return _hex_id(f"span:{trace_id}:{index}", 8)


def _nanos(ts: float) -> str:
    # protobuf JSON maps fixed64 to a decimal STRING
    return str(int(round(ts * 1e9)))


def _attr(key: str, value) -> dict:
    if isinstance(value, str):
        return {"key": key, "value": {"stringValue": value}}
    if isinstance(value, int):
        return {"key": key, "value": {"intValue": str(value)}}
    return {"key": key, "value": {"doubleValue": value}}


def hops_to_spans(traces: Iterable[Trace], *,
                  trace_id: str, root_name: str = "submit_ack"
                  ) -> list[dict]:
    """The hop table as a list of OTLP span dicts (root first).
    Hops are sorted by stamp time, same as ``breakdown()``."""
    ordered = sorted(traces, key=lambda t: t.timestamp)
    if not ordered:
        return []
    root_id = _span_id(trace_id, 0)
    spans = [{
        "traceId": trace_id,
        "spanId": root_id,
        "name": root_name,
        "kind": 1,  # SPAN_KIND_INTERNAL
        "startTimeUnixNano": _nanos(ordered[0].timestamp),
        "endTimeUnixNano": _nanos(ordered[-1].timestamp),
        "attributes": [
            _attr("fluid.hops", len(ordered)),
        ],
    }]
    prev_ts = ordered[0].timestamp
    for i, t in enumerate(ordered):
        spans.append({
            "traceId": trace_id,
            "spanId": _span_id(trace_id, i + 1),
            "parentSpanId": root_id,
            "name": hop_name(t),
            "kind": 1,
            "startTimeUnixNano": _nanos(prev_ts),
            "endTimeUnixNano": _nanos(t.timestamp),
            "attributes": [
                _attr("fluid.service", t.service),
                _attr("fluid.action", t.action),
                _attr("fluid.hop_index", i),
                # exact float source-of-truth (see module docstring)
                _attr("fluid.timestamp", repr(t.timestamp)),
            ],
        })
        prev_ts = t.timestamp
    return spans


def op_to_otlp(traces: Iterable[Trace], *,
               document_id: str = "", client_id: str = "",
               csn: int = 0,
               trace_id: Optional[str] = None) -> dict:
    """One op's hop table as a full OTLP-JSON trace document."""
    tid = trace_id or trace_id_for(document_id, client_id, csn)
    return {
        "resourceSpans": [{
            "resource": {
                "attributes": [
                    _attr("service.name", RESOURCE_SERVICE_NAME),
                ],
            },
            "scopeSpans": [{
                "scope": {"name": SCOPE_NAME},
                "spans": hops_to_spans(traces, trace_id=tid),
            }],
        }],
    }


def _attr_map(span: dict) -> dict:
    out = {}
    for a in span.get("attributes", ()):
        value = a.get("value", {})
        out[a["key"]] = next(iter(value.values()), None)
    return out


def otlp_to_hops(doc: dict) -> list[Trace]:
    """The inverse: reconstruct the hop table from an OTLP-JSON doc
    produced by :func:`op_to_otlp`, bit-exact (timestamps come from
    the ``fluid.timestamp`` attributes, hop order from
    ``fluid.hop_index``)."""
    hops: list[tuple[int, Trace]] = []
    for rs in doc.get("resourceSpans", ()):
        for ss in rs.get("scopeSpans", ()):
            for span in ss.get("spans", ()):
                attrs = _attr_map(span)
                if "fluid.timestamp" not in attrs:
                    continue  # the root span carries no hop
                hops.append((
                    int(attrs["fluid.hop_index"]),
                    Trace(
                        service=attrs["fluid.service"],
                        action=attrs["fluid.action"],
                        timestamp=float(attrs["fluid.timestamp"]),
                    ),
                ))
    return [t for _i, t in sorted(hops, key=lambda p: p[0])]


class FileSpanExporter:
    """JSON-lines OTLP file exporter (one trace document per line —
    the OpenTelemetry collector file exporter's shape). Append-only;
    a viewer-side converter or the collector ingests it directly."""

    def __init__(self, path: str):
        self.path = path
        self.exported = 0

    def export(self, traces: Iterable[Trace], *,
               document_id: str = "", client_id: str = "",
               csn: int = 0) -> dict:
        doc = op_to_otlp(
            traces, document_id=document_id, client_id=client_id,
            csn=csn,
        )
        with open(self.path, "a", encoding="utf-8") as f:
            f.write(json.dumps(doc, separators=(",", ":")) + "\n")
        self.exported += 1
        return doc

    def read_back(self) -> list[dict]:
        with open(self.path, encoding="utf-8") as f:
            return [json.loads(line) for line in f if line.strip()]


def timeline_trace_id(events) -> str:
    """Deterministic 16-byte trace id for one fleet-timeline export:
    derived from the causal seq range, so re-exporting the same
    incident is byte-identical (the op-span contract, fleet-shaped)."""
    first = events[0].seq if events else 0
    last = events[-1].seq if events else 0
    return _hex_id(f"timeline:{first}:{last}:{len(events)}", 16)


def timeline_to_otlp(events, *, root_name: str = "fleet_timeline",
                     trace_id: Optional[str] = None) -> dict:
    """A fleet-timeline event sequence (obs/timeline.py
    ``TimelineEvent`` ducks: seq/t/node/kind/fields) as an OTLP-JSON
    trace document — the INCIDENT as a span tree next to the op
    spans: one root covers the whole window, each event becomes a
    child named ``kind`` whose window is [previous event, this event]
    (the ``breakdown()`` delta attribution, fleet-shaped), with the
    node, causal seq and scalar fields as attributes. Events are
    already causally ordered by seq; ids are deterministic."""
    ordered = sorted(events, key=lambda e: e.seq)
    tid = trace_id or timeline_trace_id(ordered)
    spans: list[dict] = []
    if ordered:
        root_id = _span_id(tid, 0)
        spans.append({
            "traceId": tid,
            "spanId": root_id,
            "name": root_name,
            "kind": 1,
            "startTimeUnixNano": _nanos(ordered[0].t),
            "endTimeUnixNano": _nanos(ordered[-1].t),
            "attributes": [_attr("fleet.events", len(ordered))],
        })
        prev_t = ordered[0].t
        for i, e in enumerate(ordered):
            attrs = [
                _attr("fleet.node", e.node),
                _attr("fleet.kind", e.kind),
                _attr("fleet.seq", e.seq),
                _attr("fluid.timestamp", repr(e.t)),
            ]
            for key in sorted(e.fields):
                value = e.fields[key]
                if isinstance(value, bool):
                    value = str(value)
                if isinstance(value, (int, float, str)):
                    attrs.append(_attr(f"fleet.{key}", value))
            spans.append({
                "traceId": tid,
                "spanId": _span_id(tid, i + 1),
                "parentSpanId": root_id,
                "name": e.kind,
                "kind": 1,
                "startTimeUnixNano": _nanos(prev_t),
                "endTimeUnixNano": _nanos(e.t),
                "attributes": attrs,
            })
            prev_t = e.t
    return {
        "resourceSpans": [{
            "resource": {
                "attributes": [
                    _attr("service.name", RESOURCE_SERVICE_NAME),
                ],
            },
            "scopeSpans": [{
                "scope": {"name": SCOPE_NAME},
                "spans": spans,
            }],
        }],
    }


def format_spans(traces: Iterable[Trace]) -> str:
    """Quick human view of the span tree (indent = parentage)."""
    rows = breakdown(traces)
    if not rows:
        return "(no spans)"
    lines = ["submit_ack"]
    for r in rows:
        lines.append(
            f"  └─ {r['hop']}  +{r['delta_ms']:.3f} ms"
        )
    return "\n".join(lines)
