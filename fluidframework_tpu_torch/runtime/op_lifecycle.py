"""Outbound/inbound op lifecycle: batching marks, compression, chunking.

Reference: packages/runtime/container-runtime/src/opLifecycle/ —
``Outbox`` (outbox.ts:35), ``BatchManager`` (batchManager.ts:22),
``OpCompressor`` (opCompressor.ts:18, lz4 there; zlib here — same
boundary, different codec), ``OpSplitter`` (opSplitter.ts:18, chunked
ops for >1MB messages), ``OpDecompressor`` (:20) and
``RemoteMessageProcessor`` (remoteMessageProcessor.ts:11) as the
inbound inverse.

Stages compose outbound as: envelope -> compress (if large) -> split
(if still large); inbound: reassemble chunks -> decompress -> decode.
The wire form is the JSON encoding from ``protocol.serialization`` so
payload sizes are measured on real serialized bytes.
"""
from __future__ import annotations

import base64
import json
import uuid
import zlib
from typing import Any, Optional

from ..obs import metrics as obs_metrics

# the ledger -> histogram bridge: every acked op's per-hop deltas
# feed ONE labelled histogram, so SLO objectives can bind to a
# single hop's latency budget (per-hop budgets rather than one
# end-to-end number — the collab-window framing). Label values are
# the CANONICAL hop names (bounded vocabulary by construction).
_HOP_MS = obs_metrics.REGISTRY.histogram(
    "op_hop_ms",
    "per-hop submit→ack latency attribution from the op ledger",
    labelnames=("hop",))
_SUBMIT_ACK_MS = obs_metrics.REGISTRY.histogram(
    "op_submit_ack_ms",
    "full submit→ack wall latency of ledgered ops")
# the replicated plane's share of the critical path: repl:forward ->
# repl:quorum_ack on every acked op that crossed the quorum barrier
# (fed from the same ledger bridge, so the quorum wait is its own
# series instead of silently inflating the sequencer-ticket hop)
_QUORUM_WAIT_MS = obs_metrics.REGISTRY.histogram(
    "repl_quorum_wait_ms",
    "repl:forward→repl:quorum_ack wait of ledgered replicated ops")


def _encode(envelope: dict) -> str:
    from ..protocol.serialization import encode_contents
    return json.dumps(encode_contents(envelope))


def _decode(payload: str) -> dict:
    from ..protocol.serialization import decode_contents
    return decode_contents(json.loads(payload))


class OpCompressor:
    """Compress large op envelopes (opCompressor.ts:18)."""

    def __init__(self, min_size: int = 4 * 1024):
        self.min_size = min_size

    def maybe_compress(self, envelope: dict) -> dict:
        try:
            payload = _encode(envelope)
        except TypeError:
            return envelope  # not wire-encodable: leave in-proc form
        return self.compress_encoded(envelope, payload)[0]

    def compress_encoded(self, envelope: dict, payload: str
                         ) -> tuple[dict, str]:
        """Same, reusing an already-encoded payload; returns the
        (possibly new) envelope and its encoding."""
        if len(payload) < self.min_size:
            return envelope, payload
        data = base64.b64encode(
            zlib.compress(payload.encode("utf-8"))
        ).decode("ascii")
        if len(data) >= len(payload):
            return envelope, payload  # incompressible; keep plain
        compressed = {"kind": "compressed", "data": data}
        return compressed, _encode(compressed)


class OpDecompressor:
    """Inbound inverse (opDecompressor.ts:20)."""

    @staticmethod
    def decompress(envelope: dict) -> dict:
        if envelope.get("kind") != "compressed":
            return envelope
        payload = zlib.decompress(
            base64.b64decode(envelope["data"])
        ).decode("utf-8")
        return _decode(payload)


class OpSplitter:
    """Split oversized envelopes into chunked ops (opSplitter.ts:18).
    Each chunk rides its own message; the op takes effect at the final
    chunk's sequence number."""

    def __init__(self, chunk_size: int = 768 * 1024):
        self.chunk_size = chunk_size

    def split(self, envelope: dict) -> list[dict]:
        try:
            payload = _encode(envelope)
        except TypeError:
            return [envelope]  # not wire-encodable: leave in-proc form
        return self.split_encoded(envelope, payload)

    def split_encoded(self, envelope: dict, payload: str) -> list[dict]:
        if len(payload) <= self.chunk_size:
            return [envelope]
        chunk_id = uuid.uuid4().hex
        pieces = [
            payload[i:i + self.chunk_size]
            for i in range(0, len(payload), self.chunk_size)
        ]
        return [
            {
                "kind": "chunk",
                "chunkId": chunk_id,
                "index": i,
                "total": len(pieces),
                "data": piece,
            }
            for i, piece in enumerate(pieces)
        ]


class ChunkReassembler:
    """Collects chunk pieces per (client, chunkId); returns the
    original envelope when the final piece arrives."""

    def __init__(self) -> None:
        self._buffers: dict[tuple, list[Optional[str]]] = {}

    def add(self, client_id: str, envelope: dict) -> Optional[dict]:
        key = (client_id, envelope["chunkId"])
        buf = self._buffers.setdefault(key, [None] * envelope["total"])
        buf[envelope["index"]] = envelope["data"]
        if any(piece is None for piece in buf):
            return None
        del self._buffers[key]
        return _decode("".join(buf))


class RemoteMessageProcessor:
    """Inbound pipeline (remoteMessageProcessor.ts:11): reassemble,
    then decompress. Returns the logical envelope, or None while a
    chunked op is still incomplete."""

    def __init__(self) -> None:
        self._reassembler = ChunkReassembler()
        self._decompressor = OpDecompressor()

    def process(self, client_id: str, envelope: Any) -> Optional[dict]:
        if isinstance(envelope, dict) and envelope.get("kind") == "chunk":
            envelope = self._reassembler.add(client_id, envelope)
            if envelope is None:
                return None
        if isinstance(envelope, dict):
            envelope = self._decompressor.decompress(envelope)
        return envelope


def stage_outbound(envelope: dict, compressor: OpCompressor,
                   splitter: OpSplitter) -> list[dict]:
    """Outbound staging with a single wire encoding shared by both
    stages: encode once -> compress if beneficial -> chunk if large."""
    try:
        payload = _encode(envelope)
    except TypeError:
        return [envelope]  # in-proc-only payload: send as-is
    envelope, payload = compressor.compress_encoded(envelope, payload)
    return splitter.split_encoded(envelope, payload)


class OpLatencyLedger:
    """Bounded per-op submit→ack latency attribution.

    The container feeds it when one of its OWN ops comes back
    sequenced: the op's full trace (submit, driver-send, ingress,
    sequencer ticket, fanout, deliver, ack — whatever hops the path
    stamped) is kept per clientSequenceNumber, newest ``capacity``
    entries retained. This is the per-op half of observability; the
    metrics registry keeps the aggregates."""

    def __init__(self, capacity: int = 128):
        self.capacity = capacity
        # csn -> entry; insertion-ordered so eviction drops the oldest
        self._entries: dict[int, dict] = {}

    def record(self, csn: int, sequence_number: int,
               traces: list) -> dict:
        from ..obs.trace import breakdown, total_ms

        entry = {
            "clientSequenceNumber": csn,
            "sequenceNumber": sequence_number,
            "traces": list(traces),
            "hops": breakdown(traces),
            "total_ms": total_ms(traces),
        }
        # ledger -> histogram bridge: the per-op record doubles as
        # the aggregate sample (one observe per hop; hop names come
        # from the canonical table, so the label set stays bounded)
        for hop in entry["hops"]:
            _HOP_MS.labels(hop=hop["hop"]).observe(hop["delta_ms"])
        if entry["hops"]:
            _SUBMIT_ACK_MS.observe(entry["total_ms"])
        forward = next((t.timestamp for t in traces
                        if t.service == "repl"
                        and t.action == "forward"), None)
        acked = [t.timestamp for t in traces
                 if t.service == "repl" and t.action == "quorum_ack"]
        if forward is not None and acked:
            _QUORUM_WAIT_MS.observe((max(acked) - forward) * 1000.0)
        self._entries[csn] = entry
        while len(self._entries) > self.capacity:
            self._entries.pop(next(iter(self._entries)))
        return entry

    def get(self, csn: Optional[int] = None) -> Optional[dict]:
        """The entry for ``csn``, or the newest one when omitted."""
        if csn is not None:
            return self._entries.get(csn)
        if not self._entries:
            return None
        return self._entries[next(reversed(self._entries))]

    def format(self, csn: Optional[int] = None) -> str:
        from ..obs.trace import format_breakdown

        entry = self.get(csn)
        if entry is None:
            return "(no acked op recorded)"
        return (
            f"op csn={entry['clientSequenceNumber']} "
            f"seq={entry['sequenceNumber']} "
            f"({entry['total_ms']:.3f} ms submit→ack)\n"
            + format_breakdown(entry["traces"])
        )

    def summary(self) -> dict:
        """Per-hop mean/max delta over the retained entries."""
        agg: dict[str, list[float]] = {}
        for entry in self._entries.values():
            for hop in entry["hops"]:
                agg.setdefault(hop["hop"], []).append(hop["delta_ms"])
        return {
            hop: {
                "count": len(ds),
                "mean_ms": sum(ds) / len(ds),
                "max_ms": max(ds),
            }
            for hop, ds in agg.items()
        }

    def __len__(self) -> int:
        return len(self._entries)


# batch boundary marks moved to the protocol layer (they are a wire
# contract the drivers also consume); re-exported here for the
# runtime-side users
from ..protocol.constants import batch_flag, mark_batch  # noqa: E402,F401
