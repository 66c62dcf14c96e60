"""Networked service ingress — the alfred-equivalent front door.

Reference: the alfred socket handler
(server/routerlicious/packages/lambdas/src/alfred/index.ts —
``connect_document`` :465, ``submitOp`` :500) fronting the per-document
orderer, and the client-side socket protocol
(packages/drivers/driver-base/src/documentDeltaConnection.ts:41).

Transport: length-prefixed JSON frames (4-byte big-endian length +
UTF-8 JSON body) over TCP via asyncio — the protocol EVENTS mirror the
reference's socket.io vocabulary; the framing is deliberately minimal
(no third-party websocket dependency in this image). Events:

  client -> server
    {"type": "connect_document", "document_id", "client_id",
     "details"?}                     -> "connected"
    {"type": "submitOp", "document_id", "op": {<DocumentMessage>}}
    {"type": "read_ops", "rid", "document_id", "from_seq", "to_seq"?}
                                     -> "ops"
    {"type": "fetch_summary", "rid", "document_id"} -> "summary"
    {"type": "disconnect_document", "document_id"}

  server -> client
    {"type": "connected", "document_id", "client_id"}
    {"type": "op", "document_id", "msg": {<SequencedMessage>}}
    {"type": "nack", "document_id", ...}
    {"type": "ops", "rid", "msgs": [...]}
    {"type": "summary", "rid", "sequence_number", "summary"} | null
    {"type": "error", "message"}

All orderer work runs on the event loop thread (the deli ticket path is
synchronous and fast — the C++ batch lane exists for bulk replay);
per-connection outbound frames go through a queue drained by a writer
task, so a slow client never blocks sequencing (broadcaster batching,
lambdas/src/broadcaster/lambda.ts:49).

A copy of the reference's ``service/ingress.py``.
"""
from __future__ import annotations

import asyncio
import dataclasses
import itertools
import json
import struct
import sys
import time
from typing import Any, Optional

from ..obs import metrics as obs_metrics
from ..obs.trace import stamp as trace_stamp
from ..protocol.columnar import decode_columns, validate_columns
from ..protocol.constants import wire_version_lt
from ..qos import CLASS_CATCHUP, CLASS_SUMMARY, CLASS_WRITE
from ..qos.faults import KIND_ERROR, PLANE as _CHAOS
from ..protocol.messages import (
    ClientDetail,
    DocumentMessage,
    MessageType,
    Nack,
    NackErrorType,
    SequencedMessage,
)
from ..protocol.serialization import (
    decode_contents,
    encode_contents,
    message_from_json,
    message_to_json,
)
from .local_server import DeltaConnection, LocalServer

_LEN = struct.Struct(">I")
MAX_FRAME = 64 * 1024 * 1024

# frame-kind label values are drawn from the FIXED protocol vocabulary
# below, never from client input (bounded cardinality by construction;
# anything else counts as "unknown")
_KNOWN_FRAME_KINDS = frozenset((
    "connect_document", "submitOp", "read_ops", "fetch_summary",
    "upload_summary_chunk", "disconnect_document", "metrics", "slo",
    "fleet-metrics", "heat",
))
_FRAMES = obs_metrics.REGISTRY.counter(
    "ingress_frames_total", "frames dispatched by the ingress",
    labelnames=("kind",))
_OPS_IN = obs_metrics.REGISTRY.counter(
    "ingress_ops_received_total", "raw client ops decoded (incl. "
    "boxcar members)")
_OPS_OFFERED = obs_metrics.REGISTRY.counter(
    "ingress_ops_offered_total",
    "client ops offered to the ingress, shed ones included — the "
    "denominator of the default goodput SLO")
_OPS_TICKETED = obs_metrics.REGISTRY.counter(
    "ingress_ops_ticketed_total",
    "offered ops that actually reached the sequencer — the goodput "
    "SLO's numerator (decoded-but-nacked ops must not count as "
    "served)")
_BOXCARS = obs_metrics.REGISTRY.counter(
    "ingress_boxcars_total", "wire-1.2 boxcarred batch submits")
_COLUMNAR = obs_metrics.REGISTRY.counter(
    "ingress_columnar_batches_total",
    "wire-1.3 columnar SoA batch submits (validated once, sliced)")
_NACKS_OUT = obs_metrics.REGISTRY.counter(
    "ingress_nacks_sent_total", "nack frames sent to clients")
_ERRORS_OUT = obs_metrics.REGISTRY.counter(
    "ingress_errors_sent_total", "error frames sent to clients")
_THROTTLE_NACKS = obs_metrics.REGISTRY.counter(
    "ingress_throttle_nacks_total",
    "frames refused by the qos admission gate", labelnames=("klass",))
_OUT_DROPPED = obs_metrics.REGISTRY.counter(
    "ingress_outbound_dropped_total",
    "sequenced-op fanout frames dropped to slow consumers")
_SLOW_DISCONNECTS = obs_metrics.REGISTRY.counter(
    "ingress_slow_consumer_disconnects_total",
    "sessions disconnected past the hard outbound limit")
_OUT_DEPTH = obs_metrics.REGISTRY.gauge(
    "ingress_outbound_depth_max",
    "deepest per-session outbound queue at last sample")
_DISPATCH_MS = obs_metrics.REGISTRY.histogram(
    "ingress_dispatch_ms",
    "event-loop occupancy per dispatched frame (decode + ticket + "
    "fanout enqueue)")

# per-tenant usage rollup (the cost-attribution plane, obs/heat.py).
# AGGREGATE families only — tenant ids are unbounded client input and
# never become label values (the obs cardinality discipline); exact
# per-tenant splits live on the usage HeatLedger, LRU-capped, served
# via the heat frame / --dump-heat.
_TENANT_OPS_OFFERED = obs_metrics.REGISTRY.counter(
    "tenant_ops_offered_total",
    "ops offered by sessions with a tenant identity (connect-token "
    "claims), shed ones included")
_TENANT_OPS_TICKETED = obs_metrics.REGISTRY.counter(
    "tenant_ops_ticketed_total",
    "tenant-attributed ops that reached the sequencer")
_TENANT_BYTES_IN = obs_metrics.REGISTRY.counter(
    "tenant_bytes_in_total",
    "wire bytes received on frames attributed to a tenant")
_TENANT_BYTES_OUT = obs_metrics.REGISTRY.counter(
    "tenant_bytes_out_total",
    "wire bytes enqueued outbound on tenant-attributed fanout")
_TENANT_SHEDS = obs_metrics.REGISTRY.counter(
    "tenant_sheds_total",
    "qos admission sheds charged to a tenant")
_TENANT_UPLOADS = obs_metrics.REGISTRY.counter(
    "tenant_summary_uploads_total",
    "completed summary uploads charged to a tenant")

# chaos seam (docs/ROBUSTNESS.md): a transient fault on the summary
# upload plane — fired on the FINAL (rid-waited) chunk so it always
# reaches the uploader synchronously; the container's summarize
# fallback degrades to the inline-summary path, which is the recovery
# this seam exists to keep exercised
_SITE_UPLOAD = _CHAOS.site("ingress.summary_upload", (KIND_ERROR,))

# Wire-protocol versions this server speaks (newest first). The
# reference negotiates `versions` on connect_document
# (documentDeltaConnection.ts protocolVersions / alfred's
# connect_document): the client offers what it speaks, the server
# picks the newest shared one and echoes it in "connected"; no overlap
# is a connect error, not a silent mismatch. Snapshot formats are
# versioned separately (testing/compat.py); this covers the FRAMES.
#
# 1.0 — base frames: connect/op/nack/read_ops/summary/summarize.
# 1.1 — adds the chunked summary-upload plane (upload_summary_chunk)
#       and structured error kinds. A connection that NEGOTIATED 1.0
#       must not use 1.1 frames (server rejects them; the driver
#       degrades to inline summaries — the old-client/new-service
#       pairing of the compat matrix, tests/test_wire_compat.py).
# 1.2 — adds the boxcarred batch submit: one submitOp frame may carry
#       "ops": [<DocumentMessage>...] and the whole array tickets
#       atomically on the event loop, so a runtime batch can never be
#       interleaved with another session's ops in the sequenced order
#       (the submit->ack liveness fix — see SocketDeltaConnection).
# 1.3 — adds the columnar SoA batch submit: one submitOp frame may
#       carry "cols": {parallel arrays + shared payload string}
#       (protocol/columnar.py) — validated once, sliced, never
#       re-interpreted per op. Same atomic-ticket semantics as the
#       1.2 boxcar; 1.0-1.2 peers keep the row paths unchanged.
# 1.4 — adds the heat frame (cost-attribution plane, obs/heat.py):
#       top-k hot documents and tenants off the heat/usage ledgers,
#       with an optional requested cut "k". A connection that
#       NEGOTIATED <= 1.3 must not send it (server rejects loudly,
#       same as the 1.1 upload gate); 1.0-1.3 peers see no heat
#       frames and no behavior change.
# 1.5 — registers the sharedtree channel-op payload ("msg:tree",
#       protocol/tree_payload.py, the tree serving plane). Pure
#       vocabulary: the payload rode opaque envelope contents
#       before, so no frame changes, no gate, and no byte changes
#       for any peer — 1.5 puts its fields under the wirecheck /
#       wiresan / golden-snapshot review regime.
WIRE_VERSIONS = ("1.5", "1.4", "1.3", "1.2", "1.1", "1.0")


def document_message_to_json(op: DocumentMessage) -> dict:
    return {
        "client_sequence_number": op.client_sequence_number,
        "reference_sequence_number": op.reference_sequence_number,
        "type": int(op.type),
        "contents": encode_contents(op.contents),
        "metadata": op.metadata,
        "traces": [dataclasses.asdict(t) for t in op.traces],
    }


def document_message_from_json(data: dict) -> DocumentMessage:
    from ..protocol.messages import Trace

    return DocumentMessage(
        client_sequence_number=data["client_sequence_number"],
        reference_sequence_number=data["reference_sequence_number"],
        type=MessageType(data["type"]),
        contents=decode_contents(data.get("contents")),
        metadata=data.get("metadata"),
        traces=[Trace(**t) for t in data.get("traces", [])],
    )


def nack_to_json(nack: Nack) -> dict:
    out = {
        "sequence_number": nack.sequence_number,
        "error_type": int(nack.error_type),
        "message": nack.message,
        "operation": document_message_to_json(nack.operation)
        if nack.operation is not None else None,
    }
    # retry_after_seconds and the qos shed attribution are OPTIONAL
    # on the wire: emitted only when set, so non-throttle nack frames
    # stay byte-identical to the 1.0 shape and older peers never see
    # keys they don't know (test_wire_compat)
    if nack.retry_after_seconds is not None:
        out["retry_after_seconds"] = nack.retry_after_seconds
    if nack.pressure_tier is not None:
        out["pressure_tier"] = nack.pressure_tier
    if nack.shed_class is not None:
        out["shed_class"] = nack.shed_class
    return out


async def read_frame_sized(reader: asyncio.StreamReader
                           ) -> tuple[Optional[dict], int]:
    """(frame, wire bytes) — the server's read path keeps the exact
    frame size so the qos byte budgets charge what the wire carried,
    not a re-serialization estimate."""
    try:
        header = await reader.readexactly(_LEN.size)
    except (asyncio.IncompleteReadError, ConnectionResetError):
        return None, 0
    (length,) = _LEN.unpack(header)
    if length > MAX_FRAME:
        raise ValueError(f"frame too large: {length}")
    try:
        body = await reader.readexactly(length)
    except (asyncio.IncompleteReadError, ConnectionResetError):
        return None, 0
    return json.loads(body.decode("utf-8")), length


async def read_frame(reader: asyncio.StreamReader) -> Optional[dict]:
    frame, _ = await read_frame_sized(reader)
    return frame


def recv_frame_blocking(sock) -> dict:
    """Read one frame from a BLOCKING socket — the sync-side twin of
    ``read_frame`` (one definition of the wire framing for clients
    without an event loop, e.g. the broker's request/response
    client). Enforces the same MAX_FRAME bound: a corrupt/desynced
    length prefix must fail fast, not allocate gigabytes."""
    buf = b""
    while len(buf) < _LEN.size:
        chunk = sock.recv(_LEN.size - len(buf))
        if not chunk:
            raise ConnectionError("connection closed")
        buf += chunk
    (length,) = _LEN.unpack(buf)
    if length > MAX_FRAME:
        raise ValueError(f"frame length {length} exceeds {MAX_FRAME}")
    body = b""
    while len(body) < length:
        chunk = sock.recv(length - len(body))
        if not chunk:
            raise ConnectionError("connection closed mid-frame")
        body += chunk
    return json.loads(body.decode("utf-8"))


def pack_frame(data: dict) -> bytes:
    body = json.dumps(data).encode("utf-8")
    return _LEN.pack(len(body)) + body


class _ClientSession:
    """One TCP connection; may hold delta connections to several
    documents (the reference multiplexes the same way per socket)."""

    def __init__(self, server: "AlfredServer",
                 writer: Optional[asyncio.StreamWriter]):
        self.server = server
        self.writer = writer
        self.session_id = f"sess-{next(server._session_counter)}"
        # BOUNDED (maxsize = the hard slow-consumer limit): an
        # undrained reader must cost a bounded number of buffered
        # frames, never the server's memory. The drop/nack/disconnect
        # policy lives in send() below.
        self.outbound: asyncio.Queue[Optional[bytes]] = asyncio.Queue(
            maxsize=server.max_outbound_depth
        )
        self.closed = False
        # slow-consumer state: once the soft threshold is crossed,
        # sequenced-op fanout frames DROP (the client's own gap
        # refetch recovers them from delta storage) until the queue
        # drains to half the threshold — hysteresis, so the
        # drop-enter nack doesn't flap per frame
        self.dropping = False
        self.dropped_ops = 0
        self.connections: dict[str, DeltaConnection] = {}
        # doc -> tenant_id seen at connect (qos bucket scope key)
        self.tenant_ids: dict[str, str] = {}
        # documents this session has passed the token gate for (a
        # disconnect keeps the authorization; the token was validated)
        self.authorized: set[str] = set()
        # documents write-authorized (write-mode connect or doc:write
        # token) — the summary-upload plane requires write scope
        self.write_authorized: set[str] = set()
        # in-flight chunked summary uploads: upload_id -> state
        self.uploads: dict[str, dict] = {}
        # doc -> wire version agreed at connect_document (absent =
        # never negotiated on this session)
        self.wire_versions: dict[str, str] = {}

    def send(self, data: dict) -> None:
        """Enqueue one outbound frame under the slow-consumer policy:

        - sequenced-op fanout ("op") past the soft threshold DROPS
          (with ONE throttle nack on entering the dropping state, so
          the driver backs off); the client's inbound gap detection
          refetches dropped ops from delta storage — fanout frames
          are a delivery optimization, the op log is the truth;
        - anything still overflowing the hard maxsize (request
          replies, nacks — the session is hopeless by then) closes
          the connection LOUDLY. A reader that never drains costs a
          bounded queue, a counter and a disconnect; never the
          server's memory.
        """
        if self.closed:
            return
        if data.get("type") == "op":
            depth = self.outbound.qsize()
            soft = self.server.outbound_drop_threshold
            if self.dropping and depth <= soft // 2:
                self.dropping = False
            if self.dropping or depth >= soft:
                entered = not self.dropping
                self.dropping = True
                self.dropped_ops += 1
                _OUT_DROPPED.inc()
                if entered:
                    _NACKS_OUT.inc()
                    self._put(pack_frame({
                        "type": "nack",
                        "document_id": data.get("document_id"),
                        "operation": None,
                        "sequence_number": 0,
                        "error_type": int(NackErrorType.THROTTLING),
                        "message": (
                            "slow consumer: outbound queue at "
                            f"{depth} frames; dropping sequenced-op "
                            "fanout (refetch via read_ops)"
                        ),
                        "retry_after_seconds": 1.0,
                    }))
                return
        payload = pack_frame(data)
        if self.server.usage is not None:
            # per-tenant egress bytes: fanout and replies for a
            # tenant-attributed document charge the frame's packed
            # size (the same bytes the socket writes)
            d = data.get("document_id")
            tenant = self.tenant_ids.get(d, "") if d else ""
            if tenant:
                self.server.usage.charge(
                    tenant, 0.0, bytes_out=len(payload))
                _TENANT_BYTES_OUT.inc(len(payload))
        self._put(payload)

    def _put(self, frame: bytes) -> None:
        try:
            self.outbound.put_nowait(frame)
        except asyncio.QueueFull:
            # hard limit: the consumer has not drained ANYTHING for
            # maxsize frames — disconnect loudly (the counter + stderr
            # line are the "loud"; reconnect is the client's recovery)
            _SLOW_DISCONNECTS.inc()
            print(
                f"ingress[{self.session_id}]: outbound queue hit the "
                f"hard limit ({self.server.max_outbound_depth}); "
                "disconnecting slow consumer",
                file=sys.stderr,
            )
            self.close()

    async def writer_loop(self) -> None:
        while True:
            frame = await self.outbound.get()
            if frame is None:
                break
            try:
                self.writer.write(frame)
                await self.writer.drain()
            except (ConnectionResetError, BrokenPipeError, OSError):
                break

    def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        for conn in self.connections.values():
            conn.disconnect()
        self.connections.clear()
        try:
            self.outbound.put_nowait(None)
        except asyncio.QueueFull:
            # full of undelivered frames: displace one so the writer
            # pump still sees its shutdown sentinel
            self.outbound.get_nowait()
            self.outbound.put_nowait(None)
        if self.writer is not None:
            # actively tear the transport down: a hard-limit close
            # must unblock the read loop too, not wait for the peer
            try:
                self.writer.close()
            except (OSError, RuntimeError):
                pass


class AlfredServer:
    """asyncio ingress over a LocalServer (per-document LocalOrderer
    pipeline — deli/scriptorium/broadcaster/scribe equivalents)."""

    # slow-consumer bounds (frames). Soft: sequenced-op fanout starts
    # dropping (gap refetch recovers). Hard: the session disconnects.
    MAX_OUTBOUND_DEPTH = 8192
    OUTBOUND_DROP_THRESHOLD = 6144
    # normalizing capacity for the sequencer-inbox pressure source
    SEQUENCER_INBOX_CAPACITY = 1024

    def __init__(self, local: Optional[LocalServer] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 tenants: Optional[Any] = None,
                 qos: Optional[Any] = None,
                 slo: Optional[Any] = None,
                 fleet: Optional[Any] = None,
                 max_outbound_depth: Optional[int] = None,
                 outbound_drop_threshold: Optional[int] = None,
                 heat: Optional[Any] = None,
                 usage: Optional[Any] = None,
                 heat_top_k: int = 10):
        self.local = local or LocalServer()
        self.host = host
        self.port = port
        # optional riddler-analogue TenantManager (service/tenancy.py):
        # when set, connect_document must carry tenant_id + a valid
        # signed claims token (alfred's verifyToken gate)
        self.tenants = tenants
        # optional qos.AdmissionController: consulted BEFORE anything
        # reaches the sequencer (submitOp), the storage planes
        # (read_ops/fetch_summary) or the upload plane. None = the
        # open dev-service shape, like tenants=None.
        self.qos = qos
        # optional obs.SloEngine: answers the `slo` frame and
        # piggybacks its sampling tick on the dispatch path (the
        # engine is passive — it only reads registry families the
        # serving modules already bump). None = no objectives.
        self.slo = slo
        # optional obs.FederatedView: answers the `fleet-metrics`
        # frame with the MERGED leader/follower/partition-worker
        # registries. None = a single-node view over the process
        # registry, built lazily on first ask (the dev-service shape:
        # one process IS the fleet).
        self.fleet = fleet
        # optional cost-attribution plane (obs/heat.py): `heat` is the
        # per-document device-time ledger (the sidecar charges it at
        # its settle boundary), `usage` the per-tenant rollup ledger
        # this ingress charges at admission/ticket/upload time. Both
        # None = attribution off, zero cost on the serving path. The
        # wire-1.4 heat frame serves top-k cuts of both.
        self.heat = heat
        self.usage = usage
        self.heat_top_k = heat_top_k
        # doc -> tenant identity from the last validated connect (the
        # sidecar's tenant_of hook reads this; per-session identity
        # for the rollup stays on session.tenant_ids)
        self.doc_tenants: dict[str, str] = {}
        self.max_outbound_depth = (
            max_outbound_depth or self.MAX_OUTBOUND_DEPTH
        )
        self.outbound_drop_threshold = min(
            outbound_drop_threshold or self.OUTBOUND_DROP_THRESHOLD,
            self.max_outbound_depth,
        )
        self._session_counter = itertools.count()
        self._sessions: set[_ClientSession] = set()
        self._handler_tasks: set[asyncio.Task] = set()
        self._server: Optional[asyncio.base_events.Server] = None
        if qos is not None and getattr(qos, "pressure", None) \
                is not None:
            self._register_pressure_sources(qos.pressure)

    def _register_pressure_sources(self, pressure) -> None:
        """Default composite-pressure wiring: the depths THIS process
        can observe. ensure_source so operator/test-supplied sources
        (e.g. a sidecar's queued_ops, a broker's fanout lag) are
        never clobbered."""
        # normalized against the HARD limit: the drop policy parks a
        # persistently-slow consumer's queue at the soft threshold,
        # which lands the ratio at soft/hard (elevated/severe by
        # default) — sheds bulk traffic without starving writers;
        # only a genuinely stalled event loop reaches critical
        pressure.ensure_source(
            "session_outbound", self._max_outbound_depth_now,
            capacity=self.max_outbound_depth,
        )
        pressure.ensure_source(
            "sequencer_inbox",
            lambda: max(
                (o.inbox_depth
                 for o in getattr(self.local, "documents", {})
                 .values()),
                default=0,
            ),
            capacity=self.SEQUENCER_INBOX_CAPACITY,
        )
        # only LOCAL lag probes may sit on the serving path: the
        # pressure monitor samples inside admit() on the event loop,
        # and a RemoteOrderingQueue.fanout_lag is a blocking TCP
        # round trip — a hung broker would turn the admission gate
        # into the stall it exists to prevent. Remote lag belongs in
        # an off-loop sampler feeding add_source with a cached value.
        queue = getattr(self.local, "queue", None)
        if queue is not None and getattr(
                queue, "fanout_lag_is_local", False):
            pressure.ensure_source(
                "broker_fanout", queue.fanout_lag,
                capacity=self.SEQUENCER_INBOX_CAPACITY,
            )

    def _max_outbound_depth_now(self) -> int:
        depth = max(
            (s.outbound.qsize() for s in self._sessions), default=0
        )
        _OUT_DEPTH.set(depth)
        return depth

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port
        )
        self.port = self._server.sockets[0].getsockname()[1]

    async def serve_forever(self) -> None:
        if self._server is None:
            await self.start()
        async with self._server:
            await self._server.serve_forever()

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
        # wait_closed() only covers the listening socket on 3.10:
        # actively tear down live sessions (EOFs their read loops)
        # and wait for the handler tasks, so a loop shutdown right
        # after stop() can't strand half-torn-down pump coroutines
        for session in sorted(self._sessions,
                              key=lambda s: s.session_id):
            session.close()
        if self._handler_tasks:
            await asyncio.gather(
                *self._handler_tasks, return_exceptions=True)

    # ------------------------------------------------------------------

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        if task is not None:
            self._handler_tasks.add(task)
        session = _ClientSession(self, writer)
        self._sessions.add(session)
        pump = asyncio.ensure_future(session.writer_loop())
        try:
            while True:
                frame, nbytes = await read_frame_sized(reader)
                if frame is None or session.closed:
                    break
                try:
                    self._dispatch(session, frame, nbytes)
                except Exception as e:  # noqa: BLE001 - report, keep serving
                    _ERRORS_OUT.inc()
                    session.send({
                        "type": "error",
                        "rid": frame.get("rid"),
                        # structured kind: drivers must distinguish an
                        # auth rejection from a transport/server fault
                        # (a caching driver would otherwise serve a
                        # revoked client stale snapshots as "offline")
                        "error_kind": "permission"
                        if isinstance(e, PermissionError) else "server",
                        "message": f"{type(e).__name__}: {e}",
                    })
        finally:
            self._sessions.discard(session)
            session.close()
            await pump
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError):
                pass
            if task is not None:
                self._handler_tasks.discard(task)

    def _check_read_access(self, session: _ClientSession,
                           doc: str, frame: dict) -> None:
        """When tokens are enforced, the storage planes (read_ops /
        fetch_summary) require either a prior successful
        connect_document for the document OR a doc:read token on the
        request itself (the loader fetches snapshot + trailing ops
        BEFORE joining the delta stream — container.ts load order) —
        otherwise an unauthenticated socket could read any document's
        full op log with no credentials."""
        if self.tenants is None or doc in session.authorized:
            return
        from .tenancy import SCOPE_READ, AuthError

        try:
            self.tenants.validate_token(
                frame.get("token", ""), frame.get("tenant_id", ""),
                doc, required_scope=SCOPE_READ,
            )
        except AuthError as e:
            raise PermissionError(
                f"not authorized for document {doc!r}: {e} "
                "(connect_document first, or send a doc:read token "
                "with the request)"
            ) from e
        session.authorized.add(doc)

    def _check_write_access(self, session: _ClientSession,
                            doc: str, frame: dict) -> None:
        """The summary-upload plane mutates storage: write scope
        required (historian gates its summary routes the same way)."""
        if self.tenants is None or doc in session.write_authorized:
            return
        from .tenancy import SCOPE_WRITE, AuthError

        try:
            self.tenants.validate_token(
                frame.get("token", ""), frame.get("tenant_id", ""),
                doc, required_scope=SCOPE_WRITE,
            )
        except AuthError as e:
            raise PermissionError(
                f"no write access to document {doc!r}: {e}"
            ) from e
        session.write_authorized.add(doc)

    def _send_nack(self, session: _ClientSession, doc: str,
                   nack: Nack) -> None:
        _NACKS_OUT.inc()
        session.send({
            "type": "nack", "document_id": doc, **nack_to_json(nack),
        })

    # -- qos admission gate --------------------------------------------

    def _admit(self, session: _ClientSession, klass: str, doc: str,
               frame: dict, ops: int = 1, nbytes: int = 0):
        """Consult the admission controller (None when qos is off).
        Returns the Admission, or None for 'admitted' fast-path."""
        if self.qos is None:
            return None
        # tenant scope key: ONLY the connect-validated identity — a
        # frame-supplied tenant_id is attacker-controlled (it would
        # let one client charge a victim tenant's budget, or rotate
        # fresh ids for an untouched bucket per frame). Pre-connect
        # storage requests fall to the anonymous "" tenant and their
        # per-connection budget.
        adm = self.qos.admit(
            klass,
            tenant=session.tenant_ids.get(doc or "", ""),
            document=doc or "",
            connection=session.session_id,
            ops=ops, nbytes=nbytes,
        )
        if adm.admitted:
            return None
        _THROTTLE_NACKS.labels(klass=klass).inc()
        return adm

    def _send_shed(self, session: _ClientSession, doc: str,
                   frame: dict, adm, as_nack: bool) -> None:
        """Tell the caller it was shed. Op-plane sheds go out as
        throttle NACKs (the driver's on_nack path — the container
        defers resubmit by retry_after_seconds); request/response
        sheds answer the rid with a structured throttle error the
        driver converts to a RetriableError."""
        if self.usage is not None:
            tenant = session.tenant_ids.get(doc or "", "")
            if tenant:
                self.usage.charge(tenant, 0.0, sheds=1)
                _TENANT_SHEDS.inc()
        if as_nack:
            self._send_nack(session, doc, Nack(
                operation=None,
                sequence_number=0,
                error_type=NackErrorType.THROTTLING,
                message=(
                    f"admission refused ({adm.reason}): retry after "
                    f"{adm.retry_after_seconds:.3f}s"
                ),
                retry_after_seconds=adm.retry_after_seconds,
                pressure_tier=adm.tier,
                shed_class=adm.shed_class,
            ))
            return
        _ERRORS_OUT.inc()
        out = {
            "type": "error",
            "rid": frame.get("rid"),
            "error_kind": "throttle",
            "message": (
                f"throttled ({adm.reason}): retry after "
                f"{adm.retry_after_seconds:.3f}s"
            ),
        }
        # optional-presence wire fields: a throttle error omits the
        # retry hint / shed attribution it has nothing to say about,
        # same discipline as nack_to_json
        if adm.retry_after_seconds is not None:
            out["retry_after_seconds"] = adm.retry_after_seconds
        if adm.tier is not None:
            out["pressure_tier"] = adm.tier
        if adm.shed_class is not None:
            out["shed_class"] = adm.shed_class
        session.send(out)

    def _dispatch(self, session: _ClientSession, frame: dict,
                  nbytes: int = 0) -> None:
        """Timing shell around the frame switch: every dispatched
        frame's event-loop occupancy lands in ``ingress_dispatch_ms``
        (the latency the default SLO binds to), and the SLO engine's
        rate-limited sampling tick rides the same path — a serving
        process needs no extra timer thread to keep its burn-rate
        windows populated."""
        t0 = time.perf_counter()
        try:
            self._dispatch_frame(session, frame, nbytes)
        finally:
            _DISPATCH_MS.observe((time.perf_counter() - t0) * 1000.0)
            if self.slo is not None:
                self.slo.maybe_tick()

    def _dispatch_frame(self, session: _ClientSession, frame: dict,
                        nbytes: int = 0) -> None:
        kind = frame.get("type")
        doc = frame.get("document_id")
        _FRAMES.labels(
            kind=kind if kind in _KNOWN_FRAME_KINDS else "unknown"
        ).inc()
        if kind == "metrics":
            # the /metrics-equivalent plane: the process-wide registry
            # in both expositions (`python -m fluidframework_tpu_torch.
            # service --dump-metrics` and ops tooling read this).
            # Unauthenticated by design, like the reference's scraped
            # metrics ports: names/labels never carry tenant content.
            session.send({
                "type": "metrics", "rid": frame.get("rid"),
                "text": obs_metrics.REGISTRY.render_prometheus(),
                "metrics": obs_metrics.REGISTRY.snapshot(),
            })
            return
        if kind == "fleet-metrics":
            # the fleet half of the `metrics` plane: the federated
            # view re-merged as fresh as the ask (`--dump-fleet`
            # reads this). Unauthenticated like `metrics` — merged
            # names/labels never carry tenant content, and node ids
            # are code-chosen.
            if self.fleet is None:
                from ..obs.federation import FederatedView

                self.fleet = FederatedView()
                self.fleet.add_registry(
                    obs_metrics.REGISTRY.node, obs_metrics.REGISTRY)
            merged = self.fleet.refresh()
            session.send({
                "type": "fleet-metrics", "rid": frame.get("rid"),
                "nodes": self.fleet.nodes(),
                "text": self.fleet.registry.render_prometheus(),
                "metrics": merged,
            })
            return
        if kind == "slo":
            # the SLO plane's scrape point: tick + evaluate, so the
            # report is as fresh as the ask (`--dump-slo` reads this).
            # Unauthenticated like `metrics` — verdicts carry metric
            # names and burn rates, never tenant content.
            if self.slo is None:
                session.send({
                    "type": "slo", "rid": frame.get("rid"),
                    "report": None,
                    "message": "slo engine not enabled "
                               "(start the service with --slo)",
                })
                return
            session.send({
                "type": "slo", "rid": frame.get("rid"),
                "report": self.slo.report(),
            })
            return
        if kind == "heat":
            # the cost-attribution plane's scrape point (wire 1.4,
            # `--dump-heat` reads this): top-k hot documents (by
            # attributed device-ms) and tenants off the ledgers.
            # Unauthenticated on a dump connection like `metrics` —
            # but a session that DID negotiate is held to the compat
            # matrix: agreeing only pre-1.4 versions and sending the
            # frame anyway is a protocol error, same discipline as
            # the 1.1 upload gate.
            if session.wire_versions and all(
                    wire_version_lt(v, "1.4")
                    for v in session.wire_versions.values()):
                raise ValueError(
                    "heat frame requires wire version >= 1.4 "
                    "(connection agreed "
                    f"{sorted(set(session.wire_versions.values()))})"
                )
            k = frame.get("k")
            cut = int(k) if k is not None else self.heat_top_k
            docs = (self.heat.top_k(cut)
                    if self.heat is not None else [])
            tenants = (self.usage.top_k(cut)
                       if self.usage is not None else [])
            session.send({
                "type": "heat", "rid": frame.get("rid"),
                "docs": [[key, value] for key, value in docs],
                "tenants": [[key, value] for key, value in tenants],
            })
            return
        if self.usage is not None and doc:
            # per-tenant byte ingress: every frame of a
            # tenant-attributed document charges its wire bytes to
            # the CONNECT-VALIDATED tenant (never the frame's own
            # tenant_id — that field is client input)
            tenant = session.tenant_ids.get(doc, "")
            if tenant and nbytes:
                self.usage.charge(tenant, 0.0, bytes_in=nbytes)
                _TENANT_BYTES_IN.inc(nbytes)
        if kind == "connect_document":
            client_id = frame["client_id"]
            details = frame.get("details") or {}
            # wire-version negotiation: pick the newest shared version
            # (clients predating the field implicitly offer 1.0)
            offered = frame.get("versions") or ["1.0"]
            agreed = next(
                (v for v in WIRE_VERSIONS if v in offered), None
            )
            if agreed is None:
                session.send({
                    "type": "connect_document_error",
                    "document_id": doc,
                    "message": (
                        f"no common wire version: client {offered}, "
                        f"server {list(WIRE_VERSIONS)}"
                    ),
                })
                return
            # "read" connections subscribe without joining the quorum
            # (alfred gates the required scope by requested mode)
            mode = frame.get("mode", "write")
            if self.tenants is not None:
                from .tenancy import SCOPE_READ, SCOPE_WRITE, AuthError

                try:
                    self.tenants.validate_token(
                        frame.get("token", ""),
                        frame.get("tenant_id", ""),
                        doc,
                        required_scope=SCOPE_WRITE if mode == "write"
                        else SCOPE_READ,
                    )
                except AuthError as e:
                    session.send({
                        "type": "connect_document_error",
                        "document_id": doc,
                        "message": str(e),
                    })
                    return
            # a retried connect supersedes the old connection: leaving
            # it joined would pin the document's msn at its refSeq and
            # double-deliver every op to this session
            stale = session.connections.pop(doc, None)
            if stale is not None:
                stale.disconnect()
            conn = self.local.connect(
                doc, client_id,
                on_message=lambda msg, d=doc: session.send({
                    "type": "op", "document_id": d,
                    "msg": message_to_json(msg),
                }),
                on_nack=lambda nack, d=doc: self._send_nack(
                    session, d, nack),
                detail=ClientDetail(client_id, **details)
                if details else None,
                read_only=(mode == "read"),
            )
            session.connections[doc] = conn
            session.authorized.add(doc)
            if mode == "write":
                session.write_authorized.add(doc)
            session.wire_versions[doc] = agreed
            session.tenant_ids[doc] = frame.get("tenant_id") or ""
            if session.tenant_ids[doc]:
                # server-level doc -> tenant map: the sidecar's
                # attribution tenant_of hook resolves through this
                self.doc_tenants[doc] = session.tenant_ids[doc]
            session.send({
                "type": "connected", "document_id": doc,
                "client_id": client_id, "version": agreed,
            })
        elif kind == "submitOp":
            conn = session.connections[doc]
            # "ops" (wire >= 1.2) = one boxcarred batch. This handler
            # runs synchronously on the event loop with no awaits, so
            # the array tickets as one contiguous seq run — no other
            # session's frame can interleave a foreign op mid-batch
            # (the reference's alfred handles socket.io message arrays
            # the same way).
            boxcar = frame.get("ops")
            if boxcar is not None and wire_version_lt(
                    session.wire_versions.get(doc, "1.0"), "1.2"):
                raise ValueError(
                    "boxcarred submit requires wire version >= 1.2 "
                    f"(connection agreed "
                    f"{session.wire_versions.get(doc, '1.0')})"
                )
            cols = frame.get("cols")
            if cols is not None:
                # "cols" (wire >= 1.3) = one columnar SoA batch
                # (protocol/columnar.py). Same atomic-ticket shape as
                # the boxcar; the column layout is interpreted exactly
                # ONCE, below, never per op.
                if boxcar is not None or frame.get("op") is not None:
                    raise ValueError(
                        "submitOp carries exactly one of op/ops/cols"
                    )
                if wire_version_lt(
                        session.wire_versions.get(doc, "1.0"), "1.3"):
                    raise ValueError(
                        "columnar submit requires wire version >= 1.3 "
                        f"(connection agreed "
                        f"{session.wire_versions.get(doc, '1.0')})"
                    )
                # the whole column layout is validated BEFORE anything
                # slices it; a malformed column refuses the batch as a
                # unit with a BAD_REQUEST nack — nothing sequenced,
                # nothing sliced
                try:
                    n_ops = validate_columns(cols)
                except ValueError as e:
                    _NACKS_OUT.inc()
                    session.send({
                        "type": "nack", "document_id": doc,
                        "operation": None,
                        "sequence_number": 0,
                        "error_type": int(NackErrorType.BAD_REQUEST),
                        "message": str(e),
                    })
                    return
                _COLUMNAR.inc()
                ops_json = None
                # columnar batches are writes by construction: the
                # column vocabulary is INSERT/REMOVE only, so no
                # summarize proposal can ride one
                klass = CLASS_WRITE
            else:
                ops_json = boxcar if boxcar is not None \
                    else [frame["op"]]
                if boxcar is not None:
                    _BOXCARS.inc()
                # Summarize proposals classify as summary traffic
                # (first to shed). ALL-summarize only: the client's
                # summarizer submits solo frames, so this is the legit
                # shape — a mixed batch must classify as write, or
                # co-batching one SUMMARIZE would shed writer ops at
                # ELEVATED and dodge the op/byte budgets (charging the
                # summary buckets instead)
                klass = CLASS_SUMMARY if ops_json and all(
                    o.get("type") == int(MessageType.SUMMARIZE)
                    for o in ops_json
                ) else CLASS_WRITE
                n_ops = len(ops_json)
            # the admission gate sits BEFORE decode: at 10x offered
            # load, the shed path must cost a dict lookup and a
            # bucket peek, not a full op decode. Offered counts
            # BEFORE the gate: the goodput SLO's denominator must
            # include what admission shed, or the objective could
            # never see an overload
            _OPS_OFFERED.inc(n_ops)
            tenant = session.tenant_ids.get(doc or "", "")
            if self.usage is not None and tenant:
                self.usage.charge(tenant, 0.0, ops_offered=n_ops)
                _TENANT_OPS_OFFERED.inc(n_ops)
            adm = self._admit(session, klass, doc, frame,
                              ops=n_ops, nbytes=nbytes)
            if adm is not None:
                self._send_shed(session, doc, frame, adm,
                                as_nack=True)
                return
            # decode the WHOLE array before submitting anything: a
            # malformed op mid-boxcar must fail the batch as a unit
            # (error frame, nothing sequenced) — partially ticketing
            # it would put a torn batch on the wire, the exact state
            # the boxcar protocol exists to rule out. The columnar
            # batch was already validated as a unit above; this is
            # its one column->message slicing pass, at the sequencer
            # boundary (single-sourced sequencing: interpreted once).
            decoded = decode_columns(cols) if cols is not None \
                else [document_message_from_json(o) for o in ops_json]
            _OPS_IN.inc(len(decoded))
            for op in decoded:
                # the front-door hop: client-side stamps arrived on
                # the frame; this marks event-loop receipt
                trace_stamp(op.traces, "ingress", "receive")
            if ops_json is None:
                # columnar: the nack echo below reconstructs the row
                # form lazily (rejections only — the served path never
                # pays a per-op re-encode)
                ops_json = [None] * len(decoded)
            ticketed = 0
            for op_json, op in zip(ops_json, decoded):
                try:
                    conn.submit(op)
                    # goodput numerator: only ops the sequencer
                    # actually accepted — counting at decode would
                    # read an all-nacked fleet as 100% served
                    _OPS_TICKETED.inc()
                    ticketed += 1
                except PermissionError as e:
                    # read-mode connection: reject as a NACK so the
                    # driver's on_nack fires (parity with the in-proc
                    # path, which raises to the caller directly)
                    _NACKS_OUT.inc()
                    session.send({
                        "type": "nack", "document_id": doc,
                        "operation": (
                            op_json if op_json is not None
                            else document_message_to_json(op)
                        ),
                        "sequence_number": 0,
                        "error_type": int(NackErrorType.INVALID_SCOPE),
                        "message": str(e),
                    })
            if self.usage is not None and tenant and ticketed:
                self.usage.charge(tenant, 0.0, ops_ticketed=ticketed)
                _TENANT_OPS_TICKETED.inc(ticketed)
        elif kind == "read_ops":
            adm = self._admit(session, CLASS_CATCHUP, doc, frame)
            if adm is not None:
                self._send_shed(session, doc, frame, adm,
                                as_nack=False)
                return
            self._check_read_access(session, doc, frame)
            msgs = self.local.read_ops(
                doc, frame["from_seq"], frame.get("to_seq")
            )
            session.send({
                "type": "ops", "rid": frame.get("rid"),
                "msgs": [message_to_json(m) for m in msgs],
            })
        elif kind == "fetch_summary":
            adm = self._admit(session, CLASS_CATCHUP, doc, frame)
            if adm is not None:
                self._send_shed(session, doc, frame, adm,
                                as_nack=False)
                return
            self._check_read_access(session, doc, frame)
            latest = self.local.latest_summary(doc)
            payload: dict[str, Any] = {
                "type": "summary", "rid": frame.get("rid"),
            }
            if latest is None:
                payload["sequence_number"] = None
                payload["summary"] = None
            else:
                payload["sequence_number"] = latest.sequence_number
                payload["summary"] = encode_contents(latest.summary)
            session.send(payload)
        elif kind == "upload_summary_chunk":
            # the upload plane requires a PRIOR connect_document for
            # the document: the negotiated wire version is what
            # authorizes 1.1 frames. Un-negotiated frames used to be
            # waved through as "self-evidently 1.1", which made the
            # version gate advisory — a client could skip negotiation
            # entirely and never be held to the compat matrix
            # (round-5 advisor finding).
            agreed = session.wire_versions.get(doc)
            if agreed is None:
                raise ValueError(
                    f"summary upload before connect_document for "
                    f"{doc!r}: negotiate the wire version first"
                )
            if wire_version_lt(agreed, "1.1"):
                raise ValueError(
                    f"summary upload requires wire version >= 1.1 "
                    f"(connection agreed {agreed})"
                )
            # admission gates NEW uploads only (chunk 0), charged the
            # whole upload's estimated bytes up front — shedding a
            # continuation chunk would strand the staged prefix and
            # surface as a misleading out-of-order error later (the
            # same reasoning as the loud at-cap rejection below)
            if int(frame.get("chunk", 0)) == 0:
                est = len(str(frame.get("data", ""))) * max(
                    1, int(frame.get("total", 1))
                )
                adm = self._admit(session, CLASS_SUMMARY, doc, frame,
                                  ops=1, nbytes=est)
                if adm is not None:
                    self._send_shed(session, doc, frame, adm,
                                    as_nack=False)
                    return
            self._check_write_access(session, doc, frame)
            self._handle_upload_chunk(session, doc, frame)
            if self.usage is not None and \
                    int(frame.get("chunk", 0)) + 1 == \
                    int(frame.get("total", 1)):
                # the final chunk staged the tree: one completed
                # upload charged to the connect-validated tenant
                tenant = session.tenant_ids.get(doc or "", "")
                if tenant:
                    self.usage.charge(tenant, 0.0, summary_uploads=1)
                    _TENANT_UPLOADS.inc()
        elif kind == "disconnect_document":
            conn = session.connections.pop(doc, None)
            if conn is not None:
                conn.disconnect()
        else:
            raise ValueError(f"unknown frame type {kind!r}")

    # upload size guards: a hostile client must not balloon server
    # memory through the staging buffers. Bytes are accounted PER
    # SESSION across all in-flight uploads. Past the concurrency cap,
    # uploads idle beyond UPLOAD_IDLE_TTL are reclaimed (abandoned
    # upload_ids must not hold slots/bytes forever), then a NEW
    # upload_id is rejected loudly — never an in-progress one
    # (evicting a live upload would surface as a misleading
    # out-of-order error on its next chunk).
    MAX_UPLOAD_CHUNK = 1 << 20       # 1 MiB per frame
    MAX_UPLOAD_TOTAL = 256 << 20     # 256 MiB staged per session
    MAX_UPLOADS_IN_FLIGHT = 4
    UPLOAD_IDLE_TTL = 60.0           # seconds without a chunk

    def _handle_upload_chunk(self, session: _ClientSession, doc: str,
                             frame: dict) -> None:
        """Chunked client summary upload
        (driver-definitions/src/storage.ts:119
        uploadSummaryWithContext; historian's summary POST routes).
        Chunks arrive in order on the session's TCP stream;
        intermediate chunks are fire-and-forget (the driver pipelines
        them and only the final, rid-carrying chunk waits), and the
        final chunk stages the tree in the document's
        content-addressed store, returning the root handle for the
        summarize op."""
        upload_id = str(frame["upload_id"])
        chunk_i = int(frame["chunk"])
        total = int(frame["total"])
        data = frame["data"]
        if not isinstance(data, str) or \
                len(data) > self.MAX_UPLOAD_CHUNK:
            raise ValueError("upload chunk too large or malformed")
        if total < 1:
            raise ValueError("malformed upload")
        now = time.monotonic()
        # reclaim abandoned uploads (e.g. a driver that timed out
        # mid-upload and never sends the final chunk) on EVERY chunk,
        # not only at the count cap: an under-cap abandoned upload
        # would otherwise hold its staged bytes against
        # MAX_UPLOAD_TOTAL for the session's lifetime
        for uid in [
            uid for uid, st in session.uploads.items()
            if uid != upload_id
            and now - st["touched"] > self.UPLOAD_IDLE_TTL
        ]:
            session.uploads.pop(uid)
        state = session.uploads.get(upload_id)
        if state is None and chunk_i != 0:
            # a continuation for an upload we don't know: it was
            # rejected at the cap, reclaimed by the idle TTL, or never
            # started — say so, instead of creating fresh state and
            # failing with a misleading out-of-order error
            raise ValueError(
                "unknown upload (rejected, expired, or never started)"
            )
        if state is None:
            if len(session.uploads) >= self.MAX_UPLOADS_IN_FLIGHT:
                # Reject loudly: evicting a fresh upload would kill a
                # legitimately in-progress one on a multiplexed
                # connection, and its next chunk would then fail with
                # a misleading out-of-order error.
                raise ValueError(
                    "too many concurrent uploads "
                    f"(max {self.MAX_UPLOADS_IN_FLIGHT})"
                )
            state = session.uploads[upload_id] = {
                "doc": doc, "parts": [], "total": total,
                "touched": now,
            }
        state["touched"] = now
        if state["doc"] != doc or state["total"] != total \
                or chunk_i != len(state["parts"]):
            session.uploads.pop(upload_id, None)
            raise ValueError("upload chunk out of order")
        staged_bytes = sum(
            len(p) for st in session.uploads.values()
            for p in st["parts"]
        )
        if staged_bytes + len(data) > self.MAX_UPLOAD_TOTAL:
            session.uploads.pop(upload_id, None)
            raise ValueError("upload too large")
        state["parts"].append(data)
        if chunk_i + 1 < total:
            if frame.get("rid") is not None:
                session.send({
                    "type": "upload_ack", "rid": frame["rid"],
                    "received": chunk_i,
                })
            return
        fault = _SITE_UPLOAD.fire(doc=doc)
        if fault is not None:
            # the staged chunks are DISCARDED with the failure (a
            # retry resends the whole upload under a fresh upload_id
            # — there is no resume protocol); raising here answers
            # the waited rid with the transient error shape the
            # driver converts, and the container falls back inline
            session.uploads.pop(upload_id, None)
            raise _SITE_UPLOAD.transient(fault)
        session.uploads.pop(upload_id, None)
        summary = decode_contents(json.loads("".join(state["parts"])))
        handle = self.local.get_orderer(doc).summary_store.stage(
            summary
        )
        session.send({
            "type": "summary_uploaded", "rid": frame.get("rid"),
            "handle": handle,
        })


def default_slo_objectives() -> list:
    """The service plane's default objectives (docs/OBSERVABILITY.md
    "Serving SLOs"). They bind ONLY to families this module owns —
    obs must never import what it observes, so the objective
    declarations live with the layer that registers the histograms:

    - ``ingress-dispatch-p99``: 99% of dispatched frames occupy the
      event loop < 50ms. The loop IS the serving capacity of this
      process; a frame past 50ms is starving every other session.
    - ``ingress-goodput``: >= 95% of offered client ops decode and
      ticket (the rest were shed by admission or failed) over the
      burn window — the "is the service actually serving" floor.
    """
    from ..obs.slo import Objective

    return [
        Objective("ingress-dispatch-p99",
                  metric="ingress_dispatch_ms",
                  threshold_ms=50.0, target=0.99),
        Objective("ingress-goodput", kind="goodput",
                  good_metric="ingress_ops_ticketed_total",
                  total_metric="ingress_ops_offered_total",
                  target=0.95),
    ]


def _parse_hostport(value: str, default_host: str = "127.0.0.1"
                    ) -> tuple[str, int]:
    """Parse "host:port" (IPv6 literals bracketed: "[::1]:7081") with
    a usable error instead of an int() traceback."""
    host, sep, port = value.rpartition(":")
    if not sep or not port.isdigit():
        raise SystemExit(
            f"--broker expects host:port, got {value!r}"
        )
    host = host or default_host
    if host.startswith("[") and host.endswith("]"):
        host = host[1:-1]
    return host, int(port)


def _check_durable_layout(data_dir: Optional[str],
                          partitions: int,
                          queue_source: str = "local") -> None:
    """The inline and partitioned modes use different on-disk layouts,
    the partition count is baked into the queue's document->partition
    routing, and the QUEUE SOURCE (local file queue vs networked
    broker) determines where unconsumed records live. Restarting an
    existing data dir under a different configuration would silently
    come up empty (or misroute documents, or orphan unpumped records
    in the abandoned queue) — refuse loudly instead."""
    if data_dir is None:
        return
    import json as _json
    import os as _os

    marker = _os.path.join(data_dir, "layout.json")
    current = {"mode": "partitioned" if partitions > 0 else "inline",
               "partitions": partitions}
    if partitions > 0:
        current["queue"] = queue_source
    if _os.path.exists(marker):
        with open(marker) as f:
            stored = _json.load(f)
        # pre-queue-field markers: local was the only option then;
        # early markers stored the broker ADDRESS — normalize to the
        # kind (an address respelling must not brick the dir)
        if stored.get("mode") == "partitioned":
            stored.setdefault("queue", "local")
            if str(stored["queue"]).startswith("broker:"):
                stored["queue"] = "broker"
        if stored != current:
            raise SystemExit(
                f"data dir {data_dir!r} was created with layout "
                f"{stored}, refusing to start with {current}: document "
                "history would be ignored or misrouted. Use the "
                "original flags or a fresh --data-dir."
            )
        return
    if _os.path.isdir(data_dir) and _os.listdir(data_dir):
        # data without a marker (pre-marker release or foreign dir):
        # adopting a layout could silently orphan that history
        raise SystemExit(
            f"data dir {data_dir!r} contains data but no layout.json; "
            "refusing to guess its layout. Create layout.json "
            f"({current} for the current flags) after verifying, or "
            "use a fresh --data-dir."
        )
    _os.makedirs(data_dir, exist_ok=True)
    with open(marker, "w") as f:
        _json.dump(current, f)


def run_server(host: str = "127.0.0.1", port: int = 7070,
               data_dir: Optional[str] = None,
               partitions: int = 0,
               broker: Optional[str] = None,
               qos_enabled: bool = False,
               qos_ops_per_sec: float = 2000.0,
               slo_enabled: bool = False) -> None:
    """Blocking entry point (the tinylicious analogue; see
    service/__main__.py). ``data_dir`` makes every document durable:
    op log, summaries and deli checkpoints survive restarts.
    ``partitions`` > 0 routes everything through the partitioned
    queue pipeline (the kafka-deployment shape) instead of the inline
    orderer; ``broker`` = "host:port" of a running
    ``service.broker`` — the NETWORKED queue, so partitions span
    processes/hosts (services-ordering-rdkafka's role).
    ``qos_enabled`` turns on admission control + backpressure
    (docs/QOS.md): token-bucket limits scaled from
    ``qos_ops_per_sec``, pressure-tier shedding, and a circuit
    breaker around checkpoint writes. ``slo_enabled`` attaches the
    default serving objectives (:func:`default_slo_objectives`) to
    an obs.SloEngine serving the ``slo`` frame / ``--dump-slo``."""
    queue = None
    if broker is not None:
        from .broker import RemoteOrderingQueue

        bhost, bport = _parse_hostport(broker)
        queue = RemoteOrderingQueue(bhost, bport)
        if partitions <= 0:
            partitions = queue.n_partitions
        elif partitions != queue.n_partitions:
            # document->partition routing is crc32 % N: a consumer
            # disagreeing with the broker's N splits document ordering
            # across partitions (or produces out-of-range)
            raise SystemExit(
                f"--partitions {partitions} disagrees with the "
                f"broker's {queue.n_partitions}; drop --partitions "
                "or match it"
            )
        import os as _os

        fresh_state = data_dir is None or not _os.path.exists(
            _os.path.join(data_dir, "layout.json")
        )
        if fresh_state and any(
            queue.committed(p) >= 0 for p in range(partitions)
        ):
            # the broker has committed progress but this consumer has
            # no prior document state (no --data-dir, or an empty
            # one): resuming past the committed offsets would bring
            # every document up silently EMPTY
            raise SystemExit(
                "broker has committed offsets but this server has no "
                "prior state: resuming would skip all applied "
                "history. Point --data-dir at the original state (or "
                "a replacement host's copy)."
            )
    # the marker records WHICH KIND of queue (local file vs networked
    # broker), not the broker's address — a respelled host or a
    # re-launched broker port must not brick the data dir
    _check_durable_layout(
        data_dir, partitions,
        queue_source="broker" if broker else "local",
    )
    qos = None
    storage_breaker = None
    if qos_enabled:
        from ..qos import (
            AdmissionController,
            CircuitBreaker,
            PressureMonitor,
            default_limits,
        )

        if data_dir is not None:
            storage_breaker = CircuitBreaker(
                "checkpoint-storage", failure_threshold=3,
                reset_timeout_s=5.0,
            )
        qos = AdmissionController(
            limits=default_limits(qos_ops_per_sec),
            # cost-bounded sampling on the serving path: at overload
            # the gate runs per frame; 50ms staleness is immaterial
            # against queue depths that build over seconds
            pressure=PressureMonitor(min_interval_s=0.05),
        )
    if partitions > 0:
        from .partitioning import PartitionedServer

        local = PartitionedServer(
            n_partitions=partitions, durable_dir=data_dir,
            queue=queue, storage_breaker=storage_breaker)
    else:
        local = LocalServer(durable_dir=data_dir,
                            storage_breaker=storage_breaker)
    # cost-attribution plane (obs/heat.py): the per-document heat
    # ledger (charged by a sidecar when one is wired; served either
    # way) and the per-tenant usage rollup — both LRU-capped, both
    # behind the wire-1.4 heat frame / --dump-heat
    from ..obs.heat import HeatLedger, usage_ledger

    heat = HeatLedger()
    usage = usage_ledger()
    slo = None
    if slo_enabled:
        from ..obs.slo import SloEngine

        slo = SloEngine(default_slo_objectives())
        if qos is not None and getattr(qos, "pressure", None) \
                is not None:
            # burn-rate verdicts cite the overload context: "goodput
            # burned through its budget WHILE pressure sat at severe"
            slo.add_context("pressure", qos.pressure.context)
        # ... and WHO was burning it: every verdict carries the top-k
        # hot tenants off the usage ledger, so an overload breach
        # names its cause instead of just its symptom
        slo.add_context("hot_tenants", lambda: usage.top_k(5))
    server = AlfredServer(local, host=host, port=port, qos=qos,
                          slo=slo, heat=heat, usage=usage)

    async def main():
        await server.start()
        print(f"fluidframework-tpu-torch dev service listening on "
              f"{server.host}:{server.port}", flush=True)
        await server.serve_forever()

    try:
        asyncio.run(main())
    except KeyboardInterrupt:  # pragma: no cover - interactive
        pass
