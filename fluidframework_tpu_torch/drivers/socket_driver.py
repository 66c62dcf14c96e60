"""Socket driver: DocumentService over a TCP connection to the
networked ingress (service/ingress.py).

Reference: the production networked driver pair —
packages/drivers/driver-base/src/documentDeltaConnection.ts (:41, the
connect_document handshake + op/nack events) and
packages/drivers/routerlicious-driver/src/documentService.ts (:37, the
three planes over the wire). One TCP connection per DocumentService; a
daemon receive-pump thread dispatches broadcast ops to the container's
callback and pairs request/response frames by ``rid``.

The client surface is synchronous (the loader's Container is
synchronous and single-threaded). Two daemon threads serve it:

- the RECV PUMP parses frames and only ever sets rid events or
  enqueues broadcasts — it never calls back into user code, so a
  request issued from any thread can always complete;
- the DISPATCH thread delivers op/nack broadcasts to the container's
  callbacks while holding ``self.lock``. The container's inbound path
  may itself issue blocking requests (gap refetch calls read_ops —
  deltaManager.ts:883), which is safe because the recv pump stays
  free.

Application code MUST hold the same ``service.lock`` around container
calls (flush/process/reads) — the container is not thread-safe and the
dispatch thread mutates it; `with svc.lock: container.flush()`.
"""
from __future__ import annotations

import itertools
import json
import queue
import select
import socket
import struct
import sys
import threading
from typing import Callable, Optional

from ..obs import metrics as obs_metrics
from ..obs.flight_recorder import FlightRecorder
from ..obs.trace import stamp as trace_stamp
from ..protocol.messages import DocumentMessage, Nack, NackErrorType, SequencedMessage
from ..protocol.constants import wire_version_lt
from ..protocol.serialization import decode_contents, message_from_json
from ..qos.faults import (
    KIND_DELAY,
    KIND_DISCONNECT,
    KIND_DROP,
    KIND_DUPLICATE,
    KIND_NACK,
    KIND_REORDER,
    PLANE as _CHAOS,
)
from ..protocol.columnar import encode_columns
from ..service.ingress import document_message_to_json, pack_frame

_LEN = struct.Struct(">I")

_FRAMES_SENT = obs_metrics.REGISTRY.counter(
    "driver_frames_sent_total", "frames the socket driver sent")
_FRAMES_RECV = obs_metrics.REGISTRY.counter(
    "driver_frames_received_total", "frames the socket driver parsed")
_DISPATCH_FAULTS = obs_metrics.REGISTRY.counter(
    "driver_dispatch_faults_total",
    "delivery callbacks that raised (transport torn down loudly)")
_REQUEST_TIMEOUTS = obs_metrics.REGISTRY.counter(
    "driver_request_timeouts_total",
    "request/response deadlines missed (flight dump emitted)")

# chaos seams (docs/ROBUSTNESS.md): the SAME site names the in-proc
# chaos transport (testing/chaos.py) registers, so one schedule
# drives either harness. Outbound faults are the ones a real TCP
# stream can actually exhibit at this layer — transport death and an
# injected throttle nack (the faultInjectionDriver vocabulary);
# inbound faults apply to broadcast "op" frames only, where
# drop/duplicate/reorder are REAL phenomena with real recovery paths
# (slow-consumer fanout drops -> gap refetch; catch-up overlapping
# live fanout -> the container's seq dedupe). rid-paired
# request/response frames ride the reliable stream untouched.
_SITE_FRAME_OUT = _CHAOS.site(
    "socket.frame_out", (KIND_DISCONNECT, KIND_NACK))
_SITE_FRAME_IN = _CHAOS.site(
    "socket.frame_in",
    (KIND_DROP, KIND_DUPLICATE, KIND_REORDER, KIND_DELAY))


# wire versions this driver speaks, newest first (the server echoes
# the agreed one in "connected"; see ingress.WIRE_VERSIONS for what
# each version adds — 1.1 is the chunked summary-upload plane, 1.2 the
# boxcarred batch submit, 1.3 the columnar SoA batch submit, 1.4 the
# heat cost-attribution frame, 1.5 the registered sharedtree payload
# vocabulary)
WIRE_VERSIONS = ("1.5", "1.4", "1.3", "1.2", "1.1", "1.0")


def build_connect_frame(document_id: str, client_id: str, mode: str,
                        tenant_id=None, token=None,
                        versions=None) -> dict:
    """The connect_document handshake frame — ONE definition so the
    single-socket and multiplexed drivers cannot diverge on auth/mode
    fields. ``versions`` overrides the offer (compat tests pin an
    old client against a new server)."""
    frame = {
        "type": "connect_document",
        "document_id": document_id,
        "client_id": client_id,
        "mode": mode,
        "versions": list(versions or WIRE_VERSIONS),
    }
    if token is not None:
        frame["tenant_id"] = tenant_id
        frame["token"] = token
    return frame


class SocketDocumentService:
    """IDocumentService over the wire; create via the factory."""

    def __init__(self, host: str, port: int, document_id: str,
                 timeout: float = 30.0,
                 tenant_id: Optional[str] = None,
                 token: Optional[str] = None,
                 mode: str = "write",
                 wire_versions=None):
        self.document_id = document_id
        # riddler-analogue auth (service/tenancy.py): sent with the
        # connect_document handshake when the server gates on tokens
        self.tenant_id = tenant_id
        self.token = token
        self.mode = mode
        # offered wire versions (override pins an old client for the
        # compat matrix); the server's pick lands in agreed_version
        self.wire_versions = tuple(wire_versions or WIRE_VERSIONS)
        self.agreed_version: Optional[str] = None
        self.auth_error: Optional[str] = None
        self.lock = threading.RLock()
        self._timeout = timeout
        self._sock = socket.create_connection((host, port),
                                              timeout=timeout)
        self._send_lock = threading.Lock()
        self._rid = itertools.count(1)
        self._pending: dict[int, tuple[threading.Event, list]] = {}
        self._pending_lock = threading.Lock()
        self._on_message: Optional[Callable] = None
        self._on_nack: Optional[Callable] = None
        self._connected = threading.Event()
        self._closed = False
        self.last_error: Optional[str] = None
        # transport flight recorder: the last N frames in/out, dumped
        # automatically on a dispatch fault or a missed deadline
        self.flight = FlightRecorder(
            128, name=f"socket-{document_id}")
        self.last_flight_dump: Optional[str] = None
        self._inbox: queue.Queue[Optional[dict]] = queue.Queue()
        # broadcast frames a chaos reorder/delay fault is holding
        # (recv-pump thread only; released after the next delivery)
        self._held: list[dict] = []
        self._pump = threading.Thread(
            target=self._recv_loop, daemon=True,
            name=f"socket-recv-{document_id}",
        )
        self._pump.start()
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, daemon=True,
            name=f"socket-dispatch-{document_id}",
        )
        self._dispatcher.start()

    # -- framing -------------------------------------------------------

    def _send(self, data: dict) -> None:
        if data.get("type") == "submitOp":
            fault = _SITE_FRAME_OUT.fire(doc=self.document_id)
            if fault == KIND_NACK:
                # refused as a throttling service would: the frame is
                # dropped and an injected nack delivers on the normal
                # dispatch path — reconnect + pending-resubmit is the
                # recovery (faultInjectionDriver.ts:62 semantics)
                self.flight.record("chaos-nack", type="submitOp")
                self._inbox.put({
                    "type": "nack",
                    "document_id": self.document_id,
                    "operation": None,
                    "sequence_number": 0,
                    "error_type": int(NackErrorType.THROTTLING),
                    "message": "chaos: injected nack",
                    "retry_after_seconds": 0.0,
                })
                return
            if fault == KIND_DISCONNECT:
                # transport death, no goodbye: the frame is lost to
                # the dying socket; the recv pump's teardown protocol
                # runs and the app-level reconnect path recovers
                self.flight.record("chaos-disconnect")
                self.close()
                return
        frame = pack_frame(data)
        self.flight.record("send", type=data.get("type"),
                           rid=data.get("rid"), bytes=len(frame))
        _FRAMES_SENT.inc()
        with self._send_lock:
            self._sock.sendall(frame)

    def _recv_exact(self, n: int) -> Optional[bytes]:
        buf = b""
        while len(buf) < n:
            try:
                chunk = self._sock.recv(n - len(buf))
            except OSError:
                return None
            if not chunk:
                return None
            buf += chunk
        return buf

    # how long a chaos-held (reordered/delayed) frame may wait for a
    # NEXT frame before it releases anyway: a held frame on an IDLE
    # connection would otherwise stall the replica until the socket
    # timeout (gap detection needs follow-on traffic to notice)
    HELD_FLUSH_S = 0.05

    def _recv_header(self) -> Optional[bytes]:
        """Read the next frame header. While chaos-held frames exist,
        poll READABILITY with ``select`` and flush the holds if the
        wire stays idle — never by toggling the socket timeout, which
        is shared with concurrent ``sendall`` on the submit path (a
        50ms send timeout could tear an outbound frame mid-write and
        desync the whole length-prefixed stream)."""
        while self._held:
            try:
                readable, _, _ = select.select(
                    [self._sock], [], [], self.HELD_FLUSH_S)
            except (OSError, ValueError):
                return None  # socket died under us
            if readable:
                break  # real traffic follows: the reorder resolves
            for held in self._held:
                self._inbox.put(held)
            self._held = []
        return self._recv_exact(_LEN.size)

    def _recv_loop(self) -> None:
        try:
            while not self._closed:
                header = self._recv_header()
                if header is None:
                    break
                (length,) = _LEN.unpack(header)
                body = self._recv_exact(length)
                if body is None:
                    break
                frame = json.loads(body.decode("utf-8"))
                self.flight.record(
                    "recv", type=frame.get("type"),
                    rid=frame.get("rid"),
                    seq=(frame.get("msg") or {}).get("sequenceNumber"),
                )
                _FRAMES_RECV.inc()
                rid = frame.get("rid")
                if rid is not None:
                    with self._pending_lock:
                        pending = self._pending.pop(rid, None)
                    if pending is not None:
                        event, slot = pending
                        slot.append(frame)
                        event.set()
                    continue
                kind = frame.get("type")
                if kind == "connected":
                    self._on_connected(frame)
                elif kind == "connect_document_error":
                    # deliver directly from the pump: the dispatcher
                    # takes self.lock before delivering, but callers
                    # hold that lock around Container.load while
                    # waiting on _connected — routing the rejection
                    # through the dispatcher would deadlock into a
                    # TimeoutError instead of a prompt PermissionError
                    self._on_connect_error(frame)
                else:
                    if kind == "op":
                        fault = _SITE_FRAME_IN.fire(
                            doc=self.document_id)
                        if fault == KIND_DROP:
                            # the slow-consumer shape: the fanout
                            # frame vanishes; the container's gap
                            # detection refetches it from delta
                            # storage
                            continue
                        if fault == KIND_DUPLICATE:
                            # at-least-once shape: the container's
                            # inbound seq check drops the copy
                            self._inbox.put(frame)
                        elif fault in (KIND_REORDER, KIND_DELAY):
                            # held past the next delivered frame:
                            # out-of-order arrival — gap refetch +
                            # seq dedupe absorb it
                            self._held.append(frame)
                            continue
                    self._inbox.put(frame)
                    if self._held:
                        for held in self._held:
                            self._inbox.put(held)
                        self._held = []
        finally:
            # even on a parse error the shutdown protocol must run, or
            # the dispatcher and every pending request hang
            self.flight.record("transport-closed")
            self._closed = True
            for held in self._held:
                # chaos-held frames still deliver (late, like the
                # reordered arrivals they model) — held-forever would
                # be a silent drop without the drop accounting
                self._inbox.put(held)
            self._held = []
            self._inbox.put(None)
            with self._pending_lock:
                waiters = list(self._pending.values())
                self._pending.clear()
            for event, _slot in waiters:
                event.set()
            # a thread blocked in the connect_document handshake must
            # fail promptly too (socket death mid-handshake otherwise
            # waits out the full timeout)
            self._on_transport_closed()

    def _on_transport_closed(self) -> None:
        self._connected.set()

    def _dispatch_loop(self) -> None:
        while True:
            frame = self._inbox.get()
            if frame is None:
                break
            try:
                with self.lock:
                    self._deliver(frame)
            except Exception:  # noqa: BLE001 - must fail LOUDLY
                # A delivery callback raising used to kill this thread
                # SILENTLY: every later broadcast (including the acks
                # of ops already submitted) was dropped and the
                # container waited on pending ops forever — the exact
                # shape of the round-5 ~1-in-3 whiteboard stall (a
                # foreign op sequenced mid-batch tripped the
                # ScheduleManager assert here). Continuing to deliver
                # would be no better: the fault may have torn the
                # runtime mid-message, and feeding it further ops
                # serves silently-divergent state. Fail LOUDLY and
                # DETECTABLY instead: record the fault, print it, and
                # tear the transport down — the app layer reconnects
                # and the pending-state machinery resubmits exactly
                # (the same recovery path a dropped connection takes).
                import traceback

                err = (
                    f"dispatch fault on {frame.get('type')!r}: "
                    f"{traceback.format_exc()}"
                )
                _DISPATCH_FAULTS.inc()
                self.flight.record("dispatch-fault",
                                   type=frame.get("type"))
                with self.lock:
                    self.last_error = err
                print(
                    f"socket-driver[{self.document_id}]: {err}",
                    file=sys.stderr,
                )
                # postmortem: the last N transport events that led
                # here (what was delivered, what was in flight)
                self.last_flight_dump = self.flight.dump_to(
                    reason="dispatch fault teardown")
                self.close()
                break

    def _on_connected(self, frame: dict) -> None:
        """Handshake-ack hook (the multiplexing subclass routes by
        document_id)."""
        self.agreed_version = frame.get("version")
        self._connected.set()

    def _on_connect_error(self, frame: dict) -> None:
        # auth/handshake rejection: record the reason and release the
        # waiter so it can raise immediately with the cause
        self.auth_error = frame.get("message", "rejected")
        self._connected.set()

    def _deliver(self, frame: dict) -> None:
        kind = frame.get("type")
        if kind == "error":
            # a submit the server could neither sequence nor nack
            # (e.g. undecodable op contents): losing it silently would
            # stall the CSN stream with no diagnostic
            self.last_error = frame.get("message", "server error")
            print(
                f"socket-driver[{self.document_id}]: server error: "
                f"{self.last_error}",
                file=sys.stderr,
            )
            return
        if kind == "op" and self._on_message is not None:
            msg = message_from_json(frame["msg"])
            # per-session deserialized copy: the deliver hop is this
            # client's own (unlike the shared in-proc object)
            trace_stamp(msg.traces, "driver", "deliver")
            self._on_message(msg)
        elif kind == "nack" and self._on_nack is not None:
            from ..service.ingress import document_message_from_json

            op = frame.get("operation")
            self._on_nack(Nack(
                operation=document_message_from_json(op)
                if op else None,
                sequence_number=frame["sequence_number"],
                error_type=NackErrorType(frame["error_type"]),
                message=frame.get("message", ""),
                retry_after_seconds=frame.get("retry_after_seconds"),
                # qos shed attribution: OPTIONAL on the wire (absent
                # from pre-qos servers — test_wire_compat)
                pressure_tier=frame.get("pressure_tier"),
                shed_class=frame.get("shed_class"),
            ))

    def _request(self, data: dict) -> dict:
        rid = next(self._rid)
        event: threading.Event = threading.Event()
        slot: list = []
        with self._pending_lock:
            self._pending[rid] = (event, slot)
        self._send(dict(data, rid=rid))
        if not event.wait(self._timeout):
            with self._pending_lock:
                self._pending.pop(rid, None)
            # a missed deadline used to be a bare TimeoutError with
            # zero context; dump the recent transport events so the
            # postmortem ships with the exception
            _REQUEST_TIMEOUTS.inc()
            self.flight.record("request-timeout", type=data["type"],
                               rid=rid)
            self.last_flight_dump = self.flight.dump_to(
                reason=f"no response to {data['type']} "
                       f"(rid={rid}) within {self._timeout}s")
            raise TimeoutError(
                f"no response to {data['type']} (rid={rid}) within "
                f"{self._timeout}s; recent transport events:\n"
                f"{self.last_flight_dump}"
            )
        if not slot:
            raise ConnectionError("connection closed mid-request")
        frame = slot[0]
        if frame.get("type") == "error":
            msg = frame.get("message", "server error")
            if frame.get("error_kind") == "permission":
                raise PermissionError(msg)
            if frame.get("error_kind") == "throttle":
                # qos shed a storage-plane request: surface it as the
                # RETRIABLE shape run_with_retry honors, with the
                # server's honest retry hint as the backoff floor
                from .driver_utils import RetriableError

                raise RetriableError(
                    msg,
                    retry_after_seconds=frame.get(
                        "retry_after_seconds"),
                )
            raise RuntimeError(msg)
        return frame

    # -- DocumentService surface ---------------------------------------

    def connect_to_delta_stream(
        self,
        client_id: str,
        on_message: Callable[[SequencedMessage], None],
        on_nack: Optional[Callable[[Nack], None]] = None,
    ) -> "SocketDeltaConnection":
        self._on_message = on_message
        self._on_nack = on_nack
        # a retried handshake must not see the previous attempt's
        # rejection or completion state
        self.auth_error = None
        self._connected.clear()
        if self._closed:
            # transport already dead: clear() above just discarded the
            # shutdown wakeup — fail now, not after the full timeout
            raise ConnectionError("connection closed")
        self._send(build_connect_frame(
            self.document_id, client_id, self.mode,
            self.tenant_id, self.token,
            versions=self.wire_versions))
        if not self._connected.wait(self._timeout):
            self.last_flight_dump = self.flight.dump_to(
                reason="connect_document handshake deadline missed")
            raise TimeoutError(
                "connect_document handshake timed out; recent "
                f"transport events:\n{self.last_flight_dump}")
        if self.auth_error is not None:
            raise PermissionError(
                f"connect_document rejected: {self.auth_error}")
        if self._closed:
            raise ConnectionError("connection closed during handshake")
        return SocketDeltaConnection(self, client_id)

    def read_ops(self, from_seq: int,
                 to_seq: Optional[int] = None) -> list[SequencedMessage]:
        # storage-plane requests carry the token: the loader reads
        # snapshot + ops BEFORE connect_document
        return self._doc_read_ops(self.document_id, from_seq, to_seq,
                                  auth=(self.tenant_id, self.token))

    def get_latest_summary(self) -> Optional[tuple[int, dict]]:
        return self._doc_latest_summary(
            self.document_id, auth=(self.tenant_id, self.token))

    # single definitions of the request planes, parameterized by
    # document so the multiplexed facades reuse them verbatim; ``auth``
    # lets a facade supply ITS document's (tenant_id, token) over the
    # shared transport
    def _doc_read_ops(self, document_id: str, from_seq: int,
                      to_seq: Optional[int] = None, auth=None
                      ) -> list[SequencedMessage]:
        data = {
            "type": "read_ops", "document_id": document_id,
            "from_seq": from_seq, "to_seq": to_seq,
        }
        if auth is not None and auth[1] is not None:
            data["tenant_id"], data["token"] = auth
        frame = self._request(data)
        return [message_from_json(m) for m in frame["msgs"]]

    def upload_summary(self, summary: dict) -> str:
        """Upload a summary tree to service storage and return its
        root handle — the storage half of the reference's summarize
        flow (driver-definitions/src/storage.ts:119
        uploadSummaryWithContext): the summarize op then proposes the
        handle instead of carrying the tree on the op stream.

        Wire >= 1.1 only: on a 1.0-agreed connection raise the
        transient-shaped error the container's summarize fallback
        catches, so an old-server pairing degrades to inline
        summaries instead of sending frames the server rejects."""
        if self.agreed_version is not None and \
                wire_version_lt(self.agreed_version, "1.1"):
            raise RuntimeError(
                f"summary upload needs wire >= 1.1; connection "
                f"agreed {self.agreed_version}"
            )
        return self._doc_upload_summary(
            self.document_id, summary,
            auth=(self.tenant_id, self.token))

    _UPLOAD_CHUNK = 512 * 1024

    def _doc_upload_summary(self, document_id: str, summary: dict,
                            auth=None) -> str:
        """Chunks PIPELINE: intermediate frames are fire-and-forget
        (TCP ordering + backpressure carry them) and only the final
        chunk is a waited request — one round trip per upload, so a
        large summary does not hold the dispatch path hostage for
        total/chunk RTTs (matters most on the multiplexed socket,
        where every document shares one connection)."""
        from ..protocol.serialization import encode_contents

        payload = json.dumps(encode_contents(summary))
        parts = [
            payload[i:i + self._UPLOAD_CHUNK]
            for i in range(0, len(payload), self._UPLOAD_CHUNK)
        ] or [""]
        upload_id = f"u{next(self._rid)}"
        for i, part in enumerate(parts):
            data = {
                "type": "upload_summary_chunk",
                "document_id": document_id,
                "upload_id": upload_id,
                "chunk": i, "total": len(parts), "data": part,
            }
            if auth is not None and auth[1] is not None:
                data["tenant_id"], data["token"] = auth
            if i + 1 < len(parts):
                self._send(data)
            else:
                frame = self._request(data)
        return frame["handle"]

    def _doc_latest_summary(self, document_id: str, auth=None
                            ) -> Optional[tuple[int, dict]]:
        data = {
            "type": "fetch_summary", "document_id": document_id,
        }
        if auth is not None and auth[1] is not None:
            data["tenant_id"], data["token"] = auth
        frame = self._request(data)
        if frame.get("sequence_number") is None:
            return None
        return frame["sequence_number"], decode_contents(frame["summary"])

    def close(self) -> None:
        self._closed = True
        # shutdown BEFORE close: close() alone does not unblock a
        # thread currently inside recv() (it waits out the socket
        # timeout, deferring our FIN ~10s and stalling server-side
        # connection teardown); shutdown delivers EOF immediately
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass


class SocketDeltaConnection:
    """IDocumentDeltaConnection over the wire.

    BATCH BOXCARRING (wire >= 1.2): a runtime batch (ops between a
    ``{"batch": true}`` and ``{"batch": false}`` metadata mark) is
    buffered here and sent as ONE ``submitOp`` frame carrying the op
    array. This is the liveness fix for the round-5 ~1-in-3
    submit->ack stall: per-op frames from two TCP sessions interleave
    on the server's event loop, so another client's op could be
    SEQUENCED in the middle of this client's batch — receivers'
    ScheduleManager treats a foreign op mid-batch as a service
    ordering violation (it is one) and the replica stops acking. The
    reference never has this problem because a socket.io submitOp
    carries the whole batch array and alfred tickets it atomically;
    this restores that contract. Against a pre-1.2 server the driver
    degrades to per-op frames (the legacy racy behavior, for the
    compat matrix).

    COLUMNAR BATCHES (wire >= 1.3): at the batch flush point, a batch
    inside the columnar subset (plain text INSERT/REMOVEs, untraced —
    protocol/columnar.py) is sent as ONE ``submitOp`` frame whose
    payload IS the column layout ("cols"), which the service validates
    once and slices instead of re-interpreting per op. Anything the
    columns cannot express — and any batch against a pre-1.3 server —
    rides the wire-1.2 row boxcar unchanged (the compatibility
    fallback the compat matrix pins)."""

    def __init__(self, service: SocketDocumentService, client_id: str):
        self._service = service
        self.client_id = client_id
        self.open = True
        self._batch: list[DocumentMessage] = []
        self._batching = False

    def _boxcar_capable(self) -> bool:
        agreed = self._service.agreed_version
        return agreed is not None and not wire_version_lt(agreed, "1.2")

    def _columnar_capable(self) -> bool:
        agreed = self._service.agreed_version
        return agreed is not None and not wire_version_lt(agreed, "1.3")

    def submit(self, op: DocumentMessage) -> None:
        assert self.open, "submit on closed connection"
        from ..protocol.constants import batch_flag

        flag = batch_flag(op.metadata)
        if self._boxcar_capable() and (self._batching or flag is True):
            # buffered as the MESSAGE, not its wire form: the flush
            # point decides the encoding (columnar vs row boxcar) for
            # the batch as a unit, and the driver:send hop stamps at
            # the actual wire write below
            self._batch.append(op)
            self._batching = flag is not False
            if self._batching:
                return
            ops, self._batch = self._batch, []
            cols = (encode_columns(ops)
                    if self._columnar_capable() else None)
            if cols is not None:
                # traceless by design: the column layout carries no
                # traces column, and encode_columns routed any traced
                # (or otherwise inexpressible) batch to the row path
                # below — trace_ops traffic keeps its full hop chain
                self._service._send({
                    "type": "submitOp",
                    "document_id": self._service.document_id,
                    "cols": cols,
                })
                return
            wires = []
            for o in ops:
                trace_stamp(o.traces, "driver", "send")
                wires.append(document_message_to_json(o))
            self._service._send({
                "type": "submitOp",
                "document_id": self._service.document_id,
                "ops": wires,
            })
            return
        # stamped BEFORE serialization so the hop rides the wire
        trace_stamp(op.traces, "driver", "send")
        self._service._send({
            "type": "submitOp",
            "document_id": self._service.document_id,
            "op": document_message_to_json(op),
        })

    def disconnect(self) -> None:
        if not self.open:
            return
        self.open = False
        # an unterminated batch dies with the connection: its ops stay
        # in the runtime's pending state and resubmit on reconnect
        self._batch = []
        self._batching = False
        try:
            self._service._send({
                "type": "disconnect_document",
                "document_id": self._service.document_id,
            })
        except OSError:
            pass  # server already gone; the session cleans up


class SocketDocumentServiceFactory:
    """IDocumentServiceFactory against a running dev service
    (`python -m fluidframework_tpu_torch.service`)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 7070):
        self.host = host
        self.port = port

    def create_document_service(self, document_id: str
                                ) -> SocketDocumentService:
        return SocketDocumentService(self.host, self.port, document_id)
