"""Fault-injection driver wrappers, backed by the chaos plane's sites.

Reference: packages/test/test-service-load/src/faultInjectionDriver.ts
(:27,:62,:135,:241,:254) — wrappers over IDocumentService /
IDocumentDeltaConnection that inject disconnects and error nacks on
demand or on a schedule, so failure paths (reconnect, resubmit,
rebase) get exercised under load.

These wrappers now speak the ONE injection vocabulary of the chaos
plane (qos/faults.py): ``inject_nacks``/``inject_disconnect`` queue
scripted faults on the same named sites a seeded ``FaultSchedule``
fires at (``socket.frame_out``), and the ScriptedFrameServer's
CORRUPT reply records through ``testing.scripted_frame`` — so every
injection, scripted or scheduled, shows up in
``chaos_injected_total{site,kind}`` and the plane's flight recorder.
A copy of the reference's ``testing/fault_injection.py``.
"""
from __future__ import annotations

from typing import Callable, Optional

from ..protocol.messages import (
    DocumentMessage,
    Nack,
    NackErrorType,
    SequencedMessage,
)
from ..qos.faults import (
    KIND_CORRUPT,
    KIND_DISCONNECT,
    KIND_NACK,
    PLANE as _CHAOS,
)

# scripted injections ride the SAME site the schedule-driven socket
# faults use; the frame server's protocol corruption gets its own
# (it is a peer misbehaving, not this process's transport)
_SITE_FRAME_OUT = _CHAOS.site(
    "socket.frame_out", (KIND_DISCONNECT, KIND_NACK))
_SITE_SCRIPTED = _CHAOS.site("testing.scripted_frame", (KIND_CORRUPT,))


class FaultInjectionConnection:
    """faultInjectionDriver.ts:135 — a delta connection that can be
    killed or made to nack on command."""

    def __init__(self, inner, on_nack: Optional[Callable[[Nack], None]]):
        self._inner = inner
        self._on_nack = on_nack
        self.injected_nack_next = 0
        self.submits = 0

    @property
    def client_id(self) -> str:
        return self._inner.client_id

    @property
    def open(self) -> bool:
        return self._inner.open

    def submit(self, op: DocumentMessage) -> None:
        self.submits += 1
        if self.injected_nack_next > 0:
            self.injected_nack_next -= 1
            # recorded on the shared transport site (force, not push:
            # WHICH connection nacks is this wrapper's own state — a
            # site-level queue could be stolen by an unrelated socket
            # driver consulting the same seam)
            _SITE_FRAME_OUT.force(KIND_NACK, scripted=True)
            if self._on_nack is not None:
                self._on_nack(Nack(
                    operation=op,
                    sequence_number=-1,
                    error_type=NackErrorType.THROTTLING,
                    message="injected nack",
                    retry_after_seconds=0.0,
                ))
            return  # op dropped, as a throttling service would
        self._inner.submit(op)

    def disconnect(self) -> None:
        self._inner.disconnect()

    # ---- injection controls (injectNack/injectDisconnect)

    def inject_disconnect(self) -> None:
        """Hard-drop the socket without telling the client object."""
        _SITE_FRAME_OUT.force(KIND_DISCONNECT, scripted=True)
        self._inner.disconnect()

    def inject_nacks(self, count: int = 1) -> None:
        self.injected_nack_next += count


class FaultInjectionDocumentService:
    """faultInjectionDriver.ts:27 — wraps a DocumentService, tracking
    live connections so tests can kill them at any moment."""

    def __init__(self, inner):
        self._inner = inner
        self.connections: list[FaultInjectionConnection] = []

    @property
    def document_id(self) -> str:
        return self._inner.document_id

    def connect_to_delta_stream(self, client_id, on_message,
                                on_nack=None):
        conn = FaultInjectionConnection(
            self._inner.connect_to_delta_stream(
                client_id, on_message, on_nack
            ),
            on_nack,
        )
        self.connections.append(conn)
        return conn

    def read_ops(self, from_seq, to_seq=None) -> list[SequencedMessage]:
        return self._inner.read_ops(from_seq, to_seq)

    def get_latest_summary(self):
        return self._inner.get_latest_summary()

    # ---- injection controls

    @property
    def live_connections(self) -> list[FaultInjectionConnection]:
        return [c for c in self.connections if c.open]

    def inject_disconnect_all(self) -> int:
        live = self.live_connections
        for conn in live:
            conn.inject_disconnect()
        return len(live)


class ScriptedFrameServer:
    """TCP stand-in for a framed-protocol peer that misbehaves on cue
    — the harness for protocol-fault tests (desynced streams, corrupt
    length prefixes) against the blocking request/response clients
    (broker's RemoteOrderingQueue, moira's MH client).

    ``script`` is consumed one entry per received request frame:
    a dict is sent as a well-formed frame; the ``CORRUPT`` sentinel
    sends an insane length prefix (the poisoned-stream shape). The
    server keeps accepting reconnects until the script is exhausted,
    so tests can assert drop-and-reconnect behavior.
    """

    CORRUPT = object()

    def __init__(self, script):
        import socket
        import threading

        self.script = list(script)
        self._srv = socket.socket()
        self._srv.bind(("127.0.0.1", 0))
        self._srv.listen(2)
        self.port = self._srv.getsockname()[1]
        self._conns: list = []
        self._thread = threading.Thread(target=self._serve,
                                        daemon=True)
        self._thread.start()

    @staticmethod
    def _read_exact(conn, n):
        buf = b""
        while len(buf) < n:
            chunk = conn.recv(n - len(buf))
            if not chunk:
                return None
            buf += chunk
        return buf

    def _serve(self):
        import struct

        from ..service.ingress import pack_frame

        while self.script:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            self._conns.append(conn)
            try:
                while self.script:
                    # consume exactly ONE length-prefixed request per
                    # script entry: a coalesced or split TCP read must
                    # not desync scripted replies from requests
                    header = self._read_exact(conn, 4)
                    if header is None:
                        break  # client dropped us: await reconnect
                    (length,) = struct.unpack(">I", header)
                    if self._read_exact(conn, length) is None:
                        break
                    reply = self.script.pop(0)
                    if reply is self.CORRUPT:
                        _SITE_SCRIPTED.force(KIND_CORRUPT,
                                             scripted=True)
                        conn.sendall(struct.pack(">I", 1 << 31))
                    else:
                        conn.sendall(pack_frame(reply))
            except OSError:
                pass

    def close(self):
        import socket

        # closing the listener only unblocks accept(); a serve thread
        # parked in recv() on an accepted connection (client still
        # attached when a test assertion fails) needs its socket shut
        # down too or join() stalls its full timeout
        self._srv.close()
        for conn in self._conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass
        self._thread.join(timeout=10)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
