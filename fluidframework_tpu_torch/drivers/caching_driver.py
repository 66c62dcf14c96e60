"""Caching + multiplexing driver — the odsp-driver class.

Reference: packages/drivers/odsp-driver — the production driver whose
two defining behaviors beyond the routerlicious driver are
(a) PERSISTENT SNAPSHOT CACHING (odsp-driver + driver-web-cache:
snapshots cached across sessions, served stale-while-offline, age
policy decides refresh) and (b) SOCKET MULTIPLEXING: many documents
share one physical websocket.

Construction here:

- ``SnapshotCache`` / ``FileSnapshotCache``: (document -> sequence
  number, summary, cached_at); the file variant survives the process
  (driver-web-cache's IndexedDB analogue).
- ``CachingDocumentService``: wraps any DocumentService. Fresh cache
  hits skip the network; misses fetch and populate; fetch FAILURES
  fall back to whatever the cache holds (offline load), and the
  trailing ops come from ``read_ops`` as usual so a stale snapshot is
  only a longer catch-up, never wrong.
- ``MultiplexedSocketClient``: ONE TCP connection to the ingress
  shared by every document's service (the server's per-session
  connection map already routes ops by document_id — ingress.py
  _ClientSession.connections); per-document facades expose the
  standard DocumentService surface.
"""
from __future__ import annotations

import hashlib
import json
import os
import sys
import threading
import time
from typing import Any, Callable, Optional

from ..protocol.constants import wire_version_lt
from ..protocol.serialization import decode_contents, encode_contents  # noqa: F401 - decode used by cache load
from .socket_driver import (
    SocketDeltaConnection,
    SocketDocumentService,
    build_connect_frame,
)


# ----------------------------------------------------------------------
# snapshot cache


class SnapshotCache:
    """In-memory snapshot cache (driver-web-cache interface)."""

    def __init__(self):
        self._entries: dict[str, dict] = {}

    def get(self, document_id: str) -> Optional[dict]:
        return self._entries.get(document_id)

    def put(self, document_id: str, sequence_number: int,
            summary: dict) -> None:
        entry = {
            "sequence_number": sequence_number,
            "summary": summary,
            "cached_at": time.time(),
        }
        self._entries[document_id] = entry
        self._persist(document_id, entry)

    def _persist(self, document_id: str, entry: dict) -> None:
        pass


class FileSnapshotCache(SnapshotCache):
    """On-disk snapshot cache surviving the process (the IndexedDB
    analogue)."""

    def __init__(self, root: str):
        super().__init__()
        self.root = root
        os.makedirs(root, exist_ok=True)
        for name in os.listdir(root):
            if not name.endswith(".json"):
                continue
            try:
                with open(os.path.join(root, name)) as f:
                    entry = json.load(f)
                entry["summary"] = decode_contents(entry["summary"])
                # the real id lives inside the entry; the filename is a
                # hash (a raw id containing '/' or '..' would escape
                # the cache root and never be rescanned)
                doc_id = entry.pop("document_id", name[:-5])
                # a legacy raw-named file may coexist with the hashed
                # rewrite of the same document: scan order is
                # arbitrary, so keep the newer entry
                prev = self._entries.get(doc_id)
                if prev is not None and \
                        prev.get("cached_at", 0) >= entry.get("cached_at", 0):
                    continue
                self._entries[doc_id] = entry
            except (ValueError, KeyError, OSError) as e:
                # corrupt cache entry: treat as miss — but say so; a
                # cache that silently sheds entries looks like a cold
                # cache and hides real on-disk corruption
                print(
                    f"snapshot-cache[{self.root}]: dropping corrupt "
                    f"entry {name!r} ({type(e).__name__}: {e})",
                    file=sys.stderr,
                )
                continue

    @staticmethod
    def _filename(document_id: str) -> str:
        return hashlib.sha256(
            document_id.encode("utf-8")).hexdigest() + ".json"

    def _persist(self, document_id: str, entry: dict) -> None:
        path = os.path.join(self.root, self._filename(document_id))
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(dict(entry, document_id=document_id,
                           summary=encode_contents(entry["summary"])), f)
        os.replace(tmp, path)


class CachingDocumentService:
    """Snapshot-caching wrapper over any DocumentService (odsp-driver
    load flow: cached snapshot first, network refresh by age policy,
    stale fallback when the fetch fails)."""

    def __init__(self, inner, cache: SnapshotCache,
                 max_age_s: float = 60.0):
        self._inner = inner
        self.cache = cache
        self.max_age_s = max_age_s
        self.last_load_source: Optional[str] = None

    @property
    def document_id(self) -> str:
        return self._inner.document_id

    @property
    def lock(self):
        return self._inner.lock

    def get_latest_summary(self) -> Optional[tuple[int, dict]]:
        entry = self.cache.get(self.document_id)
        if entry is not None and \
                time.time() - entry["cached_at"] <= self.max_age_s:
            self.last_load_source = "cache"
            return entry["sequence_number"], entry["summary"]
        try:
            latest = self._inner.get_latest_summary()
        except PermissionError:
            # auth rejection is NOT "offline": serving the stale cache
            # would keep a revoked client reading the document
            # (PermissionError subclasses OSError — it must be
            # excluded before the fallback clause)
            raise
        except (OSError, TimeoutError, ConnectionError, RuntimeError):
            if entry is not None:
                # offline: a stale snapshot + op catch-up is correct,
                # just a longer replay
                self.last_load_source = "stale-cache"
                return entry["sequence_number"], entry["summary"]
            raise
        self.last_load_source = "network"
        if latest is not None:
            self.cache.put(self.document_id, latest[0], latest[1])
        return latest

    def read_ops(self, from_seq: int, to_seq=None):
        return self._inner.read_ops(from_seq, to_seq)

    def upload_summary(self, summary: dict) -> str:
        return self._inner.upload_summary(summary)

    def connect_to_delta_stream(self, client_id, on_message,
                                on_nack=None):
        return self._inner.connect_to_delta_stream(
            client_id, on_message, on_nack)

    def close(self) -> None:
        self._inner.close()


# ----------------------------------------------------------------------
# socket multiplexing


class _DocumentFacade:
    """One document's DocumentService surface over the shared socket
    (odsp socket multiplexing: many documents, one connection)."""

    def __init__(self, client: "MultiplexedSocketClient",
                 document_id: str, tenant_id: Optional[str],
                 token: Optional[str], mode: str):
        self._client = client
        self.document_id = document_id
        self.tenant_id = tenant_id
        self.token = token
        self.mode = mode
        self.auth_error: Optional[str] = None
        self.agreed_version: Optional[str] = None
        self._connected = threading.Event()
        self._on_message: Optional[Callable] = None
        self._on_nack: Optional[Callable] = None

    @property
    def lock(self):
        # one dispatch thread serves every document on the socket: all
        # containers on this connection share its lock
        return self._client.lock

    def connect_to_delta_stream(self, client_id: str, on_message,
                                on_nack=None) -> SocketDeltaConnection:
        self._on_message = on_message
        self._on_nack = on_nack
        # a retried handshake (e.g. after a token refresh) must not
        # see the previous attempt's rejection or completion state
        self.auth_error = None
        self._connected.clear()
        if self._client._closed:
            raise ConnectionError("connection closed")
        self._client._send(build_connect_frame(
            self.document_id, client_id, self.mode,
            self.tenant_id, self.token))
        if not self._connected.wait(self._client._timeout):
            raise TimeoutError("connect_document handshake timed out")
        if self.auth_error is not None:
            raise PermissionError(
                f"connect_document rejected: {self.auth_error}")
        if self._client._closed:
            raise ConnectionError("connection closed during handshake")
        return SocketDeltaConnection(self, client_id)

    # SocketDeltaConnection needs _send + document_id
    def _send(self, data: dict) -> None:
        self._client._send(data)

    def read_ops(self, from_seq: int, to_seq=None):
        return self._client._doc_read_ops(
            self.document_id, from_seq, to_seq,
            auth=(self.tenant_id, self.token))

    def get_latest_summary(self):
        return self._client._doc_latest_summary(
            self.document_id, auth=(self.tenant_id, self.token))

    def upload_summary(self, summary: dict) -> str:
        # same wire >= 1.1 guard as the single-socket driver: on a
        # 1.0-agreed connection degrade to inline summaries instead
        # of sending frames the server will reject
        if self.agreed_version is not None and \
                wire_version_lt(self.agreed_version, "1.1"):
            raise RuntimeError(
                f"summary upload needs wire >= 1.1; connection "
                f"agreed {self.agreed_version}"
            )
        return self._client._doc_upload_summary(
            self.document_id, summary,
            auth=(self.tenant_id, self.token))

    def close(self) -> None:
        # tell the server to drop this document's connection (leave
        # the quorum — a silently departed client would pin the msn);
        # the shared socket stays up for the other documents
        try:
            self._client._send({
                "type": "disconnect_document",
                "document_id": self.document_id,
            })
        except OSError:
            pass
        self._client._facades.pop(self.document_id, None)


class MultiplexedSocketClient(SocketDocumentService):
    """One physical connection, many documents: frames route to
    per-document facades by document_id."""

    def __init__(self, host: str, port: int, timeout: float = 30.0):
        self._facades: dict[str, _DocumentFacade] = {}
        super().__init__(host, port, document_id="<multiplex>",
                         timeout=timeout)

    def document_service(self, document_id: str,
                         tenant_id: Optional[str] = None,
                         token: Optional[str] = None,
                         mode: str = "write") -> _DocumentFacade:
        facade = self._facades.get(document_id)
        if facade is None:
            facade = _DocumentFacade(
                self, document_id, tenant_id, token, mode)
            self._facades[document_id] = facade
        else:
            # refresh credentials: a caller retrying with a new token
            # must not be stuck with the facade's original (possibly
            # rejected) one
            if token is not None:
                facade.token = token
                facade.tenant_id = tenant_id
            facade.mode = mode
        return facade

    # -- routing hooks --------------------------------------------------

    def _on_connected(self, frame: dict) -> None:
        facade = self._facades.get(frame.get("document_id", ""))
        if facade is not None:
            facade.agreed_version = frame.get("version")
            facade._connected.set()

    def _on_connect_error(self, frame: dict) -> None:
        facade = self._facades.get(frame.get("document_id", ""))
        if facade is not None:
            facade.auth_error = frame.get("message", "rejected")
            facade._connected.set()

    def _on_transport_closed(self) -> None:
        super()._on_transport_closed()
        for facade in list(self._facades.values()):
            facade._connected.set()

    def _deliver(self, frame: dict) -> None:
        doc = frame.get("document_id")
        facade = self._facades.get(doc) if doc is not None else None
        if facade is not None and frame.get("type") in ("op", "nack"):
            # borrow the base parsing by impersonating the facade's
            # handlers for this frame
            self._on_message = facade._on_message
            self._on_nack = facade._on_nack
            try:
                super()._deliver(frame)
            finally:
                self._on_message = None
                self._on_nack = None
            return
        super()._deliver(frame)


class CachingMultiplexFactory:
    """IDocumentServiceFactory with odsp-class behavior: one shared
    socket per server endpoint + snapshot caching on every document
    service."""

    def __init__(self, host: str = "127.0.0.1", port: int = 7070,
                 cache: Optional[SnapshotCache] = None,
                 cache_dir: Optional[str] = None,
                 max_age_s: float = 60.0,
                 tenant_id: Optional[str] = None,
                 token_for: Optional[Callable[[str], str]] = None):
        self.host = host
        self.port = port
        self.max_age_s = max_age_s
        self.tenant_id = tenant_id
        self.token_for = token_for   # document_id -> signed token
        if cache is None:
            cache = FileSnapshotCache(cache_dir) \
                if cache_dir is not None else SnapshotCache()
        self.cache = cache
        self._client: Optional[MultiplexedSocketClient] = None

    def _shared_client(self) -> MultiplexedSocketClient:
        if self._client is None or self._client._closed:
            self._client = MultiplexedSocketClient(self.host, self.port)
        return self._client

    def create_document_service(self, document_id: str
                                ) -> CachingDocumentService:
        token = self.token_for(document_id) if self.token_for else None
        facade = self._shared_client().document_service(
            document_id, tenant_id=self.tenant_id, token=token)
        return CachingDocumentService(
            facade, self.cache, max_age_s=self.max_age_s)

    def close(self) -> None:
        if self._client is not None:
            self._client.close()
            self._client = None
