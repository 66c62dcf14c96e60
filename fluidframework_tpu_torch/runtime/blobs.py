"""Attachment blobs: content-addressed binary payloads with handles.

Reference: packages/runtime/container-runtime/src/blobManager.ts
(``BlobManager`` :118) — upload, dedup by content, handle-based
referencing, GC of unreferenced blobs.

Divergence: the reference uploads blob content to storage out-of-band
and sends only the storage id in the BlobAttach op; here the content
rides the op itself (base64) — the op-lifecycle compressor/splitter
handles size, and every harness (runtime mocks, local server, replay)
gets blobs for free. The handle namespace (``/_blobs/<sha>``), dedup,
and GC semantics match the reference.
"""
from __future__ import annotations

import base64
import hashlib
from typing import TYPE_CHECKING, Optional

from .handles import FluidHandle

if TYPE_CHECKING:  # pragma: no cover
    from .container_runtime import ContainerRuntime

BLOB_ROUTE_PREFIX = "/_blobs/"


class BlobManager:
    def __init__(self, runtime: "ContainerRuntime"):
        self.runtime = runtime
        self._blobs: dict[str, bytes] = {}

    # ---- public API

    def create_blob(self, data: bytes) -> FluidHandle:
        """Store + announce a blob; returns its handle. Content
        dedup: the same bytes always yield the same handle."""
        blob_id = hashlib.sha256(data).hexdigest()[:32]
        route = BLOB_ROUTE_PREFIX + blob_id
        if blob_id not in self._blobs:
            self._blobs[blob_id] = data
            self.runtime.submit_blob_attach(
                blob_id, base64.b64encode(data).decode("ascii")
            )
        # re-creating revives a tombstoned blob immediately (the next
        # GC run observes the new reference and agrees)
        self.runtime.tombstones.discard(route)
        if self.runtime.gc is not None:
            self.runtime.gc.tombstones.discard(route)
        return FluidHandle(route)

    def get_blob(self, handle_or_id) -> bytes:
        blob_id = self._to_id(handle_or_id)
        route = BLOB_ROUTE_PREFIX + blob_id
        if route in self.runtime.tombstones:
            raise KeyError(f"blob {blob_id} is tombstoned (GC)")
        return self._blobs[blob_id]

    def has_blob(self, handle_or_id) -> bool:
        return self._to_id(handle_or_id) in self._blobs

    def ids(self) -> tuple[str, ...]:
        return tuple(self._blobs)

    @staticmethod
    def _to_id(handle_or_id) -> str:
        if isinstance(handle_or_id, FluidHandle):
            assert handle_or_id.route.startswith(BLOB_ROUTE_PREFIX)
            return handle_or_id.route[len(BLOB_ROUTE_PREFIX):]
        return handle_or_id

    # ---- runtime integration

    def process_attach(self, blob_id: str, data_b64: str) -> None:
        self._blobs.setdefault(blob_id, base64.b64decode(data_b64))

    def delete_blob(self, blob_id: str) -> bool:
        return self._blobs.pop(blob_id, None) is not None

    def summarize(self) -> dict:
        return {
            blob_id: base64.b64encode(data).decode("ascii")
            for blob_id, data in self._blobs.items()
        }

    def load(self, summary: dict) -> None:
        for blob_id, data_b64 in summary.items():
            self._blobs[blob_id] = base64.b64decode(data_b64)
