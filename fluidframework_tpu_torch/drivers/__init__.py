"""Drivers of the port: client <-> service adapters — the in-process
local driver, the TCP socket driver, the caching and multiplexing
driver, the replay driver and its file record, and the retry /
prefetch helpers, the debug driver and the URL resolver (copies of the
reference's ``drivers`` modules).

Reference analogue: packages/drivers/*.
"""
from .caching_driver import (
    CachingDocumentService,
    CachingMultiplexFactory,
    FileSnapshotCache,
    MultiplexedSocketClient,
    SnapshotCache,
)
from .debug_driver import DebugDocumentService
from .definitions import DeltaStreamConnection, DocumentService
from .driver_utils import (
    PrefetchingDocumentService,
    RetriableError,
    RetryDocumentService,
    run_with_retry,
)
from .file_driver import load_document, save_document
from .local_driver import LocalDocumentService, LocalDocumentServiceFactory
from .replay_driver import ReplayDocumentService
from .socket_driver import (
    SocketDocumentService,
    SocketDocumentServiceFactory,
)
from .url_resolver import (
    LocalUrlResolver,
    ResolvedUrl,
    SocketUrlResolver,
    UrlResolver,
    load_container_from_url,
    resolve_request,
)

__all__ = [
    "CachingDocumentService",
    "CachingMultiplexFactory",
    "DebugDocumentService",
    "DeltaStreamConnection",
    "DocumentService",
    "FileSnapshotCache",
    "LocalDocumentService",
    "LocalDocumentServiceFactory",
    "LocalUrlResolver",
    "MultiplexedSocketClient",
    "PrefetchingDocumentService",
    "ReplayDocumentService",
    "ResolvedUrl",
    "RetriableError",
    "RetryDocumentService",
    "SnapshotCache",
    "SocketDocumentService",
    "SocketDocumentServiceFactory",
    "SocketUrlResolver",
    "UrlResolver",
    "load_container_from_url",
    "load_document",
    "resolve_request",
    "run_with_retry",
    "save_document",
]
