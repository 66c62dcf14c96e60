"""Drivers of the port: client <-> service adapters — the in-process
local driver, the TCP socket driver, the caching and multiplexing
driver, the replay driver and its file record, and the retry /
prefetch helpers (copies of the reference's ``drivers`` modules; the
debug driver and the URL resolver are not ported yet).

Reference analogue: packages/drivers/*.
"""
from .caching_driver import (
    CachingDocumentService,
    CachingMultiplexFactory,
    FileSnapshotCache,
    MultiplexedSocketClient,
    SnapshotCache,
)
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

__all__ = [
    "CachingDocumentService",
    "CachingMultiplexFactory",
    "DeltaStreamConnection",
    "DocumentService",
    "FileSnapshotCache",
    "LocalDocumentService",
    "LocalDocumentServiceFactory",
    "MultiplexedSocketClient",
    "PrefetchingDocumentService",
    "ReplayDocumentService",
    "RetriableError",
    "RetryDocumentService",
    "SnapshotCache",
    "SocketDocumentService",
    "SocketDocumentServiceFactory",
    "load_document",
    "run_with_retry",
    "save_document",
]
