"""Drivers of the port: client <-> service adapters — the in-process
local driver, the replay driver and its file record, and the retry /
prefetch helpers (copies of the reference's ``drivers`` modules; the
socket, caching, debug drivers and the URL resolver come with the TCP
ingress).

Reference analogue: packages/drivers/*.
"""
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

__all__ = [
    "DeltaStreamConnection",
    "DocumentService",
    "LocalDocumentService",
    "LocalDocumentServiceFactory",
    "PrefetchingDocumentService",
    "ReplayDocumentService",
    "RetriableError",
    "RetryDocumentService",
    "load_document",
    "run_with_retry",
    "save_document",
]
