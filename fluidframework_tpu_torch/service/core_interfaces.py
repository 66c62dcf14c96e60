"""Service-plane interface layer — the services-core analogue.

Reference: server/routerlicious/packages/services-core/src — the
contracts every deployable service component implements (IOrderer,
IOrdererManager, IProducer/IConsumer over the queue, IDocumentStorage,
ICache, ITenantManager), so that local/in-memory, single-box durable,
and clustered deployments swap behind the same types.

These are structural ``typing.Protocol``s: the concrete classes
(LocalOrderer, LocalServer, OrderingQueue impls, ContentStore,
TenantManager) already conform — tests/test_service_interfaces.py
pins the conformance so drift fails loudly.
"""
from __future__ import annotations

from typing import Any, Iterator, Optional, Protocol, runtime_checkable

from ..protocol.messages import (
    ClientDetail,
    DocumentMessage,
    Nack,
    SequencedMessage,
)


@runtime_checkable
class IOrderer(Protocol):
    """One document's ordering pipeline (services-core IOrderer)."""

    def connect(self, detail: ClientDetail) -> SequencedMessage: ...

    def disconnect(self, client_id: str) -> Optional[SequencedMessage]:
        ...

    def submit(self, client_id: str,
               op: DocumentMessage) -> Optional[Nack]: ...


@runtime_checkable
class IOrdererManager(Protocol):
    """Document -> orderer resolution (IOrdererManager /
    OrdererManager, routerlicious-base runnerFactory.ts:43)."""

    def get_orderer(self, document_id: str) -> Any: ...


@runtime_checkable
class IOpLog(Protocol):
    """Durable sequenced-op store (scriptorium's collection)."""

    def append(self, msg: SequencedMessage) -> None: ...

    def read(self, from_seq: int,
             to_seq: Optional[int] = None) -> list: ...

    def truncate_below(self, seq: int) -> int: ...


@runtime_checkable
class IProducer(Protocol):
    """Raw-op transport, producer side (services-core IProducer)."""

    def produce(self, partition: int, document_id: str,
                payload: dict) -> int: ...


@runtime_checkable
class IConsumer(Protocol):
    """Raw-op transport, consumer side (IConsumer + checkpointing)."""

    def read(self, partition: int, from_offset: int) -> Iterator: ...

    def committed(self, partition: int) -> int: ...

    def commit(self, partition: int, offset: int) -> None: ...


@runtime_checkable
class IContentStore(Protocol):
    """Content-addressed object store (gitrest's blob plane)."""

    def put(self, obj: Any) -> str: ...

    def get(self, sha: str) -> Any: ...

    def has(self, sha: str) -> bool: ...


@runtime_checkable
class ITenantManager(Protocol):
    """Tenant registry + token validation (riddler / ITenantManager)."""

    def get_tenant(self, tenant_id: str) -> Any: ...

    def validate_token(self, token: str, tenant_id: str,
                       document_id: str,
                       required_scope: str = ...) -> dict: ...


@runtime_checkable
class ITelemetrySink(Protocol):
    """Structured service telemetry (services-telemetry Lumberjack)."""

    def log(self, event: str, message: str,
            properties: Optional[dict] = None) -> None: ...
