"""Wire protocol: the op/message vocabulary every layer speaks.

TPU-native re-design of the reference wire types:
- ``IDocumentMessage``  (common/lib/protocol-definitions/src/protocol.ts:133)
- ``ISequencedDocumentMessage`` (protocol.ts:212)
- ``MessageType`` (protocol.ts:6)
- ``ITrace`` (protocol.ts — per-op tracing)
- ``INack`` / nack reasons

These are plain dataclasses on the host. The sequenced form also defines
the *tensor schema* used by the batched kernels: `OpBatch` in
``ops.segment_table`` packs the numeric fields of many
`SequencedMessage`s into `[docs, window]` int32 tensors.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from enum import IntEnum
from typing import Any


class MessageType(IntEnum):
    """System + operation message kinds (protocol.ts:6-72)."""

    CLIENT_JOIN = 0
    CLIENT_LEAVE = 1
    OPERATION = 2
    NO_OP = 3
    PROPOSE = 4
    REJECT = 5
    ACCEPT = 6
    SUMMARIZE = 7
    SUMMARY_ACK = 8
    SUMMARY_NACK = 9
    NO_CLIENT = 10
    CONTROL = 11


class NackErrorType(IntEnum):
    """Why the service refused an op (protocol-definitions INackContent)."""

    THROTTLING = 0
    INVALID_SCOPE = 1
    BAD_REQUEST = 2
    LIMIT_EXCEEDED = 3


@dataclass
class Trace:
    """One hop of per-op tracing (protocol.ts ITrace; deli stamps these,
    deli/lambda.ts:1130)."""

    service: str
    action: str
    timestamp: float = field(default_factory=time.time)


@dataclass
class DocumentMessage:
    """Client -> service raw op (IDocumentMessage, protocol.ts:133)."""

    client_sequence_number: int
    reference_sequence_number: int
    type: MessageType
    contents: Any = None
    metadata: Any = None
    traces: list[Trace] = field(default_factory=list)


@dataclass
class SequencedMessage:
    """Service -> clients stamped op (ISequencedDocumentMessage,
    protocol.ts:212). ``client_id`` is the service-interned string id of
    the sender; system messages use ``client_id=None``."""

    client_id: str | None
    sequence_number: int
    minimum_sequence_number: int
    client_sequence_number: int
    reference_sequence_number: int
    type: MessageType
    contents: Any = None
    metadata: Any = None
    timestamp: float = 0.0
    traces: list[Trace] = field(default_factory=list)


@dataclass
class Nack:
    """Service rejection of a raw op (INack).

    ``retry_after_seconds`` mirrors the reference's throttling
    retryAfter. ``pressure_tier`` and ``shed_class`` are the qos
    subsystem's load-shed attribution (qos/policy.py) — OPTIONAL on
    the wire: serialization emits them only when set, and 1.0/1.1
    peers that omit or ignore them interoperate
    (tests/test_wire_compat.py)."""

    operation: DocumentMessage | None
    sequence_number: int
    error_type: NackErrorType
    message: str = ""
    retry_after_seconds: float | None = None
    pressure_tier: int | None = None
    shed_class: str | None = None


@dataclass
class ClientDetail:
    """Join payload (protocol-definitions IClient): capabilities + mode."""

    client_id: str
    mode: str = "write"  # "read" | "write"
    user: str = ""
    scopes: tuple[str, ...] = ("doc:read", "doc:write")
    timestamp: float = field(default_factory=time.time)


def is_system_message(msg_type: MessageType) -> bool:
    """System messages carry no runtime contents and are handled by the
    protocol layer (protocol-base/src/protocol.ts:114)."""
    return msg_type in (
        MessageType.CLIENT_JOIN,
        MessageType.CLIENT_LEAVE,
        MessageType.PROPOSE,
        MessageType.REJECT,
        MessageType.ACCEPT,
        MessageType.NO_CLIENT,
    )
