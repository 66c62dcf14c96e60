"""The wire vocabulary the recorder speaks: sequence-number sentinels and
the client and sequenced message records (a frozen copy of the fields
of ``fluidframework_tpu_torch/protocol/{constants,messages}.py`` that
the merge-tree clients read)."""
from __future__ import annotations

from dataclasses import dataclass
from enum import IntEnum
from typing import Any

# Seq for local, not-yet-acked ops/segments.
UNASSIGNED_SEQ = -1

# Client id used when not collaborating.
NON_COLLAB_CLIENT = -2

# A local pending op compares as the highest possible seq.
MAX_SEQ = 2**53 - 1


class MessageType(IntEnum):
    CLIENT_JOIN = 0
    CLIENT_LEAVE = 1
    OPERATION = 2
    NO_OP = 3


@dataclass
class DocumentMessage:
    """Client -> service raw op."""

    client_sequence_number: int
    reference_sequence_number: int
    type: MessageType
    contents: Any = None


@dataclass
class SequencedMessage:
    """Service -> clients stamped op; system messages have
    ``client_id=None``."""

    client_id: str | None
    sequence_number: int
    minimum_sequence_number: int
    client_sequence_number: int
    reference_sequence_number: int
    type: MessageType
    contents: Any = None
