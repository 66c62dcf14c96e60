"""Quorum: the membership + consensus-proposal state machine shared by
client and service.

Reference: server/routerlicious/packages/protocol-base/src/quorum.ts
(``QuorumClients`` :63, ``QuorumProposals`` :140, ``Quorum`` :396) and
``ProtocolOpHandler`` (protocol-base/src/protocol.ts:68,114).

Semantics:
- clients join/leave via sequenced system messages; the quorum is the
  set of clients every replica agrees is connected.
- a proposal (key, value) submitted at seq S is *accepted* once the
  minimum sequence number advances to >= S — i.e. every connected
  client has seen it. Accepted values land in the shared ``values`` map.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable

from .messages import ClientDetail, MessageType, SequencedMessage
from ..utils.events import EventEmitter


class ProtocolError(Exception):
    """A sequenced-stream invariant was violated (gap, reorder)."""


@dataclass
class QuorumProposal:
    sequence_number: int
    key: str
    value: Any


class QuorumClients(EventEmitter):
    """Tracks the connected client set (quorum.ts:63)."""

    def __init__(self, members: dict[str, ClientDetail] | None = None):
        super().__init__()
        self._members: dict[str, ClientDetail] = dict(members or {})

    @property
    def members(self) -> dict[str, ClientDetail]:
        return dict(self._members)

    def get_member(self, client_id: str) -> ClientDetail | None:
        return self._members.get(client_id)

    def add_member(self, client_id: str, detail: ClientDetail) -> None:
        self._members[client_id] = detail
        self.emit("addMember", client_id, detail)

    def remove_member(self, client_id: str) -> None:
        if client_id in self._members:
            detail = self._members.pop(client_id)
            self.emit("removeMember", client_id, detail)


class QuorumProposals(EventEmitter):
    """Tracks pending proposals and commits them on msn advance
    (quorum.ts:140)."""

    def __init__(
        self,
        values: dict[str, Any] | None = None,
        send_proposal: Callable[[str, Any], int] | None = None,
    ):
        super().__init__()
        self._values: dict[str, Any] = dict(values or {})
        self._pending: dict[int, QuorumProposal] = {}
        self._send_proposal = send_proposal

    @property
    def values(self) -> dict[str, Any]:
        return dict(self._values)

    def get(self, key: str) -> Any:
        return self._values.get(key)

    def has(self, key: str) -> bool:
        return key in self._values

    def propose(self, key: str, value: Any) -> None:
        """Submit a proposal op; acceptance happens when msn passes its
        sequence number."""
        if self._send_proposal is None:
            raise RuntimeError("quorum is read-only (no proposal submitter)")
        self._send_proposal(key, value)

    def add_proposal(self, key: str, value: Any, sequence_number: int) -> None:
        self._pending[sequence_number] = QuorumProposal(sequence_number, key, value)
        self.emit("addProposal", key, value, sequence_number)

    def update_minimum_sequence_number(self, msn: int) -> None:
        """Commit every pending proposal whose seq is now <= msn."""
        for seq in sorted(self._pending):
            if seq > msn:
                break
            proposal = self._pending.pop(seq)
            self._values[proposal.key] = proposal.value
            self.emit("approveProposal", proposal.key, proposal.value, seq)


class ProtocolOpHandler:
    """Shared client/server protocol logic: consumes the sequenced system
    messages and maintains quorum + proposal state
    (protocol-base/src/protocol.ts:68)."""

    def __init__(
        self,
        minimum_sequence_number: int = 0,
        sequence_number: int = 0,
        members: dict[str, ClientDetail] | None = None,
        values: dict[str, Any] | None = None,
        send_proposal: Callable[[str, Any], int] | None = None,
    ):
        self.minimum_sequence_number = minimum_sequence_number
        self.sequence_number = sequence_number
        self.quorum = QuorumClients(members)
        self.proposals = QuorumProposals(values, send_proposal)

    def process_message(self, message: SequencedMessage) -> None:
        """protocol-base/src/protocol.ts:114."""
        if message.sequence_number != self.sequence_number + 1:
            raise ProtocolError(
                f"non-contiguous seq: got {message.sequence_number}, "
                f"expected {self.sequence_number + 1}"
            )
        self.sequence_number = message.sequence_number
        self.minimum_sequence_number = message.minimum_sequence_number

        if message.type == MessageType.CLIENT_JOIN:
            detail: ClientDetail = message.contents
            self.quorum.add_member(detail.client_id, detail)
        elif message.type == MessageType.CLIENT_LEAVE:
            self.quorum.remove_member(message.contents)
        elif message.type == MessageType.PROPOSE:
            key, value = message.contents
            self.proposals.add_proposal(key, value, message.sequence_number)

        self.proposals.update_minimum_sequence_number(
            message.minimum_sequence_number
        )

    def snapshot(self) -> dict[str, Any]:
        """Attributes blob written into summaries (§3.4). JSON-safe and
        decoupled from live state."""
        return {
            "minimumSequenceNumber": self.minimum_sequence_number,
            "sequenceNumber": self.sequence_number,
            "members": {
                cid: dataclasses.asdict(detail)
                for cid, detail in self.quorum.members.items()
            },
            "values": self.proposals.values,
        }
