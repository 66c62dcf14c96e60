"""Wire vocabulary the port reads and writes: message types, the
sequenced-message record, nacks and trace hops, the quorum and its
protocol op handler, the wire serialization, and the sharedtree
channel-op payload codec."""
from .messages import (
    ClientDetail,
    DocumentMessage,
    MessageType,
    Nack,
    NackErrorType,
    SequencedMessage,
    Trace,
    is_system_message,
)
from .quorum import ProtocolOpHandler, QuorumClients, QuorumProposals
from .tree_payload import tree_change_from_json, tree_change_to_json

__all__ = [
    "ClientDetail",
    "DocumentMessage",
    "MessageType",
    "Nack",
    "NackErrorType",
    "ProtocolOpHandler",
    "QuorumClients",
    "QuorumProposals",
    "SequencedMessage",
    "Trace",
    "is_system_message",
    "tree_change_from_json",
    "tree_change_to_json",
]
