"""Wire vocabulary the port reads: message types, the sequenced-message
record, and the sharedtree channel-op payload codec."""
from .messages import (
    ClientDetail,
    DocumentMessage,
    MessageType,
    SequencedMessage,
)
from .tree_payload import tree_change_from_json, tree_change_to_json

__all__ = [
    "ClientDetail",
    "DocumentMessage",
    "MessageType",
    "SequencedMessage",
    "tree_change_from_json",
    "tree_change_to_json",
]
