"""Wire vocabulary the merge plane reads: message types and the
sequenced-message record."""
from .messages import (
    ClientDetail,
    DocumentMessage,
    MessageType,
    SequencedMessage,
)

__all__ = [
    "ClientDetail",
    "DocumentMessage",
    "MessageType",
    "SequencedMessage",
]
