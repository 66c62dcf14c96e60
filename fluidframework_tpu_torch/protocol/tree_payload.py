"""The sharedtree channel-op payload codec.

A SharedTree edit rides the runtime envelope two levels below a
sequenced message (``msg.contents.contents``) as
``{"type": "tree", "changes": <FieldChanges>}``, where "changes" is the
changeset JSON vocabulary of ``models/tree/changeset.py``. This pair is
the one definition: the tree recorder (``testing/tree_fuzz``) emits
through it and ``service/tree_sidecar.py`` decodes through it.
Standard library only; FieldChanges stays an opaque JSON value here.
"""
from __future__ import annotations

from typing import Any, Optional

__all__ = [
    "TREE_OP_TYPE",
    "tree_change_to_json",
    "tree_change_from_json",
]

# the payload discriminator value, as a named constant: "tree-schema"
# ops (stored-schema evolution) share the channel but NOT this codec
TREE_OP_TYPE = "tree"


def tree_change_to_json(changes: Any) -> dict:
    """Wrap one FieldChanges changeset as the wire payload dict."""
    return {"type": TREE_OP_TYPE, "changes": changes}


def tree_change_from_json(payload: Any) -> Optional[Any]:
    """The changeset carried by a channel-op payload, or None when the
    payload is not a tree edit (tree-schema ops, foreign channels,
    compressed blobs) — callers route on None instead of re-checking
    the discriminator. A tree-typed payload with no changeset is
    malformed, not foreign: that raises."""
    if not isinstance(payload, dict) or \
            payload.get("type") != TREE_OP_TYPE:
        return None
    changes = payload.get("changes")
    if changes is None:
        raise ValueError(
            "tree payload carries no 'changes' changeset"
        )
    return changes
