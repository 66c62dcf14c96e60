"""SharedTree (packages/dds/tree): the op-based tree DDS with rebasing,
its stored schema and editable surface, and its scalar core — the
changeset algebra, the forest, anchors and the EditManager, which are
also the tree plane's oracle and its host-eviction replica."""
from . import changeset
from .anchors import Anchor, AnchorSet
from .changeset import compose, invert, rebase
from .editable import EditableField, EditableNode, EditableRoot
from .editmanager import Commit, EditManager
from .forest import Forest, node, root_signature
from .schema import (
    FieldSchema,
    NodeSchema,
    SchemaViolation,
    StoredSchema,
)
from .sharedtree import SharedTree, wrap_path

__all__ = [
    "changeset", "compose", "invert", "rebase",
    "Anchor", "AnchorSet",
    "Commit", "EditManager",
    "EditableField", "EditableNode", "EditableRoot",
    "FieldSchema", "Forest", "NodeSchema", "SchemaViolation",
    "StoredSchema",
    "node", "root_signature", "SharedTree", "wrap_path",
]
