"""SharedTree's scalar core (packages/dds/tree): the changeset algebra,
the forest, anchors and the EditManager — the tree plane's oracle and
its host-eviction replica."""
from . import changeset
from .anchors import Anchor, AnchorSet
from .changeset import compose, invert, rebase
from .editmanager import Commit, EditManager
from .forest import Forest, node, root_signature

__all__ = [
    "changeset", "compose", "invert", "rebase",
    "Anchor", "AnchorSet",
    "Commit", "EditManager",
    "Forest", "node", "root_signature",
]
