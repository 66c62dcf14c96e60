"""Seeded traffic for the port: the mock collaboration session, the
op-stream recorders, and the tree plane's changeset generators and
session recorder."""
from .fuzz import FuzzConfig, record_op_stream, record_sequential_stream
from .mocks import MockCollabSession
from .tree_fuzz import (
    random_change_with_moves,
    random_changeset,
    random_trunk,
    record_tree_stream,
)

__all__ = [
    "FuzzConfig",
    "MockCollabSession",
    "random_change_with_moves",
    "random_changeset",
    "random_trunk",
    "record_op_stream",
    "record_sequential_stream",
    "record_tree_stream",
]
