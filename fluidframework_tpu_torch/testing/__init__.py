"""Seeded traffic for the port: the mock collaboration session, the
op-stream recorders, the tree plane's changeset generators and
session recorder, and bench config3's matrix streams."""
from .fuzz import FuzzConfig, record_op_stream, record_sequential_stream
from .matrix_streams import (
    MATRIX_SCALES,
    MatrixConfig,
    matrix_messages,
    record_matrix_streams,
)
from .mocks import MockCollabSession
from .tree_fuzz import (
    random_change_with_moves,
    random_changeset,
    random_trunk,
    record_tree_stream,
)

__all__ = [
    "FuzzConfig",
    "MATRIX_SCALES",
    "MatrixConfig",
    "MockCollabSession",
    "matrix_messages",
    "random_change_with_moves",
    "random_changeset",
    "random_trunk",
    "record_matrix_streams",
    "record_op_stream",
    "record_sequential_stream",
    "record_tree_stream",
]
