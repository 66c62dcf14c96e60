"""Seeded traffic for the port: the mock collaboration session, the
op-stream recorders, the generic DDS fuzz engine, the stored-format
compat matrix, the webflow-mix recorder, the tree plane's changeset generators and session
recorder, and bench config3's matrix streams."""
from .compat import (
    CompatConfig,
    compat_matrix,
    downgrade_channel_summary,
    import_as_fresh_document,
)
from .fuzz import (
    FuzzConfig,
    record_flow_stream,
    record_op_stream,
    record_sequential_stream,
    run_convergence_fuzz,
)
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
    "CompatConfig",
    "FuzzConfig",
    "MATRIX_SCALES",
    "MatrixConfig",
    "MockCollabSession",
    "compat_matrix",
    "downgrade_channel_summary",
    "import_as_fresh_document",
    "matrix_messages",
    "random_change_with_moves",
    "random_changeset",
    "random_trunk",
    "record_flow_stream",
    "record_matrix_streams",
    "record_op_stream",
    "record_sequential_stream",
    "record_tree_stream",
    "run_convergence_fuzz",
]
