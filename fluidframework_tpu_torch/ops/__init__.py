"""The tensor layer: the merge plane's segment table, host bridge, plain
step, window apply and its Hopper kernel, and two macro-step executor
routes; the scalar host replay; the matrix plane's axes and cells; the
tree plane's atom codec, batched rebase and forest apply.

The entry points below are exported lazily: this package file imports
no submodule until one of its names is asked for, so ``convert`` and
``host_bridge`` can depend on each other's modules without an import
cycle.

- ``segment_table``: ``SegmentTable``, ``OpBatch``, ``make_table``
  and the op-kind and channel constants;
- ``host_bridge``: ``DocStream``, ``encode_stream``, ``build_batch``,
  ``fetch``, ``extract_text``, ``extract_signature``;
- ``merge_kernel``: ``apply_window`` (the scan route; on a CUDA table
  the Hopper kernel of ``cuda_merge``), its double-buffered twin
  ``apply_window_pingpong``, ``pad_capacity``, ``compact``;
- ``merge_chunk``: ``compile_chunks`` / ``build_chunked`` (host),
  ``apply_window_chunked`` and its twin
  ``apply_window_chunked_pingpong`` (device), ``macro_steps``,
  ``CHUNK_K``;
- ``event_graph``: ``build_event_graph`` (host),
  ``apply_window_egwalker``, its twin
  ``apply_window_egwalker_pingpong`` and ``apply_batch_egwalker``
  (device), ``EventGraph``, ``EXECUTOR_ROUTES``, ``EG_K``,
  ``validate_executor``;
- ``host_replay``: ``HostDocReplay``, ``replay_encoded`` (the scalar
  host twin of the scan);
- ``matrix_cells``: ``apply_cells_kernel``, ``CellPack`` (the cells'
  LWW sort and scatter);
- ``matrix_bridge``: ``MatrixStream``, ``pack_matrix_batch`` (host),
  ``dispatch_matrix_batch``, ``apply_matrix_batch`` (device),
  ``extract_matrix`` (host);
- ``tree_kernel``: ``rebase_atoms``, ``rebase_over_trunk`` (the tree
  plane's batched rebase);
- ``tree_apply``: ``encode_tree_commit``, ``pack_tree_window``,
  ``window_extent`` (host), ``apply_tree_window``,
  ``pad_tree_capacity``, ``make_tree_table`` (device),
  ``TREE_EXECUTOR_ROUTES``, ``TRUNK_RING``.
"""
from importlib import import_module

_EXPORTS = {
    "KIND_ANNOTATE": "segment_table",
    "KIND_INSERT": "segment_table",
    "KIND_NOOP": "segment_table",
    "KIND_REMOVE": "segment_table",
    "MAX_CLIENTS": "segment_table",
    "NOT_REMOVED": "segment_table",
    "OpBatch": "segment_table",
    "PROP_CHANNELS": "segment_table",
    "SegmentTable": "segment_table",
    "make_table": "segment_table",
    "DocStream": "host_bridge",
    "build_batch": "host_bridge",
    "encode_stream": "host_bridge",
    "extract_signature": "host_bridge",
    "extract_text": "host_bridge",
    "fetch": "host_bridge",
    "apply_window": "merge_kernel",
    "apply_window_pingpong": "merge_kernel",
    "compact": "merge_kernel",
    "pad_capacity": "merge_kernel",
    "CHUNK_K": "merge_chunk",
    "apply_window_chunked": "merge_chunk",
    "apply_window_chunked_pingpong": "merge_chunk",
    "build_chunked": "merge_chunk",
    "compile_chunks": "merge_chunk",
    "macro_steps": "merge_chunk",
    "EG_K": "event_graph",
    "EXECUTOR_ROUTES": "event_graph",
    "EventGraph": "event_graph",
    "apply_batch_egwalker": "event_graph",
    "apply_window_egwalker": "event_graph",
    "apply_window_egwalker_pingpong": "event_graph",
    "build_event_graph": "event_graph",
    "validate_executor": "event_graph",
    "HostDocReplay": "host_replay",
    "replay_encoded": "host_replay",
    "CellPack": "matrix_cells",
    "apply_cells_kernel": "matrix_cells",
    "MatrixStream": "matrix_bridge",
    "apply_matrix_batch": "matrix_bridge",
    "dispatch_matrix_batch": "matrix_bridge",
    "extract_matrix": "matrix_bridge",
    "pack_matrix_batch": "matrix_bridge",
    "rebase_atoms": "tree_kernel",
    "rebase_over_trunk": "tree_kernel",
    "TREE_EXECUTOR_ROUTES": "tree_apply",
    "TRUNK_RING": "tree_apply",
    "apply_tree_window": "tree_apply",
    "encode_tree_commit": "tree_apply",
    "make_tree_table": "tree_apply",
    "pack_tree_window": "tree_apply",
    "pad_tree_capacity": "tree_apply",
    "window_extent": "tree_apply",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(import_module(f".{_EXPORTS[name]}", __name__), name)
