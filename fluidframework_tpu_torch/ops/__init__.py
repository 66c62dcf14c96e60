"""The tensor layer: the merge plane's segment table, host bridge, plain
step, window apply and its Hopper kernel, and two macro-step executor
routes; the tree plane's atom codec, batched rebase and forest apply.

The entry points below are exported lazily: this package file imports
no submodule until one of its names is asked for, so ``convert`` and
``host_bridge`` can depend on each other's modules without an import
cycle.

- ``merge_kernel``: ``apply_window`` (the scan route; on a CUDA table
  the Hopper kernel of ``cuda_merge``), ``pad_capacity``, ``compact``;
- ``merge_chunk``: ``compile_chunks`` / ``build_chunked`` (host),
  ``apply_window_chunked`` (device), ``macro_steps``, ``CHUNK_K``;
- ``event_graph``: ``build_event_graph`` (host),
  ``apply_window_egwalker`` and ``apply_batch_egwalker`` (device),
  ``EXECUTOR_ROUTES``, ``EG_K``, ``validate_executor``;
- ``tree_kernel``: ``rebase_atoms``, ``rebase_over_trunk`` (the tree
  plane's batched rebase);
- ``tree_apply``: ``encode_tree_commit``, ``pack_tree_window``,
  ``window_extent`` (host), ``apply_tree_window``,
  ``pad_tree_capacity``, ``make_tree_table`` (device),
  ``TREE_EXECUTOR_ROUTES``, ``TRUNK_RING``.
"""
from importlib import import_module

_EXPORTS = {
    "apply_window": "merge_kernel",
    "compact": "merge_kernel",
    "pad_capacity": "merge_kernel",
    "CHUNK_K": "merge_chunk",
    "apply_window_chunked": "merge_chunk",
    "build_chunked": "merge_chunk",
    "compile_chunks": "merge_chunk",
    "macro_steps": "merge_chunk",
    "EG_K": "event_graph",
    "EXECUTOR_ROUTES": "event_graph",
    "apply_batch_egwalker": "event_graph",
    "apply_window_egwalker": "event_graph",
    "build_event_graph": "event_graph",
    "validate_executor": "event_graph",
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
