"""State carried across: numpy <-> torch for segment tables (whole or
doc-sharded), op batches, and the tree plane's forest tables and window
programs.

The numpy side is the reference package's host form: the dict that its
``host_bridge.fetch`` returns (``removers`` as uint32) and the
``[docs, window]`` int32 op arrays of its ``OpBatch`` / ``pack_rows``.
The torch side stores ``removers`` as the int32 view of the same bits.
For the tree plane the numpy side is the reference's ``TreeTable`` /
``TreeProgram`` of int32 arrays (its ``make_tree_table`` and
``pack_tree_window`` give them; a JAX table converts with
``np.asarray`` per field).
Only numpy crosses the boundary, so the two packages can be fed
identical state without either importing the other.

On a CUDA device an op program's upload (``program_to_device``) never
syncs a stream: its fields are staged in pinned host memory and copied
on the device's copy stream, which the caller's current stream waits
for on the device.
"""
from __future__ import annotations

import functools
import threading
from typing import TYPE_CHECKING, Mapping, Union

import numpy as np
import torch

from .ops.segment_table import OpBatch, SegmentTable, ShardedTable
from .ops.tree_atoms import TreeAtoms

if TYPE_CHECKING:
    from .ops.tree_apply import TreeProgram, TreeTable

Device = Union[torch.device, str]


def _host_int32(arr) -> np.ndarray:
    """The int32 host array that crosses to the device: contiguous,
    ``uint32`` as the int32 view of its bits, any other dtype cast as
    ``astype(np.int32)`` casts it."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)  # same bits; torch has no uint32 >>
    return arr.astype(np.int32, copy=False)


def _to_device(arr, device: Device) -> torch.Tensor:
    return torch.tensor(_host_int32(arr), device=device)


# device index -> its copy stream and the event the stream records after
# each upload's copies
_COPY: dict[int, tuple] = {}
_COPY_LOCK = threading.Lock()


@functools.cache
def _staged_total():
    from .obs.metrics import REGISTRY

    return REGISTRY.counter(
        "upload_staged_total",
        "op program uploads staged through pinned host memory")


def _copy_stream(device: torch.device) -> tuple:
    index = device.index
    if index is None:
        index = torch.cuda.current_device()
    copy = _COPY.get(index)
    if copy is None:
        with _COPY_LOCK:
            copy = _COPY.get(index)
            if copy is None:
                device = torch.device("cuda", index)
                copy = _COPY[index] = (torch.cuda.Stream(device),
                                       torch.cuda.Event())
    return copy


def _staged(arrays: dict, device: torch.device) -> dict[str, torch.Tensor]:
    """``arrays`` (numpy) -> int32 tensors on the CUDA ``device``, one
    fresh tensor per field, ready for the current stream's later work.
    Each field is written into pinned memory from torch's host
    allocator, which hands a block out again only once its copy is
    done, and copied on the device's copy stream; the current stream
    waits for the copies on the device, the host not at all."""
    stream, done = _copy_stream(device)
    current = torch.cuda.current_stream(device)
    out = {}
    with torch.cuda.stream(stream):
        for f, a in arrays.items():
            a = _host_int32(a)
            pinned = torch.empty(a.shape, dtype=torch.int32,
                                 pin_memory=True)
            host = pinned.numpy()  # synccheck: disable=numpy a host tensor
            np.copyto(host, a)
            out[f] = pinned.to(device, non_blocking=True)
        done.record(stream)
    current.wait_event(done)
    for t in out.values():
        t.record_stream(current)
    _staged_total().inc()
    return out


def table_from_numpy(arrays: Mapping[str, np.ndarray],
                     device: Device) -> SegmentTable:
    """A fetched table dict (every ``SegmentTable`` field) -> a torch
    ``SegmentTable`` on ``device``."""
    return SegmentTable(**{
        f: _to_device(arrays[f], device) for f in SegmentTable._fields
    })


def table_to_numpy(table: SegmentTable) -> dict[str, np.ndarray]:
    """Inverse of ``table_from_numpy``: host numpy, ``removers`` back to
    uint32."""
    out = {f: getattr(table, f).cpu().numpy() for f in table._fields}
    out["removers"] = out["removers"].view(np.uint32)
    return out


def sharded_table_from_numpy(arrays: Mapping[str, np.ndarray],
                             devices) -> ShardedTable:
    """The reference's numpy form of a whole table -> a doc-sharded
    table: shard ``s`` takes the ``s``-th contiguous block of rows, on
    ``devices[s]`` (a device may repeat)."""
    n = len(devices)
    docs = len(arrays["count"])
    if docs % n:
        raise ValueError(f"{docs} rows not divisible by {n} shards")
    R = docs // n
    return ShardedTable([
        table_from_numpy({f: a[s * R:(s + 1) * R] for f, a in arrays.items()},
                         dev)
        for s, dev in enumerate(devices)])


def sharded_table_to_numpy(table: ShardedTable) -> dict[str, np.ndarray]:
    """Inverse of ``sharded_table_from_numpy``: the shards' host copies,
    shard by shard, joined along rows (global row = shard * R + row)."""
    parts = [table_to_numpy(t) for t in table.shards]
    return {f: np.concatenate([p[f] for p in parts])
            for f in SegmentTable._fields}


def program_to_device(arrays: Mapping[str, np.ndarray],
                      device: Device) -> dict[str, torch.Tensor]:
    """A compiled op program's ``[docs, window]`` arrays (an ``OpBatch``
    window, a chunk program, an egwalker prefix) -> int32 tensors on
    ``device``, one host-to-device copy per field. Tensors already
    given are moved to ``device`` as they are. Span ``upload``.

    On a CUDA device the numpy fields are written into pinned host
    memory and copied on the device's copy stream; the caller's current
    stream waits for the copies on the device, and the host returns
    without waiting for them. The caller may reuse its arrays at once.
    Elsewhere each field is one blocking copy."""
    from .obs.profiler import span

    with span("upload", device):
        host = {f: a for f, a in arrays.items()
                if not isinstance(a, torch.Tensor)}
        if host and torch.device(device).type == "cuda":
            staged = _staged(host, torch.device(device))
        else:
            staged = {f: _to_device(a, device) for f, a in host.items()}
        return {f: staged[f] if f in staged else a.to(device)
                for f, a in arrays.items()}


def batch_from_numpy(arrays, device: Device) -> OpBatch:
    """Op arrays (a dict keyed by ``OpBatch`` field, or an ``OpBatch``
    of numpy arrays) -> a torch ``OpBatch`` on ``device``."""
    if isinstance(arrays, tuple):
        arrays = arrays._asdict()
    return OpBatch(**program_to_device(
        {f: arrays[f] for f in OpBatch._fields}, device))


def tree_map(tree, fn):
    """``fn`` over every leaf array of a TreeTable / TreeProgram (their
    ``ring`` / ``atoms`` field is a nested TreeAtoms)."""
    return type(tree)(*(
        TreeAtoms(*(fn(a) for a in f)) if isinstance(f, tuple)
        else fn(f) for f in tree))


def tree_table_from_numpy(table, device: Device) -> TreeTable:
    """A TreeTable of host arrays (the reference's, or any array-likes)
    -> a torch TreeTable on ``device``."""
    # imported here: ops.tree_apply reaches this module through
    # ops.event_graph
    from .ops.tree_apply import TreeTable

    return tree_map(TreeTable(*table),
                    lambda a: _to_device(np.asarray(a), device))


def tree_table_to_numpy(table: TreeTable) -> TreeTable:
    """Inverse of ``tree_table_from_numpy``: a TreeTable of int32 numpy
    arrays."""
    return tree_map(table, lambda t: t.cpu().numpy())


def tree_program_to_device(program, device: Device) -> TreeProgram:
    """A packed TreeProgram of numpy arrays -> int32 tensors on
    ``device``, one host-to-device copy per field."""
    from .ops.tree_apply import TreeProgram

    return tree_map(TreeProgram(*program),
                    lambda a: _to_device(np.asarray(a), device))
