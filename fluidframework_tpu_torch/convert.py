"""State carried across: numpy <-> torch for segment tables and op
batches.

The numpy side is the reference package's host form: the dict that its
``host_bridge.fetch`` returns (``removers`` as uint32) and the
``[docs, window]`` int32 op arrays of its ``OpBatch`` / ``pack_rows``.
The torch side stores ``removers`` as the int32 view of the same bits.
Only numpy crosses the boundary, so the two packages can be fed
identical state without either importing the other.
"""
from __future__ import annotations

from typing import Mapping, Union

import numpy as np
import torch

from .ops.segment_table import OpBatch, SegmentTable

Device = Union[torch.device, str]


def _to_device(arr, device: Device) -> torch.Tensor:
    arr = np.ascontiguousarray(arr)
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)  # same bits; torch has no uint32 >>
    return torch.tensor(arr.astype(np.int32, copy=False), device=device)


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


def batch_from_numpy(arrays, device: Device) -> OpBatch:
    """Op arrays (a dict keyed by ``OpBatch`` field, or an ``OpBatch``
    of numpy arrays) -> a torch ``OpBatch`` on ``device``."""
    if isinstance(arrays, tuple):
        arrays = arrays._asdict()
    return OpBatch(**{
        f: _to_device(arrays[f], device) for f in OpBatch._fields
    })
