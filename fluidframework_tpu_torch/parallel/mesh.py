"""Device mesh and doc-axis placement for the batched merge state.

The distribution axis is documents (the reference's total order is per
document, and its documents spread over Kafka partitions). A
``DeviceMesh`` is a named-axis grid of ``torch.device``s driven by one
process, as the reference's ``jax.sharding.Mesh`` is under ``jit``: no
``torch.distributed`` inside a process. A device may appear more than
once in a grid; such shards share the device (and its stream), the
port's counterpart of the reference's virtual CPU devices, which is how
a one-GPU machine or the CPU runs a many-shard mesh.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..ops.segment_table import SegmentTable, ShardedTable

DOC_AXIS = "docs"


def _checked(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"mesh names {device} but no CUDA device is present; "
                "build the mesh of torch.device('cpu') to run on the CPU")
        if (device.index or 0) >= torch.cuda.device_count():
            raise RuntimeError(f"mesh names {device}, but only "
                               f"{torch.cuda.device_count()} CUDA devices "
                               "are present")
    elif device.type != "cpu":
        raise ValueError(f"no merge apply for device {device}")
    return device


class DeviceMesh:
    """A named-axis grid of torch devices. ``shape`` maps each axis name
    to its size (as ``jax.sharding.Mesh.shape``); ``devices`` is the
    grid, an object array in axis order."""

    def __init__(self, devices, axis_names: Sequence[str]):
        grid = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if grid.ndim != len(axis_names):
            raise ValueError(f"a {grid.ndim}-D device grid needs "
                             f"{grid.ndim} axis names, got {axis_names}")
        flat = [_checked(d) for d in grid.reshape(-1)]
        if len({d.type for d in flat}) != 1:
            raise ValueError("a mesh holds devices of one type")
        self.devices = np.empty(grid.shape, dtype=object)
        self.devices.reshape(-1)[:] = flat
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, grid.shape))

    @property
    def device_type(self) -> str:
        return self.devices.reshape(-1)[0].type

    def device_list(self) -> list:
        """Every grid entry in axis order (a device may repeat)."""
        return list(self.devices.reshape(-1))

    def __repr__(self) -> str:
        return (f"DeviceMesh({self.shape}, devices="
                f"{[str(d) for d in self.device_list()]})")


def local_devices() -> list:
    """This process's CUDA devices; raises when there is none (a mesh
    never falls back to the CPU unless the caller names it)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError("no CUDA device: pass devices=[torch.device("
                           "'cpu')] * n to build a CPU mesh")
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(devices: Optional[Sequence] = None) -> DeviceMesh:
    """A one-axis ``("docs",)`` mesh (default: every local CUDA device)."""
    devices = list(devices) if devices is not None else local_devices()
    return DeviceMesh(devices, (DOC_AXIS,))


def shard_table(table: SegmentTable, mesh: DeviceMesh,
                doc_axis: str = DOC_AXIS) -> ShardedTable:
    """Place a table's rows on the doc axis: shard ``s`` gets the
    ``s``-th contiguous block of rows on the axis's ``s``-th device."""
    devices = doc_devices(mesh, doc_axis)
    n = len(devices)
    if table.docs % n:
        raise ValueError(
            f"{table.docs} rows not divisible by doc axis {n}")
    R = table.docs // n
    return ShardedTable([
        SegmentTable(*(t[s * R:(s + 1) * R].to(dev) for t in table))
        for s, dev in enumerate(devices)])


def doc_devices(mesh: DeviceMesh, doc_axis: str = DOC_AXIS) -> list:
    """The devices along ``doc_axis`` of a mesh whose other axes have
    size 1."""
    if doc_axis not in mesh.axis_names:
        raise ValueError(f"mesh has no {doc_axis!r} axis "
                         f"(got {mesh.axis_names})")
    if any(mesh.shape[a] != 1 for a in mesh.axis_names if a != doc_axis):
        raise ValueError(f"doc placement needs every axis but "
                         f"{doc_axis!r} of size 1 (got {mesh.shape})")
    return mesh.device_list()


def global_window_floor(table: ShardedTable) -> torch.Tensor:
    """The minimum ``min_seq`` over every document of every doc shard,
    as a 0-d int32 tensor on the first shard's device: the service-wide
    collab-window floor (the op log can truncate at or below it across
    every partition)."""
    first = table.shards[0].device
    return torch.stack([t.min_seq.amin().to(first)
                        for t in table.shards]).amin()
