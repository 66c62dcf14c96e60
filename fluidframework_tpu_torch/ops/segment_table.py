"""Struct-of-arrays segment table — the device-side merge-tree state.

One document is a fixed-capacity slab of segment slots in document
order; a batch is ``[docs, capacity]`` int32 tensors over the doc axis
(the reference's Kafka-partition axis, SURVEY §2.9).

Slots ``[0, count)`` are live; suffix slots are garbage. Text payloads
never enter device memory: each slot carries ``(op_id, op_off,
length)`` provenance and the host slices insert-op payloads to
materialize text.

Property state is ``prop[docs, capacity, PROP_CHANNELS]``: a fixed set
of int32 property channels (key-interned), LWW in sequenced order. 0
means unset/deleted.

``removers`` is a 32-client bitmask. It is stored as the int32 bit
pattern of the reference's uint32 (torch has no uint32 ``>>`` on the
CPU); ``convert.py`` moves tables between the two forms.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

# "never removed" sentinel: all real seqs compare below it.
NOT_REMOVED = np.int32(2**31 - 1)

# Per-op payload bound: the merge step packs op_off into a
# j*OPOFF_BOUND+op_off int32 composite so "op_off at the first masked
# slot" rides the same min-reduce as the index searches
# (merge_step.fused_step). Host encoding rejects larger payloads, and
# every executor asserts capacity * OPOFF_BOUND fits int32.
OPOFF_BOUND = 1 << 17

# Fixed number of interned property channels per document.
PROP_CHANNELS = 4

# Max clients per document (removers bitmask width).
MAX_CLIENTS = 32


class SegmentTable(NamedTuple):
    """Batched segment state, all tensors [docs, capacity] int32 unless
    noted."""

    length: torch.Tensor       # payload length (chars); markers use 1
    seq: torch.Tensor          # insert sequence number
    client: torch.Tensor       # interned inserter id (0..MAX_CLIENTS-1)
    removed_seq: torch.Tensor  # NOT_REMOVED if alive
    removers: torch.Tensor     # bitmask of removing clients (int32 bits)
    op_id: torch.Tensor        # payload provenance: insert op index
    op_off: torch.Tensor       # offset within that op's payload
    is_marker: torch.Tensor    # 1 if marker (excluded from text)
    prop: torch.Tensor         # [docs, capacity, PROP_CHANNELS]
    count: torch.Tensor        # [docs] live slot count
    min_seq: torch.Tensor      # [docs] collab window floor
    overflow: torch.Tensor     # [docs] 1 if capacity was exhausted

    @property
    def docs(self) -> int:
        return self.length.shape[0]

    @property
    def capacity(self) -> int:
        return self.length.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.length.device


def make_table(docs: int, capacity: int,
               device: torch.device | str = "cuda") -> SegmentTable:
    shape = (docs, capacity)

    def zeros(*s):
        return torch.zeros(s or shape, dtype=torch.int32, device=device)

    return SegmentTable(
        length=zeros(),
        seq=zeros(),
        client=zeros(),
        removed_seq=torch.full(shape, int(NOT_REMOVED), dtype=torch.int32,
                               device=device),
        removers=zeros(),
        op_id=zeros(),
        op_off=zeros(),
        is_marker=zeros(),
        prop=zeros(docs, capacity, PROP_CHANNELS),
        count=zeros(docs),
        min_seq=zeros(docs),
        overflow=zeros(docs),
    )


def _storages(tensors) -> set:
    """Storage addresses of the tensors among ``tensors`` (anything else,
    e.g. a numpy array of a host program, is skipped). Host-side only:
    reading a storage pointer never waits for the device."""
    return {t.untyped_storage().data_ptr() for t in tensors
            if isinstance(t, torch.Tensor) and t.numel()}


def shares_storage(table: SegmentTable, *groups) -> bool:
    """True when a field of ``table`` shares storage with a tensor of
    ``groups`` (tables, batches, dicts of a program, or tensors)."""
    others = set()
    for g in groups:
        if isinstance(g, torch.Tensor):
            g = (g,)
        elif isinstance(g, dict):
            g = g.values()
        others |= _storages(g)
    return not _storages(table).isdisjoint(others)


def check_donated(dead: SegmentTable, table: SegmentTable, *inputs) -> None:
    """The donated output table of a double-buffered dispatch must have
    the live input's shape and share no storage with it nor with the
    dispatch's other inputs: the dispatch writes into ``dead`` and
    never reads it, while the live input survives as the sidecar's
    pre-dispatch snapshot. Raises ``ValueError``."""
    if (dead.docs, dead.capacity) != (table.docs, table.capacity):
        raise ValueError(
            f"donated table is {dead.docs} x {dead.capacity}, the input "
            f"{table.docs} x {table.capacity}")
    if shares_storage(dead, table, *inputs):
        raise ValueError("donated table shares storage with an input of "
                         "the dispatch")


def copy_into(dead: SegmentTable, table: SegmentTable) -> SegmentTable:
    """Write ``table`` into ``dead``'s storage, one ``copy_`` per field;
    returns ``dead``."""
    for d, t in zip(dead, table):
        d.copy_(t)
    return dead


@dataclass
class ShardedTable:
    """A segment table split by rows over devices (the doc-sharded pool's
    placement): shard ``s`` holds the global rows ``[s * R, (s + 1) * R)``
    on its own device, every shard with the same ``R`` rows and
    capacity. Rows are independent lanes, so each shard applies alone."""

    shards: list

    @property
    def docs(self) -> int:
        return sum(t.docs for t in self.shards)

    @property
    def rows_per_shard(self) -> int:
        return self.shards[0].docs

    @property
    def capacity(self) -> int:
        return self.shards[0].capacity


class OpBatch(NamedTuple):
    """A padded window of sequenced ops, all tensors [docs, window]
    int32. ``kind`` 3 (NOOP) pads docs with fewer ops. Numeric tensor
    form of ISequencedDocumentMessage + merge-tree op contents
    (protocol.ts:212, ops.ts)."""

    kind: torch.Tensor      # 0 INSERT / 1 REMOVE / 2 ANNOTATE / 3 NOOP
    pos1: torch.Tensor
    pos2: torch.Tensor      # REMOVE/ANNOTATE end (exclusive)
    seq: torch.Tensor       # sequence number
    refseq: torch.Tensor    # reference sequence number
    client: torch.Tensor    # interned sender
    op_id: torch.Tensor     # INSERT payload index
    length: torch.Tensor    # INSERT payload length
    is_marker: torch.Tensor
    prop_key: torch.Tensor  # ANNOTATE channel (0..PROP_CHANNELS-1)
    prop_val: torch.Tensor  # ANNOTATE value (0 deletes)
    min_seq: torch.Tensor   # msn stamp (advances the collab window)


KIND_INSERT = 0
KIND_REMOVE = 1
KIND_ANNOTATE = 2
KIND_NOOP = 3

