"""Merge-tree op vocabulary.

Reference: packages/dds/merge-tree/src/ops.ts (``MergeTreeDeltaType``,
``IMergeTreeOp`` unions). Numeric values match the reference so recorded
op streams stay comparable.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from enum import IntEnum
from typing import Any, Optional


class DeltaType(IntEnum):
    INSERT = 0
    REMOVE = 1
    ANNOTATE = 2
    GROUP = 3


class ReferenceType(IntEnum):
    """Marker/local-reference behavior flags (ops.ts ReferenceType)."""

    SIMPLE = 0x0
    TILE = 0x1
    RANGE_BEGIN = 0x10
    RANGE_END = 0x20
    SLIDE_ON_REMOVE = 0x40
    STAY_ON_REMOVE = 0x80
    TRANSIENT = 0x100
    # side-aware anchor: the reference denotes the position AFTER its
    # character. Inserts at that position land before the NEXT char, so
    # they fall on the far side of the boundary; when the anchor char
    # is removed the position collapses BACKWARD to where it was (no
    # forward slide) — the resolution sticky interval endpoints need
    # (sequence Side/stickiness machinery in the reference)
    AFTER = 0x200


@dataclass
class InsertOp:
    type: DeltaType = field(default=DeltaType.INSERT, init=False)
    pos1: int = 0
    text: Optional[str] = None           # text segment payload
    marker: Optional[dict] = None        # {"refType": int} marker payload
    props: Optional[dict] = None
    # permutation-vector runs: stable handle allocation [alloc_id, off]
    handle: Optional[list] = None


@dataclass
class RemoveOp:
    type: DeltaType = field(default=DeltaType.REMOVE, init=False)
    pos1: int = 0
    pos2: int = 0


@dataclass
class AnnotateOp:
    type: DeltaType = field(default=DeltaType.ANNOTATE, init=False)
    pos1: int = 0
    pos2: int = 0
    props: dict = field(default_factory=dict)


@dataclass
class GroupOp:
    type: DeltaType = field(default=DeltaType.GROUP, init=False)
    ops: list = field(default_factory=list)


MergeTreeOp = Any  # InsertOp | RemoveOp | AnnotateOp | GroupOp
