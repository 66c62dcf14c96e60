"""Scalar merge tree: spec-fidelity sequence CRDT (oracle + host client
path). Reference analogue: packages/dds/merge-tree."""
from .client import MergeTreeClient, SegmentGroup
from .mergetree import MergeTree
from .ops import (
    AnnotateOp,
    DeltaType,
    GroupOp,
    InsertOp,
    MergeTreeOp,
    ReferenceType,
    RemoveOp,
)
from .segments import CollabWindow, Segment

__all__ = [
    "AnnotateOp",
    "CollabWindow",
    "DeltaType",
    "GroupOp",
    "InsertOp",
    "MergeTreeClient",
    "MergeTreeOp",
    "MergeTree",
    "ReferenceType",
    "RemoveOp",
    "Segment",
    "SegmentGroup",
]
