"""Local reference positions: stable positions that slide on edit.

Reference: packages/dds/merge-tree/src/localReference.ts
(``LocalReferencePosition`` :44, ``LocalReferenceCollection`` :139).

A local reference anchors to (segment, offset). It is *local* state —
never serialized into ops — but interval endpoints and cursors are built
on it, and its slide behavior under concurrent removal is part of the
observable interval semantics:

- ``SLIDE_ON_REMOVE``: when the anchor segment's removal is acked, the
  reference resolves to the nearest surviving position — forward first,
  then backward (slideToSegment semantics). When the tombstone is
  compacted (zamboni), the reference physically transfers to that slide
  target so later edits keep behaving identically.
- ``STAY_ON_REMOVE``: rides the tombstone while it exists (resolving to
  the position the tombstone occupies); transfers like slide when the
  tombstone is compacted.
- ``SIMPLE``: detaches (resolves to ``DETACHED_POSITION``) once the
  anchor's removal is acked.
- ``TRANSIENT``: never stored on segments; for one-shot queries.
"""
from __future__ import annotations

from typing import Optional

from .ops import ReferenceType
from .segments import Segment

DETACHED_POSITION = -1


class LocalReference:
    """localReference.ts:44 — a sliding position anchor."""

    __slots__ = ("segment", "offset", "ref_type", "properties")

    def __init__(self, segment: Optional[Segment], offset: int,
                 ref_type: int = ReferenceType.SLIDE_ON_REMOVE,
                 properties: Optional[dict] = None):
        self.segment = segment
        self.offset = offset
        self.ref_type = ref_type
        self.properties = properties

    @property
    def is_transient(self) -> bool:
        return bool(self.ref_type & ReferenceType.TRANSIENT)

    @property
    def slides(self) -> bool:
        return bool(self.ref_type & ReferenceType.SLIDE_ON_REMOVE)

    @property
    def stays(self) -> bool:
        return bool(self.ref_type & ReferenceType.STAY_ON_REMOVE)

    def detach(self) -> None:
        self.segment = None
        self.offset = 0

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (
            f"LocalReference(seg={self.segment!r:.30}, off={self.offset}, "
            f"type={self.ref_type:#x})"
        )


def attach_reference(ref: LocalReference, segment: Segment,
                     offset: int) -> None:
    """Place ``ref`` on ``segment`` (LocalReferenceCollection add)."""
    if ref.segment is not None:
        detach_reference(ref)
    ref.segment = segment
    ref.offset = offset
    if not ref.is_transient:
        segment.local_refs.append(ref)


def detach_reference(ref: LocalReference) -> None:
    seg = ref.segment
    if seg is not None and not ref.is_transient:
        try:
            seg.local_refs.remove(ref)
        except ValueError:
            pass
    ref.detach()
