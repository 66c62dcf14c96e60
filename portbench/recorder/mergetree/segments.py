"""Segment model for the scalar merge tree.

Reference: packages/dds/merge-tree/src/mergeTreeNodes.ts (``ISegment``
:164 — seq/clientId/removedSeq/removedClientIds/localSeq/localRemovedSeq,
``Marker`` :575, ``CollaborationWindow`` :677).

The scalar implementation is deliberately a *flat list* of segments, not
the reference's B-tree: it is the spec oracle and the host-side client
path; its layout mirrors the kernel's struct-of-arrays table so the two
are differentially testable index-for-index.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..protocol import UNASSIGNED_SEQ


@dataclass
class Segment:
    """One run of content with shared insert/remove provenance."""

    # content: exactly one of text / marker is set
    text: Optional[str] = None
    marker: Optional[dict] = None  # {"refType": int, ...}

    # insert provenance
    seq: int = 0                     # UNASSIGNED_SEQ while local-pending
    client_id: int = -1              # interned short id of inserter
    local_seq: Optional[int] = None  # local op counter while pending

    # removal provenance (None removed_seq == never removed)
    removed_seq: Optional[int] = None          # UNASSIGNED_SEQ while local-pending
    removed_client_ids: list[int] = field(default_factory=list)
    local_removed_seq: Optional[int] = None

    # annotate state
    props: Optional[dict] = None

    # permutation-vector provenance (SharedMatrix axes): stable handle
    # allocation (alloc_id, offset) — position i in this segment has
    # handle (alloc_id, offset + i); follows splits
    handle_base: Optional[tuple] = None
    # per-key count of local annotates awaiting ack (pending wins)
    pending_props: Optional[dict] = None

    # pending-op segment groups this segment belongs to (client-side);
    # duck-typed: each entry has a ``segments`` list we must keep in
    # sync across splits (client.ts segment groups)
    groups: list = field(default_factory=list)

    # local references anchored here (localReference.ts:139); these
    # follow splits and slide on removal/zamboni — see mergetree.py
    local_refs: list = field(default_factory=list)

    # per-offset attribution runs (attributionCollection.ts:56):
    # ``None`` means the whole segment is attributed to ``seq``;
    # otherwise a run-length list [(start_offset, seq_key), ...] kept
    # across zamboni merges of segments from different ops
    attribution: Optional[list] = None

    def attribution_key(self, offset: int) -> int:
        """Attribution key (insert seq) for the character at offset."""
        if self.attribution is None:
            return self.seq
        key = self.attribution[0][1]
        for start, k in self.attribution:
            if start > offset:
                break
            key = k
        return key

    def _attribution_runs(self) -> list:
        return (
            [(0, self.seq)] if self.attribution is None
            else self.attribution
        )

    @property
    def length(self) -> int:
        if self.text is not None:
            return len(self.text)
        return 1  # markers occupy one position

    @property
    def is_marker(self) -> bool:
        return self.marker is not None

    @property
    def removed(self) -> bool:
        return self.removed_seq is not None

    @property
    def removal_acked(self) -> bool:
        return self.removed_seq is not None and self.removed_seq != UNASSIGNED_SEQ

    def split(self, offset: int) -> "Segment":
        """Split at ``offset``, returning the tail; provenance is shared
        (mergeTree.ts splitLeafSegment :1681)."""
        assert self.text is not None and 0 < offset < len(self.text), (
            "can only split text segments at interior offsets"
        )
        tail = Segment(
            text=self.text[offset:],
            seq=self.seq,
            client_id=self.client_id,
            local_seq=self.local_seq,
            removed_seq=self.removed_seq,
            removed_client_ids=list(self.removed_client_ids),
            local_removed_seq=self.local_removed_seq,
            props=dict(self.props) if self.props is not None else None,
            handle_base=(
                (self.handle_base[0], self.handle_base[1] + offset)
                if self.handle_base is not None else None
            ),
            pending_props=(
                dict(self.pending_props)
                if self.pending_props is not None else None
            ),
            groups=list(self.groups),
        )
        if self.attribution is not None:
            head = [(s, k) for s, k in self.attribution if s < offset]
            tail_runs = []
            carry = self.attribution_key(offset)
            for s, k in self.attribution:
                if s >= offset:
                    tail_runs.append((s - offset, k))
            if not tail_runs or tail_runs[0][0] != 0:
                tail_runs.insert(0, (0, carry))
            self.attribution = head
            tail.attribution = tail_runs
        self.text = self.text[:offset]
        for group in self.groups:
            group.segments.append(tail)
        # references at/after the split point move to the tail
        keep, move = [], []
        for ref in self.local_refs:
            (move if ref.offset >= offset else keep).append(ref)
        if move:
            self.local_refs = keep
            for ref in move:
                ref.segment = tail
                ref.offset -= offset
                tail.local_refs.append(ref)
        return tail

    def can_append(self, other: "Segment") -> bool:
        """Zamboni merge eligibility (both below the collab window is
        checked by the caller)."""
        handles_contiguous = (
            (self.handle_base is None and other.handle_base is None)
            or (
                self.handle_base is not None
                and other.handle_base is not None
                and self.handle_base[0] == other.handle_base[0]
                and self.handle_base[1] + len(self.text or "")
                == other.handle_base[1]
            )
        )
        return (
            self.text is not None
            and other.text is not None
            and self.removed is other.removed
            and self.props == other.props
            and handles_contiguous
        )


@dataclass
class CollabWindow:
    """mergeTreeNodes.ts:677 — the per-client collaboration window."""

    client_id: int = -1       # our interned id (NON_COLLAB_CLIENT if not collab)
    min_seq: int = 0
    current_seq: int = 0
    collaborating: bool = False
    local_seq: int = 0        # counter for local pending ops
