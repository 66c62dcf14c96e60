"""Scalar merge tree — the spec-fidelity sequence CRDT.

Faithful re-implementation of the reference merge-tree concurrency
semantics (packages/dds/merge-tree/src/mergeTree.ts) over a flat segment
list instead of a B-tree:

- position resolution at an op's (refSeq, clientId) view — the
  ``nodeLength`` visibility rules (mergeTree.ts:984 legacy branch,
  ``localNetLength`` :553),
- concurrent same-position insert ordering via ``breakTie``
  (mergeTree.ts:1705): normalized seq comparison, local pending op
  compares highest, pending segment second highest — net effect:
  later-sequenced insert lands leftmost,
- range ops visit only segments visible at the op's view
  (``nodeMap`` skips len 0/undefined — mergeTree.ts:2284),
- overlapping-remove bookkeeping (``markRangeRemoved`` :1908): first
  sequenced removal keeps the stamp, later removers are recorded,
- collab-window maintenance + zamboni compaction (:800).

This class is both the production host client path and the differential
oracle for the batched merge kernels in ``ops``.
"""
from __future__ import annotations

from typing import Optional

from ..protocol import MAX_SEQ, NON_COLLAB_CLIENT, UNASSIGNED_SEQ
from .localref import (
    DETACHED_POSITION,
    LocalReference,
    attach_reference,
)
from .ops import ReferenceType
from .segments import CollabWindow, Segment


class MergeTree:
    def __init__(self) -> None:
        self.segments: list[Segment] = []
        self.collab = CollabWindow(client_id=NON_COLLAB_CLIENT)

    # ------------------------------------------------------------------
    # collaboration lifecycle

    def start_collaboration(self, client_id: int, min_seq: int = 0,
                            current_seq: int = 0) -> None:
        """startOrUpdateCollaboration (client.ts): never REGRESSES the
        window — a container that replayed the op log while detached
        (load-time catch-up) has already advanced current_seq/min_seq,
        and clobbering them back to 0 would make every pre-connect
        segment invisible to the first local op's refSeq view."""
        self.collab.client_id = client_id
        self.collab.min_seq = max(self.collab.min_seq, min_seq)
        self.collab.current_seq = max(self.collab.current_seq,
                                      current_seq)
        self.collab.collaborating = True

    # ------------------------------------------------------------------
    # visibility (nodeLength, mergeTree.ts:984 / localNetLength :553)

    def _length_at(
        self,
        seg: Segment,
        refseq: int,
        client_id: int,
        local_seq: Optional[int] = None,
    ) -> Optional[int]:
        """Length of ``seg`` as seen at (refseq, client_id).

        None  => segment must be skipped entirely (tombstone at/below the
                 view, or concurrently inserted-and-removed);
        0     => invisible but present (participates in tie-break);
        >0    => visible.
        """
        if not self.collab.collaborating or client_id == self.collab.client_id:
            return self._local_length(seg, refseq, local_seq)

        # Remote view — the reference's *new* length calculations
        # (mergeTree.ts:1003-1025, mergeTreeUseNewLengthCalculations).
        # Unlike the legacy branch, tombstones above the collab window
        # return 0 and stay tie-break eligible by insert seq, so the
        # total segment order is replica-independent: the legacy skip
        # rule made insert placement depend on whether a replica saw a
        # segment alive before its removal, which diverges.
        if seg.removed:
            norm_removed = (
                MAX_SEQ if seg.removed_seq == UNASSIGNED_SEQ
                else seg.removed_seq
            )
            if norm_removed <= self.collab.min_seq:
                return None  # below the window: inert, zamboni-eligible
            if norm_removed <= refseq or client_id in seg.removed_client_ids:
                return 0  # removal visible to this view
        insert_visible = seg.client_id == client_id or (
            seg.seq != UNASSIGNED_SEQ and seg.seq <= refseq
        )
        return seg.length if insert_visible else 0

    def _local_length(
        self, seg: Segment, refseq: int, local_seq: Optional[int]
    ) -> Optional[int]:
        """localNetLength (mergeTree.ts:553)."""
        if local_seq is None:
            if seg.removed:
                norm_removed = (
                    MAX_SEQ if seg.removed_seq == UNASSIGNED_SEQ
                    else seg.removed_seq
                )
                if norm_removed > self.collab.min_seq:
                    return 0
                return None  # zamboni-eligible tombstone
            return seg.length

        # Rebase view: "the tree as this client saw it at (refseq,
        # local_seq)" — used by pending-op regeneration (§3.5).
        if seg.seq != UNASSIGNED_SEQ:
            if (
                seg.seq > refseq
                or (seg.removal_acked and seg.removed_seq <= refseq)
                or (seg.local_removed_seq is not None
                    and seg.local_removed_seq <= local_seq)
            ):
                return 0
            return seg.length
        assert seg.local_seq is not None
        if seg.local_seq <= local_seq:
            if (seg.local_removed_seq is not None
                    and seg.local_removed_seq <= local_seq):
                return 0
            return seg.length
        return 0

    # ------------------------------------------------------------------
    # position resolution (insertingWalk + breakTie, mergeTree.ts:1723,1705)

    def _find_insert_index(
        self,
        pos: int,
        refseq: int,
        client_id: int,
        seq: int,
        local_seq: Optional[int] = None,
    ) -> tuple[int, int]:
        """Return (segment_index, offset) where an insert with ``seq``
        lands. offset > 0 means split segments[index] first."""
        norm_op = MAX_SEQ if seq == UNASSIGNED_SEQ else seq
        remaining = pos
        for i, seg in enumerate(self.segments):
            length = self._length_at(seg, refseq, client_id, local_seq)
            if length is None:
                continue
            if remaining < length:
                return i, remaining
            if remaining == 0 and length == 0:
                # breakTie: insert before iff the op's normalized seq
                # exceeds the segment's (local pending seg = MAX_SEQ - 1).
                norm_seg = (
                    MAX_SEQ - 1 if seg.seq == UNASSIGNED_SEQ else seg.seq
                )
                if norm_op > norm_seg:
                    return i, 0
            remaining -= length
        if remaining == 0:
            return len(self.segments), 0
        raise ValueError(
            f"insert position {pos} beyond view length "
            f"(refseq={refseq}, client={client_id})"
        )

    def _split(self, index: int, offset: int) -> None:
        seg = self.segments[index]
        tail = seg.split(offset)
        self.segments.insert(index + 1, tail)

    def _ensure_boundary(
        self, pos: int, refseq: int, client_id: int,
        local_seq: Optional[int] = None,
    ) -> None:
        """ensureIntervalBoundary (mergeTree.ts:1698): split so that
        ``pos`` in the given view falls on a segment boundary."""
        remaining = pos
        for i, seg in enumerate(self.segments):
            length = self._length_at(seg, refseq, client_id, local_seq)
            if length is None:
                continue
            if remaining < length:
                if remaining > 0:
                    self._split(i, remaining)
                return
            remaining -= length

    # ------------------------------------------------------------------
    # ops (insertSegments :1394, markRangeRemoved :1908, annotateRange :1864)

    def insert(
        self,
        pos: int,
        refseq: int,
        client_id: int,
        seq: int,
        *,
        text: Optional[str] = None,
        marker: Optional[dict] = None,
        props: Optional[dict] = None,
        local_seq: Optional[int] = None,
        handle_base: Optional[tuple] = None,
    ) -> Segment:
        index, offset = self._find_insert_index(
            pos, refseq, client_id, seq, local_seq
        )
        if offset > 0:
            self._split(index, offset)
            index += 1
        seg = Segment(
            text=text,
            marker=marker,
            seq=seq,
            client_id=client_id,
            local_seq=local_seq,
            props=dict(props) if props else None,
            handle_base=handle_base,
        )
        self.segments.insert(index, seg)
        self._advance(seq)
        return seg

    def _range_segments(
        self, start: int, end: int, refseq: int, client_id: int,
        local_seq: Optional[int] = None,
    ) -> list[Segment]:
        """Visible segments fully covering [start, end) after boundary
        splits — the nodeMap walk (skips len None/0)."""
        self._ensure_boundary(start, refseq, client_id, local_seq)
        self._ensure_boundary(end, refseq, client_id, local_seq)
        out: list[Segment] = []
        acc = 0
        for seg in self.segments:
            if acc >= end:
                break
            length = self._length_at(seg, refseq, client_id, local_seq)
            if length is None or length == 0:
                continue
            if acc >= start:
                out.append(seg)
            acc += length
        return out

    def remove(
        self,
        start: int,
        end: int,
        refseq: int,
        client_id: int,
        seq: int,
        local_seq: Optional[int] = None,
    ) -> list[Segment]:
        """Mark [start, end) removed at the op's view; returns segments
        newly removed by this op (for delta events / pending tracking)."""
        newly_removed: list[Segment] = []
        for seg in self._range_segments(start, end, refseq, client_id,
                                        local_seq):
            if seg.removed:
                # Overlapping remove (markRangeRemoved :1925).
                if seg.removed_seq == UNASSIGNED_SEQ:
                    # We removed it locally but a remote remove sequenced
                    # first: remote takes the stamp, we go to list head.
                    seg.removed_client_ids.insert(0, client_id)
                    seg.removed_seq = seq
                else:
                    # Keep the earlier sequenced removal stamp.
                    seg.removed_client_ids.append(client_id)
            else:
                seg.removed_seq = seq
                seg.removed_client_ids = [client_id]
                seg.local_removed_seq = local_seq
                newly_removed.append(seg)
        self._advance(seq)
        return newly_removed

    def annotate(
        self,
        start: int,
        end: int,
        props: dict,
        refseq: int,
        client_id: int,
        seq: int,
        local_seq: Optional[int] = None,
    ) -> list[Segment]:
        """Set properties on [start, end) at the op's view. Pending
        local values win over remote ones until acked
        (segmentPropertiesManager.ts:29); None values delete keys."""
        local = seq == UNASSIGNED_SEQ
        touched: list[Segment] = []
        for seg in self._range_segments(start, end, refseq, client_id,
                                        local_seq):
            touched.append(seg)
            if seg.props is None:
                seg.props = {}
            if seg.pending_props is None:
                seg.pending_props = {}
            for key, value in props.items():
                if local:
                    seg.pending_props[key] = seg.pending_props.get(key, 0) + 1
                    self._set_prop(seg, key, value)
                else:
                    if seg.pending_props.get(key, 0) > 0:
                        continue  # pending local value wins until ack
                    self._set_prop(seg, key, value)
        self._advance(seq)
        return touched

    @staticmethod
    def _set_prop(seg: Segment, key: str, value) -> None:
        if value is None:
            seg.props.pop(key, None)
        else:
            seg.props[key] = value

    def ack_annotate(self, segments: list[Segment], props: dict) -> None:
        """Own annotate round-tripped: release pending-win counts."""
        for seg in segments:
            if seg.pending_props is None:
                continue
            for key in props:
                count = seg.pending_props.get(key, 0)
                if count > 1:
                    seg.pending_props[key] = count - 1
                elif count == 1:
                    del seg.pending_props[key]

    def _advance(self, seq: int) -> None:
        if seq != UNASSIGNED_SEQ and seq > self.collab.current_seq:
            self.collab.current_seq = seq

    # ------------------------------------------------------------------
    # reconnect normalization

    def normalize_pending_segments(self) -> None:
        """Slide every pending-insert segment left past adjacent acked
        segments that are zero-length in its rebase view (tombstones,
        and segments our earlier pending removes cover), so the local
        layout matches where receivers will place the regenerated op:
        its fresh sequence number wins every tie-break, landing it at
        the head of the zero-run. Without this, a third-party insert
        concurrent with the resubmission resolves differently against
        the sender's historical layout vs everyone else's (verified
        divergence in reconnect fuzzing). Equivalent to the
        normalizeSegmentsOnRebase step added to the reference after
        this snapshot; must run before regenerating pending ops."""
        segs = self.segments
        for idx in range(len(segs)):
            seg = segs[idx]
            if seg.seq != UNASSIGNED_SEQ:
                continue
            j = idx
            while j > 0:
                prev = segs[j - 1]
                if prev.seq == UNASSIGNED_SEQ:
                    break  # relative pending order is already consistent
                if self._local_length(
                    prev, self.collab.current_seq, seg.local_seq
                ) != 0:
                    break  # receiver sees it with length: a real boundary
                j -= 1
            if j < idx:
                segs.insert(j, segs.pop(idx))

    # ------------------------------------------------------------------
    # collab window + zamboni (mergeTree.ts:800)

    def update_min_seq(self, min_seq: int) -> None:
        if min_seq <= self.collab.min_seq:
            return
        self.collab.min_seq = min_seq
        self.zamboni()

    def zamboni(self) -> None:
        """Drop tombstones below the window; merge adjacent segments
        fully below the window. Never touches pending segments. Local
        references on dropped tombstones transfer to their slide target
        first (localReference semantics, localReference.ts:139)."""
        min_seq = self.collab.min_seq
        segs = self.segments
        dropped = [
            seg.removal_acked and seg.removed_seq <= min_seq
            for seg in segs
        ]
        for i, seg in enumerate(segs):
            if not dropped[i] or not seg.local_refs:
                continue
            fwd: Optional[Segment] = None
            for j in range(i + 1, len(segs)):  # next survivor
                if not dropped[j]:
                    fwd = segs[j]
                    break
            bwd: Optional[Segment] = None
            for j in range(i - 1, -1, -1):     # previous survivor
                if not dropped[j]:
                    bwd = segs[j]
                    break
            for ref in seg.local_refs:
                # side-aware: AFTER refs collapsed BACKWARD when their
                # char was removed (reference_position) — compaction
                # must preserve that resolution, so they transfer to
                # the previous survivor's last char; plain refs keep
                # the forward-first slide
                if ref.ref_type & ReferenceType.AFTER:
                    target = bwd or None
                    if target is not None:
                        t_off = max(target.length - 1, 0)
                    elif fwd is not None:
                        # nothing before: the AFTER position collapsed
                        # to 0 == "before the next survivor"; keep that
                        # by anchoring the next survivor's first char
                        # WITHOUT the after-bias — drop the AFTER flag
                        target, t_off = fwd, 0
                        ref.ref_type &= ~ReferenceType.AFTER
                    else:
                        target = None
                else:
                    if fwd is not None:
                        target, t_off = fwd, 0
                    elif bwd is not None:
                        target = bwd
                        t_off = max(target.length - 1, 0)
                    else:
                        target = None
                if target is None:
                    ref.detach()
                else:
                    ref.segment = target
                    ref.offset = t_off
                    target.local_refs.append(ref)
            seg.local_refs = []
        out: list[Segment] = []
        for i, seg in enumerate(segs):
            if dropped[i]:
                continue  # every view has seen this removal
            prev = out[-1] if out else None
            if (
                prev is not None
                and self._zamboni_mergeable(prev, min_seq)
                and self._zamboni_mergeable(seg, min_seq)
                and prev.can_append(seg)
            ):
                if seg.local_refs:
                    shift = len(prev.text)
                    for ref in seg.local_refs:
                        ref.segment = prev
                        ref.offset += shift
                    prev.local_refs.extend(seg.local_refs)
                    seg.local_refs = []
                # keep per-offset authorship across the merge
                # (attributionCollection.ts preserves keys; ADVICE r1)
                if (
                    prev.attribution is not None
                    or seg.attribution is not None
                    or prev.seq != seg.seq
                ):
                    shift = len(prev.text)
                    runs = list(prev._attribution_runs())
                    for s, k in seg._attribution_runs():
                        if runs and runs[-1][1] == k:
                            continue  # extend the last run
                        runs.append((s + shift, k))
                    prev.attribution = runs
                prev.text = prev.text + seg.text
                prev.seq = max(prev.seq, seg.seq)
            else:
                out.append(seg)
        self.segments = out

    @staticmethod
    def _zamboni_mergeable(seg: Segment, min_seq: int) -> bool:
        return (
            seg.seq != UNASSIGNED_SEQ
            and seg.seq <= min_seq
            and not seg.removed
            and not seg.groups
            and not seg.pending_props
        )

    # ------------------------------------------------------------------
    # queries

    def length_at(
        self, refseq: Optional[int] = None, client_id: Optional[int] = None
    ) -> int:
        refseq = self.collab.current_seq if refseq is None else refseq
        client_id = self.collab.client_id if client_id is None else client_id
        return sum(
            self._length_at(seg, refseq, client_id) or 0
            for seg in self.segments
        )

    def get_text(
        self, refseq: Optional[int] = None, client_id: Optional[int] = None
    ) -> str:
        """Concatenated visible text (markers excluded)."""
        refseq = self.collab.current_seq if refseq is None else refseq
        client_id = self.collab.client_id if client_id is None else client_id
        parts: list[str] = []
        for seg in self.segments:
            length = self._length_at(seg, refseq, client_id)
            if length and seg.text is not None:
                parts.append(seg.text)
        return "".join(parts)

    def span_content(self, start: int, end: int) -> list[tuple]:
        """Visible content items covering [start, end): ("text", str)
        runs and ("marker", ref_type, props) singletons — position-
        accurate (markers occupy one position, unlike get_text), so
        undo capture can faithfully restore a removed span."""
        out: list[tuple] = []
        acc = 0
        cur = self.collab.current_seq
        viewer = self.collab.client_id
        for seg in self.segments:
            if acc >= end:
                break
            length = self._length_at(seg, cur, viewer)
            if not length:
                continue
            lo = max(start, acc)
            hi = min(end, acc + length)
            if lo < hi:
                if seg.is_marker:
                    out.append((
                        "marker", seg.marker.get("refType", 0),
                        dict(seg.props) if seg.props else None,
                    ))
                else:
                    piece = seg.text[lo - acc:hi - acc]
                    if out and out[-1][0] == "text":
                        out[-1] = ("text", out[-1][1] + piece)
                    else:
                        out.append(("text", piece))
            acc += length
        return out

    def span_props(self, start: int, end: int,
                   keys: list[str]) -> list[tuple[int, int, dict]]:
        """Per-subrange prior values of ``keys`` over [start, end) —
        (lo, hi, {key: old_value_or_None}) for annotate undo capture."""
        out: list[tuple[int, int, dict]] = []
        acc = 0
        cur = self.collab.current_seq
        viewer = self.collab.client_id
        for seg in self.segments:
            if acc >= end:
                break
            length = self._length_at(seg, cur, viewer)
            if not length:
                continue
            lo = max(start, acc)
            hi = min(end, acc + length)
            if lo < hi:
                props = seg.props or {}
                old = {k: props.get(k) for k in keys}
                if out and out[-1][1] == lo and out[-1][2] == old:
                    out[-1] = (out[-1][0], hi, old)
                else:
                    out.append((lo, hi, old))
            acc += length
        return out

    def segment_at(
        self,
        pos: int,
        refseq: Optional[int] = None,
        client_id: Optional[int] = None,
    ) -> tuple[Segment, int]:
        """(segment, offset) containing position ``pos`` at a view
        (getContainingSegment, mergeTree.ts)."""
        refseq = self.collab.current_seq if refseq is None else refseq
        client_id = self.collab.client_id if client_id is None else client_id
        remaining = pos
        for seg in self.segments:
            length = self._length_at(seg, refseq, client_id)
            if not length:
                continue
            if remaining < length:
                return seg, remaining
            remaining -= length
        raise ValueError(
            f"position {pos} beyond view length (refseq={refseq}, "
            f"client={client_id})"
        )

    # ------------------------------------------------------------------
    # local references (localReference.ts:44,139)

    def create_local_reference(
        self,
        pos: int,
        ref_type: int = ReferenceType.SLIDE_ON_REMOVE,
        properties: Optional[dict] = None,
        refseq: Optional[int] = None,
        client_id: Optional[int] = None,
    ) -> LocalReference:
        """Anchor a sliding reference at ``pos`` resolved at a view
        (the sender's view for remote interval ops)."""
        seg, offset = self.segment_at(pos, refseq, client_id)
        ref = LocalReference(None, 0, ref_type, properties)
        attach_reference(ref, seg, offset)
        return ref

    def reference_position(self, ref: LocalReference) -> int:
        """Current document position of a local reference, applying
        slide-on-remove resolution (localReferencePositionToPosition).
        AFTER references resolve to the position following their
        character, collapsing BACKWARD (not sliding forward) when that
        character is removed — side-aware endpoints for sticky
        intervals."""
        seg = ref.segment
        if seg is None:
            return DETACHED_POSITION
        cur = self.collab.current_seq
        viewer = self.collab.client_id
        if ref.ref_type & ReferenceType.AFTER:
            try:
                base = self.get_offset(seg, cur, viewer)
            except ValueError:
                return DETACHED_POSITION  # orphaned anchor
            if self._length_at(seg, cur, viewer):
                return base + ref.offset + 1
            return base  # anchor char gone: collapse to the boundary
        length = self._length_at(seg, cur, viewer)
        if length:
            try:
                return self.get_offset(seg, cur, viewer) + ref.offset
            except ValueError:
                # transient refs aren't registered on segments, so a
                # zamboni merge can orphan their anchor silently
                return DETACHED_POSITION
        # Anchor is a tombstone (or invisible) in our current view.
        if not (ref.slides or ref.stays):
            if seg.removal_acked:
                return DETACHED_POSITION
            # local-pending remove: still resolves at the tombstone
        try:
            forward = self.get_offset(seg, cur, viewer)
        except ValueError:
            return DETACHED_POSITION  # orphaned anchor (transient ref)
        total = self.length_at(cur, viewer)
        if forward < total:
            return forward  # slid to the next surviving position
        if total == 0:
            return DETACHED_POSITION
        return total - 1  # nothing after: slide backward to last position

    def get_offset(
        self,
        target: Segment,
        refseq: int,
        client_id: int,
        local_seq: Optional[int] = None,
    ) -> int:
        """Document position of ``target`` at a view (getPosition :853).
        Pass ``local_seq`` for the rebase view used by pending-op
        regeneration (computeLocalPartials, mergeTree.ts:994)."""
        acc = 0
        for seg in self.segments:
            if seg is target:
                return acc
            acc += self._length_at(seg, refseq, client_id, local_seq) or 0
        raise ValueError("segment not in tree")
