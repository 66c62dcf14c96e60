"""Merge-tree Client: the per-DDS collaboration endpoint.

Reference: packages/dds/merge-tree/src/client.ts (``Client`` :70 —
local ops :183-216, ``applyMsg`` :918, ``ackPendingSegment`` via
mergeTree.ts:1278, ``updateSeqNumbers`` :937, ``regeneratePendingOp``
:972, short<->long clientId interning).

Owns: the scalar MergeTree, the pending-op queue (segment groups), and
the mapping between service string client ids and interned short ints.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Optional

from ..protocol import UNASSIGNED_SEQ
from ..protocol import MessageType, SequencedMessage
from .mergetree import MergeTree
from .ops import AnnotateOp, DeltaType, GroupOp, InsertOp, RemoveOp
from .segments import Segment


@dataclass
class SegmentGroup:
    """Segments affected by one pending local op (client.ts segment
    groups); splits keep both halves in the group via Segment.split.
    ``kind`` is the original op family and survives regeneration (a
    regenerated op may become a GroupOp of per-segment sub-ops)."""

    op: object
    local_seq: int
    kind: DeltaType
    segments: list[Segment] = field(default_factory=list)
    # original op props, preserved across regenerations (a regenerated
    # GroupOp has no top-level props)
    props: Optional[dict] = None


class MergeTreeClient:
    def __init__(self, long_client_id: str = ""):
        self.mergetree = MergeTree()
        self._long_to_short: dict[str, int] = {}
        self._short_to_long: list[str] = []
        self.long_client_id = long_client_id
        self._pending: deque[SegmentGroup] = deque()

    # ------------------------------------------------------------------
    # identity

    def intern(self, long_id: str) -> int:
        short = self._long_to_short.get(long_id)
        if short is None:
            short = len(self._short_to_long)
            self._long_to_short[long_id] = short
            self._short_to_long.append(long_id)
        return short

    def start_collaboration(self, long_client_id: str,
                            min_seq: int = 0, current_seq: int = 0) -> None:
        self.long_client_id = long_client_id
        self.mergetree.start_collaboration(
            self.intern(long_client_id), min_seq, current_seq
        )

    @property
    def _local_id(self) -> int:
        return self.mergetree.collab.client_id

    @property
    def current_seq(self) -> int:
        return self.mergetree.collab.current_seq

    # ------------------------------------------------------------------
    # local ops (client.ts:183-216) — return the op to submit

    def insert_text_local(self, pos: int, text: str,
                          props: Optional[dict] = None) -> InsertOp:
        op = InsertOp(pos1=pos, text=text, props=props)
        self._apply_local(op)
        return op

    def insert_marker_local(self, pos: int, ref_type: int,
                            props: Optional[dict] = None) -> InsertOp:
        op = InsertOp(pos1=pos, marker={"refType": ref_type}, props=props)
        self._apply_local(op)
        return op

    def insert_run_local(self, pos: int, count: int,
                         alloc_id: str) -> InsertOp:
        """Insert a run of ``count`` positions with stable handles
        (alloc_id, 0..count-1) — the PermutationVector primitive
        (matrix/src/permutationvector.ts:137)."""
        op = InsertOp(pos1=pos, text="\x00" * count,
                      handle=[alloc_id, 0])
        self._apply_local(op)
        return op

    def handle_at(self, pos: int) -> Optional[str]:
        """Stable handle of the row/col currently at ``pos`` in the
        local view."""
        tree = self.mergetree
        remaining = pos
        for seg in tree.segments:
            length = tree._length_at(
                seg, tree.collab.current_seq, self._local_id
            )
            if not length:
                continue
            if remaining < length:
                if seg.handle_base is None:
                    return None
                alloc, off = seg.handle_base
                return f"{alloc}:{off + remaining}"
            remaining -= length
        return None

    def position_of_handle(self, handle: str) -> Optional[int]:
        """Current position of a stable handle, or None if the
        row/col is gone from the local view."""
        alloc, _, off_s = handle.rpartition(":")
        off = int(off_s)
        tree = self.mergetree
        acc = 0
        for seg in tree.segments:
            length = tree._length_at(
                seg, tree.collab.current_seq, self._local_id
            )
            if seg.handle_base is not None:
                salloc, soff = seg.handle_base
                if salloc == alloc and soff <= off < soff + seg.length:
                    if not length:
                        return None  # removed in local view
                    return acc + (off - soff)
            acc += length or 0
        return None

    def remove_range_local(self, start: int, end: int) -> RemoveOp:
        op = RemoveOp(pos1=start, pos2=end)
        self._apply_local(op)
        return op

    def annotate_range_local(self, start: int, end: int,
                             props: dict) -> AnnotateOp:
        op = AnnotateOp(pos1=start, pos2=end, props=dict(props))
        self._apply_local(op)
        return op

    def _apply_local(self, op) -> None:
        collab = self.mergetree.collab
        if not collab.collaborating:
            # Non-collaborative: apply with universal seq, no pending.
            self._apply_op(op, collab.current_seq, self._local_id, 0)
            return
        collab.local_seq += 1
        group = SegmentGroup(
            op=op, local_seq=collab.local_seq, kind=op.type,
            props=getattr(op, "props", None),
        )
        segs = self._apply_op(
            op, collab.current_seq, self._local_id, UNASSIGNED_SEQ,
            local_seq=collab.local_seq,
        )
        group.segments.extend(segs)
        for seg in segs:
            seg.groups.append(group)
        self._pending.append(group)

    # ------------------------------------------------------------------
    # sequenced stream (client.ts applyMsg :918)

    def apply_msg(self, msg: SequencedMessage) -> None:
        if msg.type != MessageType.OPERATION:
            # System messages (join/leave/propose/noop) carry no
            # merge-tree op but still advance the collab window —
            # mirrors updateSeqNumbers running for every sequenced
            # message while applyMsg (client.ts:918) only sees ops.
            self._update_seq_numbers(msg)
            return
        op = msg.contents
        if msg.client_id == self.long_client_id:
            self._ack_own(op, msg)
        else:
            self._apply_op(
                op,
                msg.reference_sequence_number,
                self.intern(msg.client_id),
                msg.sequence_number,
            )
        self._update_seq_numbers(msg)

    def _update_seq_numbers(self, msg: SequencedMessage) -> None:
        """updateSeqNumbers (client.ts:937): advance window, zamboni."""
        collab = self.mergetree.collab
        collab.current_seq = max(collab.current_seq, msg.sequence_number)
        self.mergetree.update_min_seq(msg.minimum_sequence_number)

    def _apply_op(self, op, refseq: int, client_id: int, seq: int,
                  local_seq: Optional[int] = None) -> list[Segment]:
        tree = self.mergetree
        if op.type == DeltaType.INSERT:
            seg = tree.insert(
                op.pos1, refseq, client_id, seq,
                text=op.text, marker=op.marker, props=op.props,
                local_seq=local_seq,
                handle_base=(
                    tuple(op.handle) if op.handle is not None else None
                ),
            )
            return [seg]
        if op.type == DeltaType.REMOVE:
            return tree.remove(
                op.pos1, op.pos2, refseq, client_id, seq,
                local_seq=local_seq,
            )
        if op.type == DeltaType.ANNOTATE:
            return tree.annotate(
                op.pos1, op.pos2, op.props, refseq, client_id, seq,
                local_seq=local_seq,
            )
        if op.type == DeltaType.GROUP:
            segs: list[Segment] = []
            for sub in op.ops:
                segs.extend(
                    self._apply_op(sub, refseq, client_id, seq, local_seq)
                )
            return segs
        raise ValueError(f"unknown op type {op.type}")

    # ------------------------------------------------------------------
    # own-op ack (ackPendingSegment, mergeTree.ts:1278)

    def _ack_own(self, op, msg: SequencedMessage) -> None:
        assert self._pending, "ack with empty pending queue"
        group = self._pending.popleft()
        assert group.op is op or group.kind == getattr(op, "type", None) or (
            getattr(op, "type", None) == DeltaType.GROUP
        ), "pending queue out of order with sequenced stream"
        seq = msg.sequence_number

        for seg in group.segments:
            if group.kind == DeltaType.INSERT and seg.seq == UNASSIGNED_SEQ:
                seg.seq = seq
                seg.local_seq = None
            if group.kind == DeltaType.REMOVE and seg.removed:
                if seg.removed_seq == UNASSIGNED_SEQ:
                    seg.removed_seq = seq
                seg.local_removed_seq = None
            seg.groups = [g for g in seg.groups if g is not group]
        if group.kind == DeltaType.ANNOTATE:
            self.mergetree.ack_annotate(group.segments, group.props or {})

    # ------------------------------------------------------------------
    # reconnect (regeneratePendingOp, client.ts:972)

    def regenerate_pending_ops(self) -> list[object]:
        """Rebase every pending local op against the current tree state
        for resubmission after reconnect (regeneratePendingOp,
        client.ts:972).

        Per group, emits one sub-op per surviving segment (a GroupOp if
        several): remote edits may have fragmented or scattered the
        original range. Positions are local-view offsets, which match
        what a receiver sees when it applies the resubmitted stream in
        order (its view at (refSeq, us) shows our pending inserts by
        client-match and our earlier resubmitted removes as
        removed-by-us). Groups whose every segment was superseded (e.g.
        a remove fully covered by a sequenced remote remove) are dropped
        from both the output *and* the pending queue, keeping the ack
        queue aligned with the resubmitted stream.
        """
        collab = self.mergetree.collab
        # Receivers place regenerated ops at the head of tombstone runs
        # (fresh seq wins ties); make the local layout agree first.
        self.mergetree.normalize_pending_segments()
        regenerated: list[object] = []
        kept_groups: deque[SegmentGroup] = deque()
        # Receivers apply GroupOp sub-ops sequentially, so sub-op
        # offsets are only consistent if emitted in document order
        # (split tails are appended to group.segments out of order).
        doc_order = {
            id(s): i for i, s in enumerate(self.mergetree.segments)
        }
        for group in self._pending:
            sub_ops: list[object] = []
            kept_segs: list[Segment] = []
            group_segments = sorted(
                group.segments,
                key=lambda s: doc_order.get(id(s), len(doc_order)),
            )
            for seg in group_segments:
                if group.kind == DeltaType.INSERT:
                    if seg.seq != UNASSIGNED_SEQ:
                        continue  # already acked (shouldn't normally occur)
                    # Pending-removed-by-us segments are still resubmitted:
                    # our later pending remove needs them to exist on peers.
                    pos = self.mergetree.get_offset(
                        seg, collab.current_seq, self._local_id,
                        local_seq=group.local_seq,
                    )
                    sub_ops.append(InsertOp(
                        pos1=pos, text=seg.text,
                        marker=seg.marker, props=group.props,
                        handle=(
                            list(seg.handle_base)
                            if seg.handle_base is not None else None
                        ),
                    ))
                elif group.kind == DeltaType.REMOVE:
                    if seg.removal_acked:
                        continue  # a sequenced remote remove already won
                    pos = self.mergetree.get_offset(
                        seg, collab.current_seq, self._local_id,
                        local_seq=group.local_seq,
                    )
                    sub_ops.append(RemoveOp(pos1=pos, pos2=pos + seg.length))
                elif group.kind == DeltaType.ANNOTATE:
                    if seg.removal_acked:
                        continue  # annotation on a gone segment is moot
                    props = group.props or {}
                    pos = self.mergetree.get_offset(
                        seg, collab.current_seq, self._local_id,
                        local_seq=group.local_seq,
                    )
                    sub_ops.append(AnnotateOp(
                        pos1=pos, pos2=pos + seg.length, props=props
                    ))
                else:
                    raise ValueError(f"unexpected group kind {group.kind}")
                kept_segs.append(seg)
            if not sub_ops:
                # Fully superseded: detach and drop the group so the ack
                # queue stays in sync with what we actually resubmit.
                for seg in group.segments:
                    seg.groups = [g for g in seg.groups if g is not group]
                continue
            new_op = sub_ops[0] if len(sub_ops) == 1 else GroupOp(ops=sub_ops)
            for seg in group.segments:
                if seg not in kept_segs:
                    seg.groups = [g for g in seg.groups if g is not group]
            group.op = new_op
            group.segments = kept_segs
            kept_groups.append(group)
            regenerated.append(new_op)
        self._pending = kept_groups
        return regenerated

    # ------------------------------------------------------------------
    # local references (cursor/interval anchors)

    def create_reference(self, pos: int, ref_type: int,
                         view_of: Optional[SequencedMessage] = None):
        """Anchor a local reference at ``pos``. With ``view_of`` given,
        the position is interpreted at that message's (refSeq, sender)
        view — how remote interval endpoints resolve."""
        if view_of is None:
            return self.mergetree.create_local_reference(pos, ref_type)
        return self.mergetree.create_local_reference(
            pos, ref_type,
            refseq=view_of.reference_sequence_number,
            client_id=self.intern(view_of.client_id),
        )

    def reference_position(self, ref) -> int:
        return self.mergetree.reference_position(ref)

    def length_in_view(
        self, view_of: Optional[SequencedMessage] = None
    ) -> int:
        """Visible length at a message's (refSeq, sender) view — the
        coordinate space its positions live in (current view when
        None)."""
        if view_of is None:
            return self.mergetree.length_at()
        return self.mergetree.length_at(
            view_of.reference_sequence_number,
            self.intern(view_of.client_id),
        )

    # ------------------------------------------------------------------
    # queries

    def get_text(self) -> str:
        return self.mergetree.get_text()

    def get_length(self) -> int:
        return self.mergetree.length_at()
