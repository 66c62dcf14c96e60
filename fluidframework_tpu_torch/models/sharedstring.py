"""SharedString: collaborative rich text over the merge-tree client.

Reference: packages/dds/sequence/src/sharedString.ts (:63) +
sequence.ts (``SharedSegmentSequence`` :109). The channel is a thin
facade: concurrency lives in ``MergeTreeClient``; this class adapts it
to the SharedObject contract and summary format.
"""
from __future__ import annotations

from typing import Any, Optional

from ..protocol.constants import UNASSIGNED_SEQ
from ..protocol.messages import SequencedMessage
from ..runtime.shared_object import SharedObject
from ..utils.events import EventEmitter
from .intervals import IntervalCollection, IntervalOp
from .mergetree import MergeTreeClient
from .mergetree.segments import Segment


SNAPSHOT_CHUNK_SEGMENTS = 512


class SharedString(SharedObject, EventEmitter):
    type_name = "sharedstring"

    def __init__(self, channel_id: str):
        SharedObject.__init__(self, channel_id)
        EventEmitter.__init__(self)
        self.client = MergeTreeClient()
        self._resubmit_epoch = -1
        self._interval_collections: dict[str, IntervalCollection] = {}

    # ------------------------------------------------------------------

    def _on_connect(self) -> None:
        client_id = self.client_id
        if not client_id:
            return  # container identity not known yet
        if not self.client.mergetree.collab.collaborating:
            self.client.start_collaboration(client_id)
        else:
            self.client.long_client_id = client_id

    # ------------------------------------------------------------------
    # public editing API (sharedString.ts surface)

    def insert_text(self, pos: int, text: str,
                    props: Optional[dict] = None) -> None:
        op = self.client.insert_text_local(pos, text, props)
        self.submit_local_message(op)
        # revert info for undo handlers (sequence undo-redo handler)
        if self.listener_count("localEdit"):
            self.emit("localEdit", "insert", pos, len(text))

    def insert_marker(self, pos: int, ref_type: int,
                      props: Optional[dict] = None) -> None:
        op = self.client.insert_marker_local(pos, ref_type, props)
        self.submit_local_message(op)
        if self.listener_count("localEdit"):
            self.emit("localEdit", "insert", pos, 1)

    def remove_text(self, start: int, end: int) -> None:
        # capture BEFORE the removal, position-accurate incl. markers
        removed = (
            self.client.mergetree.span_content(start, end)
            if self.listener_count("localEdit") else None
        )
        op = self.client.remove_range_local(start, end)
        self.submit_local_message(op)
        if removed is not None:
            self.emit("localEdit", "remove", start, removed)

    def annotate_range(self, start: int, end: int, props: dict) -> None:
        prior = (
            self.client.mergetree.span_props(start, end, list(props))
            if self.listener_count("localEdit") else None
        )
        op = self.client.annotate_range_local(start, end, props)
        self.submit_local_message(op)
        if prior is not None:
            self.emit("localEdit", "annotate", start, prior)

    def get_text(self) -> str:
        return self.client.get_text()

    def get_length(self) -> int:
        return self.client.get_length()

    # ------------------------------------------------------------------
    # interval collections (sequence/src/intervalCollection.ts:1309)

    def get_interval_collection(self, label: str) -> IntervalCollection:
        coll = self._interval_collections.get(label)
        if coll is None:
            coll = IntervalCollection(
                label, self.client, self.submit_local_message
            )
            self._interval_collections[label] = coll
        return coll

    def attribution_at(self, pos: int) -> Optional[int]:
        """Attribution key (insert seq) for the character at ``pos`` —
        feed to an ``Attributor`` for (user, timestamp)
        (attributionCollection.ts keys == segment seqs). ``None`` for
        locally-inserted text whose op has not sequenced yet (no
        authorship record exists anywhere until the ack)."""
        seg, off = self.client.mergetree.segment_at(pos)
        key = seg.attribution_key(off)
        return None if key == UNASSIGNED_SEQ else key

    def create_position_reference(self, pos: int, ref_type: int):
        """Public cursor-anchor API (sharedString createLocalReference
        passthrough)."""
        return self.client.create_reference(pos, ref_type)

    def local_reference_position(self, ref) -> int:
        return self.client.reference_position(ref)

    # ------------------------------------------------------------------
    # SharedObject contract

    def process_core(self, msg: SequencedMessage, local: bool,
                     local_op_metadata: Any = None) -> None:
        # A channel materialized during load-time catch-up processes
        # sequenced ops BEFORE the container connects. It must still
        # track (seq, refSeq) views and tombstones — non-collab apply
        # resolves positions at the tip view and silently diverges on
        # concurrent streams (found by tools/net_stress). Enter
        # collaboration in observer mode; _on_connect renames us later.
        if not self.client.mergetree.collab.collaborating:
            self.client.start_collaboration(
                self.client_id or "\x00detached"
            )
        assert local == (msg.client_id == self.client.long_client_id)
        if isinstance(msg.contents, IntervalOp):
            op = msg.contents
            coll = self.get_interval_collection(op.label)
            coll.process(op, msg, local)
            # interval ops still advance the merge-tree collab window
            # (they are sequence ops; window advance keeps ref views
            # and zamboni in step with the channel stream)
            self.client.mergetree.update_min_seq(
                msg.minimum_sequence_number
            )
            self.client.mergetree._advance(msg.sequence_number)
            self.emit("intervalDelta", msg, local)
            return
        self.client.apply_msg(msg)
        self.emit("sequenceDelta", msg, local)

    def resubmit_core(self, contents: Any, metadata: Any = None) -> None:
        """Reconnect rebase (client.ts regeneratePendingOp via
        reSubmitCore). The merge-tree client owns the whole pending
        queue, so the first replayed op of an epoch regenerates and
        resubmits everything; later replays of the same epoch no-op."""
        epoch = getattr(self._services, "reconnect_epoch", None)
        if epoch is not None and epoch == self._resubmit_epoch:
            return
        self._resubmit_epoch = epoch if epoch is not None else (
            self._resubmit_epoch - 1
        )
        for op in self.client.regenerate_pending_ops():
            self.submit_local_message(op)
        # Interval ops resubmit after text ops: their regenerated
        # positions are expressed against the post-rebase local view.
        for coll in self._interval_collections.values():
            for iop in coll.regenerate_pending_ops():
                self.submit_local_message(iop)

    def apply_stashed_op(self, contents: Any) -> Any:
        """Offline-stash rehydrate (client.ts:894 applyStashedOp):
        re-author the stashed op as pending local state; reconnect
        then regenerates and resubmits it rebased.

        Collaboration MUST be active first: a non-collab _apply_local
        lands as universal (non-pending) state, so the op would look
        applied locally yet never resubmit — silent permanent
        divergence (found by the all-channel stash-cycle test; only
        bites documents whose string had no sequenced ops yet)."""
        if not self.client.mergetree.collab.collaborating:
            self.client.start_collaboration(
                self.client_id or "\x00detached"
            )
        if isinstance(contents, IntervalOp):
            coll = self.get_interval_collection(contents.label)
            return coll.apply_stashed_op(contents) \
                if hasattr(coll, "apply_stashed_op") else None
        self.client._apply_local(contents)
        return None

    def signature(self):
        """Per-position (char|marker, props) content signature."""
        tree = self.client.mergetree
        out = []
        for seg in tree.segments:
            length = tree._length_at(
                seg, tree.collab.current_seq, tree.collab.client_id
            )
            if not length:
                continue
            props = tuple(sorted((seg.props or {}).items()))
            if seg.is_marker:
                out.append(("M", seg.marker["refType"], props))
            else:
                out.extend((ch, props) for ch in seg.text)
        intervals = tuple(
            (label, coll.signature())
            for label, coll in sorted(self._interval_collections.items())
            if len(coll)
        )
        return (tuple(out), intervals)

    # ------------------------------------------------------------------
    # summary (SnapshotV1 simplified: snapshotV1.ts:36)

    def summarize_core(self) -> dict:
        tree = self.client.mergetree
        assert not self.client._pending, (
            "summarize with pending local ops (the summarizer client "
            "must be quiescent)"
        )
        segments = []
        for seg in tree.segments:
            segments.append({
                "text": seg.text,
                "marker": seg.marker,
                "seq": seg.seq,
                "client": self.client._short_to_long[seg.client_id]
                if 0 <= seg.client_id < len(self.client._short_to_long)
                else "",
                "removedSeq": seg.removed_seq,
                "removedClients": [
                    self.client._short_to_long[c]
                    for c in seg.removed_client_ids
                    if 0 <= c < len(self.client._short_to_long)
                ],
                "props": seg.props,
                # per-offset authorship runs survive zamboni merges —
                # persist them or reload collapses attribution to the
                # merged segment's max seq (attributionCollection.ts
                # keys are part of the snapshot)
                "attribution": (
                    [list(run) for run in seg.attribution]
                    if seg.attribution is not None else None
                ),
            })
        # Chunked snapshot format v2 (snapshotV1.ts:36 +
        # snapshotChunks.ts): fixed-size segment chunks so the
        # content-addressed store re-uses every unchanged chunk of an
        # append-mostly document; "format" guards compat (format
        # changes must keep load_core accepting all published values).
        chunks = [
            segments[i : i + SNAPSHOT_CHUNK_SEGMENTS]
            for i in range(0, len(segments), SNAPSHOT_CHUNK_SEGMENTS)
        ] or [[]]
        return {
            "format": 2,
            "chunks": chunks,
            "minSeq": tree.collab.min_seq,
            "currentSeq": tree.collab.current_seq,
            "intervals": {
                label: coll.summarize()
                for label, coll in self._interval_collections.items()
                if len(coll)
            },
        }

    def load_core(self, summary: dict) -> None:
        tree = self.client.mergetree
        assert not tree.segments, "load into non-empty string"
        tree.collab.min_seq = summary["minSeq"]
        tree.collab.current_seq = summary["currentSeq"]
        if "chunks" in summary:  # format 2
            entries = [e for chunk in summary["chunks"] for e in chunk]
        else:  # format 1 (flat list) — still loadable
            entries = summary["segments"]
        for entry in entries:
            seg = Segment(
                text=entry["text"],
                marker=entry["marker"],
                seq=entry["seq"],
                client_id=self.client.intern(entry["client"]),
                removed_seq=entry["removedSeq"],
                removed_client_ids=[
                    self.client.intern(c) for c in entry["removedClients"]
                ],
                props=dict(entry["props"]) if entry["props"] else None,
                attribution=(
                    [tuple(run) for run in entry["attribution"]]
                    if entry.get("attribution") else None
                ),
            )
            tree.segments.append(seg)
        for label, entries in summary.get("intervals", {}).items():
            self.get_interval_collection(label).load(entries)
