"""Interval collections: named sets of sliding ranges over a sequence.

Reference: packages/dds/sequence/src/intervalCollection.ts
(``IntervalCollection`` :1309, ``SequenceInterval``), stored via the
sequence's defaultMap op envelope. Each interval is a pair of merge-tree
local references (``SLIDE_ON_REMOVE``) plus a property bag.

Concurrency model (matching the reference's observable behavior):

- ``add``: interval ids are unique per creator (``<client>-<n>``), so
  adds never conflict; endpoints are resolved at the *sender's*
  (refSeq, client) view, then slide under later edits.
- ``delete``: idempotent; wins over any concurrent ``change`` (the
  reference drops changes for unknown/deleted ids).
- ``change``: endpoint changes are LWW by sequence order per interval;
  a client's own pending change wins locally until it round-trips
  (same pending-wins discipline as map/annotate).
- property changes merge per-key LWW with the same pending-wins rule.

Interval ops ride the owning SharedString channel (the reference nests
them in the sequence op envelope via defaultMap.ts) — so they are
totally ordered *with* the text ops they reference.
"""
from __future__ import annotations

import uuid
from dataclasses import dataclass
from typing import TYPE_CHECKING, Iterator, Optional

from .mergetree.localref import DETACHED_POSITION, detach_reference
from .mergetree.ops import ReferenceType

if TYPE_CHECKING:  # pragma: no cover
    from .mergetree import MergeTreeClient
    from ..protocol.messages import SequencedMessage

ENDPOINT_REF_TYPE = ReferenceType.SLIDE_ON_REMOVE

# Endpoint stickiness (the reference's IntervalStickiness,
# intervalCollection.ts side/stickiness machinery): whether text
# inserted exactly AT a boundary joins the interval. Implemented with
# SIDE-AWARE anchors — a sequenced insert lands BEFORE the slot at its
# position, so which character an endpoint anchors, and on which side
# (ReferenceType.AFTER = the position following the char, collapsing
# backward when the char is removed), decides boundary membership:
#   start non-sticky: anchor ON the first contained char (boundary
#     inserts push it right -> stay outside);
#   start sticky:     anchor AFTER the char preceding the interval
#     (boundary inserts land beyond that char -> inside); at position
#     0 the sentinel DOC_START pins the boundary to 0 forever;
#   end sticky:       anchor ON the char at the exclusive bound
#     (boundary inserts land before it -> inside); at document end
#     the sentinel DOC_END tracks the live length (appends join);
#   end non-sticky:   anchor AFTER the last contained char (boundary
#     inserts fall beyond the resolved position -> outside; removing
#     that char collapses the end backward, never absorbing text).
STICKY_END = "end"      # the reference's default
STICKY_START = "start"
STICKY_FULL = "full"
STICKY_NONE = "none"
_STICKINESS = (STICKY_END, STICKY_START, STICKY_FULL, STICKY_NONE)
_DOC_START = "<doc-start>"
_DOC_END = "<doc-end>"


def _wire_stickiness(stickiness: str) -> Optional[str]:
    """Default-elided wire form (the add op omits the default)."""
    return None if stickiness == STICKY_END else stickiness


@dataclass
class IntervalOp:
    """The nested interval op carried inside the sequence channel
    envelope (intervalCollection.ts op kinds add/delete/change)."""

    label: str
    action: str                    # "add" | "delete" | "change"
    interval_id: str
    start: Optional[int] = None    # sender-view positions
    end: Optional[int] = None
    props: Optional[dict] = None
    stickiness: Optional[str] = None  # add only; None = "end"


class SequenceInterval:
    """A live interval: two sliding endpoint references + properties."""

    __slots__ = ("interval_id", "start_ref", "end_ref", "props",
                 "change_seq", "pending_endpoints", "pending_props",
                 "stickiness")

    def __init__(self, interval_id: str, start_ref, end_ref,
                 props: Optional[dict] = None,
                 stickiness: str = STICKY_END):
        self.interval_id = interval_id
        self.start_ref = start_ref     # LocalReference | _DOC_START
        self.end_ref = end_ref         # LocalReference | _DOC_END
        self.stickiness = stickiness
        self.props: dict = dict(props) if props else {}
        # seq that last changed this interval (LWW ordering); 0 = not
        # yet sequenced (pending local add)
        self.change_seq = 0
        # pending-wins bookkeeping, per aspect: un-acked local endpoint
        # changes, and per-key un-acked local property changes — remote
        # ops merge per aspect, like annotate's PropertiesManager
        self.pending_endpoints = 0
        self.pending_props: dict = {}

    @property
    def has_pending(self) -> bool:
        return bool(self.pending_endpoints or self.pending_props)


class IntervalCollection:
    """One labeled collection over one sequence client."""

    def __init__(self, label: str, client: "MergeTreeClient",
                 submit_fn) -> None:
        self.label = label
        self._client = client
        self._submit = submit_fn
        self._intervals: dict[str, SequenceInterval] = {}
        self._deleted: set[str] = set()
        # local deletes awaiting ack: must resubmit after reconnect
        self._pending_deletes: set[str] = set()

    # ------------------------------------------------------------------
    # queries

    def __len__(self) -> int:
        return len(self._intervals)

    def __iter__(self) -> Iterator[SequenceInterval]:
        return iter(list(self._intervals.values()))

    def get(self, interval_id: str) -> Optional[SequenceInterval]:
        return self._intervals.get(interval_id)

    def endpoints(self, interval: SequenceInterval) -> tuple[int, int]:
        """Current (start, end) positions after sliding (start
        inclusive, end exclusive; stickiness decides boundary
        membership — see _make)."""
        def resolve(ref):
            if ref == _DOC_START:
                return 0
            if ref == _DOC_END:
                return self._client.get_length()
            return self._client.reference_position(ref)

        return resolve(interval.start_ref), resolve(interval.end_ref)

    def find_overlapping(self, start: int, end: int
                         ) -> list[SequenceInterval]:
        """Intervals intersecting [start, end] (inclusive positions).

        Linear scan; the reference keeps an augmented interval tree
        (intervalCollection.ts IntervalTree) — worth revisiting if
        collections grow hot."""
        out = []
        for iv in self._intervals.values():
            s, e = self.endpoints(iv)
            if s == DETACHED_POSITION or e == DETACHED_POSITION:
                continue
            if s <= end and start <= e:
                out.append(iv)
        return out

    # ------------------------------------------------------------------
    # local edits

    def add(self, start: int, end: int,
            props: Optional[dict] = None,
            stickiness: str = STICKY_END) -> SequenceInterval:
        # uuid ids like the reference: creator-unique without any
        # counter state to restore on summary load
        interval_id = uuid.uuid4().hex
        interval = self._make(interval_id, start, end, props,
                              stickiness=stickiness)
        interval.pending_endpoints += 1
        for k in (props or {}):
            interval.pending_props[k] = interval.pending_props.get(k, 0) + 1
        self._intervals[interval_id] = interval
        self._submit(IntervalOp(
            label=self.label, action="add", interval_id=interval_id,
            start=start, end=end, props=dict(props) if props else None,
            stickiness=_wire_stickiness(stickiness),
        ))
        return interval

    def delete(self, interval_id: str) -> None:
        interval = self._intervals.pop(interval_id, None)
        if interval is None:
            return
        self._drop_refs(interval)
        self._deleted.add(interval_id)
        self._pending_deletes.add(interval_id)
        self._submit(IntervalOp(
            label=self.label, action="delete", interval_id=interval_id,
        ))

    def change(self, interval_id: str, start: Optional[int] = None,
               end: Optional[int] = None,
               props: Optional[dict] = None) -> None:
        interval = self._intervals.get(interval_id)
        if interval is None:
            raise KeyError(interval_id)
        if start is not None:
            self._drop_ref(interval.start_ref)
            interval.start_ref = self._start_ref(
                start, interval.stickiness
            )
        if end is not None:
            self._drop_ref(interval.end_ref)
            interval.end_ref = self._end_ref(
                end, interval.stickiness
            )
        if props:
            interval.props.update(
                {k: v for k, v in props.items() if v is not None}
            )
            for k, v in props.items():
                if v is None:
                    interval.props.pop(k, None)
                interval.pending_props[k] = (
                    interval.pending_props.get(k, 0) + 1
                )
        if start is not None or end is not None:
            interval.pending_endpoints += 1
        self._submit(IntervalOp(
            label=self.label, action="change", interval_id=interval_id,
            start=start, end=end, props=dict(props) if props else None,
        ))

    # ------------------------------------------------------------------
    # sequenced stream

    def process(self, op: IntervalOp, msg: "SequencedMessage",
                local: bool) -> None:
        if local:
            self._ack_own(op, msg)
            return
        if op.action == "add":
            # ids are creator-unique (uuid); a resubmitted add after
            # reconnect may overwrite — drop the old refs first.
            old = self._intervals.get(op.interval_id)
            if old is not None:
                self._drop_refs(old)
            interval = self._make(
                op.interval_id, op.start, op.end, op.props,
                view_of=msg, stickiness=op.stickiness or STICKY_END,
            )
            interval.change_seq = msg.sequence_number
            self._intervals[op.interval_id] = interval
        elif op.action == "delete":
            interval = self._intervals.pop(op.interval_id, None)
            if interval is not None:
                self._drop_refs(interval)
            self._deleted.add(op.interval_id)
        elif op.action == "change":
            if op.interval_id in self._deleted:
                return  # concurrent delete wins
            interval = self._intervals.get(op.interval_id)
            if interval is None:
                return
            interval.change_seq = msg.sequence_number
            # per-aspect merge: endpoints yield to pending local
            # endpoint changes; props merge per key, each key yielding
            # to pending local values (PropertiesManager discipline)
            if interval.pending_endpoints == 0:
                if op.start is not None:
                    self._drop_ref(interval.start_ref)
                    interval.start_ref = self._start_ref(
                        op.start, interval.stickiness, view_of=msg
                    )
                if op.end is not None:
                    self._drop_ref(interval.end_ref)
                    interval.end_ref = self._end_ref(
                        op.end, interval.stickiness, view_of=msg
                    )
            if op.props:
                for k, v in op.props.items():
                    if interval.pending_props.get(k, 0) > 0:
                        continue  # pending local value wins until ack
                    if v is None:
                        interval.props.pop(k, None)
                    else:
                        interval.props[k] = v
        else:  # pragma: no cover - forward compat
            raise ValueError(f"unknown interval action {op.action!r}")

    def _ack_own(self, op: IntervalOp, msg: "SequencedMessage") -> None:
        if op.action == "delete":
            self._pending_deletes.discard(op.interval_id)
            return
        interval = self._intervals.get(op.interval_id)
        if interval is None:
            return  # deleted locally while in flight
        interval.change_seq = msg.sequence_number
        if op.action == "add" or op.start is not None or op.end is not None:
            if interval.pending_endpoints > 0:
                interval.pending_endpoints -= 1
        for k in (op.props or {}):
            count = interval.pending_props.get(k, 0)
            if count > 1:
                interval.pending_props[k] = count - 1
            elif count == 1:
                del interval.pending_props[k]

    # ------------------------------------------------------------------
    # reconnect: regenerate pending ops at current positions

    def regenerate_pending_ops(self) -> list[IntervalOp]:
        """Rebased resubmission (intervalCollection.ts rebase helpers):
        endpoints are re-expressed as *current* positions — the sliding
        already incorporated every remote edit seen while offline."""
        out: list[IntervalOp] = []
        # un-acked deletes resubmit first: peers must stop tracking
        # the interval regardless of what else changed. Sorted: the
        # pending set's iteration order is per-process
        # (PYTHONHASHSEED), and these ops go on the wire — reconnect
        # resubmission must be byte-identical run to run
        for interval_id in sorted(self._pending_deletes):
            out.append(IntervalOp(
                label=self.label, action="delete",
                interval_id=interval_id,
            ))
        for interval in list(self._intervals.values()):
            if not interval.has_pending:
                continue
            start, end = self.endpoints(interval)
            if start == DETACHED_POSITION or end == DETACHED_POSITION:
                # the content it anchored to is gone
                interval.pending_endpoints = 0
                interval.pending_props.clear()
                if interval.change_seq == 0:
                    # never sequenced anywhere: drop it locally too,
                    # or this replica keeps an interval no peer has
                    self._drop_refs(interval)
                    del self._intervals[interval.interval_id]
                continue
            if interval.change_seq == 0:
                # never sequenced: peers have nothing — resend the
                # whole interval (deleted-then-readded keys are simply
                # absent; no tombstone needed)
                out.append(IntervalOp(
                    label=self.label, action="add",
                    interval_id=interval.interval_id,
                    start=start, end=end,
                    props=dict(interval.props) or None,
                    stickiness=_wire_stickiness(interval.stickiness),
                ))
                interval.pending_endpoints = 1
                interval.pending_props = {k: 1 for k in interval.props}
                continue
            # sequenced before: resubmit ONLY the pending aspects.
            # Pending keys whose value is gone locally were *deleted* —
            # emit an explicit {key: None} so peers drop them too;
            # untouched keys stay out of the op so concurrent remote
            # updates to them survive.
            pending_keys = sorted(interval.pending_props)
            props = (
                {k: interval.props.get(k) for k in pending_keys} or None
            )
            has_endpoints = interval.pending_endpoints > 0
            out.append(IntervalOp(
                label=self.label, action="change",
                interval_id=interval.interval_id,
                start=start if has_endpoints else None,
                end=end if has_endpoints else None,
                props=props,
            ))
            interval.pending_endpoints = 1 if has_endpoints else 0
            interval.pending_props = {k: 1 for k in pending_keys}
        return out

    # ------------------------------------------------------------------
    # summary

    def summarize(self) -> list[dict]:
        out = []
        for interval in self._intervals.values():
            start, end = self.endpoints(interval)
            if start == DETACHED_POSITION or end == DETACHED_POSITION:
                continue  # anchored content is gone; nothing to restore
            entry = {
                "id": interval.interval_id,
                "start": start,
                "end": end,
                "props": interval.props or None,
            }
            if interval.stickiness != STICKY_END:
                entry["stickiness"] = interval.stickiness
            out.append(entry)
        return out

    def load(self, entries: list[dict]) -> None:
        for entry in entries:
            if entry["start"] < 0 or entry["end"] < 0:
                continue  # detached in the summary writer's view
            interval = self._make(
                entry["id"], entry["start"], entry["end"],
                entry["props"],
                stickiness=entry.get("stickiness", STICKY_END),
            )
            self._intervals[entry["id"]] = interval

    # ------------------------------------------------------------------

    def _start_ref(self, start: int, stickiness: str,
                   view_of: Optional["SequencedMessage"] = None):
        if stickiness in (STICKY_START, STICKY_FULL):
            if start == 0:
                return _DOC_START
            return self._client.create_reference(
                start - 1, ENDPOINT_REF_TYPE | ReferenceType.AFTER,
                view_of=view_of)
        return self._client.create_reference(
            start, ENDPOINT_REF_TYPE, view_of=view_of)

    def _end_ref(self, end: int, stickiness: str,
                 view_of: Optional["SequencedMessage"] = None):
        if stickiness in (STICKY_END, STICKY_FULL):
            if end >= self._client.length_in_view(view_of):
                return _DOC_END
            return self._client.create_reference(
                end, ENDPOINT_REF_TYPE, view_of=view_of)
        if end == 0:
            return _DOC_START
        return self._client.create_reference(
            end - 1, ENDPOINT_REF_TYPE | ReferenceType.AFTER,
            view_of=view_of)

    @staticmethod
    def _drop_ref(ref) -> None:
        if ref not in (_DOC_START, _DOC_END):
            detach_reference(ref)

    def _make(self, interval_id: str, start: int, end: int,
              props: Optional[dict],
              view_of: Optional["SequencedMessage"] = None,
              stickiness: str = STICKY_END) -> SequenceInterval:
        if stickiness not in _STICKINESS:
            raise ValueError(f"unknown stickiness {stickiness!r}")
        return SequenceInterval(
            interval_id,
            self._start_ref(start, stickiness, view_of),
            self._end_ref(end, stickiness, view_of),
            props, stickiness,
        )

    @classmethod
    def _drop_refs(cls, interval: SequenceInterval) -> None:
        cls._drop_ref(interval.start_ref)
        cls._drop_ref(interval.end_ref)

    # ------------------------------------------------------------------

    def signature(self) -> tuple:
        """Convergence signature: sorted (id, start, end, props)."""
        rows = []
        for interval in self._intervals.values():
            start, end = self.endpoints(interval)
            rows.append((
                interval.interval_id, start, end,
                tuple(sorted(interval.props.items())),
            ))
        return tuple(sorted(rows))
