"""Undo/redo over DDS deltas.

Reference: packages/framework/undo-redo/src —
``UndoRedoStackManager`` (undoRedoStackManager.ts): operations are
groups of revertibles; reverting replays through the DDS as ordinary
local edits, which the handlers capture onto the *other* stack (undo
while undoing lands on redo, and vice versa).
``SharedMapUndoRedoHandler`` (mapHandler.ts) and
``SharedSegmentSequenceUndoRedoHandler`` (sequenceHandler.ts) — the
sequence handler anchors ranges with sliding local references so
concurrent remote edits move the undo target instead of corrupting it.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Optional, Protocol

from ..models.map import SharedMap
from ..models.mergetree.localref import DETACHED_POSITION
from ..models.mergetree.ops import ReferenceType

if TYPE_CHECKING:  # pragma: no cover
    from ..models.sharedstring import SharedString


class Revertible(Protocol):
    def revert(self) -> None: ...


class MapValueRevertible:
    """Undo of one map set/delete: restore the previous value."""

    def __init__(self, shared_map: SharedMap, key: str, previous):
        self.map = shared_map
        self.key = key
        self.previous = previous

    def revert(self) -> None:
        if self.previous is SharedMap._MISSING:
            self.map.delete(self.key)
        else:
            self.map.set(self.key, self.previous)


class MapClearRevertible:
    def __init__(self, shared_map: SharedMap, previous: dict):
        self.map = shared_map
        self.previous = previous

    def revert(self) -> None:
        for key, value in self.previous.items():
            self.map.set(key, value)


class _TrackingGroup:
    """Follows tracked segments through splits: merge-tree appends
    split tails to every entry in ``segment.groups`` (the reference's
    TrackingGroup mechanism, used by its sequence undo handler)."""

    __slots__ = ("segments",)

    def __init__(self) -> None:
        self.segments: list = []


class StringInsertRevertible:
    """Undo of a text/marker insert: remove exactly the inserted
    segments (tracked through splits), never remote content that
    landed inside the range afterwards."""

    def __init__(self, string: "SharedString", pos: int, length: int):
        self.string = string
        self.track = _TrackingGroup()
        tree = string.client.mergetree
        cur = tree.collab.current_seq
        viewer = tree.collab.client_id
        acc = 0
        end = pos + length
        for seg in tree.segments:
            if acc >= end:
                break
            seg_len = tree._length_at(seg, cur, viewer) or 0
            if seg_len and acc + seg_len > pos:
                self.track.segments.append(seg)
                seg.groups.append(self.track)
            acc += seg_len

    def revert(self) -> None:
        tree = self.string.client.mergetree
        cur = tree.collab.current_seq
        viewer = tree.collab.client_id
        for seg in list(self.track.segments):
            seg.groups = [g for g in seg.groups if g is not self.track]
            if seg.removed:
                continue  # someone else already removed it
            length = tree._length_at(seg, cur, viewer)
            if not length:
                continue
            start = tree.get_offset(seg, cur, viewer)
            self.string.remove_text(start, start + length)
        self.track.segments.clear()


class StringRemoveRevertible:
    """Undo of a removal: re-insert the captured span (text runs AND
    markers, position-accurate) where the removal point slid to."""

    def __init__(self, string: "SharedString", pos: int,
                 removed: list[tuple]):
        # constructed AFTER the removal applied: anchor the surviving
        # character just before the removal point and re-insert after
        # it (a start-of-document removal re-inserts at 0)
        self.string = string
        self.removed = removed
        self.ref = (
            string.client.create_reference(
                pos - 1, ReferenceType.SLIDE_ON_REMOVE
            ) if pos > 0 and string.get_length() >= pos else None
        )

    def revert(self) -> None:
        if self.ref is None:
            pos = 0
        else:
            anchor = self.string.client.reference_position(self.ref)
            pos = (
                self.string.get_length() if anchor == DETACHED_POSITION
                else anchor + 1
            )
        for item in self.removed:
            if item[0] == "text":
                self.string.insert_text(pos, item[1])
                pos += len(item[1])
            else:  # ("marker", ref_type, props)
                self.string.insert_marker(pos, item[1], item[2])
                pos += 1


class StringAnnotateRevertible:
    """Undo of an annotate: restore each subrange's prior values
    (None restores 'key absent')."""

    def __init__(self, string: "SharedString",
                 prior: list[tuple[int, int, dict]]):
        self.string = string
        client = string.client
        self.spans = [
            (client.create_reference(lo, ReferenceType.SLIDE_ON_REMOVE),
             hi - lo, dict(old))
            for lo, hi, old in prior
        ]

    def revert(self) -> None:
        for ref, length, old in self.spans:
            start = self.string.client.reference_position(ref)
            if start == DETACHED_POSITION:
                continue
            self.string.annotate_range(start, start + length, old)


class UndoRedoStackManager:
    """undoRedoStackManager.ts — operation-grouped undo/redo."""

    NORMAL, UNDOING, REDOING = range(3)

    def __init__(self) -> None:
        self._undo: list[list[Revertible]] = []
        self._redo: list[list[Revertible]] = []
        self._current: Optional[list[Revertible]] = None
        self._mode = self.NORMAL

    # ---- capture

    def push_revertible(self, revertible: Revertible) -> None:
        if self._mode == self.UNDOING:
            self._redo.append([revertible])
            return
        if self._mode == self.REDOING:
            self._undo.append([revertible])
            return
        if self._current is None:
            self._current = []
            self._undo.append(self._current)
        self._current.append(revertible)
        self._redo.clear()  # a fresh edit invalidates the redo branch

    def close_current_operation(self) -> None:
        """Group boundary: edits after this land in a new operation."""
        self._current = None

    # ---- stacks

    @property
    def undo_count(self) -> int:
        return len(self._undo)

    @property
    def redo_count(self) -> int:
        return len(self._redo)

    def undo_operation(self) -> bool:
        self.close_current_operation()
        if not self._undo:
            return False
        operation = self._undo.pop()
        self._mode = self.UNDOING
        try:
            # captured inverse edits of this op merge into ONE redo op
            marker = len(self._redo)
            for revertible in reversed(operation):
                revertible.revert()
            merged = [r for group in self._redo[marker:] for r in group]
            del self._redo[marker:]
            if merged:
                self._redo.append(merged)
        finally:
            self._mode = self.NORMAL
        return True

    def redo_operation(self) -> bool:
        self.close_current_operation()
        if not self._redo:
            return False
        operation = self._redo.pop()
        self._mode = self.REDOING
        try:
            marker = len(self._undo)
            for revertible in reversed(operation):
                revertible.revert()
            merged = [r for group in self._undo[marker:] for r in group]
            del self._undo[marker:]
            if merged:
                self._undo.append(merged)
        finally:
            self._mode = self.NORMAL
        return True


class SharedMapUndoRedoHandler:
    """mapHandler.ts — captures local map edits as revertibles."""

    def __init__(self, stack: UndoRedoStackManager,
                 shared_map: SharedMap):
        self.stack = stack
        self.map = shared_map
        self._offs = [
            shared_map.on("valueChanged", self._on_value_changed),
            shared_map.on("cleared", self._on_cleared),
        ]

    def dispose(self) -> None:
        for off in self._offs:
            off()

    def _on_value_changed(self, key, local, previous=None) -> None:
        if local:
            self.stack.push_revertible(
                MapValueRevertible(self.map, key, previous)
            )

    def _on_cleared(self, local, previous=None) -> None:
        if local:
            self.stack.push_revertible(
                MapClearRevertible(self.map, previous or {})
            )


class SharedStringUndoRedoHandler:
    """sequenceHandler.ts — captures local string edits."""

    def __init__(self, stack: UndoRedoStackManager,
                 string: "SharedString"):
        self.stack = stack
        self.string = string
        self._off = string.on("localEdit", self._on_local_edit)

    def dispose(self) -> None:
        self._off()

    def _on_local_edit(self, kind: str, pos: int, payload) -> None:
        if kind == "insert":
            self.stack.push_revertible(
                StringInsertRevertible(self.string, pos, payload)
            )
        elif kind == "remove":
            self.stack.push_revertible(
                StringRemoveRevertible(self.string, pos, payload)
            )
        elif kind == "annotate":
            self.stack.push_revertible(
                StringAnnotateRevertible(self.string, payload)
            )
