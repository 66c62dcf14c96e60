"""SharedMatrix: collaborative 2-D cells over two permutation vectors.

Reference: packages/dds/matrix/src — ``SharedMatrix`` (matrix.ts:79),
``PermutationVector extends Client`` (permutationvector.ts:137): the
row and column axes are each a merge tree whose segments are runs of
inserted rows/cols carrying stable handles; cells live in a sparse
store keyed by (rowHandle, colHandle) with LWW + pending-local-wins
(the conflict-resolution sets of productSet.ts reduce to per-handle
LWW because handles never move).

Insert/remove rows/cols = merge-tree ops (all the concurrency math is
inherited); setCell ops carry handles, so they commute with any
concurrent permutation.
"""
from __future__ import annotations

import itertools
from typing import Any, Optional

from ..protocol.messages import SequencedMessage
from ..runtime.shared_object import SharedObject
from ..utils.events import EventEmitter
from .mergetree import MergeTreeClient
from .mergetree.segments import Segment


class SharedMatrix(SharedObject, EventEmitter):
    type_name = "sharedmatrix"

    def __init__(self, channel_id: str):
        SharedObject.__init__(self, channel_id)
        EventEmitter.__init__(self)
        self.rows = MergeTreeClient()
        self.cols = MergeTreeClient()
        self._cells: dict[tuple[str, str], Any] = {}
        self._pending_cells: dict[tuple[str, str], int] = {}
        self._alloc_counter = itertools.count()
        self._resubmit_epoch = -1

    # ------------------------------------------------------------------

    def _on_connect(self) -> None:
        client_id = self.client_id
        if not client_id:
            return
        for axis in (self.rows, self.cols):
            if not axis.mergetree.collab.collaborating:
                axis.start_collaboration(client_id)
            else:
                axis.long_client_id = client_id

    def _alloc(self) -> str:
        return f"{self.client_id or 'detached'}/{next(self._alloc_counter)}"

    # ------------------------------------------------------------------
    # public API (matrix.ts surface)

    @property
    def row_count(self) -> int:
        return self.rows.get_length()

    @property
    def col_count(self) -> int:
        return self.cols.get_length()

    def insert_rows(self, pos: int, count: int) -> None:
        op = self.rows.insert_run_local(pos, count, self._alloc())
        self.submit_local_message({"target": "rows", "op": op})

    def insert_cols(self, pos: int, count: int) -> None:
        op = self.cols.insert_run_local(pos, count, self._alloc())
        self.submit_local_message({"target": "cols", "op": op})

    def remove_rows(self, pos: int, count: int) -> None:
        op = self.rows.remove_range_local(pos, pos + count)
        self.submit_local_message({"target": "rows", "op": op})

    def remove_cols(self, pos: int, count: int) -> None:
        op = self.cols.remove_range_local(pos, pos + count)
        self.submit_local_message({"target": "cols", "op": op})

    def set_cell(self, row: int, col: int, value: Any) -> None:
        row_handle = self.rows.handle_at(row)
        col_handle = self.cols.handle_at(col)
        assert row_handle is not None and col_handle is not None, (
            "cell outside the matrix"
        )
        key = (row_handle, col_handle)
        self._cells[key] = value
        self._pending_cells[key] = self._pending_cells.get(key, 0) + 1
        self.submit_local_message({
            "target": "cell", "row": row_handle, "col": col_handle,
            "value": value,
        })

    def get_cell(self, row: int, col: int, default: Any = None) -> Any:
        row_handle = self.rows.handle_at(row)
        col_handle = self.cols.handle_at(col)
        if row_handle is None or col_handle is None:
            return default
        return self._cells.get((row_handle, col_handle), default)

    def to_lists(self) -> list[list[Any]]:
        return [
            [self.get_cell(r, c) for c in range(self.col_count)]
            for r in range(self.row_count)
        ]

    # ------------------------------------------------------------------
    # SharedObject contract

    def apply_stashed_op(self, contents: Any) -> Any:
        """Offline-stash rehydrate: re-author axis merge-tree ops and
        cell LWW writes as pending local state (matrix.ts
        applyStashedOp)."""
        target = contents["target"]
        if target in ("rows", "cols"):
            axis = self.rows if target == "rows" else self.cols
            if not axis.mergetree.collab.collaborating:
                axis.start_collaboration(
                    self.client_id or "\x00detached")
            axis._apply_local(contents["op"])
            return None
        assert target == "cell"
        key = (contents["row"], contents["col"])
        self._cells[key] = contents["value"]
        self._pending_cells[key] = self._pending_cells.get(key, 0) + 1
        return None

    def process_core(self, msg: SequencedMessage, local: bool,
                     local_op_metadata: Any = None) -> None:
        # see SharedString.process_core: load-time catch-up must apply
        # with collab view tracking, else concurrent streams diverge
        for ax in (self.rows, self.cols):
            if not ax.mergetree.collab.collaborating:
                ax.start_collaboration(self.client_id or "\x00detached")
        contents = msg.contents
        target = contents["target"]
        if target in ("rows", "cols"):
            axis = self.rows if target == "rows" else self.cols
            inner = SequencedMessage(
                client_id=msg.client_id,
                sequence_number=msg.sequence_number,
                minimum_sequence_number=msg.minimum_sequence_number,
                client_sequence_number=msg.client_sequence_number,
                reference_sequence_number=msg.reference_sequence_number,
                type=msg.type,
                contents=contents["op"],
            )
            axis.apply_msg(inner)
            self.emit("permutationChanged", target, local)
            return
        # setCell: handle-keyed LWW with pending-local-wins
        key = (contents["row"], contents["col"])
        if local:
            count = self._pending_cells.get(key, 0) - 1
            if count <= 0:
                self._pending_cells.pop(key, None)
            else:
                self._pending_cells[key] = count
            return
        # NB: both axes must still advance their collab windows even on
        # cell ops — do it via msn on next axis op; cells don't care.
        if key in self._pending_cells:
            return
        self._cells[key] = contents["value"]
        self.emit("cellChanged", key, local)

    def resubmit_core(self, contents: Any, metadata: Any = None) -> None:
        """Axis ops regenerate through their merge-tree clients (once
        per epoch each); cell ops resubmit verbatim — handles are
        stable, so no positional rebase is needed."""
        if contents["target"] == "cell":
            self.submit_local_message(contents)
            return
        epoch = getattr(self._services, "reconnect_epoch", None)
        if epoch is not None and epoch == self._resubmit_epoch:
            return
        self._resubmit_epoch = epoch if epoch is not None else (
            self._resubmit_epoch - 1
        )
        for target, axis in (("rows", self.rows), ("cols", self.cols)):
            for op in axis.regenerate_pending_ops():
                self.submit_local_message({"target": target, "op": op})

    # ------------------------------------------------------------------
    # summary

    @staticmethod
    def _axis_summary(axis: MergeTreeClient) -> dict:
        segments = []
        for seg in axis.mergetree.segments:
            segments.append({
                "length": seg.length,
                "seq": seg.seq,
                "client": axis._short_to_long[seg.client_id]
                if 0 <= seg.client_id < len(axis._short_to_long) else "",
                "removedSeq": seg.removed_seq,
                "removedClients": [
                    axis._short_to_long[c]
                    for c in seg.removed_client_ids
                ],
                "handle": list(seg.handle_base) if seg.handle_base
                else None,
            })
        return {
            "segments": segments,
            "minSeq": axis.mergetree.collab.min_seq,
            "currentSeq": axis.mergetree.collab.current_seq,
        }

    @staticmethod
    def _load_axis(axis: MergeTreeClient, summary: dict) -> None:
        tree = axis.mergetree
        tree.collab.min_seq = summary["minSeq"]
        tree.collab.current_seq = summary["currentSeq"]
        for entry in summary["segments"]:
            tree.segments.append(Segment(
                text="\x00" * entry["length"],
                seq=entry["seq"],
                client_id=axis.intern(entry["client"]),
                removed_seq=entry["removedSeq"],
                removed_client_ids=[
                    axis.intern(c) for c in entry["removedClients"]
                ],
                handle_base=(
                    tuple(entry["handle"]) if entry["handle"] else None
                ),
            ))

    def summarize_core(self) -> dict:
        assert not self.rows._pending and not self.cols._pending, (
            "summarize with pending axis ops"
        )
        return {
            "rows": self._axis_summary(self.rows),
            "cols": self._axis_summary(self.cols),
            "cells": {
                f"{r}|{c}": v for (r, c), v in self._cells.items()
            },
        }

    def load_core(self, summary: dict) -> None:
        self._load_axis(self.rows, summary["rows"])
        self._load_axis(self.cols, summary["cols"])
        for key, value in summary["cells"].items():
            row_handle, _, col_handle = key.partition("|")
            self._cells[(row_handle, col_handle)] = value

    def signature(self):
        """Visible grid content (replica-canonical)."""
        return tuple(
            tuple(
                (self._cells.get((rh, ch)) if rh and ch else None)
                for ch in self._visible_handles(self.cols)
            )
            for rh in self._visible_handles(self.rows)
        )

    @staticmethod
    def _visible_handles(axis: MergeTreeClient) -> list[str]:
        tree = axis.mergetree
        out = []
        for seg in tree.segments:
            length = tree._length_at(
                seg, tree.collab.current_seq, tree.collab.client_id
            )
            if not length:
                continue
            alloc, off = seg.handle_base if seg.handle_base else ("", 0)
            for i in range(seg.length):
                out.append(f"{alloc}:{off + i}" if alloc else "")
        return out
