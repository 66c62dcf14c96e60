"""Ink: append-only stroke stream for freehand drawing.

Reference: packages/dds/ink/src/ink.ts (:99). Strokes are identified by
creator-unique ids. Local ops apply optimistically; a pending-op ledger
keeps replicas convergent when a remote ``clear`` interleaves with
un-acked local ops: every peer applies our op *after* the clear (it
sequences later), so when the ack arrives we must re-apply any effect
the clear wiped.

Single-writer-per-stroke (as in the reference's usage model): the
client that created a stroke is the only one appending points to it.
Concurrent appends to one stroke by different clients would apply in
submission order locally but sequenced order remotely — the optimistic
path is only order-stable for a single writer.
"""
from __future__ import annotations

import uuid
from collections import deque
from typing import Any, Optional

from ..protocol.messages import SequencedMessage
from ..runtime.shared_object import SharedObject
from ..utils.events import EventEmitter


class Ink(SharedObject, EventEmitter):
    type_name = "ink"

    def __init__(self, channel_id: str):
        SharedObject.__init__(self, channel_id)
        EventEmitter.__init__(self)
        # stroke id -> {"pen": {...}, "points": [...]}
        self._strokes: dict[str, dict] = {}
        # submitted-but-unacked local ops, oldest first; ``wiped`` is
        # set when a remote clear sequenced after we applied the op
        # optimistically (so its effect must be re-applied on ack)
        self._pending: deque[dict] = deque()

    # ---- public API

    def create_stroke(self, pen: Optional[dict] = None) -> str:
        stroke_id = uuid.uuid4().hex
        op = {
            "type": "createStroke", "id": stroke_id,
            "pen": dict(pen) if pen else {},
        }
        self._apply(op)
        self._pending.append({"op": op, "wiped": False})
        self.submit_local_message(op)
        return stroke_id

    def append_point(self, stroke_id: str, point: dict) -> None:
        op = {"type": "stylus", "id": stroke_id, "point": dict(point)}
        self._apply(op)
        self._pending.append({"op": op, "wiped": False})
        self.submit_local_message(op)

    def clear(self) -> None:
        op = {"type": "clear"}
        self._apply(op)
        self._pending.append({"op": op, "wiped": False})
        self.submit_local_message(op)

    def get_stroke(self, stroke_id: str) -> Optional[dict]:
        return self._strokes.get(stroke_id)

    def get_strokes(self) -> list[dict]:
        return list(self._strokes.values())

    # ---- SharedObject contract

    def apply_stashed_op(self, contents: Any) -> Any:
        """Offline-stash rehydrate: re-apply the stroke op locally and
        queue it pending (same bookkeeping as the live edit path)."""
        self._apply(contents)
        self._pending.append({"op": contents, "wiped": False})
        return None

    def process_core(self, msg: SequencedMessage, local: bool,
                     local_op_metadata: Any = None) -> None:
        op = msg.contents
        if local:
            entry = self._pending.popleft()
            assert entry["op"]["type"] == op["type"], "ack out of order"
            if op["type"] == "clear":
                # our clear just sequenced: every remote op applied
                # since the optimistic wipe sequenced BEFORE it — peers
                # cleared them; re-wipe to match. Our own later pending
                # ops sequence after and re-apply on their acks.
                self._apply(op)
                for later in self._pending:
                    later["wiped"] = True
            elif entry["wiped"]:
                # a clear sequenced between submit and ack: peers apply
                # this op after their clear — match them
                self._apply(op)
            return
        self._apply(op)
        if op["type"] == "clear":
            # our optimistic pending effects were just wiped; their
            # acks must re-apply (each peer applies them post-clear)
            for entry in self._pending:
                entry["wiped"] = True
        self.emit("stroke", op, local)

    def _apply(self, op: dict) -> None:
        kind = op["type"]
        if kind == "createStroke":
            # carry the id IN the stroke record (IInkStroke.id): a
            # view painting get_strokes() needs a replica-independent
            # z-order, and local dict insertion order differs across
            # replicas for concurrent strokes
            self._strokes.setdefault(
                op["id"],
                {"id": op["id"], "pen": dict(op["pen"]),
                 "points": []},
            )
        elif kind == "stylus":
            stroke = self._strokes.get(op["id"])
            if stroke is not None:  # cleared underneath: no-op
                stroke["points"].append(dict(op["point"]))
        elif kind == "clear":
            self._strokes.clear()
        else:  # pragma: no cover - forward compat
            raise ValueError(f"unknown op {kind!r}")

    def summarize_core(self) -> dict:
        return {"strokes": {
            k: {"pen": dict(v["pen"]),
                "points": [dict(p) for p in v["points"]]}
            for k, v in self._strokes.items()
        }}

    def load_core(self, summary: dict) -> None:
        self._strokes = {
            k: {"id": k, "pen": dict(v["pen"]),
                "points": [dict(p) for p in v["points"]]}
            for k, v in summary["strokes"].items()
        }
