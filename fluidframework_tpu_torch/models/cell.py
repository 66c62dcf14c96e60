"""SharedCell: a single optimistic LWW value.

Reference: packages/dds/cell/src/cell.ts (:93) — set/delete with
pending-local-wins, same machinery as one map key.
"""
from __future__ import annotations

from typing import Any

from ..protocol.messages import SequencedMessage
from ..runtime.shared_object import SharedObject
from ..utils.events import EventEmitter

_EMPTY = object()


class SharedCell(SharedObject, EventEmitter):
    type_name = "sharedcell"

    def __init__(self, channel_id: str):
        SharedObject.__init__(self, channel_id)
        EventEmitter.__init__(self)
        self._value: Any = _EMPTY
        self._pending = 0

    # ---- public API

    def set(self, value: Any) -> None:
        self._value = value
        self._pending += 1
        self.submit_local_message({"type": "set", "value": value})

    def get(self, default: Any = None) -> Any:
        return default if self._value is _EMPTY else self._value

    def delete(self) -> None:
        self._value = _EMPTY
        self._pending += 1
        self.submit_local_message({"type": "delete"})

    @property
    def empty(self) -> bool:
        return self._value is _EMPTY

    # ---- SharedObject contract

    def apply_stashed_op(self, contents: Any) -> Any:
        """Offline-stash rehydrate: re-author the set/delete as the
        pending local value (sharedObject.ts:510)."""
        if contents["type"] == "set":
            self._value = contents["value"]
        else:
            self._value = _EMPTY
        self._pending += 1
        return None

    def process_core(self, msg: SequencedMessage, local: bool,
                     local_op_metadata: Any = None) -> None:
        op = msg.contents
        if local:
            self._pending -= 1
            return
        if self._pending > 0:
            return  # pending local value wins until ack
        if op["type"] == "set":
            self._value = op["value"]
        else:
            self._value = _EMPTY
        self.emit("valueChanged", local)

    def summarize_core(self) -> dict:
        return {
            "empty": self._value is _EMPTY,
            "value": None if self._value is _EMPTY else self._value,
        }

    def load_core(self, summary: dict) -> None:
        self._value = _EMPTY if summary["empty"] else summary["value"]
