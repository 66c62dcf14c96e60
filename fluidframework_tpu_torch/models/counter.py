"""SharedCounter: commutative increments.

Reference: packages/dds/counter/src/counter.ts (:80) — increments
commute, so there is no pending-wins machinery: local increments apply
immediately and remote (non-own) increments always apply.
"""
from __future__ import annotations

from typing import Any

from ..protocol.messages import SequencedMessage
from ..runtime.shared_object import SharedObject
from ..utils.events import EventEmitter


class SharedCounter(SharedObject, EventEmitter):
    type_name = "sharedcounter"

    def __init__(self, channel_id: str):
        SharedObject.__init__(self, channel_id)
        EventEmitter.__init__(self)
        self.value: int = 0

    # ---- public API

    def increment(self, delta: int = 1) -> None:
        if not isinstance(delta, int):
            raise TypeError("counter delta must be an integer")
        self.value += delta
        self.submit_local_message({"increment": delta})

    # ---- SharedObject contract

    def apply_stashed_op(self, contents: Any) -> Any:
        """Offline-stash rehydrate: re-apply the increment
        optimistically (it resubmits as a pending op)."""
        self.value += contents["increment"]
        return None

    def process_core(self, msg: SequencedMessage, local: bool,
                     local_op_metadata: Any = None) -> None:
        if local:
            return  # already applied optimistically
        self.value += msg.contents["increment"]
        self.emit("incremented", msg.contents["increment"], self.value)

    def summarize_core(self) -> dict:
        return {"value": self.value}

    def load_core(self, summary: dict) -> None:
        self.value = summary["value"]
