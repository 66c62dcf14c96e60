"""SharedQuorum: values accepted only once every client has seen them.

Reference: packages/dds/quorum/src/quorum.ts (:156) — a set is
*pending* from sequencing until the msn advances past its sequence
number (i.e. every connected client's refSeq has caught up), at which
point it becomes the *accepted* value. Competing sets: the latest
sequenced pending value supersedes earlier pending ones; acceptance is
always of the latest pending once the window catches up to it.
"""
from __future__ import annotations

from typing import Any

from ..protocol.messages import SequencedMessage
from ..runtime.shared_object import SharedObject
from ..utils.events import EventEmitter


class SharedQuorum(SharedObject, EventEmitter):
    type_name = "sharedquorum"

    def __init__(self, channel_id: str):
        SharedObject.__init__(self, channel_id)
        EventEmitter.__init__(self)
        self._accepted: dict[str, dict] = {}   # key -> {value, seq}
        self._pending: dict[str, dict] = {}    # key -> {value, seq}

    # ---- public API

    def set(self, key: str, value: Any) -> None:
        self.submit_local_message({
            "type": "set", "key": key, "value": value,
        })

    def get(self, key: str, default: Any = None) -> Any:
        entry = self._accepted.get(key)
        return entry["value"] if entry else default

    def get_pending(self, key: str, default: Any = None) -> Any:
        entry = self._pending.get(key)
        return entry["value"] if entry else default

    def has_pending(self, key: str) -> bool:
        return key in self._pending

    # ---- SharedObject contract

    def apply_stashed_op(self, contents: Any) -> Any:
        """Offline-stash rehydrate: quorum sets have no optimistic
        local state (values become pending only when SEQUENCED), so
        the stashed op just resubmits verbatim."""
        return None

    def process_core(self, msg: SequencedMessage, local: bool,
                     local_op_metadata: Any = None) -> None:
        op = msg.contents
        assert op["type"] == "set"
        # later sequenced set supersedes any earlier pending one
        self._pending[op["key"]] = {
            "value": op["value"], "seq": msg.sequence_number,
        }
        self.emit("pending", op["key"], op["value"])
        self._check_accept(msg.minimum_sequence_number)

    def on_sequence_advance(self, seq: int, min_seq: int) -> None:
        self._check_accept(min_seq)

    def _check_accept(self, min_seq: int) -> None:
        for key in list(self._pending):
            entry = self._pending[key]
            if entry["seq"] <= min_seq:
                del self._pending[key]
                self._accepted[key] = entry
                self.emit("accepted", key, entry["value"])

    def summarize_core(self) -> dict:
        return {
            "accepted": {k: dict(v) for k, v in self._accepted.items()},
            "pending": {k: dict(v) for k, v in self._pending.items()},
        }

    def load_core(self, summary: dict) -> None:
        self._accepted = {
            k: dict(v) for k, v in summary["accepted"].items()
        }
        self._pending = {
            k: dict(v) for k, v in summary["pending"].items()
        }
