"""SharedSummaryBlock: summary-only data, no op traffic.

Reference: packages/dds/shared-summary-block/src/sharedSummaryBlock.ts
(:38). Values are written before attach / between summaries and travel
exclusively via the summary tree — there is no op path, so writes after
attach are local-only by design (the reference throws; we do too).
"""
from __future__ import annotations

from typing import Any

from ..protocol.messages import SequencedMessage
from ..runtime.shared_object import SharedObject


class SharedSummaryBlock(SharedObject):
    type_name = "sharedsummaryblock"

    def __init__(self, channel_id: str):
        SharedObject.__init__(self, channel_id)
        self._data: dict[str, Any] = {}

    def get(self, key: str, default: Any = None) -> Any:
        return self._data.get(key, default)

    def set(self, key: str, value: Any) -> None:
        if self._services is not None:  # attached (connected or not)
            raise RuntimeError(
                "SharedSummaryBlock is write-once pre-attach: it has no "
                "op stream to propagate live writes"
            )
        self._data[key] = value

    def keys(self) -> tuple[str, ...]:
        return tuple(self._data)

    # ---- SharedObject contract

    def process_core(self, msg: SequencedMessage, local: bool,
                     local_op_metadata: Any = None) -> None:
        raise AssertionError("SharedSummaryBlock receives no ops")

    def apply_stashed_op(self, contents: Any) -> Any:
        raise AssertionError(
            "SharedSummaryBlock receives no ops (write-once pre-attach)"
        )

    def summarize_core(self) -> dict:
        return {"data": dict(self._data)}

    def load_core(self, summary: dict) -> None:
        self._data = dict(summary["data"])
