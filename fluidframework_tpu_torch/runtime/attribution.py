"""Attribution: who wrote what, keyed by sequence number.

Reference: packages/framework/attributor/src — ``Attributor``
(attributor.ts:79), ``OpStreamAttributor`` (:122) mapping op sequence
numbers to (user, timestamp); summary encoders with string interning +
compression (encoders.ts, lz4Encoder.ts — zlib here,
stringInterner.ts); runtime mixin (mixinAttributor.ts) — here a plain
observer attached to a Container.

Merge-tree integration: a segment's attribution key IS its insert seq
(attributionCollection.ts keys), so
``SharedString.attribution_at(pos)`` -> seq -> attributor lookup gives
per-character authorship with no extra per-segment state.
"""
from __future__ import annotations

import base64
import json
import zlib
from dataclasses import dataclass
from typing import TYPE_CHECKING, Optional

from ..protocol.messages import MessageType, SequencedMessage

if TYPE_CHECKING:  # pragma: no cover
    from ..loader.container import Container


@dataclass(frozen=True)
class AttributionInfo:
    user: str
    timestamp: float


class Attributor:
    """attributor.ts:79 — key -> AttributionInfo."""

    def __init__(self, entries: Optional[dict[int, AttributionInfo]] = None):
        self._entries: dict[int, AttributionInfo] = dict(entries or {})

    def get(self, key: int) -> Optional[AttributionInfo]:
        return self._entries.get(key)

    def record(self, key: int, info: AttributionInfo) -> None:
        self._entries[key] = info

    def __len__(self) -> int:
        return len(self._entries)

    # ---- summary encoding (encoders.ts: interning + compression)

    def encode(self) -> str:
        users = []
        index: dict[str, int] = {}
        rows = []
        for key in sorted(self._entries):
            info = self._entries[key]
            if info.user not in index:
                index[info.user] = len(users)
                users.append(info.user)
            rows.append([key, index[info.user], info.timestamp])
        payload = json.dumps({"users": users, "rows": rows})
        return base64.b64encode(
            zlib.compress(payload.encode("utf-8"))
        ).decode("ascii")

    @classmethod
    def decode(cls, data: str) -> "Attributor":
        payload = json.loads(
            zlib.decompress(base64.b64decode(data)).decode("utf-8")
        )
        users = payload["users"]
        return cls({
            key: AttributionInfo(users[uidx], ts)
            for key, uidx, ts in payload["rows"]
        })


class OpStreamAttributor(Attributor):
    """attributor.ts:122 — records every sequenced op's author as it
    streams through a container."""

    def __init__(self, container: "Container",
                 entries: Optional[dict[int, AttributionInfo]] = None):
        super().__init__(entries)
        self._off = container.on("processed", self._on_processed)

    def dispose(self) -> None:
        self._off()

    def _on_processed(self, msg: SequencedMessage) -> None:
        if msg.type == MessageType.OPERATION and msg.client_id:
            self.record(msg.sequence_number, AttributionInfo(
                user=msg.client_id, timestamp=msg.timestamp,
            ))
