"""File driver: persist/load op streams + summaries as JSON files.

Reference: packages/drivers/file-driver — reads snapshots/ops from
local files for tooling (replay tool, corpus benchmarks).
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

from ..protocol.messages import SequencedMessage
from ..protocol.serialization import (
    decode_contents,
    encode_contents,
    message_from_json,
    message_to_json,
)
from .replay_driver import ReplayDocumentService


def save_document(path: str | Path, document_id: str,
                  messages: list[SequencedMessage],
                  summary: Optional[tuple[int, dict]] = None) -> None:
    blob = {
        "documentId": document_id,
        "messages": [message_to_json(m) for m in messages],
        # summaries can hold FluidHandles and op dataclasses: encode
        "summary": (
            {"sequenceNumber": summary[0],
             "tree": encode_contents(summary[1])}
            if summary else None
        ),
    }
    Path(path).write_text(json.dumps(blob))


def load_document(path: str | Path) -> ReplayDocumentService:
    blob = json.loads(Path(path).read_text())
    summary = None
    if blob.get("summary"):
        summary = (blob["summary"]["sequenceNumber"],
                   decode_contents(blob["summary"]["tree"]))
    return ReplayDocumentService(
        document_id=blob["documentId"],
        messages=[message_from_json(d) for d in blob["messages"]],
        summary=summary,
    )
