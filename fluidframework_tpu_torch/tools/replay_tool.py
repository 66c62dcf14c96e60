"""Replay tool: validate persisted op streams against live replay.

Reference: packages/tools/replay-tool (src/replayMessages.ts,
replayTool.ts) — loads a snapshot + op log, replays through a real
container, and validates state at checkpoints (storing/expecting
intermediate snapshots).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..drivers.file_driver import load_document
from ..drivers.replay_driver import ReplayDocumentService
from ..loader.container import Container


@dataclass
class ReplayReport:
    document_id: str
    ops_replayed: int = 0
    final_seq: int = 0
    checkpoints: list[dict] = field(default_factory=list)
    mismatches: list[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.mismatches


def replay_document(
    service: ReplayDocumentService,
    checkpoint_every: Optional[int] = None,
    expected_checkpoints: Optional[list[dict]] = None,
) -> tuple[Container, ReplayReport]:
    """Replay a recorded document through a fresh read-only container.
    With ``checkpoint_every``, runtime summaries are captured at that
    op cadence; with ``expected_checkpoints``, each captured one is
    compared (replay-tool's snapshot validation mode)."""
    report = ReplayReport(document_id=service.document_id)
    container = Container.load(service, client_id="", connect=False,
                               replay_trailing=False)
    base_seq = container.last_processed_seq

    messages = service.read_ops(base_seq)
    for i, msg in enumerate(messages, start=1):
        container._process(msg)
        report.ops_replayed += 1
        if checkpoint_every and i % checkpoint_every == 0:
            report.checkpoints.append({
                "sequenceNumber": msg.sequence_number,
                "summary": container.runtime.summarize(),
            })
    report.final_seq = container.last_processed_seq

    if expected_checkpoints is not None:
        for got, want in zip(report.checkpoints, expected_checkpoints):
            if got != want:
                report.mismatches.append(
                    f"checkpoint at seq {got['sequenceNumber']} differs"
                )
        if len(report.checkpoints) != len(expected_checkpoints):
            report.mismatches.append(
                f"checkpoint count {len(report.checkpoints)} != "
                f"expected {len(expected_checkpoints)}"
            )
    return container, report


def replay_file(path, **kwargs) -> tuple[Container, ReplayReport]:
    return replay_document(load_document(path), **kwargs)


def main(argv: Optional[list[str]] = None) -> int:  # pragma: no cover
    import argparse
    import json as _json

    parser = argparse.ArgumentParser(
        description="Replay a recorded document and report final state"
    )
    parser.add_argument("path")
    parser.add_argument("--checkpoint-every", type=int, default=None)
    args = parser.parse_args(argv)
    _, report = replay_file(
        args.path, checkpoint_every=args.checkpoint_every
    )
    print(_json.dumps({
        "documentId": report.document_id,
        "opsReplayed": report.ops_replayed,
        "finalSeq": report.final_seq,
        "ok": report.ok,
    }))
    return 0 if report.ok else 1


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
