"""Headless container runner / exporter.

Reference: packages/tools/fluid-runner (src/exportFile.ts,
fluidRunner.ts) — load a persisted document headlessly, run it to the
end of its op log, and export its content as JSON.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Optional

from ..drivers.file_driver import load_document
from ..loader.container import Container
from ..protocol.serialization import encode_contents


def export_content(container: Container) -> dict:
    """Walk every datastore/channel and export user-level content."""
    out: dict[str, Any] = {}
    for ds_id, ds in container.runtime.datastores.items():
        channels: dict[str, Any] = {}
        for ch_id, channel in ds.channels.items():
            entry: dict[str, Any] = {"type": channel.type_name}
            if hasattr(channel, "get_text"):
                entry["text"] = channel.get_text()
            else:
                entry["content"] = channel.summarize_core()
            channels[ch_id] = entry
        out[ds_id] = channels
    return out


def export_file(input_path, output_path: Optional[str] = None) -> dict:
    """exportFile.ts — replay a saved document fully, export content
    (and optionally write it to ``output_path``)."""
    from .replay_tool import replay_document

    service = load_document(input_path)
    container, report = replay_document(service)
    result = {
        "documentId": report.document_id,
        "finalSeq": report.final_seq,
        "opsReplayed": report.ops_replayed,
        "content": encode_contents(export_content(container)),
    }
    if output_path is not None:
        Path(output_path).write_text(json.dumps(result))
    return result


def main(argv: Optional[list[str]] = None) -> int:  # pragma: no cover
    import argparse

    parser = argparse.ArgumentParser(
        description="Headless export of a persisted document"
    )
    parser.add_argument("input")
    parser.add_argument("--output", default=None)
    args = parser.parse_args(argv)
    result = export_file(args.input, args.output)
    if args.output is None:
        print(json.dumps(result))
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
