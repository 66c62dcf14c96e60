"""Fetch tool: download a document's snapshot + op stream from a
running service into the file-driver format.

Reference: packages/tools/fetch-tool (downloads snapshots/ops from
services for offline debugging/replay). The saved file loads with
``drivers.file_driver.load_document`` and replays through the replay
driver or ``tools/replay_tool``.

Usage:
    python -m fluidframework_tpu_torch.tools.fetch_tool \
        --host 127.0.0.1 --port 7070 --document doc --out doc.json
"""
from __future__ import annotations

import argparse
import sys
from typing import Optional


def fetch(host: str, port: int, document_id: str,
          out_path: str) -> dict:
    from ..drivers.file_driver import save_document
    from ..drivers.socket_driver import SocketDocumentService

    svc = SocketDocumentService(host, port, document_id)
    try:
        summary = svc.get_latest_summary()
        from_seq = summary[0] if summary else 0
        ops = svc.read_ops(from_seq)
        save_document(out_path, document_id, ops, summary)
        return {
            "document_id": document_id,
            "summary_seq": summary[0] if summary else None,
            "ops": len(ops),
            "out": out_path,
        }
    finally:
        svc.close()


def main(argv: Optional[list] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m fluidframework_tpu_torch.tools.fetch_tool")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=7070)
    parser.add_argument("--document", required=True)
    parser.add_argument("--out", required=True)
    args = parser.parse_args(argv)
    report = fetch(args.host, args.port, args.document, args.out)
    print(report)
    return 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
