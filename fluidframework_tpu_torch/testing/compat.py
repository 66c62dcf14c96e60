"""Stored-format compat matrix — the describeCompat analogue.

Reference: packages/test/test-version-utils (describeCompat.ts /
compatConfig.ts) runs every e2e scenario across version pairings (new
loader + old runtime, old loader + new runtime, ...) by installing
published package versions at runtime. This repo has no published
versions to install, so the axis that CAN drift here — and the one the
reference's snapshot suite (packages/test/snapshots) guards — is the
PERSISTED FORMAT: a summary written by an older writer must load in
the current runtime, collaborate with current-format containers, and
re-summarize forward.

``compat_matrix()`` enumerates writer configurations; ``downgrade_*``
rewrite a current summary into the exact older shape (the committed
golden fixtures in tests/fixtures pin the same thing end-to-end at the
container level).
"""
from __future__ import annotations

import copy
from typing import Any, Callable, Iterator


def downgrade_sharedstring_summary(summary: dict) -> dict:
    """Current chunked format 2 -> format 1 (flat ``segments`` list),
    byte-shape of the pre-chunking writer (models/sharedstring.py
    load_core keeps accepting it)."""
    out = copy.deepcopy(summary)
    chunks = out.pop("chunks", None)
    if chunks is not None:
        out["segments"] = [e for chunk in chunks for e in chunk]
    out.pop("format", None)
    return out


_DOWNGRADES: dict[str, Callable[[dict], dict]] = {
    "sharedstring": downgrade_sharedstring_summary,
}


def downgrade_channel_summary(type_name: str, summary: dict) -> dict:
    """Rewrite one channel's summary to its oldest supported format
    (identity for channels whose format has never changed)."""
    fn = _DOWNGRADES.get(type_name)
    return fn(summary) if fn else copy.deepcopy(summary)


def import_as_fresh_document(summary: dict) -> dict:
    """Rebase a SharedString summary into a NEW document's sequence
    space (the copy/import operation): tombstoned segments drop, every
    surviving segment becomes universally-visible base content
    (seq 0), and the collab window resets. Needed whenever stored
    content boots a document whose service starts from sequence 0 —
    same-document loads keep the original seq space via the op log
    instead (drivers/file_driver.py)."""
    out = copy.deepcopy(summary)
    entries = ([e for chunk in out.get("chunks", []) for e in chunk]
               if "chunks" in out else out.get("segments", []))
    fresh = []
    for e in entries:
        if e.get("removedSeq") is not None:
            continue
        e = dict(e, seq=0, client="", removedClients=[])
        fresh.append(e)
    if "chunks" in out:
        out["chunks"] = [fresh] if fresh else [[]]
    else:
        out["segments"] = fresh
    out["minSeq"] = 0
    out["currentSeq"] = 0
    return out


class CompatConfig:
    def __init__(self, name: str, summary_format: str):
        self.name = name
        self.summary_format = summary_format  # "current" | "legacy"

    def channel_summary(self, type_name: str, summary: dict) -> dict:
        if self.summary_format == "legacy":
            return downgrade_channel_summary(type_name, summary)
        return copy.deepcopy(summary)

    def __repr__(self) -> str:  # pytest id readability
        return self.name


def compat_matrix() -> Iterator[CompatConfig]:
    """The pairings every load/collab scenario should pass
    (compatConfig.ts configList analogue)."""
    yield CompatConfig("current-writer", "current")
    yield CompatConfig("legacy-writer", "legacy")
