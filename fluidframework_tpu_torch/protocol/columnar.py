"""Columnar SoA encoding for ``submitOp`` batches (wire 1.3).

The row-path boxcar (wire 1.2, ``ops``) ships one JSON object per op
and the service re-interprets every one: per-op dict walk in
``document_message_from_json``, per-op ``encode_contents`` descent,
per-op dict build in ``DocStream._add_op``, per-op field extraction in
``pack_rows``. The columnar variant (``cols``) ships the batch as the
COLUMN LAYOUT itself — parallel arrays of client_sequence_number /
reference_sequence_number / kind / positions plus one shared payload
string with an offsets column — so the service validates shapes once,
slices columns, and the pack stage degrades to array concatenation
(``host_bridge.lower_columns`` + the block fast path in ``pack_rows``).
Single-sourced sequencing (arXiv 1007.5093) is what makes this safe:
the batch is interpreted exactly once, at the sequencer boundary,
never re-derived per hop.

Scope: a columnar batch carries plain text INSERTs and REMOVEs from
one client — the hot-path op mix. Anything else (markers, props,
annotate, group, traces, non-batch metadata) is inexpressible and the
encoder returns None, which routes the batch down the wire-1.2 row
boxcar unchanged. That keeps this codec total: every frame it emits
decodes bit-faithfully (``decode_columns`` is the compatibility
inverse), and everything it cannot express still has a wire form.

The codec is the ONE definition of the column layout: the driver
encodes through it, ingress validates/decodes through it, wirecheck's
schema registry names its fields, and wiresan's payload descent walks
them. Pure stdlib on purpose — the protocol layer stays importable
without numpy; the array view lives in ``ops/host_bridge``.
"""
from __future__ import annotations

from typing import Any, Optional

from .constants import batch_flag, mark_batch
from .messages import DocumentMessage, MessageType

__all__ = [
    "COLUMNS",
    "INT_COLUMNS",
    "encode_columns",
    "validate_columns",
    "decode_columns",
]

# Column names, in wire order. "csn"/"refseq" are per-op sequencing
# inputs; "kind" is the DeltaType int (INSERT=0 / REMOVE=1 only);
# "pos1"/"pos2" are merge-tree positions (pos2 unused by inserts);
# "text_off" has n+1 monotone offsets into the shared "text" payload
# (op i's payload = text[text_off[i]:text_off[i+1]]; removes span 0).
INT_COLUMNS = ("csn", "refseq", "kind", "pos1", "pos2")
COLUMNS = INT_COLUMNS + ("text_off",)

_KIND_INSERT = 0  # DeltaType.INSERT — literal: this module cannot
_KIND_REMOVE = 1  # import models (protocol is the bottom layer)


def _canonical_batch_mark(op: DocumentMessage, i: int, n: int) -> bool:
    """True iff the op's metadata is exactly what ``decode_columns``
    reconstructs at position ``i`` of ``n``: the batchManager.ts marks
    (first {batch: true}, last {batch: false}, singletons/middles
    unmarked). The marks are positional in the column layout, so only
    the canonical pattern round-trips bit-faithfully; anything else is
    inexpressible and falls back to the row boxcar."""
    flag = batch_flag(op.metadata)
    if op.metadata is not None and not (
        isinstance(op.metadata, dict) and set(op.metadata) == {"batch"}
    ):
        return False
    if n > 1 and i == 0:
        return flag is True
    if n > 1 and i == n - 1:
        return flag is False
    return op.metadata is None


def encode_columns(ops: list[DocumentMessage]) -> Optional[dict]:
    """Encode a batch as the columnar ``cols`` payload, or None if any
    member is outside the columnar subset (caller falls back to the
    row boxcar). Never raises on shape grounds: inexpressible means
    None, not an error."""
    if not ops:
        return None
    n = len(ops)
    csn, refseq, kind, pos1, pos2, text_off = [], [], [], [], [], [0]
    text_parts: list[str] = []
    for i, op in enumerate(ops):
        if not isinstance(op, DocumentMessage):
            return None
        if op.type != MessageType.OPERATION or op.traces:
            return None
        if not _canonical_batch_mark(op, i, n):
            return None
        c = op.contents
        k = getattr(c, "type", None)
        if k == _KIND_INSERT:
            if c.marker is not None or c.props or c.handle is not None:
                return None
            if not isinstance(c.text, str):
                return None
            text_parts.append(c.text)
            kind.append(_KIND_INSERT)
            pos1.append(int(c.pos1))
            pos2.append(0)
            text_off.append(text_off[-1] + len(c.text))
        elif k == _KIND_REMOVE:
            kind.append(_KIND_REMOVE)
            pos1.append(int(c.pos1))
            pos2.append(int(c.pos2))
            text_off.append(text_off[-1])
        else:
            return None
        csn.append(int(op.client_sequence_number))
        refseq.append(int(op.reference_sequence_number))
    return {
        "n": n,
        "csn": csn, "refseq": refseq, "kind": kind,
        "pos1": pos1, "pos2": pos2,
        "text_off": text_off, "text": "".join(text_parts),
    }


def validate_columns(cols: Any) -> int:
    """Validate a received ``cols`` payload IN FULL, before anything
    slices it — the whole point of the columnar form is that this is
    the only per-batch interpretation pass. Returns the op count.
    Raises ValueError (→ BAD_REQUEST nack at ingress) on any malformed
    column; the error text names the column so a misbehaving client
    can be debugged from its nack."""
    if not isinstance(cols, dict):
        raise ValueError("cols: payload must be an object")
    n = cols.get("n")
    if not isinstance(n, int) or isinstance(n, bool) or n <= 0:
        raise ValueError("cols.n: positive op count required")
    text = cols.get("text")
    if not isinstance(text, str):
        raise ValueError("cols.text: shared payload string required")
    unknown = set(cols) - set(COLUMNS) - {"n", "text"}
    if unknown:
        raise ValueError(f"cols: unknown columns {sorted(unknown)}")
    for name in COLUMNS:
        col = cols.get(name)
        want = n + 1 if name == "text_off" else n
        if not isinstance(col, list) or len(col) != want:
            raise ValueError(
                f"cols.{name}: length-{want} array required"
            )
        if not all(
            isinstance(v, int) and not isinstance(v, bool) and v >= 0
            for v in col
        ):
            raise ValueError(f"cols.{name}: non-negative ints required")
    if any(k not in (_KIND_INSERT, _KIND_REMOVE)
           for k in cols["kind"]):
        raise ValueError("cols.kind: INSERT/REMOVE only")
    off = cols["text_off"]
    if off[0] != 0 or off[-1] != len(text) or any(
        a > b for a, b in zip(off, off[1:])
    ):
        raise ValueError(
            "cols.text_off: monotone offsets covering text required"
        )
    return n


def decode_columns(cols: dict) -> list[DocumentMessage]:
    """Compatibility inverse of ``encode_columns``: reconstruct the
    DocumentMessage batch (batch boundary marks re-derived from
    position). The service's sequencer boundary consumes these; the
    zero-per-op pack path consumes the columns directly via
    ``host_bridge.lower_columns``. Callers must ``validate_columns``
    first."""
    from ..models.mergetree.ops import InsertOp, RemoveOp

    n = cols["n"]
    off = cols["text_off"]
    out = []
    for i in range(n):
        if cols["kind"][i] == _KIND_INSERT:
            contents: Any = InsertOp(
                pos1=cols["pos1"][i],
                text=cols["text"][off[i]:off[i + 1]],
            )
        else:
            contents = RemoveOp(
                pos1=cols["pos1"][i], pos2=cols["pos2"][i]
            )
        metadata = None
        if n > 1 and i == 0:
            metadata = mark_batch(None, True)
        elif n > 1 and i == n - 1:
            metadata = mark_batch(None, False)
        out.append(DocumentMessage(
            client_sequence_number=cols["csn"][i],
            reference_sequence_number=cols["refseq"][i],
            type=MessageType.OPERATION,
            contents=contents,
            metadata=metadata,
        ))
    return out
