"""Host <-> device bridge for the merge kernel.

Encoding: turns sequenced message streams (SequencedMessage with
merge-tree op contents) into padded ``[docs, window]`` numpy op arrays;
text payloads stay host-side keyed by op_id (SURVEY §7: the device
resolves positions, the host splices text). ``convert.batch_from_numpy``
moves packed arrays onto a device.

Extraction: materializes text / property signatures from a fetched
segment table (numpy, see ``fetch``).

Everything here is numpy on the host; only ``fetch`` touches a tensor.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np

from ..convert import table_to_numpy
from ..models.mergetree.ops import DeltaType
from ..protocol.messages import MessageType, SequencedMessage
from .bucket_ladder import BucketLadder
from .segment_table import (
    KIND_ANNOTATE,
    KIND_INSERT,
    KIND_NOOP,
    KIND_REMOVE,
    MAX_CLIENTS,
    NOT_REMOVED,
    OPOFF_BOUND,
    OpBatch,
    PROP_CHANNELS,
    SegmentTable,
)

OP_FIELDS = (
    "kind", "pos1", "pos2", "seq", "refseq", "client",
    "op_id", "length", "is_marker", "prop_key", "prop_val", "min_seq",
)


@dataclass
class DocStream:
    """One document's encoded op stream + payload table."""

    ops: list[dict] = field(default_factory=list)
    payloads: list[str] = field(default_factory=list)
    client_ids: dict[str, int] = field(default_factory=dict)
    prop_keys: dict[str, int] = field(default_factory=dict)
    prop_vals: dict[Any, int] = field(default_factory=dict)

    def intern_client(self, long_id: str) -> int:
        if long_id not in self.client_ids:
            if len(self.client_ids) >= MAX_CLIENTS:
                # the removers bitmask is MAX_CLIENTS wide; a 33rd
                # client would shift out of range. Raising here routes
                # the doc to the sidecar's host eviction path, same as
                # property-channel overflow.
                raise ValueError(
                    f"more than {MAX_CLIENTS} clients in one document"
                )
            self.client_ids[long_id] = len(self.client_ids)
        return self.client_ids[long_id]

    def intern_prop(self, key: str, value: Any) -> tuple[int, int]:
        if key not in self.prop_keys:
            if len(self.prop_keys) >= PROP_CHANNELS:
                raise ValueError(
                    f"more than {PROP_CHANNELS} property channels"
                )
            self.prop_keys[key] = len(self.prop_keys)
        if value is None:
            vid = 0  # deletion
        else:
            if value not in self.prop_vals:
                self.prop_vals[value] = len(self.prop_vals) + 1
            vid = self.prop_vals[value]
        return self.prop_keys[key], vid

    def add_message(self, msg: SequencedMessage) -> None:
        if msg.type != MessageType.OPERATION:
            self.add_noop(msg.minimum_sequence_number)
            return
        self._add_op(msg.contents, msg)

    def add_noop(self, min_seq: int) -> None:
        # NOT coalesced here: the sidecar ships ops incrementally
        # (stream.ops[before:]), so mutating an already-dispatched noop
        # in place would silently drop idle-heartbeat min_seq advances.
        # Consumers coalesce at pack time instead
        # (build_batch, sidecar._dispatch), where it is safe.
        self.ops.append(dict(
            kind=KIND_NOOP, pos1=0, pos2=0, seq=0, refseq=0, client=0,
            op_id=0, length=0, is_marker=0, prop_key=0, prop_val=0,
            min_seq=min_seq,
        ))

    def _add_op(self, op, msg: SequencedMessage) -> None:
        base = dict(
            seq=msg.sequence_number,
            refseq=msg.reference_sequence_number,
            client=self.intern_client(msg.client_id),
            min_seq=msg.minimum_sequence_number,
            op_id=0, length=0, is_marker=0,
            prop_key=0, prop_val=0, pos2=0,
        )
        if op.type == DeltaType.GROUP:
            for sub in op.ops:
                self._add_op(sub, msg)
            return
        if op.type == DeltaType.INSERT:
            is_marker = op.text is None
            payload = "" if is_marker else op.text
            length = 1 if is_marker else len(payload)
            if length >= OPOFF_BOUND:
                # one op's payload bounds the op_off composite the
                # kernel's fused reduce packs; the op-splitter upstream
                # chunks payloads this large long before they reach a
                # device window
                raise ValueError(
                    f"insert payload {length} exceeds device bound "
                    f"{OPOFF_BOUND}"
                )
            self.ops.append(dict(
                base, kind=KIND_INSERT, pos1=op.pos1,
                op_id=len(self.payloads),
                length=length,
                is_marker=int(is_marker),
            ))
            self.payloads.append(payload)
            # Insert-time properties (insert(..., props=) /
            # segmentPropertiesManager.ts:29): lower to synthetic
            # ANNOTATEs at the same (seq, refseq, client) covering the
            # new content — in the sender's view it occupies exactly
            # [pos1, pos1+length), and sequenced-order LWW then matches
            # the oracle (later annotates still override).
            for key, value in (getattr(op, "props", None) or {}).items():
                if value is None:
                    continue  # deleting an unset key is a no-op
                k, v = self.intern_prop(key, value)
                self.ops.append(dict(
                    base, kind=KIND_ANNOTATE, pos1=op.pos1,
                    pos2=op.pos1 + length, prop_key=k, prop_val=v,
                ))
        elif op.type == DeltaType.REMOVE:
            self.ops.append(dict(
                base, kind=KIND_REMOVE, pos1=op.pos1, pos2=op.pos2,
            ))
        elif op.type == DeltaType.ANNOTATE:
            for key, value in op.props.items():
                k, v = self.intern_prop(key, value)
                self.ops.append(dict(
                    base, kind=KIND_ANNOTATE, pos1=op.pos1, pos2=op.pos2,
                    prop_key=k, prop_val=v,
                ))
        else:
            raise ValueError(f"unknown op type {op.type}")


def encode_stream(messages: list[SequencedMessage]) -> DocStream:
    stream = DocStream()
    for msg in messages:
        stream.add_message(msg)
    return stream


def decode_stream(stream: DocStream) -> list[SequencedMessage]:
    """Reconstruct sequenced messages from an encoded stream — the
    inverse of ``encode_stream`` up to op-level equivalence (GROUP ops
    come back as groups of their flattened parts; insert-time props come
    back as a same-seq annotate inside the group, which is LWW-identical
    in sequenced order; marker refTypes are not round-tripped — the
    encoding never held them, and text/signature reads don't consume
    them).

    This makes the encoded stream the single canonical per-doc history:
    the sidecar's eviction path replays it through the scalar oracle
    instead of retaining a duplicate raw-message log."""
    from ..models.mergetree.ops import (
        AnnotateOp,
        GroupOp,
        InsertOp,
        RemoveOp,
    )

    inv_clients = {v: k for k, v in stream.client_ids.items()}
    inv_keys = {v: k for k, v in stream.prop_keys.items()}
    inv_vals = {v: k for k, v in stream.prop_vals.items()}

    def decode_op(op: dict):
        if op["kind"] == KIND_INSERT:
            if op["is_marker"]:
                return InsertOp(pos1=op["pos1"], marker={"refType": 0})
            return InsertOp(
                pos1=op["pos1"], text=stream.payloads[op["op_id"]]
            )
        if op["kind"] == KIND_REMOVE:
            return RemoveOp(pos1=op["pos1"], pos2=op["pos2"])
        key = inv_keys[op["prop_key"]]
        val = None if op["prop_val"] == 0 else inv_vals[op["prop_val"]]
        return AnnotateOp(pos1=op["pos1"], pos2=op["pos2"],
                          props={key: val})

    out: list[SequencedMessage] = []
    i = 0
    while i < len(stream.ops):
        op = stream.ops[i]
        if op["kind"] == KIND_NOOP:
            out.append(SequencedMessage(
                client_id=None, sequence_number=0,
                minimum_sequence_number=op["min_seq"],
                client_sequence_number=0, reference_sequence_number=0,
                type=MessageType.NO_OP, contents=None,
            ))
            i += 1
            continue
        # fold the flattened run sharing one (seq, client) back into
        # a single sequenced message (GROUP / insert-time props)
        j = i + 1
        while (
            j < len(stream.ops)
            and stream.ops[j]["kind"] != KIND_NOOP
            and stream.ops[j]["seq"] == op["seq"]
            and stream.ops[j]["client"] == op["client"]
        ):
            j += 1
        parts = [decode_op(o) for o in stream.ops[i:j]]
        contents = parts[0] if len(parts) == 1 else GroupOp(ops=parts)
        out.append(SequencedMessage(
            client_id=inv_clients[op["client"]],
            sequence_number=op["seq"],
            minimum_sequence_number=op["min_seq"],
            client_sequence_number=0,
            reference_sequence_number=op["refseq"],
            type=MessageType.OPERATION, contents=contents,
        ))
        i = j
    return out


def coalesce_noops(ops: list[dict]) -> list[dict]:
    """Collapse runs of consecutive noops to one carrying the max
    min_seq — only the window floor matters, and cell/system-heavy
    streams would otherwise pad every doc's window. Pack-time only:
    the source stream stays faithful for incremental consumers."""
    out: list[dict] = []
    for op in ops:
        if (
            op["kind"] == KIND_NOOP and out
            and out[-1]["kind"] == KIND_NOOP
        ):
            if op["min_seq"] > out[-1]["min_seq"]:
                out[-1] = dict(out[-1], min_seq=op["min_seq"])
            continue
        out.append(op)
    return out


def lower_columns(cols: dict, *, seq0: int, client: int,
                  min_seq=0) -> tuple[np.ndarray, list[str]]:
    """Vectorized lowering of a VALIDATED columnar batch
    (the wire layer's ``validate_columns`` first — this function
    slices, it does not re-check) into one ``[n, len(OP_FIELDS)]``
    int32 row block plus its payload slices — the zero-per-op twin of
    ``DocStream._add_op`` for the columnar subset (plain INSERT /
    REMOVE from one client, contiguous seqs ``seq0..seq0+n-1``, the
    shape an atomically-ticketed batch sequences as). The block's
    column order IS ``OP_FIELDS``; ``pack_rows`` accepts such blocks
    directly and degrades to array concatenation. ``min_seq`` may be
    a scalar or a per-op array; ``op_id`` is LOCAL (0-based per
    insert) — callers appending to an existing stream offset it by
    their payload count."""
    n = cols["n"]
    kind = np.asarray(cols["kind"], np.int32)
    off = np.asarray(cols["text_off"], np.int64)
    length = (off[1:] - off[:-1]).astype(np.int32)
    if int(length.max(initial=0)) >= OPOFF_BOUND:
        # parity with DocStream._add_op: one op's payload bounds the
        # op_off composite the kernel's fused reduce packs
        raise ValueError(
            f"insert payload {int(length.max())} exceeds device "
            f"bound {OPOFF_BOUND}"
        )
    is_ins = kind == KIND_INSERT
    block = np.zeros((n, len(OP_FIELDS)), np.int32)
    block[:, OP_FIELDS.index("kind")] = kind
    block[:, OP_FIELDS.index("pos1")] = cols["pos1"]
    block[:, OP_FIELDS.index("pos2")] = cols["pos2"]
    block[:, OP_FIELDS.index("seq")] = seq0 + np.arange(
        n, dtype=np.int32)
    block[:, OP_FIELDS.index("refseq")] = cols["refseq"]
    block[:, OP_FIELDS.index("client")] = client
    # inserts number their payloads in batch order (cumsum is the
    # vectorized running len(payloads))
    block[:, OP_FIELDS.index("op_id")] = np.where(
        is_ins, np.cumsum(is_ins) - 1, 0
    ).astype(np.int32)
    block[:, OP_FIELDS.index("length")] = np.where(is_ins, length, 0)
    block[:, OP_FIELDS.index("min_seq")] = min_seq
    text = cols["text"]
    payloads = [
        text[off[i]:off[i + 1]] for i in range(n) if is_ins[i]
    ]
    return block, payloads


def pack_rows(n_rows: int, ops_by_row: dict,
              bucket_floor: int = 16) -> dict:
    """Pack per-row op lists into padded [n_rows, bucket] arrays with
    power-of-two window bucketing — THE op-packing recipe (one
    definition, so the fill/bucket policy cannot drift).

    Vectorized: one fromiter pass builds a [total_ops, n_fields]
    matrix, then one fancy-index scatter per field lands it — no
    per-op per-field Python loop (the old quadratic-ish host cost on
    the serving path).

    COLUMNAR FAST PATH: a row's value may be a ``[k, len(OP_FIELDS)]``
    int32 block (``lower_columns``) instead of a list of op dicts —
    then this degrades to array concatenation with zero per-op Python,
    which is the whole point of the wire-1.3 columnar ingress."""
    window = max((len(v) for v in ops_by_row.values()), default=0)
    bucket = BucketLadder(window_floor=bucket_floor).window_bucket(window)
    arrays = {f: np.zeros((n_rows, bucket), np.int32)
              for f in OP_FIELDS}
    arrays["kind"][:] = KIND_NOOP
    items = [(row, ops) for row, ops in ops_by_row.items()
             if len(ops)]
    if not items:
        return arrays
    lens = np.array([len(ops) for _, ops in items], np.int64)
    total = int(lens.sum())
    row_idx = np.repeat(np.array([r for r, _ in items], np.int64), lens)
    starts = np.cumsum(lens) - lens
    col_idx = np.arange(total, dtype=np.int64) - np.repeat(starts, lens)
    n_fields = len(OP_FIELDS)
    if any(isinstance(ops, np.ndarray) for _, ops in items):
        blocks = []
        for _, ops in items:
            if isinstance(ops, np.ndarray):
                assert ops.ndim == 2 and ops.shape[1] == n_fields, \
                    f"columnar block must be [k, {n_fields}]"
                blocks.append(ops.astype(np.int32, copy=False))
            else:
                blocks.append(np.fromiter(
                    (op[f] for op in ops for f in OP_FIELDS),
                    np.int32, count=len(ops) * n_fields,
                ).reshape(len(ops), n_fields))
        flat = (np.concatenate(blocks, axis=0)
                if len(blocks) > 1 else blocks[0])
    else:
        flat = np.fromiter(
            (op[f] for _, ops in items for op in ops
             for f in OP_FIELDS),
            np.int32, count=total * n_fields,
        ).reshape(total, n_fields)
    dst = row_idx * bucket + col_idx
    for j, f in enumerate(OP_FIELDS):
        arrays[f].reshape(-1)[dst] = flat[:, j]
    return arrays


def build_batch(streams: list[DocStream],
                window: Optional[int] = None) -> OpBatch:
    """Pack per-doc streams into [docs, window] OpBatch numpy arrays,
    padded with NOOPs (consecutive noops coalesced)."""
    packed = [coalesce_noops(s.ops) for s in streams]
    window = window or max(len(p) for p in packed)
    docs = len(streams)
    arrays = {f: np.zeros((docs, window), np.int32) for f in OP_FIELDS}
    arrays["kind"][:] = KIND_NOOP
    for d, ops in enumerate(packed):
        n = len(ops)
        if n > window:
            raise ValueError(
                f"doc {d}: {n} ops exceed window {window}"
            )
        # columnar fill (C-speed fromiter per field, not a Python loop
        # per element): packing sits on the serving hot path
        for f in OP_FIELDS:
            arrays[f][d, :n] = np.fromiter(
                (op[f] for op in ops), np.int32, n
            )
    return OpBatch(**arrays)


def fetch(table: SegmentTable) -> dict[str, np.ndarray]:
    """Copy a segment table to host numpy (one device->host read per
    field; ``removers`` comes back as the reference's uint32)."""
    return table_to_numpy(table)


def extract_text(table_np: dict[str, np.ndarray], stream: DocStream,
                 doc: int) -> str:
    """Tip-view text of one document (removed slots excluded, markers
    skipped)."""
    parts = []
    count = int(table_np["count"][doc])
    for i in range(count):
        if table_np["removed_seq"][doc, i] != NOT_REMOVED:
            continue
        if table_np["is_marker"][doc, i]:
            continue
        op_id = int(table_np["op_id"][doc, i])
        off = int(table_np["op_off"][doc, i])
        length = int(table_np["length"][doc, i])
        parts.append(stream.payloads[op_id][off:off + length])
    return "".join(parts)


def interned_signature(client, enc: DocStream) -> tuple:
    """Per-position (char|"M", interned-props) signature of a scalar
    ``MergeTreeClient``'s tip view, interning props through ``enc``'s
    tables so it compares equal to ``extract_signature`` of the device
    table fed from the same encoder. Unseen VALUES are interned at read
    time (the value table is unbounded); keys beyond ``PROP_CHANNELS``
    are inexpressible on device and are skipped on both sides."""
    tree = client.mergetree
    out = []
    for seg in tree.segments:
        length = tree._length_at(
            seg, tree.collab.current_seq, tree.collab.client_id
        )
        if not length:
            continue
        props = [0] * PROP_CHANNELS
        for key, value in (seg.props or {}).items():
            if value is None:
                continue
            try:
                k, v = enc.intern_prop(key, value)
            except ValueError:
                continue  # key channel overflow: dropped device-side too
            props[k] = v
        entry = tuple(props)
        if seg.is_marker:
            out.append(("M", entry))
        else:
            out.extend((ch, entry) for ch in seg.text)
    return tuple(out)


def extract_signature(table_np: dict[str, np.ndarray], stream: DocStream,
                      doc: int) -> tuple:
    """Per-position (char, interned-props) signature for differential
    comparison with the scalar oracle."""
    out = []
    count = int(table_np["count"][doc])
    for i in range(count):
        if table_np["removed_seq"][doc, i] != NOT_REMOVED:
            continue
        props = tuple(int(v) for v in table_np["prop"][doc, i])
        if table_np["is_marker"][doc, i]:
            out.append(("M", props))
            continue
        op_id = int(table_np["op_id"][doc, i])
        off = int(table_np["op_off"][doc, i])
        length = int(table_np["length"][doc, i])
        for ch in stream.payloads[op_id][off:off + length]:
            out.append((ch, props))
    return tuple(out)
