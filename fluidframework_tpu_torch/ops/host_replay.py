"""Scalar host replay of encoded op streams — the kernel's pure-Python
twin over the SAME numeric encoding. A copy of the reference's
``ops/host_replay.py``, code unchanged.

One document's ops (``host_bridge.DocStream.ops`` entries) apply one by
one; the output dict is shaped exactly like one doc of ``fetch(table)``,
so ``extract_text`` / ``extract_signature`` / ``matrix_bridge.
_visible_handles`` read it unchanged. Semantics mirror
``merge_step.fused_step`` (the scan and the window kernel); the tests
hold it against the port's scan and the reference's replay, and it is
the host oracle of the matrix plane's axes.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .segment_table import (
    KIND_ANNOTATE,
    KIND_INSERT,
    KIND_NOOP,
    KIND_REMOVE,
    NOT_REMOVED,
    PROP_CHANNELS,
)


@dataclass
class _Slot:
    length: int = 0
    seq: int = 0
    client: int = 0
    removed_seq: int = int(NOT_REMOVED)
    removers: int = 0
    op_id: int = 0
    op_off: int = 0
    is_marker: int = 0
    prop: list = field(default_factory=lambda: [0] * PROP_CHANNELS)


class HostDocReplay:
    """One document's segment state, applied op-by-op from encoded
    dicts (host_bridge.DocStream.ops entries)."""

    def __init__(self) -> None:
        self.slots: list[_Slot] = []
        self.min_seq = 0
        self._ops_since_compact = 0

    # -- visibility (merge_kernel._views) ------------------------------

    def _below_window(self, s: _Slot) -> bool:
        return s.removed_seq != NOT_REMOVED and s.removed_seq <= self.min_seq

    def _visible(self, s: _Slot, refseq: int, client: int) -> bool:
        if self._below_window(s):
            return False
        if not (s.seq <= refseq or s.client == client):
            return False
        if s.removed_seq != NOT_REMOVED and (
            s.removed_seq <= refseq or (s.removers >> (client & 31)) & 1
        ):
            return False
        return True

    # -- structure -----------------------------------------------------

    def _split(self, i: int, off: int) -> None:
        s = self.slots[i]
        tail = _Slot(
            length=s.length - off, seq=s.seq, client=s.client,
            removed_seq=s.removed_seq, removers=s.removers,
            op_id=s.op_id, op_off=s.op_off + off,
            is_marker=s.is_marker, prop=list(s.prop),
        )
        s.length = off
        self.slots.insert(i + 1, tail)

    def _insert(self, op: dict) -> None:
        p1, refseq, client = op["pos1"], op["refseq"], op["client"]
        E = 0
        idx, off = len(self.slots), 0
        for i, s in enumerate(self.slots):
            if self._below_window(s):
                continue  # not stop-eligible
            vlen = s.length if self._visible(s, refseq, client) else 0
            if E == p1 or (E <= p1 < E + vlen):
                idx, off = i, p1 - E
                break
            E += vlen
        else:
            if p1 > E:
                return  # beyond total: invalid op
        if off > 0:
            self._split(idx, off)
            idx += 1
        self.slots.insert(idx, _Slot(
            length=op["length"], seq=op["seq"], client=client,
            op_id=op["op_id"], is_marker=op["is_marker"],
        ))

    def _boundary(self, p: int, refseq: int, client: int) -> None:
        E = 0
        for i, s in enumerate(self.slots):
            if self._below_window(s):
                continue
            vlen = s.length if self._visible(s, refseq, client) else 0
            if E < p < E + vlen:
                self._split(i, p - E)
                return
            E += vlen
            if E >= p:
                return

    def _range_stamp(self, op: dict) -> None:
        p1, p2 = op["pos1"], op["pos2"]
        refseq, client = op["refseq"], op["client"]
        self._boundary(p1, refseq, client)
        self._boundary(p2, refseq, client)
        E = 0
        for s in self.slots:
            if self._below_window(s):
                continue
            vlen = s.length if self._visible(s, refseq, client) else 0
            if vlen > 0 and E >= p1 and E + vlen <= p2:
                if op["kind"] == KIND_REMOVE:
                    if s.removed_seq == NOT_REMOVED:
                        s.removed_seq = op["seq"]
                    s.removers |= 1 << (client & 31)
                else:
                    s.prop[op["prop_key"]] = op["prop_val"]
            E += vlen
            if E >= p2:
                break

    def _compact(self) -> None:
        self.slots = [
            s for s in self.slots
            if not (s.removed_seq != NOT_REMOVED
                    and s.removed_seq <= self.min_seq)
        ]

    # -- public --------------------------------------------------------

    def apply(self, op: dict) -> None:
        kind = op["kind"]
        if kind == KIND_INSERT:
            self._insert(op)
        elif kind in (KIND_REMOVE, KIND_ANNOTATE):
            self._range_stamp(op)
        elif kind != KIND_NOOP:  # pragma: no cover - forward compat
            raise ValueError(f"unknown kind {kind}")
        if op["min_seq"] > self.min_seq:
            self.min_seq = op["min_seq"]
        self._ops_since_compact += 1
        if self._ops_since_compact >= 64:
            self._ops_since_compact = 0
            self._compact()

    def as_table(self) -> dict[str, np.ndarray]:
        """One-doc dict shaped like ``fetch(table)`` (doc index 0)."""
        n = len(self.slots)

        def col(name):
            return np.array(
                [[getattr(s, name) for s in self.slots]], np.int64
            )

        return {
            "length": col("length"),
            "seq": col("seq"),
            "client": col("client"),
            "removed_seq": col("removed_seq"),
            "removers": col("removers"),
            "op_id": col("op_id"),
            "op_off": col("op_off"),
            "is_marker": col("is_marker"),
            "prop": np.array([[s.prop for s in self.slots]], np.int64),
            "count": np.array([n], np.int64),
            "min_seq": np.array([self.min_seq], np.int64),
            "overflow": np.zeros((1,), np.int64),
        }


def replay_encoded(ops: list[dict]) -> HostDocReplay:
    doc = HostDocReplay()
    for op in ops:
        doc.apply(op)
    return doc
