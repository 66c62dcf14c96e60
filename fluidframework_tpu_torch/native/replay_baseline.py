"""Python face of the C++ scalar merge replayer (merge_replay.cpp).

Used by bench.py as the compiled-language baseline (the stand-in for
the reference's Node.js merge-tree — no Node runtime exists in this
image) and by tests as a third differential implementation next to the
Python oracle and the batched kernel.
"""
from __future__ import annotations

import ctypes
import time
from typing import Optional

import numpy as np

from ..ops.host_bridge import OP_FIELDS, DocStream
from ..ops.segment_table import NOT_REMOVED
from . import load_merge_replay

_MASK = (1 << 64) - 1


def encode_ops_array(stream: DocStream) -> np.ndarray:
    """[n_ops, 12] int32 row-major in OP_FIELDS order."""
    arr = np.zeros((len(stream.ops), len(OP_FIELDS)), np.int32)
    for i, op in enumerate(stream.ops):
        for j, f in enumerate(OP_FIELDS):
            arr[i, j] = op[f]
    return np.ascontiguousarray(arr)


def replay(ops_arr: np.ndarray, reps: int = 1
           ) -> Optional[tuple[int, int, float]]:
    """Replay one doc's stream ``reps`` times in C++; returns
    (checksum, live_chars, wall_seconds) or None if the native lib is
    unavailable."""
    lib = load_merge_replay()
    if lib is None:
        return None
    checksum = ctypes.c_uint64(0)
    live = ctypes.c_int64(0)
    ptr = ops_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    t0 = time.perf_counter()
    lib.merge_replay(ptr, ops_arr.shape[0], reps,
                     ctypes.byref(checksum), ctypes.byref(live))
    dt = time.perf_counter() - t0
    return checksum.value, live.value, dt


def table_checksum(table_np: dict[str, np.ndarray], doc: int) -> int:
    """FNV-1a per-character checksum of one doc's tip view from a
    fetched kernel table — bit-identical to merge_replay.cpp's
    Doc::checksum for parity assertions."""
    h = 1469598103934665603

    def mix(v: int, h: int) -> int:
        v &= _MASK  # two's-complement view of negatives
        for b in range(8):
            h ^= (v >> (8 * b)) & 0xFF
            h = (h * 1099511628211) & _MASK
        return h

    count = int(table_np["count"][doc])
    for i in range(count):
        if table_np["removed_seq"][doc, i] != NOT_REMOVED:
            continue
        op_id = int(table_np["op_id"][doc, i])
        op_off = int(table_np["op_off"][doc, i])
        is_marker = int(table_np["is_marker"][doc, i])
        props = [int(v) for v in table_np["prop"][doc, i]]
        for c in range(int(table_np["length"][doc, i])):
            h = mix(op_id, h)
            h = mix(op_off + c, h)
            h = mix(is_marker, h)
            for p in props:
                h = mix(p, h)
    return h


class MergeHostSession:
    """Incremental multi-document merge state in C++ — the host
    serving tier the full-service pipeline routes through on hosts
    without an accelerator (the device path is the CUDA window kernel;
    the sidecar evicts cold docs to these same engines).

    Rows must be fed in sequenced order per document; each round is
    one ``apply(rows, doc_of_row)`` call with row-major
    ``[n_rows, 12]`` int32 (OP_FIELDS order).
    """

    def __init__(self, n_docs: int):
        lib = load_merge_replay()
        if lib is None:
            raise RuntimeError("native merge tier unavailable")
        self._lib = lib
        self._h = lib.merge_session_create(n_docs)
        self.n_docs = n_docs

    def apply(self, rows: np.ndarray, doc_of_row: np.ndarray) -> None:
        assert rows.ndim == 2 and rows.shape[1] == len(OP_FIELDS)
        rows = np.ascontiguousarray(rows, np.int32)
        doc_of_row = np.ascontiguousarray(doc_of_row, np.int32)
        assert rows.shape[0] == doc_of_row.shape[0]
        if doc_of_row.size:
            # bounds-check HERE: C++ indexes s->docs[doc] unchecked,
            # so a bad index would be heap corruption, not an error
            lo, hi = int(doc_of_row.min()), int(doc_of_row.max())
            assert 0 <= lo and hi < self.n_docs, (
                f"doc_of_row out of range [{lo},{hi}] "
                f"for {self.n_docs} docs"
            )
        self._lib.merge_session_apply(
            self._h,
            rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            doc_of_row.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            rows.shape[0],
        )

    def stats(self, doc: int) -> tuple[int, int]:
        """(checksum, live_chars) of one doc's tip view."""
        checksum = ctypes.c_uint64(0)
        live = ctypes.c_int64(0)
        self._lib.merge_session_stats(
            self._h, doc, ctypes.byref(checksum), ctypes.byref(live)
        )
        return checksum.value, live.value

    def text(self, doc: int, stream: DocStream) -> str:
        """Tip-view text via (op_id, op_off, length) triples — same
        reconstruction as host_bridge.extract_text."""
        cap = 256
        while True:
            out = np.zeros((cap, 3), np.int32)
            n = self._lib.merge_session_segs(
                self._h, doc,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                cap,
            )
            if n <= cap:
                break
            cap = int(n)
        parts = []
        for op_id, off, length in out[:n]:
            parts.append(
                stream.payloads[int(op_id)][int(off):int(off) + int(length)]
            )
        return "".join(parts)

    def close(self) -> None:
        if self._h is not None:
            self._lib.merge_session_destroy(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover - GC ordering
        try:
            self.close()
        except Exception:
            pass
