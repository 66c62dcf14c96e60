"""Seeded SharedMatrix traffic at bench config3's shapes: N matrices,
each a sequentially consistent stream (refseq = seq - 1) of row-run
inserts, column inserts, single-row removes and cell writes (the
reference's ``bench.py`` ``stage_config3``, its stream builder copied
with the seed made an argument)."""
from __future__ import annotations

import random
from dataclasses import dataclass

from ..models.mergetree.ops import InsertOp, RemoveOp
from ..ops.matrix_bridge import MatrixStream
from ..protocol.messages import MessageType, SequencedMessage


@dataclass(frozen=True)
class MatrixConfig:
    """One config3 scale: per matrix ``row_runs`` inserts of ``run_len``
    rows, ``cols`` single-column inserts, ``removes`` one-row removes
    and ``cells`` cell writes; ``capacity`` is the axis table's."""

    matrices: int
    row_runs: int
    run_len: int
    cols: int
    cells: int
    removes: int
    capacity: int

    @property
    def rows(self) -> int:
        """The row handle space: every row ever inserted."""
        return self.row_runs * self.run_len


MATRIX_SCALES = {
    "full": MatrixConfig(64, 205, 50, 16, 4000, 60, 1024),
    "cpu": MatrixConfig(8, 40, 25, 8, 800, 20, 256),
    "smoke": MatrixConfig(2, 10, 10, 4, 100, 5, 128),
}


def matrix_messages(scale: str = "full", seed: int = 1337) -> list:
    """Each matrix's inner sequenced messages (contents ``{"target":
    "rows" | "cols" | "cell", ...}``), in config3's order: row runs at
    random positions, columns, row removes, cell writes to random
    (row, column) handles. One generator over all matrices, as the
    bench draws them."""
    cfg = MATRIX_SCALES[scale]
    rng = random.Random(seed)

    def build(m: int) -> list:
        out = []

        def send(contents):
            seq = len(out) + 1
            out.append(SequencedMessage(
                client_id="w", sequence_number=seq,
                minimum_sequence_number=max(0, seq - 1),
                client_sequence_number=seq,
                reference_sequence_number=seq - 1,
                type=MessageType.OPERATION, contents=contents,
            ))

        n_rows = 0
        for alloc in range(cfg.row_runs):
            send({"target": "rows", "op": InsertOp(
                pos1=rng.randint(0, n_rows),
                text="\x00" * cfg.run_len,
                handle=[f"w/{m}/{alloc}", 0],
            )})
            n_rows += cfg.run_len
        for c in range(cfg.cols):
            send({"target": "cols", "op": InsertOp(
                pos1=rng.randint(0, c), text="\x00",
                handle=[f"w/{m}/c{c}", 0],
            )})
        for _ in range(cfg.removes):
            start = rng.randint(0, n_rows - 2)
            send({"target": "rows", "op": RemoveOp(
                pos1=start, pos2=start + 1)})
            n_rows -= 1
        for _ in range(cfg.cells):
            send({
                "target": "cell",
                "row": f"w/{m}/{rng.randint(0, cfg.row_runs - 1)}:"
                       f"{rng.randint(0, cfg.run_len - 1)}",
                "col": f"w/{m}/c{rng.randint(0, cfg.cols - 1)}:0",
                "value": rng.randint(0, 9999),
            })
        return out

    return [build(m) for m in range(cfg.matrices)]


def record_matrix_streams(scale: str = "full", seed: int = 1337) -> tuple:
    """(config, one encoded ``MatrixStream`` per matrix) of
    ``matrix_messages(scale, seed)``."""
    streams = []
    for msgs in matrix_messages(scale, seed):
        ms = MatrixStream()
        for msg in msgs:
            ms.add_message(msg)
        streams.append(ms)
    return MATRIX_SCALES[scale], streams
