"""The control of ``correct``: the program with one guarantee that the
configurations state broken, a stale msn. Its lane stamps every message
of a round with the msn its document had when the round began (the
step a later change that stamps msn once a round would take), and runs
through ``cell.run`` in the program's place, so the numbers it reads
are the harness's own, over the kept batches of a window at the cell's
size and load.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \\
        --seconds 10

prints one JSON line per seed with the run's ``checks`` and
``correct``. The benchmark's own runs never run it.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import cell as cells  # noqa: E402
from portbench import harness  # noqa: E402


class StaleMsn(harness.Lane):
    """The program's ticket, each document's msn then held at its value
    when the round began (0, the msn after the joins, in a batch's first
    round)."""

    def open(self):
        self._msn0 = np.zeros(self.docs, np.int64)
        return super().open()

    def ticket(self, seqs, rd: dict) -> tuple:
        seq, msn, status = super().ticket(seqs, rd)
        n = np.diff(rd["doc_start"])
        stale = np.repeat(self._msn0, n)
        has = n > 0
        self._msn0[has] = msn[rd["doc_start"][1:][has] - 1]
        return seq, stale, status


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    root = Path(__file__).resolve().parent.parent
    cell = cells.load_cell(root, args.workload)
    import torch

    device = "cuda" if torch.cuda.is_available() else "cpu"
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        out = cells.run(cell, seed, args.seconds, False, device, t,
                        lane_cls=StaleMsn, workers=4)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "device": device, "correct": out["correct"],
                          "checks": out["checks"],
                          "batches": out["host_ms"]["batches"],
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
