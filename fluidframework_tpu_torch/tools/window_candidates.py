"""Time variants of the Hopper window kernel side by side on one card.

    python -m fluidframework_tpu_torch.tools.window_candidates \\
        [--seed N] [--set NAME=VALUE ...] [--reference PATH ...]

Each ``--set`` list (comma-separated ``NAME=VALUE`` pairs, e.g.
``THREADS=128,MAIN_MIN_BLOCKS=4``) is one candidate: the committed
``ops/csrc/merge_window.cu`` with those ``constexpr int`` constants
replaced. Each ``--reference`` adds another source file with the same C
interface as it is (an earlier kernel, unpacked from git). The committed
source is always the first candidate.

Every candidate is built with the flags of ``ops/cuda_merge.py`` into
``_build/candidates/``, checked bit for bit against the plain version on
seeded random states, and timed at each shape of ``SHAPES`` in turns
(forward, then backward) with CUDA events around 10 back-to-back
launches: the main shape (4096 documents x capacity 1024) at the window
rungs 16 / 32 / 64, and the capacities 4096 and 8192. Prints the card,
then one line per candidate with its ptxas registers and spills and its
median times. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import re
import statistics
import subprocess
import sys

import numpy as np
import torch

from ..ops import cuda_merge
from ..ops.merge_kernel import apply_window_plain
from ..testing import windows

SHAPES = (  # (docs, capacity, window)
    (4096, 1024, 16), (4096, 1024, 32), (4096, 1024, 64),
    (1024, 4096, 64), (512, 8192, 64),
)


def _source(settings: str) -> str:
    text = cuda_merge.SOURCE.read_text()
    for pair in filter(None, settings.split(",")):
        name, value = pair.split("=")
        text, n = re.subn(rf"constexpr int {name} = [^;]+;",
                          f"constexpr int {name} = {value};", text)
        if n != 1:
            raise ValueError(f"no constant {name} in the kernel source")
    return text


def _build(text: str, tag: str):
    out = cuda_merge.BUILD_DIR / "candidates"
    out.mkdir(parents=True, exist_ok=True)
    src = out / f"{tag}.cu"
    src.write_text(text)
    lib_path = out / f"{tag}.so"
    log = cuda_merge.compile_source(src, lib_path)
    report = [
        f"Q={k['q']}{'' if k['smem'] else ' device memory'}: "
        f"{k['registers']} registers, spills {k['spill_stores']}/"
        f"{k['spill_loads']} B"
        for k in cuda_merge.ptxas_report(log)]
    return cuda_merge.bind(lib_path), report


def _time_ms(lib, table, batch, reps: int, launches: int = 10) -> list:
    """Per-launch times of ``reps`` runs of ``launches`` back-to-back
    launches each (the host's enqueue time hides behind the device's)."""
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(launches):
            cuda_merge.launch(lib, table, batch)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / launches)
    return times


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--set", action="append", default=[],
                    help="NAME=VALUE[,NAME=VALUE] of one candidate")
    ap.add_argument("--reference", action="append", default=[],
                    help="another kernel source, taken as it is")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device")
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)

    cands = [("committed", _source(""))]
    cands += [(s, _source(s)) for s in args.set]
    cands += [(f"reference {p}", open(p).read()) for p in args.reference]
    libs = []
    for i, (name, text) in enumerate(cands):
        lib, report = _build(text, f"c{i}")
        libs.append(lib)
        print(f"[{i}] {name}: " + "; ".join(report), flush=True)

    rng = np.random.default_rng(args.seed + 1)
    times = {(i, s): [] for i in range(len(cands)) for s in SHAPES}
    inputs = {}
    for shape in SHAPES:
        docs, cap, w = shape
        if (docs, cap) not in inputs:
            table = windows.random_table(rng, docs, cap, "cuda")
            inputs = {(docs, cap): (table, windows.random_batch(
                rng, table, max(s[2] for s in SHAPES), "cuda"))}
        table, full = inputs[(docs, cap)]
        batch = type(full)(*(t[:, :w].contiguous() for t in full))
        want = apply_window_plain(table, batch)
        for i, lib in enumerate(libs):
            got = cuda_merge.launch(lib, table, batch)
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(got, want)):
                print(f"[{i}] != plain at {shape}", flush=True)
                return 1
            cuda_merge.launch(lib, table, batch)
        order = list(range(len(libs)))
        for turn in order + order[::-1]:
            times[(turn, shape)] += _time_ms(libs[turn], table, batch, 5)
    for i, (name, _) in enumerate(cands):
        print(f"[{i}] {name}: median ms " + ", ".join(
            f"D={d} C={c} W={w} {statistics.median(times[(i, (d, c, w))]):.4f}"
            for d, c, w in SHAPES), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
