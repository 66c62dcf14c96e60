#!/usr/bin/env python3
"""The port's benchmark: one cell of ``BENCHMARK.json`` on the card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout of the repository. The cell's lane
(``portbench/lanes/``) makes its traffic from ``--seed`` and warms every
shape the window uses; the window lasts ``--seconds``; then the plain
reference judges what the window produced.
The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``; ``checks`` last), and the last lines of standard error
give each compared number beside its limit.

Exits 2 without a result when the machine has fewer CUDA cards than the
cell asks for, 3 when the checkout lacks the program, 4 when a module of
JAX or of the JAX package was loaded.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "fluidframework_tpu")
RECORD_WORKERS = 4


def loaded_forbidden() -> list:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".", 1)[0] in FORBIDDEN})


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"


def run_cell(cell, args, recording):
    """The result line's object, or the exit code of a run that cannot
    give one."""
    import torch

    from portbench import cell as cells

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        import fluidframework_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"portbench: the program is not in this checkout: {e}",
              file=sys.stderr)
        return 3

    def log(msg):
        print(f"portbench: {msg}", file=sys.stderr, flush=True)

    log(f"{args.workload} seed {args.seed} seconds {args.seconds} trace "
        f"{args.trace}; torch {torch.__version__} cuda {torch.version.cuda}")
    return cells.run(cell, args.seed, args.seconds, bool(args.trace),
                     "cuda", T0, recording=recording, log=log)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # fixed build and kernel cache directories inside the checkout, set
    # before torch loads
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(ROOT / ".portbench_cache" / sub)
    sys.path.insert(0, str(ROOT))
    from portbench import cell as cells

    cell = cells.load_cell(ROOT, args.workload)
    # the traffic is made in spawned processes while this one loads
    # torch and the program and reaches the card
    recording = cell.lane.Recording(cell.config, args.seed, RECORD_WORKERS)
    try:
        result = run_cell(cell, args, recording)
    finally:
        recording.stop()
    if result is None or isinstance(result, int):
        return result or 1
    found = loaded_forbidden()
    if found:
        print(f"portbench: modules of JAX or the JAX package were loaded: "
              f"{found}", file=sys.stderr)
        return 4
    result["power_limit"] = power_limit()
    checks = result.pop("checks")
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
