"""One cell of ``BENCHMARK.json``, found by name and run.

Everything that belongs to one configuration, traffic mix or metric sits
in a file of its own under the checkout's ``portbench/``:
``configs/<config>.json`` (the entry's ``file``), ``traffic/<mix>.json``
and ``metrics/<metric>.py``. A cell reports the end-to-end metrics (with
``trace`` off) or the per-layer metrics (with it on) that list it, or
that list no cells at all.

A run: the sessions recorded from the seed and cut into rounds; one
whole batch through the lane to warm every shape the window uses (the
kernels' builds, the allocator's blocks); the window; then, with the
program's work done, the memory peak, the trace's reading, the plain
reference and the comparison.
"""
from __future__ import annotations

import importlib.util
import json
import math
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from . import generator


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    metrics: dict        # name -> unit, with trace off
    traced_metrics: dict  # name -> unit, with trace on
    root: Path


def _lists(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: Path, name: str) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files;
    raises ``KeyError`` for a name it does not hold."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    work = {w["name"]: w for w in spec["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(has {sorted(work)})")
    w = work[name]
    cfg = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = json.loads((root / cfg["file"]).read_text())
    traffic = json.loads(
        (root / "portbench" / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(
        name=name, chips=w["chips"], config=config, traffic=traffic,
        metrics={m["name"]: m["unit"] for m in spec["end_to_end"]
                 if _lists(m, name)},
        traced_metrics={m["name"]: m["unit"] for m in spec["per_layer"]
                        if _lists(m, name)},
        root=root)


def reader(root: Path, metric: str):
    """The ``read`` of ``metrics/<metric>.py``, loaded from its file. A
    metric split by cell, ``<quantity>.<qualifier>``, falls back to
    ``metrics/<quantity>.py``."""
    base = root / "portbench" / "metrics"
    path = base / f"{metric}.py"
    if not path.exists():
        path = base / f"{metric.split('.', 1)[0]}.py"
    if not path.exists():
        raise FileNotFoundError(f"no reader for metric {metric!r} in {base}")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def slices(r, width: float = 10.0) -> str:
    """Op rows per second and host ms per round (ticket, stamp, upload)
    over each ``width`` seconds of the window: how the window drifts."""
    t = r.rounds["ta"] - r.rounds["ta"][0]
    out = []
    for k in range(int(t[-1] // width) + 1):
        m = (t >= k * width) & (t < (k + 1) * width)
        span = min(width, r.window_s - k * width)
        out.append(
            f"[{r.rounds['rows'][m].sum() / span / 1e6:.3f} M/s, ticket "
            f"{(r.rounds['tb'] - r.rounds['ta'])[m].mean() * 1e3:.3f}, stamp "
            f"{(r.rounds['tc'] - r.rounds['tb'])[m].mean() * 1e3:.3f}, upload "
            f"{(r.rounds['td'] - r.rounds['tw'])[m].mean() * 1e3:.3f} ms]")
    return " ".join(out)


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: str,
        t0: float, lane_cls=None, workers: int = 1, sessions=None,
        log=lambda msg: None) -> dict:
    """One run of ``cell``; returns the result line's object. ``t0`` is
    the host clock at process start; ``lane_cls`` stands in for
    ``harness.Lane``; ``sessions`` is a ``generator.Recording`` of the
    cell's config and ``seed`` when it was started earlier; ``log``
    takes progress lines."""
    import torch

    from . import compare, harness, reference, roofline
    from .readings import collect

    lane_cls = lane_cls or harness.Lane
    cfg, traffic = cell.config, cell.traffic
    docs, clients, cap = cfg["docs"], cfg["clients"], cfg["capacity"]
    per_round = traffic["messages_per_round"]
    cuda = torch.device(device).type == "cuda"

    if sessions is None:
        sessions = generator.Recording(cfg, seed, workers)
    t = time.perf_counter()
    lane = lane_cls(device, docs, clients, cap)
    log(f"lane: {time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    sessions = sessions()
    rounds = generator.make_rounds(sessions, docs, per_round)
    tile = np.arange(docs) % len(sessions)
    log(f"traffic: {len(sessions)} sessions, messages "
        f"{[len(s['counts']) for s in sessions]}, {len(rounds)} rounds of "
        f"window {rounds[0]['win']} ({time.perf_counter() - t:.3f} s)")

    t = time.perf_counter()
    marks = harness.Marks(device)
    marks.start()
    harness.run_batch(lane, rounds, marks, harness.Window(marks=marks),
                      -1, math.inf, trace)
    marks.resolve(wait=True)
    log(f"warm-up batch: {time.perf_counter() - t:.3f} s")
    prof = None
    if trace:
        from .trace import Trace
        prof = Trace()
        prof.start()
    setup_s = time.perf_counter() - t0

    win = harness.run_window(lane, rounds, seconds, seed, trace)

    if prof is not None:
        prof.stop()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    traced = None
    if prof is not None:
        from .trace import read
        t = time.perf_counter()
        traced = read(prof, win)
        del prof
        log(f"trace read: {time.perf_counter() - t:.3f} s")
    del lane
    t = time.perf_counter()
    ref = reference.replay(sessions, clients, cap, per_round, device=device)
    checks = compare.judge(win, rounds, ref, tile)
    log(f"reference and check: {time.perf_counter() - t:.3f} s, "
        f"{len(win.kept)} batches kept "
        f"{[(k['batch'], k['rounds']) for k in win.kept]}")
    least = roofline.least_seconds(ref["live"], tile, docs, cap,
                                   rounds[0]["win"])
    readings = collect(win, setup_s, least, traced)
    log("by 10 s of the window: " + slices(readings))
    names = cell.traced_metrics if trace else cell.metrics
    metrics = {}
    for name, unit in names.items():
        value = reader(cell.root, name)(readings)
        if value is not None:
            metrics[name] = {"value": value, "unit": unit}
    out = {
        "correct": all(c["value"] <= c["limit"] for c in checks.values()),
        "attempted": int(readings.rounds["msgs"].sum()),
        "failed": compare.failed_messages(win, rounds, tile),
        "metrics": metrics,
        "device": {
            "platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
            "count": cell.chips,
            "memory_peak_bytes": int(peak),
        },
    }
    if traced is not None:
        out["device"]["busy_s"] = traced["busy_s"]
        out["device"]["window_s"] = traced["window_s"]
        out["breakdown"] = {"device_ops": traced["device_ops"],
                            "idle_gaps": traced["idle_gaps"]}
        out["b1_lost_by_the_trace"] = traced["b1_lost"]
    host = readings.rounds
    out["host_ms"] = {
        "ticket": float((host["tb"] - host["ta"]).mean() * 1e3),
        "stamp": float((host["tc"] - host["tb"]).mean() * 1e3),
        "upload_wait": float((host["tw"] - host["tc"]).mean() * 1e3),
        "upload": float((host["td"] - host["tw"]).mean() * 1e3),
        "apply_enqueue": float((host["te"] - host["td"]).mean() * 1e3),
        "open": float((readings.opens[:, 1] - readings.opens[:, 0]).mean()
                      * 1e3),
        "rounds": int(len(host["ta"])),
        "batches": int(len(readings.opens)),
    }
    out["checks"] = checks
    return out

