"""One cell of ``BENCHMARK.json``, found by name and run.

Everything that belongs to one configuration, traffic mix, lane or
metric sits in a file of its own under the checkout's ``portbench/``:
``configs/<config>.json`` (the entry's ``file``), ``traffic/<mix>.json``,
``lanes/<lane>.py`` (the configuration's ``"lane"``, ``lanes.DEFAULT``
where it names none; the contract is in ``lanes/__init__.py``) and
``metrics/<metric>.py``. A cell reports the end-to-end metrics (with
``trace`` off) or the per-layer metrics (with it on) that list it, or
that list no cells at all.

A run: the lane's set-up (the program opened, the traffic made from the
seed, every shape the window uses warmed); the window; then, with the
program's work done, the memory peak, the trace's reading, the plain
reference and the comparison.
"""
from __future__ import annotations

import importlib.util
import json
import sys
import time
from dataclasses import dataclass
from pathlib import Path

from .lanes import DEFAULT as DEFAULT_LANE


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    metrics: dict        # name -> unit, with trace off
    traced_metrics: dict  # name -> unit, with trace on
    root: Path
    lane: object          # the module of lanes/<lane>.py


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
        root=root, lane=load_lane(root, config.get("lane", DEFAULT_LANE)))


def _load(path: Path, name: str):
    """The module of the file ``path``, as ``sys.modules[name]``."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def load_lane(root: Path, lane: str):
    """The module of ``lanes/<lane>.py``, loaded from its file."""
    path = root / "portbench" / "lanes" / f"{lane}.py"
    if not path.exists():
        raise FileNotFoundError(f"no lane {lane!r} in {path.parent}")
    return _load(path, f"portbench_lane_{lane}")


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
    return _load(path, "portbench_metric_" + metric.replace(".", "_")).read


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: str,
        t0: float, workers: int = 1, recording=None,
        log=lambda msg: None, **parts) -> dict:
    """One run of ``cell``; returns the result line's object. ``t0`` is
    the host clock at process start; ``recording`` is the lane's
    ``Recording`` of the cell's config and ``seed`` when it was started
    earlier (else one with ``workers``); ``log`` takes progress lines;
    ``parts`` go to the lane's ``Run``."""
    import torch

    from .readings import collect

    lane = cell.lane
    cuda = torch.device(device).type == "cuda"
    if recording is None:
        recording = lane.Recording(cell.config, seed, workers)
    lane_run = lane.Run(cell, seed, device, trace, recording, log, **parts)
    prof = None
    if trace:
        from .trace import Trace
        prof = Trace()
        prof.start()
    setup_s = time.perf_counter() - t0

    win = lane_run.window(seconds)

    if prof is not None:
        prof.stop()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    traced = None
    if prof is not None:
        from .trace import read
        t = time.perf_counter()
        traced = read(prof, win, lane.PHASES, lane.KERNEL, lane.SUMS)
        del prof
        log(f"trace read: {time.perf_counter() - t:.3f} s")
    checks, failed, least = lane_run.check()
    readings = collect(win, setup_s, least, traced)
    log("by 10 s of the window: " + lane.slices(readings))
    names = cell.traced_metrics if trace else cell.metrics
    metrics = {}
    for name, unit in names.items():
        value = reader(cell.root, name)(readings)
        if value is not None:
            metrics[name] = {"value": value, "unit": unit}
    out = {
        "correct": all(c["value"] <= c["limit"] for c in checks.values()),
        "attempted": int(readings.rounds["msgs"].sum()),
        "failed": failed,
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
        kernel = lane.KERNEL[0]
        out[f"{kernel}_lost_by_the_trace"] = traced[f"{kernel}_lost"]
    out.update(lane.extras(readings))
    out["checks"] = checks
    return out
