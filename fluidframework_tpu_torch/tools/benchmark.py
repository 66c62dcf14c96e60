"""Benchmark harness: timed runs with stats and reporters (a copy of the
reference's ``tools/benchmark.py``).

Reference: tools/benchmark — ``benchmark()`` (src/Runner.ts:48),
``BenchmarkType`` {Measurement, Perspective, OwnCorrectness,
Diagnostic} (src/Configuration.ts:25), custom reporters
(MochaReporter.ts). Here: a plain function harness usable from pytest
or scripts, emitting the same shape of statistics.
"""
from __future__ import annotations

import json
import math
import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Callable, Optional


class BenchmarkType(Enum):
    MEASUREMENT = "Measurement"       # tracked perf number
    PERSPECTIVE = "Perspective"       # comparison baseline
    OWN_CORRECTNESS = "OwnCorrectness"  # validates the harness
    DIAGNOSTIC = "Diagnostic"         # informational only


@dataclass
class BenchmarkResult:
    title: str
    benchmark_type: BenchmarkType
    iterations: int
    total_s: float
    mean_s: float
    p50_s: float
    p95_s: float
    min_s: float
    max_s: float
    samples_s: list[float] = field(repr=False, default_factory=list)

    @property
    def ops_per_sec(self) -> float:
        return 1.0 / self.mean_s if self.mean_s else math.inf

    def to_json(self) -> dict:
        return {
            "title": self.title,
            "type": self.benchmark_type.value,
            "iterations": self.iterations,
            "meanMs": self.mean_s * 1000,
            "p50Ms": self.p50_s * 1000,
            "p95Ms": self.p95_s * 1000,
            "minMs": self.min_s * 1000,
            "maxMs": self.max_s * 1000,
            "opsPerSec": self.ops_per_sec,
        }


def _percentile(sorted_samples: list[float], q: float) -> float:
    if not sorted_samples:
        return 0.0
    idx = min(len(sorted_samples) - 1,
              max(0, math.ceil(q * len(sorted_samples)) - 1))
    return sorted_samples[idx]


def benchmark(
    title: str,
    fn: Callable[[], Any],
    *,
    benchmark_type: BenchmarkType = BenchmarkType.MEASUREMENT,
    min_iterations: int = 5,
    max_iterations: int = 1000,
    min_time_s: float = 0.5,
    warmup: int = 1,
    setup: Optional[Callable[[], Any]] = None,
) -> BenchmarkResult:
    """Runner.ts:48 — run ``fn`` until both min_iterations and
    min_time_s are satisfied (or max_iterations); report stats. If
    ``setup`` is given its return value is passed to ``fn``."""
    for _ in range(warmup):
        fn(setup()) if setup else fn()
    samples: list[float] = []
    total = 0.0
    while (
        len(samples) < max_iterations
        and (len(samples) < min_iterations or total < min_time_s)
    ):
        arg = setup() if setup else None
        start = time.perf_counter()
        fn(arg) if setup else fn()
        dt = time.perf_counter() - start
        samples.append(dt)
        total += dt
    ordered = sorted(samples)
    return BenchmarkResult(
        title=title,
        benchmark_type=benchmark_type,
        iterations=len(samples),
        total_s=total,
        mean_s=total / len(samples),
        p50_s=_percentile(ordered, 0.50),
        p95_s=_percentile(ordered, 0.95),
        min_s=ordered[0],
        max_s=ordered[-1],
        samples_s=samples,
    )


class BenchmarkReporter:
    """MochaReporter.ts analogue: collect + render results."""

    def __init__(self) -> None:
        self.results: list[BenchmarkResult] = []

    def add(self, result: BenchmarkResult) -> BenchmarkResult:
        self.results.append(result)
        return result

    def render_table(self) -> str:
        lines = [
            f"{'title':40} {'iters':>6} {'mean ms':>10} "
            f"{'p95 ms':>10} {'ops/s':>12}"
        ]
        for r in self.results:
            lines.append(
                f"{r.title:40} {r.iterations:>6} "
                f"{r.mean_s * 1000:>10.3f} {r.p95_s * 1000:>10.3f} "
                f"{r.ops_per_sec:>12.1f}"
            )
        return "\n".join(lines)

    def render_json(self) -> str:
        return json.dumps([r.to_json() for r in self.results])
