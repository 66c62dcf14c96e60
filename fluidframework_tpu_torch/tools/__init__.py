"""Tooling layer: benchmark harness, replay tool, headless runner,
stress runner.

Reference analogue: tools/benchmark, packages/tools/{replay-tool,
fluid-runner}, packages/test/test-service-load.

The reference's exports. ``window_candidates`` (the kernel's tuning
script, the port's own) is not exported: run it as
``python -m fluidframework_tpu_torch.tools.window_candidates``.
"""
from .benchmark import (
    BenchmarkReporter,
    BenchmarkResult,
    BenchmarkType,
    benchmark,
)
from .fluid_runner import export_content, export_file
from .replay_tool import ReplayReport, replay_document, replay_file
from .serve_bench import (
    ServeBenchConfig,
    ServeBenchReport,
    run_serve_bench,
)
from .stress import StressConfig, StressReport, run_stress

__all__ = [
    "BenchmarkReporter",
    "BenchmarkResult",
    "BenchmarkType",
    "ReplayReport",
    "ServeBenchConfig",
    "ServeBenchReport",
    "StressConfig",
    "StressReport",
    "benchmark",
    "export_content",
    "export_file",
    "replay_document",
    "replay_file",
    "run_serve_bench",
    "run_stress",
]
