"""Tiny cells for the CPU tests, and the marker of tests that need a
CUDA card (they skip, decided inside the test, on a machine without
one). Run: ``python -m pytest portbench/tests -q``."""
import json
import shutil
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]

TINY_CONFIG = {
    "name": "tiny", "docs": 6, "clients": 3, "capacity": 256,
    "sessions": 2, "steps": 70, "messages": 48,
    "mix": {"insert": 0.6, "remove": 0.2, "annotate": 0.1,
            "process": 0.1, "max_insert_len": 6},
}
TINY_TRAFFIC = {"name": "tiny16", "loop": "closed", "messages_per_round": 16}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one")


@pytest.fixture
def tiny_root(tmp_path):
    """A checkout-shaped directory: the benchmark's files, plus one added
    configuration, traffic mix, metric reader and cell, with no code
    edited."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    (root / "portbench" / "configs" / "tiny.json").write_text(
        json.dumps(TINY_CONFIG))
    (root / "portbench" / "traffic" / "tiny16.json").write_text(
        json.dumps(TINY_TRAFFIC))
    (root / "portbench" / "metrics" / "rounds_per_s.py").write_text(
        "def read(r):\n    return len(r.rounds['ta']) / r.window_s\n")
    spec["configs"].append({
        "name": "tiny", "source": "a test's own", "reduced": [],
        "file": "portbench/configs/tiny.json", "why": "a test"})
    spec["workloads"].append({
        "name": "tiny.r16", "config": "tiny", "traffic": "tiny16",
        "chips": 1, "why": "a test"})
    for name, unit in (("ops_per_s.tiny", "ops/s"),
                       ("round_p95_ms.tiny", "ms")):
        spec["end_to_end"].append({
            "name": name, "unit": unit, "better": "lower", "bound": 0.25,
            "source": "host_clock", "workloads": ["tiny.r16"]})
    spec["per_layer"].append({
        "name": "rounds_per_s", "unit": "1/s", "better": "higher",
        "source": "host_clock", "layer": "device", "moves": "ops_per_s.tiny",
        "workloads": ["tiny.r16"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root
