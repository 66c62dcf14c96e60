"""The port's examples (``fluidframework_tpu_torch/examples/``), the
counterpart of ``tests/test_examples.py``: each script runs clean as
``python -m fluidframework_tpu_torch.examples.<name>`` under the
reference's 120 s timeout and prints ``OK``; the two that build a merge
sidecar run with ``--device cpu``. This file holds the scripts whose
standard output repeats byte for byte across runs of the reference;
for each, the port's output equals the reference script's (run as
``python examples/<name>.py``, ``JAX_PLATFORMS=cpu``).

Compared here (``COMPARED``): the five in-process scripts
(``collaborative_text``, ``todo_app``, ``table_grid``, ``tree_outline``,
``property_cad``), the two step-clock timelines (``fleet_timeline``,
``netsplit_timeline``) and ``heat_dump`` (manual clocks and a seeded
serve_bench). The others run in ``tests/test_torch_examples_net.py``
and are not compared, because their output is not the same from one
run of the reference to the next: ``network_chat`` and
``secure_multitenant`` print the server's free port, ``slo_report``
its profiler's sample counts, ``op_trace`` wall-clock hop latencies,
and ``ink_whiteboard`` paints overlapping strokes in the order of
their ``uuid4`` ids; ``richtext_editor`` and ``webflow_editor`` wait
for broadcasts with fixed sleeps, so a loaded host may interleave
their edits otherwise.

Tolerance: exact (byte-equal standard output).
"""
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DIR = os.path.join(REPO, "fluidframework_tpu_torch", "examples")
DEVICE_FLAG = {"heat_dump": ["--device", "cpu"],
               "op_trace": ["--device", "cpu"]}
COMPARED = ("collaborative_text", "todo_app", "table_grid", "tree_outline",
            "property_cad", "fleet_timeline", "netsplit_timeline",
            "heat_dump")


def run_port_example(name: str) -> str:
    proc = subprocess.run(
        [sys.executable, "-m", f"fluidframework_tpu_torch.examples.{name}",
         *DEVICE_FLAG.get(name, [])],
        capture_output=True, text=True, cwd=REPO, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "OK" in proc.stdout
    return proc.stdout


def test_every_reference_example_has_a_port_copy():
    ref = {f for f in os.listdir(os.path.join(REPO, "examples"))
           if f.endswith(".py")}
    port = {f for f in os.listdir(PORT_DIR)
            if f.endswith(".py") and f != "__init__.py"}
    assert ref == port and len(port) == 15
    readme = open(os.path.join(PORT_DIR, "README.md")).read()
    assert all(f"`{f[:-3]}`" in readme for f in port)


@pytest.mark.parametrize("name", COMPARED)
def test_example_runs_clean_and_prints_what_the_reference_prints(name):
    out = run_port_example(name)
    ref = subprocess.run(
        [sys.executable, os.path.join("examples", f"{name}.py")],
        capture_output=True, text=True, cwd=REPO, timeout=120,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert ref.returncode == 0, ref.stderr[-2000:]
    assert out == ref.stdout
