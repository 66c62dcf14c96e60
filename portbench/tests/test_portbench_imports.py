"""What the benchmark imports: never JAX or the JAX package (top-level
names compared whole), and on the reference's side nothing of the
program."""
import ast

import pytest

from .conftest import ROOT

PB = ROOT / "portbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "fluidframework_tpu"}
# the yardstick's side: traffic, the reference, the comparison, the
# roofline, the readers
REFERENCE_SIDE = ["generator.py", "reference.py", "compare.py",
                  "roofline.py", "readings.py", "recorder", "metrics"]


def top_level_imports(path):
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".", 1)[0])
    return names


def files(*parts):
    for p in parts:
        path = PB / p
        yield from (sorted(path.rglob("*.py")) if path.is_dir() else [path])


@pytest.mark.parametrize("path", list(files(".")), ids=str)
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", list(files(*REFERENCE_SIDE)), ids=str)
def test_reference_side_imports_nothing_of_the_program(path):
    assert "fluidframework_tpu_torch" not in top_level_imports(path)


def test_forbidden_check_compares_whole_names(monkeypatch):
    import sys

    from portbench import run

    monkeypatch.setitem(sys.modules, "fluidframework_tpu_torch_x", None)
    assert "fluidframework_tpu_torch_x" not in run.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "fluidframework_tpu.ops", None)
    assert "fluidframework_tpu.ops" in run.loaded_forbidden()
