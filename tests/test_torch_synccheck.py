"""The port's host-sync lint (``analysis/synccheck.py``), the
counterpart of the reference's ``jaxhazards:dispatch-loop-sync``: it
finds each flagged pattern in a fixture loop, lints the port clean,
accepts ``_settle``'s overflow read only as the boundary it is, honours
an inline suppression only with a reason, and runs as a module."""
import subprocess
import sys
from pathlib import Path

import pytest

from fluidframework_tpu_torch.analysis import (
    DISPATCH_LOOPS,
    RULES,
    check_package,
    check_source,
)
from fluidframework_tpu_torch.analysis import synccheck

REPO = Path(__file__).resolve().parent.parent

FIXTURE = '''
import torch

class Loop:
    def apply(self, table: SegmentTable, host):
        self._dispatch(table, host)
        self._settle()

    def _dispatch(self, table, host):
        flags = torch.zeros(4)
        n = flags.sum().item()                        # item
        k = int(self._table.count[0])                 # item
        a = self._table.overflow.cpu()                # cpu
        b = self._table.overflow.tolist()             # tolist
        c = a.numpy()                                 # numpy
        if flags.any():                               # truthiness
            pass
        ok = bool(self._table.count.max() > 3)        # truthiness
        torch.cuda.synchronize()                      # synchronize
        d = flags.to("cpu")                           # to-cpu
        e = torch.nonzero(flags)                      # nonzero
        f = flags.to("cpu", non_blocking=True)
        g = host.tolist()
        if table is None or host:
            pass
        return table.docs, table.shape

    def _settle(self):
        return bool(self._table.overflow.any())
'''


def _fixture_findings(boundary=("_settle",)):
    return check_source(FIXTURE, "fixture.py", ("apply",), boundary)


@pytest.mark.parametrize("rule", RULES)
def test_each_pattern_is_flagged(rule):
    lines = FIXTURE.splitlines()
    want = sorted(i + 1 for i, line in enumerate(lines)
                  if line.rstrip().endswith(f"# {rule}"))
    got = sorted(f.line for f in _fixture_findings() if f.rule == rule)
    assert want and got == want


def test_only_the_marked_lines_are_flagged():
    lines = FIXTURE.splitlines()
    marked = {i + 1 for i, line in enumerate(lines)
              if line.rstrip().split("# ")[-1] in RULES}
    assert {f.line for f in _fixture_findings()} == marked


def test_settle_read_is_the_boundary():
    """_settle's read is accepted as the boundary; with no boundary the
    same read is a finding, in the fixture and in the sidecar."""
    assert all(f.function != "_settle" for f in _fixture_findings())
    extra = [f for f in _fixture_findings(boundary=())
             if f.function == "_settle"]
    assert [f.rule for f in extra] == ["truthiness"]
    path = synccheck.PACKAGE / "service" / "gpu_sidecar.py"
    roots, boundary = DISPATCH_LOOPS["service/gpu_sidecar.py"]
    assert check_source(path.read_text(), str(path), roots, boundary) == []
    unguarded = check_source(path.read_text(), str(path), roots, ())
    assert {f.function for f in unguarded} >= {"_settle", "_recover"}


def test_suppression_needs_a_reason():
    src = FIXTURE.replace(
        "flags.to(\"cpu\")                           # to-cpu",
        "flags.to(\"cpu\")  # synccheck: disable=to-cpu the test says so")
    assert "to-cpu" not in {f.rule for f in check_source(
        src, "f.py", ("apply",), ("_settle",))}
    bare = FIXTURE.replace(
        "torch.nonzero(flags)                      # nonzero",
        "torch.nonzero(flags)  # synccheck: disable=nonzero")
    rules = {f.rule for f in check_source(bare, "f.py", ("apply",),
                                          ("_settle",))}
    assert "disable-without-reason" in rules and "nonzero" not in rules


def test_port_lints_clean():
    assert check_package() == []
    for rel in DISPATCH_LOOPS:
        assert (synccheck.PACKAGE / rel).exists(), rel


def test_cli_runs_clean():
    proc = subprocess.run(
        [sys.executable, "-m", "fluidframework_tpu_torch.analysis"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "synccheck: clean" in proc.stdout
