"""The reference's tests of the native layer, run on both packages
(``test_torch_service_layers.run_mirrored``: the reference's own test
source, imports rewired): the C++ sequencer core against the Python
``DocumentSequencer`` (``test_native_sequencer``) and the C++ scalar
merge replayer against the scan (``test_native_replay``; on the port,
the scan runs on the CPU).

No case is left out. The reference modules' ``skipif`` marks (no
toolchain) are module-level and do not reach the mirrored bodies, so a
failed build of the port's libraries fails these cases; and
``test_port_native_libraries_build`` pins that the port's loaders
return a library here.
"""
import shutil
from pathlib import Path

import pytest

from test_torch_service_layers import (
    PACKAGES,
    case_id,
    mirror_cases,
    registries_restored,
    run_mirrored,
)
from test_torch_native_build import reference_native

MIRRORED = ("test_native_sequencer", "test_native_replay")
LEFT_OUT: dict = {}
# the port's table and batch live on the CPU (its entry points default
# to the card)
PORT_EDITS = (
    ("from fluidframework_tpu_torch.ops import (",
     "from fluidframework_tpu_torch.convert import batch_from_numpy\n"
     "from fluidframework_tpu_torch.ops import ("),
    ("table = apply_window(make_table(1, capacity), batch)",
     "table = apply_window(make_table(1, capacity, \"cpu\"),\n"
     "                         batch_from_numpy(batch, \"cpu\"))"),
)


@pytest.fixture(autouse=True)
def _registries_restored():
    yield from registries_restored()


@pytest.fixture(autouse=True)
def _reference_libraries():
    """The reference's libraries, built race-free under xdist."""
    reference_native()


@pytest.mark.parametrize("package", PACKAGES)
@pytest.mark.parametrize("module,name,params",
                         mirror_cases(MIRRORED, LEFT_OUT), ids=case_id)
def test_mirrored(package, module, name, params, request):
    edits = PORT_EDITS if (package == "fluidframework_tpu_torch"
                           and module == "test_native_replay") else ()
    run_mirrored(package, module, name, request, params, edits)


def test_port_native_libraries_build():
    """The port builds both libraries from its own sources into its
    ``_build/`` (the test machines have ``g++``)."""
    from fluidframework_tpu_torch import native

    assert shutil.which("g++") is not None
    seq, rep = native.load_native_sequencer(), native.load_merge_replay()
    assert seq is not None, native.native_build_error()
    assert rep is not None, native.merge_replay_error()
    for lib in (seq, rep):
        assert Path(lib._name).parent == native.BUILD_DIR
