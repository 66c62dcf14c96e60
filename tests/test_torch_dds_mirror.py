"""The reference's tests of the DDS catalogue, run on both packages
(``test_torch_service_layers.run_mirrored``: the reference's own test
source, imports rewired): SharedMatrix (``test_matrix``), the consensus
collections, task manager, quorum and summary block
(``test_consensus_dds``), the generic DDS fuzz (``test_dds_fuzz``), the
legacy tree, OT and property DDSes, the runtime across every channel
type (``test_runtime``), offline stash, the golden snapshot fixtures and
the stored-format compat matrix.

The reference's ``test_matrix_kernel`` is ported by hand in
``tests/test_torch_matrix.py``; the SharedTree files are mirrored in
``tests/test_torch_tree_mirror.py``. Nothing is left out.
"""
import pytest

from test_torch_service_layers import (
    PACKAGES,
    case_id,
    mirror_cases,
    run_mirrored,
)

MIRRORED = (
    "test_matrix",
    "test_consensus_dds",
    "test_dds_fuzz",
    "test_legacy_tree",
    "test_ot",
    "test_property_dds",
    "test_runtime",
    "test_offline_stash",
    "test_snapshot_fixtures",
    "test_compat_matrix",
)
LEFT_OUT: dict = {}


def test_left_out_cases_exist():
    """Every case named as left out is still a test of the reference,
    and every mirrored module gives cases."""
    cases = mirror_cases(MIRRORED, LEFT_OUT)
    assert {m for m, _n, _p in cases} == set(MIRRORED)
    assert not LEFT_OUT


@pytest.mark.parametrize("package", PACKAGES)
@pytest.mark.parametrize("module,name,params",
                         mirror_cases(MIRRORED, LEFT_OUT), ids=case_id)
def test_mirrored(package, module, name, params, request):
    run_mirrored(package, module, name, request, params)
