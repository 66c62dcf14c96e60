"""The reference's wire-level tests of the TCP ingress, run on both
packages: version negotiation and columnar batches
(``test_wire_compat``), the chunked summary-upload plane
(``test_summary_upload``) and ack liveness over the socket driver
(``test_ack_liveness``). Each body is the reference test file's own
source, executed once per package with its imports rewired
(``test_torch_service_layers.run_mirrored``); the parametrized cases are
expanded one per parameter set. The ``alfred`` fixture below overrides
``tests/conftest.py``'s: it starts the ingress of the package under
test.

Mirrored by hand: ``test_summary_upload.py::
test_sigkill_restart_resumes_from_client_uploaded_summary`` (it carries
a slow mark, kept here).
"""
import pytest

from test_torch_service_layers import (
    PACKAGES,
    alfred_fixture,
    case_id,
    mirror_cases,
    run_mirrored,
)

MIRRORED = ("test_wire_compat", "test_summary_upload", "test_ack_liveness")
SLOW = ("test_summary_upload",
        "test_sigkill_restart_resumes_from_client_uploaded_summary")


@pytest.fixture()
def alfred(package, monkeypatch):
    yield from alfred_fixture(package, monkeypatch)


@pytest.mark.parametrize("package", PACKAGES)
@pytest.mark.parametrize("module,name,params",
                         mirror_cases(MIRRORED, {}, {SLOW}), ids=case_id)
def test_mirrored(package, module, name, params, request):
    run_mirrored(package, module, name, request, params)


@pytest.mark.slow
@pytest.mark.parametrize("package", PACKAGES)
def test_sigkill_restart_resumes_from_client_uploaded_summary(
        package, request):
    run_mirrored(package, *SLOW, request)
