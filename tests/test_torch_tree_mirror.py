"""The reference's tests of SharedTree, run on both packages
(``test_torch_service_layers.run_mirrored``: the reference's own test
source, imports rewired): the DDS and its rebasing (``test_tree``),
moves (``test_tree_moves``), schema and transactions
(``test_tree_schema_txn``), the register field kind
(``test_tree_register``) and the tree serving plane through the
``LocalServer`` → ``Container`` → ``TreeSidecar`` loop
(``test_tree_serve``). Nothing is left out.

``test_tree_serve``'s source names what the port calls otherwise, so on
the port it runs with the edits in ``SERVE_EDITS``: its ``TreeSidecar``
is bound to ``device="cpu"`` (the port's planes run on the CPU only when
the caller names it), the reference's ``TpuMergeSidecar`` is the port's
``GpuMergeSidecar(device="cpu")``, ``service.tpu_sidecar`` is
``service.gpu_sidecar``, and a one-device mesh is the CPU's rather than
``jax.devices()[:1]``. The cases those edits touch, and the two that
carry a slow mark, are mirrored by hand below (the slow ones keep it).
"""
import pytest

from test_torch_service_layers import (
    PACKAGES,
    case_id,
    mirror_cases,
    run_mirrored,
)

MIRRORED = (
    "test_tree",
    "test_tree_moves",
    "test_tree_schema_txn",
    "test_tree_register",
    "test_tree_serve",
)
LEFT_OUT: dict = {}
BY_HAND = {
    ("test_tree_serve", "test_routes_agree_on_steady_multidoc_traffic"),
    ("test_tree_serve", "test_routes_agree_through_grow_ladder"),
    ("test_tree_serve", "test_routes_agree_with_pool_tier"),
    ("test_tree_serve", "test_channel_kind_router_routes_by_channel_type"),
    ("test_tree_serve", "test_select_pool_tree_plane"),
}
SERVE_EDITS = (
    ("import json\n", "import functools\nimport json\n"),
    ("    TpuMergeSidecar,\n", "    GpuMergeSidecar,\n"),
    ('ROUTES = ("atom", "macro")\n',
     'ROUTES = ("atom", "macro")\n'
     'TreeSidecar = functools.partial(TreeSidecar, device="cpu")\n'),
    ("TpuMergeSidecar(max_docs=4", 'GpuMergeSidecar(device="cpu", max_docs=4'),
    ("    import jax\n", "    import torch\n"),
    ("jax.devices()[:1]", '[torch.device("cpu")]'),
    ("service.tpu_sidecar import select_pool",
     "service.gpu_sidecar import select_pool"),
    ('max_capacity=64, plane="tree")',
     'max_capacity=64, plane="tree", device="cpu")'),
)


def _edits(package, module):
    if package == PACKAGES[1] and module == "test_tree_serve":
        return SERVE_EDITS
    return ()


def test_left_out_cases_exist():
    """Every mirrored module gives cases, and every case mirrored by
    hand is still a test of the reference."""
    cases = mirror_cases(MIRRORED, LEFT_OUT, BY_HAND)
    assert {m for m, _n, _p in (getattr(c, "values", c) for c in cases)} \
        == set(MIRRORED)
    assert not LEFT_OUT


@pytest.mark.parametrize("package", PACKAGES)
@pytest.mark.parametrize("module,name,params",
                         mirror_cases(MIRRORED, LEFT_OUT, BY_HAND),
                         ids=case_id)
def test_mirrored(package, module, name, params, request):
    run_mirrored(package, module, name, request, params,
                 _edits(package, module))


@pytest.mark.slow
@pytest.mark.parametrize("package", PACKAGES)
def test_routes_agree_on_steady_multidoc_traffic(package, request):
    """The reference's case, with its slow mark."""
    run_mirrored(package, "test_tree_serve",
                 "test_routes_agree_on_steady_multidoc_traffic", request,
                 edits=_edits(package, "test_tree_serve"))


@pytest.mark.slow
@pytest.mark.parametrize("package", PACKAGES)
def test_routes_agree_through_grow_ladder(package, request):
    """The reference's case, with its slow mark."""
    run_mirrored(package, "test_tree_serve",
                 "test_routes_agree_through_grow_ladder", request,
                 edits=_edits(package, "test_tree_serve"))


@pytest.mark.parametrize("package", PACKAGES)
def test_routes_agree_with_pool_tier(package, request):
    """The reference's case; the port's one-device mesh is the CPU's."""
    run_mirrored(package, "test_tree_serve",
                 "test_routes_agree_with_pool_tier", request,
                 edits=_edits(package, "test_tree_serve"))


@pytest.mark.parametrize("package", PACKAGES)
def test_channel_kind_router_routes_by_channel_type(package, request):
    """The reference's case; the port's merge sidecar is
    ``GpuMergeSidecar(device="cpu")``."""
    run_mirrored(package, "test_tree_serve",
                 "test_channel_kind_router_routes_by_channel_type",
                 request, edits=_edits(package, "test_tree_serve"))


@pytest.mark.parametrize("package", PACKAGES)
def test_select_pool_tree_plane(package, request):
    """The reference's case; the port's pool selector lives in
    ``service.gpu_sidecar`` and builds the tree pool on the CPU."""
    run_mirrored(package, "test_tree_serve",
                 "test_select_pool_tree_plane", request,
                 edits=_edits(package, "test_tree_serve"))
