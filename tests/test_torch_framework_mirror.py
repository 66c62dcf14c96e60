"""The reference's tests of the framework layer (``test_framework``: the
service client, data objects, the helpers and undo/redo), the webflow
document binding (``test_flowdoc``) and the rich-text editor binding
(``test_richtext``), run on both packages
(``test_torch_service_layers.run_mirrored``: the reference's own test
source, imports rewired). Nothing is left out.

Each of ``test_flowdoc`` and ``test_richtext`` has one case that feeds
the binding's stream to the merge plane's window apply, so on the port
they run with the edits in ``EDITS``: the reference's
``apply_window_impl`` is the port's ``merge_kernel.apply_window`` on a
``make_table(..., "cpu")`` table with the packed batch moved to the CPU
through ``convert.batch_from_numpy`` (the plain version of the Hopper
kernel; the port's planes run on the CPU only when the caller names it),
and the chunked route's table is made on the CPU too. ``test_flowdoc``'s
case also loses its ``jax`` platform pin.
"""
import pytest

from test_torch_service_layers import (
    PACKAGES,
    case_id,
    mirror_cases,
    run_mirrored,
)

MIRRORED = ("test_framework", "test_flowdoc", "test_richtext")
LEFT_OUT: dict = {}
_KERNEL_EDITS = (
    ("    from fluidframework_tpu_torch.ops.merge_kernel import "
     "apply_window_impl\n",
     "    from fluidframework_tpu_torch.convert import batch_from_numpy\n"
     "    from fluidframework_tpu_torch.ops.merge_kernel import "
     "apply_window\n"),
    ("apply_window_impl(make_table(1, 1024), batch)",
     "apply_window(make_table(1, 1024, \"cpu\"), "
     "batch_from_numpy(batch, \"cpu\"))"),
    ("make_table(1, 1024), build_chunked(batch, K=8)",
     "make_table(1, 1024, \"cpu\"), build_chunked(batch, K=8)"),
)
EDITS = {
    "test_flowdoc": (
        ("    import jax\n\n"
         "    jax.config.update(\"jax_platforms\", \"cpu\")\n", ""),
    ) + _KERNEL_EDITS,
    "test_richtext": _KERNEL_EDITS,
}


def test_every_mirrored_module_gives_cases():
    cases = mirror_cases(MIRRORED, LEFT_OUT)
    assert {m for m, _n, _p in (getattr(c, "values", c) for c in cases)} \
        == set(MIRRORED)
    assert not LEFT_OUT


@pytest.mark.parametrize("package", PACKAGES)
@pytest.mark.parametrize("module,name,params",
                         mirror_cases(MIRRORED, LEFT_OUT), ids=case_id)
def test_mirrored(package, module, name, params, request):
    edits = EDITS.get(module, ()) if package == PACKAGES[1] else ()
    run_mirrored(package, module, name, request, params, edits)
