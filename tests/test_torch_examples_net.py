"""The port's examples whose output varies from run to run (the list
and the reasons: ``tests/test_torch_examples.py``): each runs clean as
``python -m fluidframework_tpu_torch.examples.<name>`` under the
reference's 120 s timeout and prints ``OK`` (``op_trace`` with
``--device cpu``)."""
import pytest

from test_torch_examples import COMPARED, PORT_DIR, run_port_example

NOT_COMPARED = ("network_chat", "ink_whiteboard", "richtext_editor",
                "webflow_editor", "secure_multitenant", "slo_report",
                "op_trace")


def test_the_two_files_cover_every_example():
    import os

    names = {f[:-3] for f in os.listdir(PORT_DIR)
             if f.endswith(".py") and f != "__init__.py"}
    assert names == set(COMPARED) | set(NOT_COMPARED)
    assert not set(COMPARED) & set(NOT_COMPARED)


@pytest.mark.parametrize("name", NOT_COMPARED)
def test_example_runs_clean(name):
    run_port_example(name)
