"""A pytest plugin that runs a session under the port's five runtime
sanitizers:

    python -m pytest -p fluidframework_tpu_torch.testing.sanitize_plugin \\
        tests/test_torch_service_layers.py

It does for the port what the reference's ``FFTPU_SANITIZE=1`` block in
``tests/conftest.py`` does for the JAX package. At ``pytest_configure``,
before any test module is imported (so locks created at test-module
import are instrumented too), it installs fluidsan (lock order,
``sanitizer``), jitsan (per-root compile counts and donated-table reads),
detsan (un-routed clock reads and unseeded RNG on the deterministic
planes), wiresan (frame fields against ``WIRE_SCHEMA``) and failsan
(fault-to-signal accounting over the chaos plane). An autouse guard then
fails any test during which one of them tripped, naming the trips. The
plugin is opt-in: nothing loads it by default.
"""
from __future__ import annotations

import pytest

from . import detsan, failsan, jitsan, sanitizer, wiresan

# in install order; a trip report names the sanitizer
_SANITIZERS = (("fluidsan", sanitizer), ("jitsan", jitsan),
               ("detsan", detsan), ("wiresan", wiresan),
               ("failsan", failsan))


def pytest_configure(config) -> None:
    for _name, mod in _SANITIZERS:
        mod.install()


def pytest_unconfigure(config) -> None:
    for _name, mod in reversed(_SANITIZERS):
        mod.uninstall()


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_call(item):
    yield
    # failsan evaluates the windows a test closed when they are read:
    # the chaos harnesses disarm before their quiesce, so the end of
    # the test body is the first point where every recovery signal has
    # landed, and the last before fixture teardown (a fixture that
    # restores the metric registries would erase the deltas)
    failsan.flush()


@pytest.fixture(autouse=True)
def _sanitizer_trip_guard():
    before = {name: len(mod.trips()) for name, mod in _SANITIZERS}
    yield
    for name, mod in _SANITIZERS:
        fresh = mod.trips()[before[name]:]
        if fresh:
            dump = getattr(fresh[0], "flight_dump", "")
            pytest.fail(f"{name} tripped during this test:\n"
                        + "\n".join(t.describe() for t in fresh)
                        + (f"\n{dump}" if dump else ""))
