"""The reference's tests of the service, driver, loader and runtime
layers, run on both packages.

Each mirrored test body is the reference test file's own source, executed
once per package: for the port, every ``fluidframework_tpu`` import in
the source is rewired to ``fluidframework_tpu_torch`` and nothing else
changes, so a body cannot drift from the reference's. Every case runs
twice (``[fluidframework_tpu-...]`` and ``[fluidframework_tpu_torch-...]``).

The helpers here (``mirror_cases``, ``run_mirrored``) serve the other
mirror files too: a case's parametrize marks are expanded into cases of
their own, and a fixture the reference module defines for itself is
built from the same executed source, so it too comes from the package
under test.

No case of these modules is left out.
"""
import ast
import functools
import inspect
import linecache
import re
from pathlib import Path

import pytest

TESTS = Path(__file__).resolve().parent
PACKAGES = ("fluidframework_tpu", "fluidframework_tpu_torch")
MIRRORED = (
    "test_local_server",
    "test_quorum",
    "test_sequencer",
    "test_collab_window",
    "test_op_lifecycle",
    "test_durable_storage",
)
LEFT_OUT: dict = {}


def mirror_cases(mirrored, left_out, by_hand=()) -> list:
    """``(module, name, params)`` for every test of the ``mirrored``
    reference modules that is neither left out nor mirrored by hand;
    a parametrized test gives one case per parameter set (``params``
    is a tuple of ``(argname, value)``). A test with any other mark
    must be named in ``left_out`` or ``by_hand``."""
    out = []
    for module in mirrored:
        tree = ast.parse((TESTS / f"{module}.py").read_text())
        defined = {n.name for n in tree.body
                   if isinstance(n, ast.FunctionDef)}
        named = set(left_out.get(module, {})) | {
            n for m, n in by_hand if m == module}
        assert named <= defined, (module, named - defined)
        for node in tree.body:
            if (not isinstance(node, ast.FunctionDef)
                    or not node.name.startswith("test_")
                    or node.name in left_out.get(module, {})
                    or (module, node.name) in by_hand):
                continue
            if not node.decorator_list:
                out.append((module, node.name, ()))
                continue
            fn = _namespace(module, PACKAGES[0])[node.name]
            for mark in fn.pytestmark:
                assert mark.name == "parametrize", (
                    f"{module}::{node.name} carries {mark.name}; "
                    "mirror it by hand")
            for p, marks in _param_rows(fn):
                case = (module, node.name, p)
                out.append(pytest.param(*case, marks=marks) if marks
                           else case)
    return out


def _param_rows(fn) -> list:
    """``(params, marks)`` for each parameter set of ``fn``'s
    parametrize marks, in order; ``marks`` are those its
    ``pytest.param`` values carry (a slow-marked seed stays slow)."""
    sets = [((), ())]
    for mark in getattr(fn, "pytestmark", ()):
        names, values = mark.args[:2]
        if isinstance(names, str):
            names = [n.strip() for n in names.split(",")]
        rows = []
        for v in values:
            marks = tuple(getattr(v, "marks", ()))
            if hasattr(v, "values"):  # a pytest.param
                v = tuple(v.values)
            else:
                v = tuple(v) if len(names) > 1 else (v,)
            rows.append((tuple(zip(names, v)), marks))
        sets = [(a + b, am + bm) for a, am in sets for b, bm in rows]
    return sets


def _param_sets(fn) -> list:
    """The parameter sets of ``fn``'s parametrize marks, in order."""
    return [p for p, _marks in _param_rows(fn)]


def case_id(value) -> str:
    if isinstance(value, tuple):
        return "-".join(f"{k}={v!r}" for k, v in value)[:60] or "-"
    return str(value)


# carries a slow mark: mirrored by hand below, with its mark
BY_HAND = {("test_durable_storage", "test_service_survives_kill_and_restart")}


def _cases() -> list:
    return [(m, n) for m, n, _ in mirror_cases(MIRRORED, LEFT_OUT,
                                               BY_HAND)]


def _fixture_value(namespace: dict, arg: str, request):
    """A fixture the mirrored module defines for itself, built from
    the executed source (so from the package under test); any other
    fixture comes from pytest."""
    wrapped = getattr(namespace.get(arg), "_get_wrapped_function", None)
    if wrapped is None:
        return request.getfixturevalue(arg)
    fn = wrapped()
    value = fn(**{a: _fixture_value(namespace, a, request)
                  for a in inspect.signature(fn).parameters})
    if inspect.isgenerator(value):
        gen = value
        value = next(gen)
        request.addfinalizer(lambda: next(gen, None))
    return value


def run_mirrored(package, module, name, request, params=(), edits=()):
    """Run one reference test body on ``package``. A parameter set
    (from the reference's marks) is taken at the same position from the
    package's own marks, so a parameter built by the package (a config
    object, a factory) comes from the package under test. ``edits``
    are ``(old, new)`` replacements of the rewired source."""
    namespace = _namespace(module, package, tuple(edits))
    fn = namespace[name]
    if params:
        ref = _param_sets(_namespace(module, PACKAGES[0])[name])
        params = _param_sets(fn)[ref.index(tuple(params))]
    kwargs = dict(params)
    for arg in inspect.signature(fn).parameters:
        if arg not in kwargs:
            kwargs[arg] = _fixture_value(namespace, arg, request)
    fn(**kwargs)


def registries_restored():
    """A fixture body: after the case, every series of each package's
    process-wide ``REGISTRY`` holds the value it had before it, and a
    series the case created is zeroed (``MetricsRegistry.reset``'s
    notion of empty). Mirrored bodies then leave no counts behind for a
    reference test that reads a counter's absolute value in the same
    process."""
    import copy
    import importlib

    registries = [importlib.import_module(f"{p}.obs.metrics").REGISTRY
                  for p in PACKAGES]
    saved = [{(name, key): copy.deepcopy(child)
              for name, fam in r._families.items()
              for key, child in fam._children.items()}
             for r in registries]
    yield
    for registry, before in zip(registries, saved):
        registry.reset()
        for name, fam in registry._families.items():
            for key, child in fam._children.items():
                if (name, key) in before:
                    for slot in type(child).__slots__:
                        setattr(child, slot,
                                getattr(before[name, key], slot))


def alfred_fixture(package, monkeypatch):
    """The ``alfred`` fixture of ``tests/conftest.py`` with the
    ingress taken from ``package``: ``start(...)`` returns the running
    server; teardown stops it and joins the thread."""
    import asyncio
    import importlib
    import threading

    state = {}
    ingress_mod = importlib.import_module(f"{package}.service.ingress")

    def start(tenants=None, server_versions=None, qos=None, slo=None):
        if server_versions is not None:
            monkeypatch.setattr(
                ingress_mod, "WIRE_VERSIONS", tuple(server_versions))
        server = ingress_mod.AlfredServer(tenants=tenants, qos=qos,
                                          slo=slo)
        loop = asyncio.new_event_loop()
        started = threading.Event()

        def run():
            asyncio.set_event_loop(loop)
            loop.run_until_complete(server.start())
            started.set()
            loop.run_forever()

        t = threading.Thread(target=run, daemon=True)
        t.start()
        assert started.wait(10)
        state.update(server=server, loop=loop, thread=t)
        return server

    yield start
    if state:
        fut = asyncio.run_coroutine_threadsafe(
            state["server"].stop(), state["loop"])
        try:
            fut.result(timeout=10)
        except Exception:
            pass
        state["loop"].call_soon_threadsafe(state["loop"].stop)
        state["thread"].join(timeout=10)


@functools.lru_cache(maxsize=None)
def _namespace(module: str, package: str, edits: tuple = ()) -> dict:
    """The reference test module's namespace, its imports taken from
    ``package``, with ``edits`` (``(old, new)`` pairs, each of which
    must occur) applied to the rewired source."""
    path = TESTS / f"{module}.py"
    source = re.sub(r"\bfluidframework_tpu\b", package, path.read_text())
    for old, new in edits:
        assert old in source, (module, old)
        source = source.replace(old, new)
    namespace = {"__name__": f"{module}[{package}]", "__file__": str(path)}
    # the code's file name keeps the module's own base name (a sanitizer
    # names a site by it) in a directory named for the package; linecache
    # holds the executed source, so tracebacks and site names read it
    filename = str(TESTS / f"[{package}]" / f"{module}.py")
    linecache.cache[filename] = (len(source), None,
                                 source.splitlines(True), filename)
    exec(compile(source, filename, "exec"), namespace)
    return namespace


def test_left_out_cases_exist():
    """Every case named as left out is still a test of the reference."""
    for module, names in LEFT_OUT.items():
        tree = ast.parse((TESTS / f"{module}.py").read_text())
        defined = {n.name for n in tree.body
                   if isinstance(n, ast.FunctionDef)}
        assert set(names) <= defined, module


@pytest.mark.parametrize("package", PACKAGES)
@pytest.mark.parametrize("module,name", _cases(),
                         ids=lambda v: v)
def test_mirrored(package, module, name, request):
    fn = _namespace(module, package)[name]
    assert not getattr(fn, "pytestmark", None), (
        f"{module}::{name} carries marks; mirror it by hand")
    run_mirrored(package, module, name, request)


@pytest.mark.slow
@pytest.mark.parametrize("package", PACKAGES)
def test_service_survives_kill_and_restart(package, request):
    """The service subprocess (``python -m <package>.service``) is
    SIGKILLed and restarted on its data dir; the reference's case,
    with its slow mark."""
    run_mirrored(package, "test_durable_storage",
                 "test_service_survives_kill_and_restart", request)
