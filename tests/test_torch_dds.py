"""The port's DDS catalogue against the JAX package's, on the CPU.

- The registry: the same 16 channel types, in the same order.
- One seeded ``LocalServer`` session per package with one channel of
  each of the 16 types in one datastore, two writers and a late joiner
  (``chip_smoke.mixed_session``, the "dds:" phase's mixed leg): the
  broadcast messages (as ``message_to_json`` records modulo the client
  and driver hop stamps, which read the wall clock), the scribe's
  summaries and every channel's ``summarize_core()`` in every Container
  are equal, and a summary written by either package loads in the other
  with equal channels. ``uuid.uuid4`` (consensus and ink ids) and the
  tree's move-pair counter are reset to the same deterministic state
  before each package's run.
- The port's own SharedMatrix session (``chip_smoke.matrix_session`` at
  bench config3's ``smoke`` scale) through the port's matrix plane on the
  CPU equals the reference's writers.
- The port's own SharedTree session (``chip_smoke.tree_session``)
  through ``ChannelKindRouter`` -> ``TreeSidecar(device="cpu")`` on both
  routes equals the reference's writers.
- ``run_dds_fuzz`` gives equal reports for every ``ACTIONS`` type on
  three seeds.
- Three faults of the reference, mirrored by the port (ROADMAP section
  C), pinned on both packages.

Exact equality throughout.
"""
import importlib
import itertools
import json
import uuid

import pytest

import chip_smoke

REF, PORT = "fluidframework_tpu", "fluidframework_tpu_torch"
PACKAGES = (REF, PORT)
DIRECTIONS = [(REF, PORT), (PORT, REF)]


def _mod(package: str, name: str):
    return importlib.import_module(f"{package}.{name}")


def _api(package: str):
    return chip_smoke.session_api(importlib.import_module(package))


@pytest.fixture()
def deterministic(monkeypatch):
    """``reset()`` puts ``uuid.uuid4`` and both packages' move-pair
    counters in the same state."""
    def reset():
        count = itertools.count(1)
        monkeypatch.setattr(uuid, "uuid4",
                            lambda: uuid.UUID(int=next(count)))
        for package in PACKAGES:
            monkeypatch.setattr(_mod(package, "models.tree.changeset"),
                                "_PAIR_COUNTER", itertools.count())
    return reset


def test_registry_lists_the_reference_types_in_order():
    ref = _mod(REF, "models").default_registry().types
    port = _mod(PORT, "models").default_registry().types
    assert port == ref
    assert len(port) == 16
    assert sorted(_mod(PORT, "models").__all__) == sorted(
        _mod(REF, "models").__all__)


# ----------------------------------------------------------------------
# every channel type in one datastore


def _log(package: str, messages: list) -> list:
    to_json = _mod(package, "protocol.serialization").message_to_json
    out = []
    for m in messages:
        rec = to_json(m)
        rec["traces"] = [t for t in rec.get("traces") or []
                         if t["service"] not in ("client", "driver")]
        out.append(json.dumps(rec, sort_keys=True, default=str))
    return out


def _channels(container, types_: tuple) -> list:
    ds = container.runtime.get_datastore("d")
    return [json.dumps(ds.get_channel(t).summarize_core(), sort_keys=True,
                       default=str) for t in types_]


def _mixed(package: str, seed: int) -> dict:
    api = _api(package)
    server_of = {}

    def on_document(server, _doc):
        server_of["server"] = server

    sessions = chip_smoke.mixed_session(api, 4, 4, seed,
                                        chip_smoke._SelfTimes(),
                                        on_document)
    server = server_of["server"]
    return {
        "api": api, "server": server, "sessions": sessions,
        "logs": {d: _log(package, s["messages"])
                 for d, s in sessions.items()},
        "summaries": {d: json.dumps(server.latest_summary(d).summary,
                                    sort_keys=True, default=str)
                      for d in sessions},
        "channels": {d: [_channels(c, api.types) for c in s["containers"]]
                     for d, s in sessions.items()},
    }


@pytest.mark.parametrize("seed", [10, 11])
def test_mixed_session_equals_reference(seed, deterministic):
    deterministic()
    ref = _mixed(REF, seed)
    deterministic()
    port = _mixed(PORT, seed)
    assert port["logs"] == ref["logs"]
    assert port["summaries"] == ref["summaries"]
    assert port["channels"] == ref["channels"]
    # within the session: the writers and the late joiner agree on every
    # channel in the form replicas agree on (the phase's check)
    for d, s in port["sessions"].items():
        for t in port["api"].types:
            chans = [c.runtime.get_datastore("d").get_channel(t)
                     for c in s["containers"]]
            forms = {chip_smoke._mixed_form(t, ch) for ch in chans}
            assert len(forms) == 1 or (t == "shareddirectory"
                                       and s["orphan_dir"]), (d, t)


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_mixed_summary_loads_across_packages(tmp_path, writer, reader,
                                             deterministic):
    """The scribe's summary of the mixed session and the tail after it,
    written by one package's file driver, load in both packages with
    equal channels: the summary alone, and the summary with the tail
    (which gives the writers' channels)."""
    deterministic()
    run = _mixed(writer, 12)
    types_ = run["api"].types
    server = run["server"]
    for doc, s in run["sessions"].items():
        latest = server.latest_summary(doc)
        path = tmp_path / f"{doc}.json"
        _mod(writer, "drivers").save_document(
            path, doc, server.read_ops(doc, 0),
            (latest.sequence_number, latest.summary))
        loaded = {}
        for package in (writer, reader):
            drivers = _mod(package, "drivers")
            container = _mod(package, "loader").Container
            loaded[package] = [
                _channels(container.load(
                    drivers.load_document(path), client_id="reader",
                    connect=False, replay_trailing=trailing), types_)
                for trailing in (False, True)]
        assert loaded[reader] == loaded[writer], doc
        fresh = _mod(reader, "loader").Container.load(
            _mod(reader, "drivers").load_document(path), client_id="r2",
            connect=False)
        for t in types_:
            want = chip_smoke._mixed_form(t, s["containers"][0].runtime
                                          .get_datastore("d").get_channel(t))
            got = chip_smoke._mixed_form(
                t, fresh.runtime.get_datastore("d").get_channel(t))
            assert got == want or (t == "shareddirectory"
                                   and s["orphan_dir"]), (doc, t)


# ----------------------------------------------------------------------
# the matrix and tree planes fed by the port's own sessions


def test_port_matrix_session_through_the_plane_equals_reference():
    from fluidframework_tpu_torch.ops.host_bridge import fetch
    from fluidframework_tpu_torch.ops.matrix_bridge import (
        MatrixStream, dispatch_matrix_batch, extract_matrix,
        pack_matrix_batch,
    )
    from fluidframework_tpu_torch.ops.matrix_cells import CellPack
    from fluidframework_tpu_torch.testing import MATRIX_SCALES

    cfg = MATRIX_SCALES["smoke"]
    ref = chip_smoke.matrix_session(_api(REF), cfg, 1337,
                                    chip_smoke._SelfTimes())
    port = chip_smoke.matrix_session(_api(PORT), cfg, 1337,
                                     chip_smoke._SelfTimes())
    streams = []
    for r, p in zip(ref, port):
        assert _log(PORT, p["messages"]) == _log(REF, r["messages"])
        for m in (*r["writers"], *p["writers"]):
            assert m.to_lists() == r["grid"]
        ms = MatrixStream()
        for msg in chip_smoke._log_stream(p["messages"], "d", "m"):
            ms.add_message(msg)
        streams.append(ms)
    table = fetch(dispatch_matrix_batch(pack_matrix_batch(streams),
                                        cfg.matrices, cfg.capacity,
                                        device="cpu"))
    assert not table["overflow"].any()
    cells = CellPack(cfg.rows, cfg.cols, device="cpu")
    cells.pack(streams)
    grid = cells.apply().numpy()
    for m, (r, ms) in enumerate(zip(ref, streams)):
        assert extract_matrix(table, ms, m) == r["grid"], m
        lww = dict(zip(zip(ms.cell_rows, ms.cell_cols), ms.cell_vals))
        for (rh, ch), v in lww.items():
            assert cells.lookup(grid, m, rh, ch) == v


@pytest.mark.parametrize("route", ["atom", "macro"])
def test_port_tree_session_through_the_router_equals_reference(route):
    from fluidframework_tpu_torch.service import (
        ChannelKindRouter, TreeSidecar,
    )

    ref = chip_smoke.tree_session(_api(REF), 3, 3, 6, 1700,
                                  chip_smoke._SelfTimes())
    router = ChannelKindRouter(tree=TreeSidecar(
        device="cpu", executor=route, max_docs=3, capacity=128,
        max_capacity=512))
    port = chip_smoke.tree_session(_api(PORT), 3, 3, 6, 1700,
                                   chip_smoke._SelfTimes(),
                                   router.subscribe, router.tree.apply)
    router.tree.sync()
    for r, p in zip(ref, port):
        assert p["signature"] == r["signature"]
        assert router.tree.signature(p["doc"], "d", "t") == r["signature"]
        assert len(p["messages"]) == len(r["messages"])
    assert router.tree.host_mode_docs() == 0
    assert not router.tree.overflowed()


# ----------------------------------------------------------------------
# the generic DDS fuzz


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize(
    "channel_type", sorted(_mod(PORT, "testing.dds_fuzz").ACTIONS))
def test_dds_fuzz_report_equals_reference(channel_type, seed):
    reports = []
    for package in PACKAGES:
        fuzz = _mod(package, "testing.dds_fuzz")
        r = fuzz.run_dds_fuzz(fuzz.DdsFuzzConfig(
            channel_type=channel_type, seed=seed, n_steps=120))
        reports.append((r.channel_type, r.seed, r.steps, r.actions,
                        r.reconnects, r.trace))
    assert reports[1] == reports[0]
    assert sorted(_mod(PORT, "testing.dds_fuzz").ACTIONS) == sorted(
        _mod(REF, "testing.dds_fuzz").ACTIONS)


# ----------------------------------------------------------------------
# faults of the reference, mirrored (ROADMAP section C)


def _two_writers(package: str, type_name: str):
    server = _mod(package, "service").LocalServer()
    factory = _mod(package, "drivers").LocalDocumentServiceFactory(server)
    container = _mod(package, "loader").Container
    a = container.load(factory.create_document_service("doc"),
                       client_id="a")
    ca = a.runtime.create_datastore("d").create_channel(type_name, "c")
    a.flush()
    b = container.load(factory.create_document_service("doc"),
                       client_id="b")
    return server, a, b, ca, b.runtime.get_datastore("d").get_channel("c")


@pytest.mark.parametrize("package", PACKAGES)
def test_directory_missing_parent_fault(package):
    """A subdirectory created under a parent its author lacks: the
    author holds the leaf alone, every other replica creates the parent
    too (``SharedDirectory.process_core``'s implicit ancestors), so a
    later write to the parent is dropped on the author."""
    _server, a, b, da, db = _two_writers(package, "shareddirectory")
    da.create_sub_directory("b", "/a")
    a.flush()
    db.set("k", 1, "/a")
    b.flush()
    assert da.summarize_core() == {"nodes": {"/": {}, "/a/b": {}}}
    assert db.summarize_core() == {
        "nodes": {"/": {}, "/a/b": {}, "/a": {"k": 1}}}


@pytest.mark.parametrize("package", PACKAGES)
def test_legacy_tree_edit_count_not_restored_by_load(package):
    """``LegacySharedTree.summarize_core`` writes ``edit_count`` (the
    edits the replica processed), which ``load_core`` does not restore:
    a replica loaded from a summary summarizes a count of 0."""
    _server, a, _b, ta, _tb = _two_writers(package, "legacysharedtree")
    lt = _mod(package, "models.legacy_tree")
    ta.apply(lt.insert_tree(
        [{"definition": "n", "identifier": "x", "payload": 1}],
        lt.place_at_start("root", "items")))
    a.flush()
    summary = ta.summarize_core()
    assert summary["edit_count"] == 1
    fresh = lt.LegacySharedTree("c")
    fresh.load_core(summary)
    assert fresh.summarize_core() == dict(summary, edit_count=0)


@pytest.mark.parametrize("package", PACKAGES)
def test_interval_op_into_the_merge_sidecar_raises(package):
    """An interval op on a SharedString that a merge sidecar serves
    reaches ``DocStream._add_op``, which reads ``op.type`` that an
    ``IntervalOp`` lacks: the orderer's broadcast raises
    ``AttributeError`` in both packages."""
    service = _mod(package, "service")
    server = service.LocalServer()
    if package == REF:
        sidecar = service.TpuMergeSidecar(max_docs=2, capacity=64)
    else:
        sidecar = service.GpuMergeSidecar(device="cpu", max_docs=2,
                                          capacity=64)
    sidecar.subscribe(server, "doc", "d", "s")
    factory = _mod(package, "drivers").LocalDocumentServiceFactory(server)
    c = _mod(package, "loader").Container.load(
        factory.create_document_service("doc"), client_id="w")
    s = c.runtime.create_datastore("d").create_channel("sharedstring", "s")
    s.insert_text(0, "hello")
    c.flush()
    s.get_interval_collection("x").add(0, 2, {"n": 1})
    with pytest.raises(AttributeError, match="IntervalOp"):
        c.flush()
