"""The port's tools against the JAX package's, on the CPU.

- A seeded two-writer session (a SharedString and a SharedMap, a manual
  server clock) recorded through either package and saved with its
  ``save_document``: the other package's ``save_document`` of the same
  messages writes the same bytes, and both packages' ``replay_file``
  (with checkpoints) give the same ``ops_replayed``, ``final_seq``,
  text and checkpoint summaries; a validation replay against the other
  package's checkpoints reports no mismatch; ``export_file`` gives the
  same JSON.
- ``benchmark()`` with ``time.perf_counter`` replaced by one fixed
  sequence gives the same ``to_json()``, ``render_table()`` and
  ``render_json()`` in both packages.
- ``fetch`` from each package's own in-process TCP server on a seeded
  single-writer session gives the same file, modulo the hops that read
  the wall clock (client, driver, ingress) and a join's client-detail
  time; the fetched ops are the server's op log.
- The replayed documents, ingested into ``GpuMergeSidecar(device="cpu")``
  and the reference's ``TpuMergeSidecar`` (``JAX_PLATFORMS=cpu``), give
  the same texts and signatures, equal to the replay's.
- The commands ``net_stress`` spawns name ``fluidframework_tpu_torch``
  and never the JAX package.
- ``op_trace`` and ``heat_dump`` build their sidecar on ``cuda`` unless
  told otherwise, so without a card they fail rather than fall back.
- Both sidecars keep ``last_settled_msgs`` (``op_trace`` reads it; the
  port's lacked it until the examples were copied).
- A fault of the reference, kept alike: a fetched file of a summarized
  document does not replay (ROADMAP.md section C).

Tolerance: exact for every compared field.
"""
import importlib
import json
import os
import random
import re
import subprocess
import sys
import types

import pytest

from test_torch_ingress import WALL_HOPS, _clock, _serving, _until
from test_torch_ingress import _api as _tcp_api

REF, PORT = "fluidframework_tpu", "fluidframework_tpu_torch"
PACKAGES = (REF, PORT)
DOCS = ("doc-0", "doc-1", "doc-2")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _api(package: str) -> types.SimpleNamespace:
    def m(name):
        return importlib.import_module(f"{package}.{name}")

    tools = m("tools")
    return types.SimpleNamespace(
        LocalServer=m("service.local_server").LocalServer,
        factory=m("drivers").LocalDocumentServiceFactory,
        Container=m("loader").Container,
        save_document=m("drivers").save_document,
        load_document=m("drivers.file_driver").load_document,
        encode_contents=m("protocol.serialization").encode_contents,
        replay_file=tools.replay_file,
        export_file=tools.export_file,
        benchmark=tools.benchmark,
        BenchmarkReporter=tools.BenchmarkReporter,
        BenchmarkType=tools.BenchmarkType,
        fetch=m("tools.fetch_tool").fetch,
    )


def _edit(rng, s, m, tag: str) -> None:
    n = s.get_length()
    r = rng.random()
    if r < 0.55 or n == 0:
        s.insert_text(rng.randint(0, n), "".join(
            rng.choice("abcdef ") for _ in range(rng.randint(1, 6))))
    elif r < 0.8:
        start = rng.randrange(n)
        s.remove_text(start, min(n, start + rng.randint(1, 5)))
    elif r < 0.9:
        start = rng.randrange(n)
        s.annotate_range(start, min(n, start + 3), {"b": rng.randint(0, 2)})
    else:
        m.set(f"{tag}-{rng.randint(0, 3)}", rng.randint(0, 99))


def record(package: str, tmp_path, seed: int) -> dict:
    """Each document of ``DOCS``: two writers, 3 rounds of 6 edits
    each, saved to ``tmp_path/<package>/<doc>.json``; returns the
    live text and signature per document."""
    api = _api(package)
    server = api.LocalServer(clock=_clock())
    factory = api.factory(server)
    rng = random.Random(seed)
    out = {}
    (tmp_path / package).mkdir()
    for doc in DOCS:
        a, b = (api.Container.load(factory.create_document_service(doc),
                                   client_id=f"{doc}-{w}") for w in "ab")
        ds = a.runtime.create_datastore("d")
        ds.create_channel("sharedstring", "s")
        ds.create_channel("sharedmap", "m")
        a.flush()
        for _ in range(3):
            for c, tag in ((a, "a"), (b, "b")):
                ds_c = c.runtime.get_datastore("d")
                for _ in range(6):
                    _edit(rng, ds_c.get_channel("s"), ds_c.get_channel("m"),
                          tag)
                c.flush()
        s = a.runtime.get_datastore("d").get_channel("s")
        api.save_document(tmp_path / package / f"{doc}.json", doc,
                          server.read_ops(doc, 0))
        out[doc] = (s.get_text(), s.signature())
    return out


def _replayed(package: str, path, **kwargs):
    api = _api(package)
    container, report = api.replay_file(path, **kwargs)
    s = container.runtime.get_datastore("d").get_channel("s")
    return {
        "ops": report.ops_replayed, "final_seq": report.final_seq,
        "text": s.get_text(), "signature": s.signature(),
        "checkpoints": json.dumps(api.encode_contents(report.checkpoints),
                                  sort_keys=True),
        "mismatches": report.mismatches,
    }, report.checkpoints


@pytest.mark.parametrize("recorder", PACKAGES)
def test_saved_replayed_and_exported_alike(recorder, tmp_path):
    live = record(recorder, tmp_path, seed=17)
    for doc in DOCS:
        path = tmp_path / recorder / f"{doc}.json"
        saved = path.read_bytes()
        for package in PACKAGES:
            api = _api(package)
            again = tmp_path / f"{package}-{doc}.json"
            api.save_document(again, doc, api.load_document(path)
                              .read_ops(0))
            assert again.read_bytes() == saved, (package, doc)
        (ref, ref_cps), (port, port_cps) = (
            _replayed(p, path, checkpoint_every=4) for p in PACKAGES)
        assert ref == port
        assert (port["text"], port["signature"]) == live[doc]
        assert port["ops"] > 20 and port_cps
        # validation mode: each package against the other's checkpoints
        for package, want in ((REF, port_cps), (PORT, ref_cps)):
            valid, _ = _replayed(package, path, checkpoint_every=4,
                                 expected_checkpoints=want)
            assert valid["mismatches"] == [], package
        exports = [json.dumps(_api(p).export_file(path), sort_keys=True)
                   for p in PACKAGES]
        assert exports[0] == exports[1]
        assert json.loads(exports[1])["content"]["d"]["s"]["text"] == \
            live[doc][0]


def test_replayed_documents_serve_alike_in_both_sidecars(tmp_path,
                                                          monkeypatch):
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    from fluidframework_tpu.service.tpu_sidecar import TpuMergeSidecar
    from fluidframework_tpu_torch.service import GpuMergeSidecar

    live = record(PORT, tmp_path, seed=23)
    served = []
    for package, sidecar in ((REF, TpuMergeSidecar(max_docs=4,
                                                   capacity=128)),
                             (PORT, GpuMergeSidecar(max_docs=4, capacity=128,
                                                    device="cpu"))):
        api = _api(package)
        for doc in DOCS:
            sidecar.track(doc, "d", "s")
            for msg in api.load_document(tmp_path / PORT / f"{doc}.json") \
                    .read_ops(0):
                sidecar.ingest(doc, msg)
        assert sidecar.apply() > 0
        sidecar.sync()
        served.append({doc: (sidecar.text(doc, "d", "s"),
                             sidecar.signature(doc, "d", "s"))
                       for doc in DOCS})
    assert served[0] == served[1]
    for doc in DOCS:
        replayed, _ = _replayed(PORT, tmp_path / PORT / f"{doc}.json")
        assert served[1][doc][0] == replayed["text"] == live[doc][0]


def test_benchmark_statistics_alike(monkeypatch):
    import time

    outs = []
    for package in PACKAGES:
        api = _api(package)
        ticks = iter([0.0, 0.004, 0.010, 0.011, 0.020, 0.027, 0.030,
                      0.0305, 0.040, 0.052, 0.060, 0.0601])
        monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))
        reporter = api.BenchmarkReporter()
        seen = []
        result = reporter.add(api.benchmark(
            "round", seen.append, setup=lambda: len(seen),
            min_iterations=6, min_time_s=0.0, warmup=1,
            benchmark_type=api.BenchmarkType.DIAGNOSTIC))
        monkeypatch.undo()
        assert seen == list(range(7))
        outs.append((result.to_json(), result.samples_s,
                     reporter.render_table(), reporter.render_json()))
    assert outs[0] == outs[1]
    assert outs[1][0]["iterations"] == 6


def _canon(blob: dict) -> dict:
    """A fetched file without what reads the wall clock."""
    out = []
    for rec in blob["messages"]:
        rec = dict(rec, traces=[t for t in rec.get("traces") or []
                                if t["service"] not in WALL_HOPS])
        contents = rec.get("contents")
        if isinstance(contents, dict) and "__clientdetail__" in contents:
            detail = dict(contents["__clientdetail__"])
            detail.pop("timestamp", None)
            rec["contents"] = {**contents, "__clientdetail__": detail}
        out.append(rec)
    return dict(blob, messages=out)


def test_fetched_documents_alike(tmp_path):
    fetched = []
    for package in PACKAGES:
        api, tcp = _api(package), _tcp_api(package)
        rng = random.Random(31)
        with _serving(tcp) as alfred:
            svc = tcp.SocketDocumentService("127.0.0.1", alfred.port,
                                            "fetched")
            with svc.lock:
                c = tcp.Container.load(svc, client_id="writer")
                ds = c.runtime.create_datastore("d")
                s = ds.create_channel("sharedstring", "s")
                m = ds.create_channel("sharedmap", "m")
                c.flush()
            for _ in range(4):
                with svc.lock:
                    for _ in range(5):
                        _edit(rng, s, m, "w")
                    c.flush()
                _until(lambda: c.runtime.pending.count == 0, "acks")
            out = tmp_path / f"{package}.json"
            report = api.fetch("127.0.0.1", alfred.port, "fetched", str(out))
            want = [tcp.message_to_json(msg)
                    for msg in alfred.local.read_ops("fetched", 0)]
            with svc.lock:
                c.close()
            svc.close()
        blob = json.loads(out.read_text())
        assert report["ops"] == len(want) > 20
        assert blob["messages"] == json.loads(json.dumps(want))
        fetched.append(_canon(blob))
    assert fetched[0] == fetched[1]


def test_net_stress_spawns_only_the_port(monkeypatch):
    from fluidframework_tpu_torch.tools import net_stress

    spawned = []
    real = subprocess.Popen

    def recording(cmd, *args, **kwargs):
        spawned.append((cmd, kwargs.get("env")))
        return real(cmd, *args, **kwargs)

    monkeypatch.setattr(subprocess, "Popen", recording)
    report = net_stress.run_net_stress(n_workers=2, n_ops=4, seed=5)
    assert len({w["text_sha"] for w in report["workers"]}) == 1
    assert len(spawned) == 3
    for cmd, env in spawned:
        line = " ".join(cmd)
        assert "fluidframework_tpu_torch." in line, line
        assert not re.search(r"\bfluidframework_tpu\.", line), line
        assert env is None or "JAX_PLATFORMS" not in env
    assert spawned[0][0][1:3] == ["-m", "fluidframework_tpu_torch.service"]


@pytest.mark.parametrize("name", ["op_trace", "heat_dump"])
def test_sidecar_examples_default_to_the_card(name):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default would run")
    proc = subprocess.run(
        [sys.executable, "-m", f"{PORT}.examples.{name}"],
        capture_output=True, text=True, cwd=REPO, timeout=120)
    assert proc.returncode != 0
    assert "OK" not in proc.stdout
    assert re.search(r"CUDA|cuda", proc.stderr), proc.stderr[-2000:]


def test_sidecar_keeps_the_last_settled_messages_like_the_reference(
        monkeypatch):
    """``op_trace`` reads an op's dispatch hops from
    ``last_settled_msgs``, which the reference sidecar keeps
    (``service/tpu_sidecar.py:648``, ``:1236``)."""
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    from fluidframework_tpu.service.tpu_sidecar import TpuMergeSidecar
    from fluidframework_tpu_torch.service import GpuMergeSidecar

    seen = []
    for package, make in ((REF, TpuMergeSidecar),
                          (PORT, lambda **kw: GpuMergeSidecar(device="cpu",
                                                              **kw))):
        m = importlib.import_module(f"{package}.protocol.messages")
        ops = importlib.import_module(f"{package}.models.mergetree.ops")
        sc = make(max_docs=4, capacity=128, trace_ops=True)
        assert sc.last_settled_msgs == []
        sc.track("d", "ds", "ch")
        msg = m.SequencedMessage(
            client_id="c1", sequence_number=1, minimum_sequence_number=0,
            client_sequence_number=1, reference_sequence_number=0,
            type=m.MessageType.OPERATION,
            contents={"kind": "op", "address": "ds", "channel": "ch",
                      "contents": ops.InsertOp(pos1=0, text="hi")})
        sc.ingest("d", msg)
        assert sc.apply() == 1
        sc.sync()
        assert sc.last_settled_msgs == [msg]
        seen.append([(t.service, t.action) for t in msg.traces])
    assert seen[0] == seen[1]


def test_fetched_summarized_document_replay_fault_matches_reference(
        tmp_path):
    """A fault of the reference, kept: ``fetch`` reads the ops after the
    summary's own sequence number (the summarize op's), while the
    summary's state stops just before it, so replaying the fetched file
    breaks at the summarize op. The port fails the same way."""
    failures = []
    for package in PACKAGES:
        api, tcp = _api(package), _tcp_api(package)
        with _serving(tcp) as alfred:
            svc = tcp.SocketDocumentService("127.0.0.1", alfred.port, "sum")
            acks = []
            with svc.lock:
                c = tcp.Container.load(svc, client_id="writer")
                s = c.runtime.create_datastore("d").create_channel(
                    "sharedstring", "s")
                c.flush()
                s.insert_text(0, "summarized")
                c.flush()
            _until(lambda: c.runtime.pending.count == 0, "acks")
            with svc.lock:
                c.on("summaryAck", acks.append)
                c.summarize()
            _until(lambda: acks, "the summary's ack")
            with svc.lock:
                s.insert_text(0, "tail ")
                c.flush()
            _until(lambda: c.runtime.pending.count == 0, "acks")
            out = tmp_path / f"{package}.json"
            report = api.fetch("127.0.0.1", alfred.port, "sum", str(out))
            summary_seq = alfred.local.latest_summary("sum").sequence_number
            with svc.lock:
                c.close()
            svc.close()
        assert report["summary_seq"] == summary_seq
        assert json.loads(out.read_text())["messages"][0][
            "sequenceNumber"] == summary_seq + 1
        with pytest.raises(AssertionError, match="inbound stream broken") \
                as err:
            api.replay_file(out)
        failures.append(str(err.value).splitlines()[0])
    assert failures[0] == failures[1]
