"""The port's framework-era layers against the JAX package's, on the CPU,
on the same seeds; exact equality throughout.

- ``record_flow_stream`` records the same sequenced stream (modulo the
  wall-clock timestamps) and the same encoding in both packages.
- A corpus shaped as bench's ``_build_streams`` (three fuzz-mix streams
  and one webflow-mix stream in every four; ``chip_smoke.bench_streams``
  in the port) gives the same encoding, and one window of it through the
  reference's ``apply_window_impl`` and through the port's plain
  ``apply_window`` gives equal live fields, ``count``, ``min_seq`` and
  ``overflow``.
- A live session with a ``SummaryManager`` on every writer, a
  ``GarbageCollector`` on every runtime and an ``OpStreamAttributor`` on
  writer B elects the same client, stores equal summaries (their GC
  state too) and encodes the same attribution.
- ``IdCompressor`` gives the same ids over a seeded script of three
  sessions.
- ``GpuMergeSidecar(usage=, tenant_of=)`` rolls a session's device time
  up to the same per-tenant usage as ``TpuMergeSidecar``, and
  ``serve_bench`` with ``heat=True`` and a sidecar reports the same
  tenants.
- ``FFTPU_SIDECAR_PIPELINE`` set to ``0``, ``1``, unset or a typo acts
  the same on both merge sidecars and both tree sidecars.
"""
import importlib
import itertools
import random
import re
import uuid

import pytest

import chip_smoke

REF, PORT = "fluidframework_tpu", "fluidframework_tpu_torch"
PACKAGES = (REF, PORT)


def _mod(package: str, name: str):
    return importlib.import_module(f"{package}.{name}")


@pytest.fixture()
def deterministic(monkeypatch):
    """``reset()`` puts ``uuid.uuid4`` in the same state for each
    package's run."""
    def reset():
        count = itertools.count(1)
        monkeypatch.setattr(uuid, "uuid4",
                            lambda: uuid.UUID(int=next(count)))
    return reset


def _untimed(stream) -> list:
    """A stream's messages with their wall-clock timestamps blanked."""
    return [re.sub(r"timestamp=[-+.e0-9]+", "timestamp=_", repr(m))
            for m in stream]


def _enc_key(enc):
    return (enc.ops, enc.payloads, enc.client_ids, enc.prop_keys,
            enc.prop_vals)


# ----------------------------------------------------------------------
# the webflow-mix recorder and bench's corpus


@pytest.mark.parametrize("seed", [0, 3, 31340])
def test_record_flow_stream_matches_reference(seed, deterministic):
    recorded = []
    for package in PACKAGES:
        deterministic()
        recorded.append(_mod(package, "testing").record_flow_stream(
            seed=seed, n_clients=4, n_steps=120))
    (ref_text, ref_stream), (text, stream) = recorded
    assert text == ref_text
    assert _untimed(stream) == _untimed(ref_stream)
    assert _enc_key(_mod(PORT, "ops.host_bridge").encode_stream(stream)) \
        == _enc_key(_mod(REF, "ops.host_bridge").encode_stream(ref_stream))


@pytest.mark.parametrize("seed0", [31337, 4200])
def test_bench_corpus_window_matches_reference(seed0):
    import bench
    from fluidframework_tpu.ops import fetch as ref_fetch
    from fluidframework_tpu.ops import make_table as ref_make_table
    from fluidframework_tpu.ops.merge_kernel import apply_window_impl
    from fluidframework_tpu_torch.convert import batch_from_numpy
    from fluidframework_tpu_torch.ops import host_bridge as hb
    from fluidframework_tpu_torch.ops.merge_kernel import apply_window
    from fluidframework_tpu_torch.ops.segment_table import make_table
    from fluidframework_tpu_torch.protocol.messages import MessageType
    from fluidframework_tpu_torch.testing.windows import live_difference

    _, enc_ref = bench._build_streams(8, 60, 3, seed0=seed0)
    raw = chip_smoke.bench_streams(8, 60, 3, seed0)
    encs = [hb.encode_stream(s) for s in raw]
    assert [_enc_key(e) for e in encs] == [_enc_key(e) for e in enc_ref]
    # the flow quarter carries markers and fills the four channels
    assert any(getattr(m.contents, "marker", None) is not None
               for m in raw[3] if m.type == MessageType.OPERATION)
    assert sorted(encs[3].prop_keys) == ["class", "heading", "pairId", "tag"]
    tiled = [encs[d % len(encs)] for d in range(16)]
    batch = hb.build_batch(tiled)
    want = ref_fetch(apply_window_impl(ref_make_table(16, 512),
                                       batch))
    got = hb.fetch(apply_window(make_table(16, 512, "cpu"),
                                batch_from_numpy(batch, "cpu")))
    assert not want["overflow"].any()
    assert live_difference(want, got) is None
    for d in range(len(encs)):
        assert hb.extract_text(got, tiled[d], d) == chip_smoke._oracle(
            raw[d])[0]


# ----------------------------------------------------------------------
# the summarizer, GC and attribution in one live session


def _summary_session(package: str) -> dict:
    """Two writers on a manual-clock LocalServer, each with a
    SummaryManager (its time heuristic on a session clock moved once)
    and a GarbageCollector, writer B with an OpStreamAttributor; three
    rounds of seeded edits, a GC pass and the summarizers' tick after
    the second."""
    runtime = _mod(package, "runtime")
    gc_mod = _mod(package, "runtime.gc")
    attribution = _mod(package, "runtime.attribution")
    tick = itertools.count(1)
    server = _mod(package, "service").LocalServer(
        clock=lambda: 1000.0 + next(tick) * 0.001)
    factory = _mod(package, "drivers").LocalDocumentServiceFactory(server)
    container = _mod(package, "loader").Container
    session_clock = {"t": 0.0}

    def heuristics():
        return runtime.SummarizerHeuristics(
            max_ops=1 << 30, max_time_s=1.0,
            clock=lambda: session_clock["t"])

    pair = [container.load(factory.create_document_service("doc"),
                           client_id=who) for who in ("a", "b")]
    managers = [runtime.SummaryManager(c, heuristics_factory=heuristics)
                for c in pair]
    collectors = [gc_mod.GarbageCollector(
        c.runtime, clock=lambda: session_clock["t"]) for c in pair]
    attributor = attribution.OpStreamAttributor(pair[1])
    pair[0].runtime.create_datastore("d").create_channel("sharedstring",
                                                         "s")
    pair[0].runtime.create_datastore("side", root=False)
    pair[0].flush()
    rng = random.Random(5)
    for rnd in range(3):
        for c in pair:
            s = c.runtime.get_datastore("d").get_channel("s")
            for _ in range(6):
                chip_smoke._service_edit(rng, s)
            c.flush()
        if rnd == 1:
            session_clock["t"] = 1.0
            for collector in collectors:
                collector.collect()
            for manager in managers:
                manager.tick()
    summary = server.latest_summary("doc")
    return {
        "elected": [m.election.elected for m in managers],
        "summarizer": [m.is_summarizer for m in managers],
        "produced": managers[0].running.summaries_produced,
        "summary": (summary.sequence_number, summary.summary),
        "gc": [c.snapshot() for c in collectors],
        "attribution": attributor.encode(),
        "entries": len(attributor),
        "decoded": len(attribution.Attributor.decode(attributor.encode())),
        "text": pair[1].runtime.get_datastore("d").get_channel(
            "s").get_text(),
    }


def test_summarizer_gc_attribution_session_matches_reference(
        deterministic):
    runs = []
    for package in PACKAGES:
        deterministic()
        runs.append(_summary_session(package))
    ref, port = runs
    assert port == ref
    assert ref["elected"] == ["a", "a"] and ref["summarizer"] == [True,
                                                                  False]
    assert ref["produced"] == 1
    assert "/side" in ref["summary"][1]["runtime"]["gc"][
        "unreferencedSince"]
    assert ref["entries"] == ref["decoded"] > 0


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_id_compressor_matches_reference(seed):
    def script(package):
        compressor = _mod(package, "utils.id_compressor").IdCompressor
        rng = random.Random(seed)
        replicas = [compressor(f"session-{i}", cluster_capacity=4)
                    for i in range(3)]
        out, local = [], {i: [] for i in range(3)}
        for _ in range(60):
            i = rng.randrange(3)
            if rng.random() < 0.7:
                local[i].append(replicas[i].generate_compressed_id())
                out.append(("local", i, local[i][-1]))
                continue
            creation = replicas[i].take_next_creation_range()
            if creation is None:
                continue
            for r in replicas:  # sequenced: every replica finalizes
                r.finalize_creation_range(creation)
            for j, r in enumerate(replicas):
                finals = [replicas[i].normalize_to_op_space(x)
                          for x in local[i]]
                out.append(("final", i, j, finals,
                            [r.normalize_to_session_space(f, replicas[i]
                             .session_id) for f in finals],
                            [r.decompress(f) for f in finals]))
        snap = replicas[0].snapshot()
        restored = compressor.restore(snap, "other")
        out.append(("snapshot", snap, [restored.recompress(
            replicas[0].decompress(f)) for f in range(2)]))
        return out

    assert script(PORT) == script(REF)


# ----------------------------------------------------------------------
# per-tenant usage, serve_bench's heat report, FFTPU_SIDECAR_PIPELINE


def _sidecar(package: str, **kw):
    if package == REF:
        return _mod(REF, "service.tpu_sidecar").TpuMergeSidecar(**kw)
    return _mod(PORT, "service").GpuMergeSidecar(device="cpu", **kw)


def _tree_sidecar(package: str, **kw):
    if package == REF:
        return _mod(REF, "service.tree_sidecar").TreeSidecar(**kw)
    return _mod(PORT, "service").TreeSidecar(device="cpu", **kw)


def test_sidecar_usage_rollup_matches_reference():
    snapshots = []
    for package in PACKAGES:
        heat = _mod(package, "obs.heat")
        step = _mod(package, "tools.serve_bench")._StepClock
        testing = _mod(package, "testing")
        usage = heat.usage_ledger(clock=step())
        ledger = heat.HeatLedger(clock=step())
        sidecar = _sidecar(
            package, max_docs=6, capacity=256, heat=ledger, usage=usage,
            tenant_of=_mod(package, "tools.serve_bench")._tenant_of_doc,
            attr_clock=step())
        streams = [chip_smoke._wrap(testing.record_op_stream(
            testing.FuzzConfig(n_clients=2, n_steps=40, seed=70 + i))[1])
            for i in range(6)]
        for d in range(6):
            sidecar.track(f"sdoc-{d}", "d", "s")
        for start in range(0, 60, 12):
            for d, stream in enumerate(streams):
                for msg in stream[start:start + 12 + d]:
                    sidecar.ingest(f"sdoc-{d}", msg)
            sidecar.apply()
        sidecar.sync()
        snapshots.append((usage.snapshot(), ledger.snapshot(),
                          usage.top_k(3, by="device_ms")))
    assert snapshots[1] == snapshots[0]
    tenants = snapshots[0][0]
    assert len(tenants) == 3
    assert all(t["device_ms"] > 0 for t in tenants.values())
    assert sum(t["device_ms"] for t in tenants.values()) == pytest.approx(
        sum(d["heat"] for d in snapshots[0][1].values()), rel=1e-12)


def test_serve_bench_heat_tenants_match_reference():
    reports = []
    for package in PACKAGES:
        sb = _mod(package, "tools.serve_bench")
        kw = dict(n_docs=64, duration_s=0.5, sidecar_docs=8, heat=True,
                  seed=90)
        if package == PORT:
            kw["sidecar_device"] = "cpu"
        reports.append(sb.run_serve_bench(sb.ServeBenchConfig(**kw)))
    ref, port = reports
    assert ref.heat_top_tenants, "the reference filled no tenants"
    assert port.heat_top_tenants == ref.heat_top_tenants
    assert port.heat_top_docs == ref.heat_top_docs
    assert port.heat_attributed_ms == ref.heat_attributed_ms
    assert sum(v for _, v in port.heat_top_tenants) == pytest.approx(
        port.heat_attributed_ms, rel=1e-12)


@pytest.mark.parametrize("make", [_sidecar, _tree_sidecar],
                         ids=["merge", "tree"])
@pytest.mark.parametrize("env", [None, "0", "1", "yes"])
def test_pipeline_env_matches_reference(make, env, monkeypatch):
    if env is None:
        monkeypatch.delenv("FFTPU_SIDECAR_PIPELINE", raising=False)
    else:
        monkeypatch.setenv("FFTPU_SIDECAR_PIPELINE", env)
    outcomes = []
    for package in PACKAGES:
        try:
            outcomes.append(make(package).pipeline)
        except ValueError as e:
            outcomes.append(str(e))
        # the argument wins over the variable, a typo included
        assert make(package, pipeline=False).pipeline is False
    assert outcomes[1] == outcomes[0]
    want = {None: True, "0": False, "1": True,
            "yes": "FFTPU_SIDECAR_PIPELINE='yes': expected '0' or '1'"}
    assert outcomes[0] == want[env]

