"""The port's observability plane against the JAX package's: the
registry families the sidecars, pools, tree sidecar, heat ledger, fault
plane, breaker, profiler and sanitizer register (names, kinds, labels),
the chaos site vocabulary and the canonical hop table are the
reference's; the same seeded stream through ``TpuMergeSidecar`` and
``GpuMergeSidecar(device="cpu")`` gives the same flight-record sequence
and the same hops per message; the heat attribution charges the same
documents the same milliseconds, conserved per round; the registry
counts what the sidecar's own counters count. Also the profiler's
device-trace hooks (record_function on the CPU, NVTX on a CUDA device)
and the window cost reckoning behind ``compiled_window``."""
import copy
import dataclasses
import json
import random

import numpy as np
import pytest
import torch

from fluidframework_tpu.obs import heat as ref_heat
from fluidframework_tpu.obs import metrics as ref_metrics
from fluidframework_tpu.obs import profiler as ref_profiler
from fluidframework_tpu.obs import trace as ref_trace
from fluidframework_tpu.obs.timeline import FleetTimeline as RefTimeline
from fluidframework_tpu.parallel import mesh_pool as ref_mesh_pool
from fluidframework_tpu.qos import breaker as ref_breaker
from fluidframework_tpu.qos import faults as ref_faults
from fluidframework_tpu.service import LocalServer, TpuMergeSidecar
from fluidframework_tpu.service import tpu_sidecar as ref_sidecar
from fluidframework_tpu.service import tree_sidecar as ref_tree
from fluidframework_tpu.testing import jitsan as ref_jitsan
from fluidframework_tpu_torch.obs import (
    REGISTRY,
    FleetTimeline,
    HeatLedger,
    attribute_round,
    heat,
    metrics,
    profiler,
    trace,
)
from fluidframework_tpu_torch.ops import event_graph, merge_chunk
from fluidframework_tpu_torch.ops.merge_kernel import (
    apply_window,
    apply_window_plain,
    compiled_window,
)
from fluidframework_tpu_torch.ops.merge_step import fused_step, table_to_state
from fluidframework_tpu_torch.ops.window_cost import step_ops_per_slot
from fluidframework_tpu_torch.parallel import mesh_pool
from fluidframework_tpu_torch.qos import breaker, faults
from fluidframework_tpu_torch.service import GpuMergeSidecar
from fluidframework_tpu_torch.service import gpu_sidecar, tree_sidecar
from fluidframework_tpu_torch.testing import (
    FuzzConfig,
    jitsan,
    record_op_stream,
    windows,
)
from test_torch_mesh_pool import (
    _grow_into_pool,
    _hot_rounds,
    _hotspot,
    _settle,
)

REF_MODULES = (ref_sidecar, ref_mesh_pool, ref_tree, ref_heat, ref_faults,
               ref_breaker, ref_profiler, ref_jitsan)
PORT_MODULES = (gpu_sidecar, mesh_pool, tree_sidecar, heat, faults,
                breaker, profiler, jitsan)
SITES = ("sidecar.dispatch", "sidecar.pool_dispatch", "sidecar.pool_admit",
         "sidecar.pool_migrate", "tree_sidecar.dispatch")
# the flight-record fields that do not carry a wall time
FLIGHT_FIELDS = ("round", "real_ops", "pool_ops", "capacity", "overflow",
                 "admitted", "failed", "slot", "slots")


def _families(modules, family_type) -> dict:
    return {v.name: (v.kind, v.labelnames)
            for m in modules for v in vars(m).values()
            if isinstance(v, family_type)}


def test_registry_families_match_reference():
    want = _families(REF_MODULES, ref_metrics._Family)
    got = _families(PORT_MODULES, metrics._Family)
    assert got == want
    assert len(got) >= 50
    ref_tl, port_tl = RefTimeline()._c_events, FleetTimeline()._c_events
    assert (port_tl.name, port_tl.kind, port_tl.labelnames) == \
        (ref_tl.name, ref_tl.kind, ref_tl.labelnames)


def test_chaos_sites_and_hop_table_match_reference():
    want = {n: s.kinds for n, s in ref_faults.PLANE.sites().items()
            if n in SITES}
    got = {n: s.kinds for n, s in faults.PLANE.sites().items()}
    assert got == want and sorted(got) == sorted(SITES)
    assert trace.CANONICAL_HOPS == ref_trace.CANONICAL_HOPS
    with pytest.raises(ValueError, match="unknown trace hop"):
        trace.stamp([], "warpdrive", "engage")  # fluidlint: disable=obs-untimed-hop -- the rule under test


def _wrap(stream):
    out = []
    for msg in stream:
        if msg.type == 2:  # an operation: into the runtime envelope
            msg = dataclasses.replace(msg, contents={
                "kind": "op", "address": "d", "channel": "s",
                "contents": msg.contents})
        out.append(msg)
    return out


def _corpus(n_docs=3, n_steps=70):
    return {f"doc-{i}": _wrap(record_op_stream(FuzzConfig(
        n_clients=3, n_steps=n_steps, seed=700 + i))[1])
        for i in range(n_docs)}


def _feed(sc, corpus, per_round=9):
    """Every document's stream, ``per_round`` messages per document per
    round, ``apply`` after each round, ``sync`` at the end; returns the
    messages as the sidecar saw them (its own copies) and what each
    ``apply`` returned."""
    msgs = {doc: copy.deepcopy(s) for doc, s in corpus.items()}
    for doc in msgs:
        sc.track(doc, "d", "s")
    applied = []
    longest = max(len(s) for s in msgs.values())
    for start in range(0, longest, per_round):
        for doc, stream in msgs.items():
            for msg in stream[start:start + per_round]:
                sc.ingest(doc, msg)
        applied.append(sc.apply())
    sc.sync()
    return msgs, applied


def _kinds(flight):
    return [(kind, {k: v for k, v in fields.items() if k in FLIGHT_FIELDS})
            for _i, _t, kind, fields in flight.events()]


@pytest.mark.parametrize("max_capacity", [64, 32])
def test_flight_records_and_hops_match_reference(max_capacity):
    """Grows, and at max_capacity=32 evictions too: the same record
    kinds with the same round / capacity / slot fields, and every
    message stamped sidecar:pack then sidecar:settle, as the
    reference does."""
    corpus = _corpus()
    kw = dict(max_docs=4, capacity=16, max_capacity=max_capacity,
              trace_ops=True)
    ref = TpuMergeSidecar(executor="scan", **kw)
    port = GpuMergeSidecar(device="cpu", **kw)
    ref_msgs, _ = _feed(ref, corpus)
    port_msgs, _ = _feed(port, corpus)
    assert _kinds(port.flight) == _kinds(ref.flight)
    kinds = {k for k, _ in _kinds(port.flight)}
    assert {"dispatch", "settle", "recover-grow"} <= kinds
    if max_capacity == 32:
        assert "recover-evict" in kinds and port.host_mode_docs() > 0
    assert port.flight.capacity == ref.flight.capacity == 256
    assert port.flight.name == ref.flight.name == "sidecar"
    assert "overflow flag set" in port.last_flight_dump
    for doc, stream in port_msgs.items():
        for got, want in zip(stream, ref_msgs[doc]):
            hops = [trace.hop_name(t) for t in got.traces]
            assert hops == [ref_trace.hop_name(t) for t in want.traces]
        hosted = port._slots[(doc, "d", "s")] in port._host
        if not hosted:
            assert [trace.hop_name(t) for t in stream[0].traces] == \
                ["sidecar:pack", "sidecar:settle"]
        assert port.text(doc, "d", "s") == ref.text(doc, "d", "s")


def test_trace_ops_env_default_and_typo(monkeypatch):
    monkeypatch.setenv("FFTPU_SIDECAR_TRACE", "1")
    assert GpuMergeSidecar(max_docs=1, capacity=16, device="cpu").trace_ops
    monkeypatch.setenv("FFTPU_SIDECAR_TRACE", "yes")
    with pytest.raises(ValueError, match="FFTPU_SIDECAR_TRACE"):
        GpuMergeSidecar(max_docs=1, capacity=16, device="cpu")
    monkeypatch.delenv("FFTPU_SIDECAR_TRACE")
    assert not GpuMergeSidecar(max_docs=1, capacity=16,
                               device="cpu").trace_ops


def test_registry_counts_equal_sidecar_counters():
    before = REGISTRY.flat()
    port = GpuMergeSidecar(max_docs=4, capacity=16, max_capacity=64,
                           device="cpu")
    _, applied = _feed(port, _corpus())
    delta = REGISTRY.delta(before)
    assert delta["sidecar_rounds_total"] == port.stats["rounds"] > 0
    assert delta["sidecar_real_ops_total"] == sum(applied) > 0
    assert delta["sidecar_grow_total"] == port.grow_count > 0
    assert delta["sidecar_pack_ms_count"] == port.stats["rounds"]
    assert REGISTRY.get("sidecar_capacity").value == port.capacity
    assert "sidecar_rounds_total" in REGISTRY.render_prometheus()


# ======================================================================
# heat attribution


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_attribute_round_matches_reference_and_conserves(seed):
    rng = random.Random(seed)
    want = ref_heat.HeatLedger(max_keys=16, clock=lambda: 0.0)
    got = HeatLedger(max_keys=16, clock=lambda: 0.0)
    usage_w, usage_g = (ref_heat.usage_ledger(clock=lambda: 0.0),
                        heat.usage_ledger(clock=lambda: 0.0))
    for _ in range(30):
        counts = {f"doc-{rng.randrange(24)}": rng.randrange(0, 9)
                  for _ in range(rng.randrange(1, 8))}
        round_ms = rng.uniform(0.0, 40.0)
        charged = attribute_round(got, counts, round_ms, usage=usage_g,
                                  tenant_of=lambda d: d[-1])
        assert charged == ref_heat.attribute_round(
            want, counts, round_ms, usage=usage_w,
            tenant_of=lambda d: d[-1])
        if sum(counts.values()):
            assert charged == pytest.approx(round_ms, rel=1e-12)
    assert got.snapshot() == want.snapshot()
    assert got.top_k(5) == want.top_k(5)
    assert usage_g.top_k(3, by="device_ms") == \
        usage_w.top_k(3, by="device_ms")
    assert got.evictions == want.evictions > 0


def _step_clock():
    t = [0.0]

    def clock():
        t[0] += 0.001
        return t[0]
    return clock


def test_sidecar_heat_matches_reference(monkeypatch):
    """Each round's ms (a step clock) is split over its documents by
    ops applied, at the settle boundary: the same charges as the
    reference's, and every round's charges sum to its ms."""
    rounds = []
    inner = gpu_sidecar.attribute_round

    def spy(ledger, counts, round_ms, **kw):
        charged = inner(ledger, counts, round_ms, **kw)
        rounds.append((round_ms, charged))
        return charged

    monkeypatch.setattr(gpu_sidecar, "attribute_round", spy)
    corpus = _corpus()
    ledgers = []
    for cls, kw in ((TpuMergeSidecar, {"executor": "scan"}),
                    (GpuMergeSidecar, {"device": "cpu"})):
        mod = ref_heat if cls is TpuMergeSidecar else heat
        ledger = mod.HeatLedger(clock=lambda: 0.0)
        _feed(cls(max_docs=4, capacity=16, max_capacity=64, heat=ledger,
                  attr_clock=_step_clock(), **kw), corpus)
        ledgers.append(ledger)
    want, got = ledgers
    assert got.snapshot() == want.snapshot() and len(got) == 3
    assert got.top_k(3) == want.top_k(3)
    assert rounds and all(c == pytest.approx(ms, rel=1e-12)
                          for ms, c in rounds)
    assert sum(got.get(k) for k in got.keys()) == pytest.approx(
        sum(ms for ms, _ in rounds), rel=1e-12)


def test_mesh_pool_timeline_and_migration_hops_match_reference():
    server = LocalServer()
    sidecars, docs, containers, strings = _hotspot(server)
    sidecars = sidecars[:2]
    for sc in sidecars:
        sc._pool.timeline = (RefTimeline if isinstance(sc, TpuMergeSidecar)
                             else FleetTimeline)(clock=lambda: 0.0)
    for doc in docs:
        _grow_into_pool(containers[doc], strings[doc])
    _settle(sidecars)
    _hot_rounds(sidecars, docs, containers, strings, 6)
    ref, port = (sc._pool for sc in sidecars)
    assert port.migration_count == ref.migration_count > 0
    assert port.timeline.deterministic_events() == \
        ref.timeline.deterministic_events()
    assert [trace.hop_name(t) for t in port.migration_traces] == \
        ["pool:migrate"] * port.migration_count


# ======================================================================
# the profiler


def test_device_trace_names_rounds_on_cpu_without_nvtx(monkeypatch,
                                                       tmp_path):
    """Enabled, every dispatch opens one record_function range named by
    round; on a CPU sidecar NVTX is never called (it raises in a CPU
    build); start/stop write the Chrome trace."""
    monkeypatch.setenv("FFTPU_DEVICE_TRACE", "1")

    def refuse(_name):
        raise AssertionError("NVTX on a CPU sidecar")

    monkeypatch.setattr(torch.cuda.nvtx, "range", refuse)
    assert profiler.start_device_trace(str(tmp_path))
    sc = GpuMergeSidecar(max_docs=4, capacity=16, max_capacity=64,
                         device="cpu")
    _feed(sc, _corpus(n_steps=30))
    assert profiler.stop_device_trace()
    events = json.loads((tmp_path / profiler.TRACE_FILE).read_text())
    names = [e["name"] for e in events["traceEvents"]
             if e.get("name", "").startswith("sidecar:dispatch:r")]
    assert sorted(names) == sorted(
        f"sidecar:dispatch:r{n}" for n in range(1, sc.stats["rounds"] + 1))


def test_device_trace_opens_nvtx_on_cuda_and_is_off_by_default(
        monkeypatch):
    opened = []

    class Range:
        def __init__(self, name):
            opened.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.cuda.nvtx, "range", Range)
    monkeypatch.delenv("FFTPU_DEVICE_TRACE", raising=False)
    with profiler.device_trace("r0", torch.device("cuda")):
        pass
    assert not profiler.start_device_trace("unused")
    assert not profiler.stop_device_trace()
    monkeypatch.setenv("FFTPU_DEVICE_TRACE", "1")
    with profiler.device_trace("r1", torch.device("cuda")):
        pass
    with profiler.device_trace("r2", "cpu"):
        pass
    assert opened == ["r1"]


def test_continuous_profiler_samples_and_accounts_its_cost():
    before = REGISTRY.flat()
    prof = profiler.ContinuousProfiler(interval_s=0.002)
    with prof:
        end = 0
        for i in range(400000):
            end += i * i
    assert prof.samples > 0 and not prof.running
    assert 0.0 < prof.overhead_fraction < 1.0
    assert prof.by_component().get("main", 0) > 0
    assert REGISTRY.delta(before).get(
        'profiler_samples_total{component="main"}', 0) > 0


# ======================================================================
# compiled_window's cost reckoning


def _former_live_slot_steps(table, batch) -> int:
    """The count ``chip_smoke.py`` made before the reckoning moved into
    the package: per real step, the document's live slots."""
    st = table_to_state(table)
    live = 0
    for w in range(batch.kind.shape[-1]):
        op = {f: getattr(batch, f)[:, w:w + 1] for f in batch._fields}
        real = (op["kind"] >= 0) & (op["kind"] <= 2)
        live += int((st["count"].long() * real).sum())
        st = fused_step(st, op)
    return live


def _reckoning(cost) -> tuple:
    return (cost.docs, cost.capacity, cost.window, cost.ops_per_slot_step,
            cost.live_slot_steps, cost.state_bytes, cost.op_bytes)


@pytest.mark.parametrize("D,C,W", [(5, 16, 16), (8, 64, 32), (3, 100, 8)])
def test_compiled_window_reckoning(D, C, W):
    rng = np.random.default_rng(D * C + W)
    table = windows.random_table(rng, D, C, "cpu")
    batch = windows.random_batch(rng, table, W, "cpu")
    fn, args, cost = compiled_window(table, batch)
    assert fn is apply_window_plain and args == (table, batch)
    assert "live_slot_steps" not in vars(cost)  # read lazily, below
    for got, want in zip(fn(*args), apply_window(table, batch)):
        assert torch.equal(got, want)
    assert step_ops_per_slot() == cost.ops_per_slot_step == 135
    assert cost.slot_steps == D * C * W
    assert cost.live_slot_steps == _former_live_slot_steps(table, batch)
    assert 0 < cost.live_slot_steps <= cost.slot_steps
    assert cost.nbytes == 2 * D * (12 * C + 3) * 4 + 12 * D * W * 4
    ms, by = cost.bound_ms(3.35e12, 132 * 64 * 1.98e9, live=False)
    assert by == "operations" and ms == pytest.approx(
        D * C * W * 135 / (132 * 64 * 1.98e9) * 1e3)
    # the macro-step routes read the same reckoning of the same window
    arrays = {f: getattr(batch, f).numpy() for f in batch._fields}
    fn, args, chunk_cost = merge_chunk.compiled_window(
        table, merge_chunk.compile_chunks(arrays))
    assert _reckoning(chunk_cost) == _reckoning(cost)
    for got, want in zip(fn(*args), merge_chunk.apply_window_chunked(
            table, merge_chunk.compile_chunks(arrays))):
        assert torch.equal(got, want)
    prefix = event_graph.build_event_graph(arrays)["prefix"]
    if prefix is not None:
        fn, args, walk_cost = event_graph.compiled_window(table, prefix)
        assert fn is event_graph.apply_window_egwalker
        assert walk_cost.ops_per_slot_step == 135
        for got, want in zip(fn(*args), event_graph.apply_window_egwalker(
                table, prefix)):
            assert torch.equal(got, want)
