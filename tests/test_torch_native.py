"""The native host layer and the chaos harness across the two packages,
on the CPU: bench config5's array lane at bench's ``smoke`` size
(``chip_smoke.config5_rounds`` / ``run_config5``: the same columnar
rounds ticketed by each package's ``MultiDocSequencer.ticket_boxcar``
and applied by each package's scan), and the chaos storms of bench's
config11-13 at 60 steps. Exact: the work is integer-only and the
storms run on a step clock."""
import importlib

import numpy as np
import pytest

import chip_smoke
from test_torch_native_build import reference_native

PACKAGES = ("fluidframework_tpu", "fluidframework_tpu_torch")


@pytest.fixture(autouse=True)
def _reference_libraries():
    """The reference's libraries, built race-free under xdist."""
    reference_native()


def _corpus(package, base, steps, clients):
    """bench's ``_build_streams`` from ``package``'s own recorders."""
    testing = importlib.import_module(f"{package}.testing")
    ops = importlib.import_module(f"{package}.ops")
    raw = [testing.record_flow_stream(
        seed=chip_smoke.CONFIG5_SEED0 + i, n_clients=clients,
        n_steps=steps)[1] if i % 4 == 3
        else testing.record_op_stream(testing.FuzzConfig(
            n_clients=clients, n_steps=steps,
            seed=chip_smoke.CONFIG5_SEED0 + i, insert_weight=0.55,
            remove_weight=0.25, annotate_weight=0.05,
            process_weight=0.15))[1]
        for i in range(base)]
    return raw, [ops.encode_stream(s) for s in raw]


def _lane(package, rounds, docs, clients, cap):
    """One pass of the array lane in ``package`` on the CPU: the table
    (as numpy) and every round's (seq, msn, status)."""
    seq_core = importlib.import_module(f"{package}.native.sequencer_core")
    ops = importlib.import_module(f"{package}.ops")
    if package == "fluidframework_tpu":
        table = ops.make_table(docs, cap)

        def upload(arrays):
            return ops.OpBatch(**arrays)
    else:
        from fluidframework_tpu_torch.convert import batch_from_numpy

        table = ops.make_table(docs, cap, "cpu")

        def upload(arrays):
            return batch_from_numpy(arrays, "cpu")
    tickets = []
    table, total, walls = chip_smoke.run_config5(
        chip_smoke.config5_sequencer(seq_core.MultiDocSequencer, docs,
                                     clients), table, rounds,
        upload, ops.apply_window, tickets=tickets)
    assert len(walls) == len(rounds) and total == sum(
        len(rd["flat_dst"]) for rd in rounds)
    return ops.fetch(table), tickets


def test_config5_array_lane_smoke_equals_reference():
    """Corpus, columnar rounds, tickets (seq, msn, status), every table
    field on the live slots with count / min_seq / overflow, and every
    document's text against the MergeTreeClient oracle: equal in both
    packages at bench's smoke size."""
    from fluidframework_tpu_torch.models.mergetree import MergeTreeClient
    from fluidframework_tpu_torch.ops.host_bridge import (
        encode_stream, extract_text,
    )
    from fluidframework_tpu_torch.protocol.messages import MessageType

    docs, base, steps, clients, cap, every = chip_smoke.CONFIG5_SCALES[
        "smoke"]
    corpora = {p: _corpus(p, base, steps, clients) for p in PACKAGES}
    raw, encoded = corpora["fluidframework_tpu_torch"]
    assert [e.ops for e in encoded] == [
        e.ops for e in corpora["fluidframework_tpu"][1]]
    assert [e.ops for e in encoded] == [
        encode_stream(s).ops for s in chip_smoke.bench_streams(
            base, steps, clients, chip_smoke.CONFIG5_SEED0)]
    rounds = {p: chip_smoke.config5_rounds(*corpora[p], docs, every)
              for p in PACKAGES}
    port_rounds = rounds["fluidframework_tpu_torch"]
    assert len(port_rounds) > 1
    for a, b in zip(rounds["fluidframework_tpu"], port_rounds):
        assert a.keys() == b.keys()
        for k in ("doc_start", "cids", "csns", "refs", "counts",
                  "flat_dst", "doc_of_row"):
            assert np.array_equal(a[k], b[k]), k
        for f, v in a["content"].items():
            assert np.array_equal(v, b["content"][f]), f
    got = {p: _lane(p, port_rounds, docs, clients, cap) for p in PACKAGES}
    (ref, ref_tickets), (port, port_tickets) = (
        got["fluidframework_tpu"], got["fluidframework_tpu_torch"])
    for a, b in zip(ref_tickets, port_tickets):
        for x, y in zip(a, b):
            assert np.array_equal(x, y)
        assert not b[2].any()
    for f in ("count", "min_seq", "overflow"):
        assert np.array_equal(ref[f], port[f]), f
    assert not port["overflow"].any()
    for d in range(docs):
        n = int(port["count"][d])
        for f, v in ref.items():
            if v.ndim > 1:
                assert np.array_equal(v[d, :n], port[f][d, :n]), (f, d)
        obs = MergeTreeClient("obs")
        obs.start_collaboration("obs")
        for msg in raw[d % base]:
            if msg.type == MessageType.OPERATION:
                obs.apply_msg(msg)
        assert extract_text(port, encoded[d % base], d) == obs.get_text()


def test_config5_host_tier_matches_the_scan():
    """The C++ host tier replaying config5's smoke rounds in each
    package equals the port's scan: checksums, live counts and text."""
    from fluidframework_tpu_torch.native.replay_baseline import (
        table_checksum,
    )
    from fluidframework_tpu_torch.ops.host_bridge import extract_text
    from fluidframework_tpu_torch.ops.segment_table import NOT_REMOVED

    docs, base, steps, clients, cap, every = chip_smoke.CONFIG5_SCALES[
        "smoke"]
    raw, encoded = _corpus("fluidframework_tpu_torch", base, steps, clients)
    rounds = chip_smoke.config5_rounds(raw, encoded, docs, every)
    table, _ = _lane("fluidframework_tpu_torch", rounds, docs, clients, cap)
    for package in PACKAGES:
        seq_core = importlib.import_module(
            f"{package}.native.sequencer_core")
        baseline = importlib.import_module(
            f"{package}.native.replay_baseline")
        session = baseline.MergeHostSession(docs)
        ops, secs = chip_smoke.run_config5_host(
            chip_smoke.config5_sequencer(seq_core.MultiDocSequencer, docs,
                                         clients), session, rounds)
        assert ops == sum(len(rd["flat_dst"]) for rd in rounds) and secs > 0
        for d in range(docs):
            checksum, live = session.stats(d)
            assert checksum == table_checksum(table, d), (package, d)
            n = int(table["count"][d])
            alive = table["removed_seq"][d, :n] == NOT_REMOVED
            assert live == int(table["length"][d, :n][alive].sum())
            assert session.text(d, encoded[d % base]) == extract_text(
                table, encoded[d % base], d)
        session.close()


STORMS = (
    ("config11", {}),
    ("config12", {"kill_leader_step": 30}),
    ("config13", {"netsplit": (25, 35)}),
)


@pytest.mark.parametrize("seed,name,kw", [
    (11 + i, name, kw) for i, (name, kw) in enumerate(STORMS)],
    ids=lambda v: v if isinstance(v, str) else None)
def test_chaos_storm_equals_reference(seed, name, kw):
    """Each storm leg of bench's config11-13 (its seed; a leader kill
    mid-storm for config12, the leader's netsplit over the middle half
    of the storm for config13) at 60 steps, storm (20, 40): equal
    ``deterministic_fields()`` in both packages, the port's sidecar on
    the CPU."""
    ref = importlib.import_module("fluidframework_tpu.testing.chaos")
    port = importlib.import_module("fluidframework_tpu_torch.testing.chaos")
    want = ref.run_chaos_storm(seed=seed, steps=60, storm=(20, 40), **kw)
    got = port.run_chaos_storm(seed=seed, steps=60, storm=(20, 40),
                               device="cpu", **kw)
    assert want.converged and got.converged, (want.failures, got.failures)
    assert got.deterministic_fields() == want.deterministic_fields()
    assert got.chaos_counts == want.chaos_counts
    if "kill_leader_step" in kw:
        assert got.failovers >= 1 and got.failover_time_s is not None
    if "netsplit" in kw:
        assert got.unavailable_nacks > 0


def test_chaos_harness_defaults_to_the_card(tmp_path):
    """The harness's sidecar is on ``cuda`` unless the caller asks for
    the CPU: without a CUDA device the default raises."""
    import torch

    from fluidframework_tpu_torch.testing import chaos

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        chaos.ChaosHarness(str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        chaos.run_chaos(0, faults=False)
