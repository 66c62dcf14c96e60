"""The port's sanitizer (``testing/jitsan.py``): on every executor route,
the mesh pool and both tree routes, a sidecar driven through real
traffic — grows, pool admission and migration included — reaches at
most the launch signatures ``ops/bucket_ladder.ladder_bounds`` (and
``tree_ladder_bounds``) allow per root, the port's form of the
reference's compile-count differential; a read of a table donated to an
earlier dispatch raises at the read site while the dispatch's own
output passes; a donated table that shares storage with a live input
records a trip; the window kernel's builds are counted per source
hash; ``publish_compiles`` feeds ``jax_compiles_total``."""
import numpy as np
import pytest
import torch

from fluidframework_tpu.service import LocalServer
from fluidframework_tpu_torch.obs import REGISTRY
from fluidframework_tpu_torch.ops import cuda_merge, merge_kernel
from fluidframework_tpu_torch.ops.bucket_ladder import (
    BucketLadder,
    ladder_bounds,
    tree_ladder_bounds,
)
from fluidframework_tpu_torch.ops.segment_table import make_table
from fluidframework_tpu_torch.service import GpuMergeSidecar, TreeSidecar
from fluidframework_tpu_torch.testing import jitsan, record_tree_stream
from fluidframework_tpu_torch.testing import windows
from test_torch_mesh_pool import (
    _grow_into_pool,
    _hot_rounds,
    _hotspot,
    _settle,
)
from test_torch_obs import _corpus, _feed


@pytest.fixture()
def sanitizer():
    jitsan.install()
    jitsan.reset()
    yield jitsan
    jitsan.reset()
    jitsan.uninstall()


def _within(counts, bounds):
    for root, bound in bounds.items():
        assert counts[root] <= bound, (
            f"{root}: {counts[root]} launch signatures > ladder bound "
            f"{bound} — an unladdered shape reached the device")


@pytest.mark.parametrize("route,donate", [
    ("scan", False), ("scan", True), ("chunked", True),
    ("egwalker", False)])
def test_launch_signatures_within_ladder_bounds(sanitizer, route, donate):
    """prewarm, then traffic that grows the slab twice: within the
    bounds, and the route's own root reached (not vacuous)."""
    sc = GpuMergeSidecar(max_docs=4, capacity=16, max_capacity=64,
                         executor=route, donate=donate, device="cpu",
                         ladder=BucketLadder(16, 32))
    sc.prewarm()
    _feed(sc, _corpus(n_steps=90))
    assert sc.grow_count >= 2
    counts = sanitizer.compile_counts()
    _within(counts, ladder_bounds(16, 32, 16, 64, executor=route,
                                  donate=donate))
    own = {"scan": "apply_window", "chunked": "chunked",
           "egwalker": "egwalker"}[route]
    assert counts[own + ("_pingpong" if donate else "")] > 0
    assert counts["compact"] > 0 and counts["pad_capacity"] > 0
    assert sanitizer.trips() == []
    assert bool(sanitizer.donation_events()) == donate


def test_mesh_pool_signatures_within_ladder_bounds(sanitizer):
    """Admission replays, incremental tails and a live migration on a
    2-shard CPU mesh pool."""
    server = LocalServer()
    sidecars, docs, containers, strings = _hotspot(server)
    port = sidecars[1]
    sidecars = sidecars[:2]
    for doc in docs:
        _grow_into_pool(containers[doc], strings[doc])
    _settle(sidecars)
    _hot_rounds(sidecars, docs, containers, strings, 6)
    assert port._pool.migration_count > 0
    counts = sanitizer.compile_counts()
    _within(counts, ladder_bounds(16, 64, 16, 16, pool_capacity=256,
                                  pool_rows=2))
    assert counts["mesh_pool"] > 0 and counts["mesh_move"] > 0
    events = sanitizer.donation_events()
    assert [e.root for e in events] == ["mesh_move"] * len(events)
    assert len(events) == port._pool.migration_count


@pytest.mark.parametrize("route", ["atom", "macro"])
def test_tree_signatures_within_ladder_bounds(sanitizer, route):
    sc = TreeSidecar(max_docs=4, capacity=16, max_capacity=256,
                     executor=route, device="cpu")
    recorded = [record_tree_stream(1700 + i) for i in range(2)]
    for i, (_sig, stream) in enumerate(recorded):
        sc.track(f"t{i}", "d", "t")
        for start in range(0, len(stream), 8):
            for msg in stream[start:start + 8]:
                sc.ingest(f"t{i}", msg)
            sc.apply()
    sc.sync()
    assert sc.grow_count >= 1
    counts = sanitizer.compile_counts()
    _within(counts, tree_ladder_bounds(16, 256))
    assert counts["tree_window"] > 0 and counts["tree_pad"] > 0
    assert [sc.signature(f"t{i}", "d", "t") for i in range(2)] == \
        [sig for sig, _ in recorded]


def _window(D=3, C=16, W=8, seed=4):
    rng = np.random.default_rng(seed)
    table = windows.random_table(rng, D, C, "cpu")
    return table, windows.random_batch(rng, table, W, "cpu")


def test_read_of_a_donated_table_raises(sanitizer):
    table, batch = _window()
    dead = make_table(table.docs, table.capacity, "cpu")
    dead_length = dead.length
    ptr = dead_length.untyped_storage().data_ptr()
    out = merge_kernel.apply_window_pingpong(dead, table, batch)
    # the output lives in the retired storage, as a new object: it reads
    assert out.length.untyped_storage().data_ptr() == ptr
    assert out.length is not dead_length
    want = merge_kernel.apply_window(table, batch)
    assert all(torch.equal(a, b) for a, b in zip(out, want))
    with pytest.raises(RuntimeError, match="jitsan: .*donated"):
        dead_length.sum()
    with pytest.raises(RuntimeError, match="jitsan"):
        torch.add(dead.count, 1)
    [event] = sanitizer.donation_events()
    assert (event.root, event.retired) == ("apply_window_pingpong", 12)
    assert sanitizer.compile_counts()["apply_window_pingpong"] == 1


def test_donated_table_aliasing_an_input_records_a_trip(sanitizer):
    table, batch = _window()
    with pytest.raises(ValueError):
        merge_kernel.apply_window_pingpong(table, table, batch)
    [trip] = sanitizer.trips()
    assert trip.root == "apply_window_pingpong"
    assert "shares storage" in trip.describe()
    assert sanitizer.donation_events() == []
    table.length.sum()  # the live input was not retired


def test_uninstall_restores_and_disarms():
    jitsan.install()
    patched = merge_kernel.apply_window_pingpong
    assert hasattr(patched, "__jitsan_wrapped__")
    table, batch = _window()
    dead = make_table(table.docs, table.capacity, "cpu")
    merge_kernel.apply_window_pingpong(dead, table, batch)
    jitsan.uninstall()
    assert not jitsan.installed()
    assert merge_kernel.apply_window_pingpong is patched.__jitsan_wrapped__
    dead.length.sum()  # the trap is gone with the sanitizer


def test_publish_compiles_feeds_the_registry(sanitizer):
    before = REGISTRY.flat()
    table, batch = _window()
    merge_kernel.apply_window(table, batch)
    merge_kernel.apply_window(table, batch)
    merge_kernel.compact(table)
    sizes = sanitizer.publish_compiles()
    delta = REGISTRY.delta(before)
    assert delta['jax_compiles_total{root="apply_window"}'] >= 1
    assert sizes["apply_window"] >= 1
    assert sanitizer.publish_compiles() == sizes
    assert REGISTRY.delta(before) == delta  # monotone: no double count


def test_nvcc_builds_are_counted_per_source_hash(monkeypatch, tmp_path):
    """One build per library file: a second build() of the same source
    finds it and builds nothing."""
    monkeypatch.setattr(cuda_merge, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_merge, "BUILDS", {})

    def fake_compile(source, out):
        out.write_bytes(b"")
        return ""

    monkeypatch.setattr(cuda_merge, "compile_source", fake_compile)
    path = cuda_merge.build()
    cuda_merge.build()
    assert jitsan.nvcc_builds() == {path.name: 1}


def test_sanitize_env_installs_once(monkeypatch):
    monkeypatch.setenv("FFTPU_SANITIZE", "1")
    monkeypatch.setattr(jitsan._STATE, "env_installed", False)
    try:
        GpuMergeSidecar(max_docs=1, capacity=16, device="cpu")
        TreeSidecar(max_docs=1, capacity=16, device="cpu")
        assert jitsan.installed() and jitsan._STATE.installed == 1
    finally:
        jitsan.uninstall()
    assert not jitsan.installed()
