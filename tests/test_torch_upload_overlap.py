"""The array lane's overlap of upload and window kernel: on a CUDA device
``convert.program_to_device`` stages its fields in pinned host memory
and copies them on a copy stream without syncing, and
``cuda_merge.apply_window_cuda`` keeps at most one window queued behind
the running one. The CPU test holds the CPU path to the blocking copy;
the card tests skip without a CUDA card (on the card:
``python -m pytest --noconftest tests/test_torch_upload_overlap.py``)."""
import sys
import time

import numpy as np
import pytest
import torch

from fluidframework_tpu_torch import convert
from fluidframework_tpu_torch.convert import (
    batch_from_numpy,
    program_to_device,
)
from fluidframework_tpu_torch.obs.metrics import REGISTRY
from fluidframework_tpu_torch.ops import cuda_merge
from fluidframework_tpu_torch.ops.merge_kernel import (
    apply_window,
    apply_window_plain,
)
from fluidframework_tpu_torch.ops.segment_table import OpBatch, SegmentTable

COUNTERS = ("upload_staged_total", "b1_inflight_waits_total")


def counters() -> dict:
    flat = REGISTRY.flat()
    return {c: flat.get(c, 0.0) for c in COUNTERS}


def mixed_fields(rng) -> dict:
    """Every input form the upload takes: int32, int64 beyond int32's
    range (narrowed), uint32 with the top bit set (viewed), a transposed
    and a strided view, booleans, and fields of different shapes."""
    return {
        "i32": rng.integers(-2**31, 2**31, (64, 16)).astype(np.int32),
        "i64": rng.integers(-2**40, 2**40, (64, 16)),
        "u32": rng.integers(0, 2**32, (64, 16)).astype(np.uint32),
        "transposed": rng.integers(0, 99, (16, 64)).astype(np.int32).T,
        "strided": rng.integers(0, 99, (64, 48)).astype(np.int32)[:, ::3],
        "bool": rng.random((64, 16)) < 0.5,
        "rows": rng.integers(0, 99, 64),
        "cube": rng.integers(0, 99, (3, 5, 7)).astype(np.int16),
        "empty": np.zeros((0, 16), np.int32),
    }


def test_cpu_upload_is_the_blocking_copy():
    rng = np.random.default_rng(23)
    fields = mixed_fields(rng)
    fields["tensor"] = torch.arange(12, dtype=torch.int32)
    before, streams = counters(), dict(convert._COPY)
    got = program_to_device(fields, "cpu")
    assert list(got) == list(fields)
    for f, a in fields.items():
        want = (a if isinstance(a, torch.Tensor)
                else convert._to_device(a, "cpu"))
        assert got[f].dtype == torch.int32 and got[f].device.type == "cpu"
        assert torch.equal(got[f], want), f
    assert counters() == before
    assert convert._COPY == streams


# -- card tests ----------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the staged upload and the window "
                    "kernel have no CPU form")


_CYCLES_PER_MS = []


def sleep_ms(ms: float) -> None:
    """Keep the current stream busy for about ``ms`` milliseconds."""
    if not _CYCLES_PER_MS:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(10_000_000)
        end.record()
        end.synchronize()
        _CYCLES_PER_MS.append(10_000_000 / start.elapsed_time(end))
    torch.cuda._sleep(int(ms * _CYCLES_PER_MS[0]))


def host_batch(rng, table, window: int) -> dict:
    from fluidframework_tpu_torch.testing.windows import random_batch

    batch = random_batch(rng, table, window, "cpu")
    return {f: getattr(batch, f).numpy() for f in OpBatch._fields}


def same_table(a: SegmentTable, b: SegmentTable) -> bool:
    return all(torch.equal(x.cpu(), y.cpu()) for x, y in zip(a, b))


@pytest.mark.cuda
def test_staged_upload_is_bit_equal_to_the_blocking_copy():
    _card()
    rng = np.random.default_rng(23)
    fields = mixed_fields(rng)
    fields["tensor"] = torch.arange(12, dtype=torch.int32)
    before = counters()
    got = program_to_device(fields, "cuda")
    torch.cuda.current_stream().synchronize()
    assert list(got) == list(fields)
    for f, a in fields.items():
        want = (a.to("cuda") if isinstance(a, torch.Tensor)
                else convert._to_device(a, "cuda"))
        assert got[f].dtype == torch.int32 and got[f].is_cuda
        assert got[f].shape == want.shape and got[f].is_contiguous()
        assert torch.equal(got[f], want), f
    storages = {t.untyped_storage().data_ptr() for t in got.values()
                if t.numel()}
    assert len(storages) == sum(1 for t in got.values() if t.numel())
    after = counters()
    assert after["upload_staged_total"] == before["upload_staged_total"] + 1


@pytest.mark.cuda
def test_staged_upload_survives_the_callers_writes_and_later_uploads():
    _card()
    rng = np.random.default_rng(24)
    fields = {f: rng.integers(0, 1000, (256, 64)).astype(np.int32)
              for f in OpBatch._fields}
    kept = {f: a.copy() for f, a in fields.items()}
    first = batch_from_numpy(fields, "cuda")
    for a in fields.values():
        a.fill(-1)
    later = []
    for k in range(4):
        more = {f: np.full((256, 64), k, np.int32) for f in OpBatch._fields}
        later.append(batch_from_numpy(more, "cuda"))
        for a in more.values():
            a.fill(-7)
    torch.cuda.current_stream().synchronize()
    for f in OpBatch._fields:
        assert np.array_equal(getattr(first, f).cpu().numpy(), kept[f]), f
    for k, batch in enumerate(later):
        assert all(bool((t == k).all()) for t in batch), k


@pytest.mark.cuda
def test_upload_returns_behind_a_busy_stream_and_b1_reads_it():
    _card()
    from fluidframework_tpu_torch.testing.windows import random_table

    rng = np.random.default_rng(25)
    table = random_table(rng, 64, 1024, "cuda")
    arrays = host_batch(rng, table, 16)
    batch_from_numpy(arrays, "cuda")  # the copy stream exists
    apply_window(table, batch_from_numpy(arrays, "cuda"))  # the build
    torch.cuda.synchronize()
    sleep_ms(50)
    t0 = time.perf_counter()
    batch = batch_from_numpy(arrays, "cuda")
    took = time.perf_counter() - t0
    out = apply_window(table, batch)
    torch.cuda.synchronize()
    assert took < 0.005, f"the upload took {took * 1e3:.3f} ms"
    want = apply_window_plain(table, batch_from_numpy(arrays, "cuda"))
    assert same_table(out, want)


@pytest.mark.cuda
def test_at_most_one_window_queues_behind_the_running_one():
    _card()
    from fluidframework_tpu_torch.testing.windows import random_table

    rng = np.random.default_rng(26)
    table = random_table(rng, 64, 1024, "cuda")
    tables, batches = [table], []
    for _ in range(10):
        batches.append(host_batch(rng, tables[-1], 16))
        tables.append(apply_window_plain(
            tables[-1], batch_from_numpy(batches[-1], "cuda")))
    uploaded = [batch_from_numpy(b, "cuda") for b in batches]
    torch.cuda.synchronize()

    sleep_ms(0)  # calibrated before the windows are queued
    stream = torch.cuda.current_stream()
    key = (stream.device_index, stream.cuda_stream)
    before = counters()
    sleep_ms(100)
    t0 = time.perf_counter()
    out = apply_window(table, uploaded[0])
    first_done = torch.cuda.Event()
    first_done.record()
    first = time.perf_counter() - t0
    assert first < 0.05, f"the first apply waited {first * 1e3:.1f} ms"
    assert not first_done.query()
    events = list(cuda_merge._QUEUED[key])
    assert len(events) == 2
    for batch in uploaded[1:3]:
        out = apply_window(out, batch)
    assert first_done.query()  # the third apply returned after window 1
    waits = counters()["b1_inflight_waits_total"] - \
        before["b1_inflight_waits_total"]
    assert 1 <= waits <= 2
    for batch in uploaded[3:]:
        out = apply_window(out, batch)
    torch.cuda.synchronize()
    assert same_table(out, tables[-1])
    # the stream's two queue events, taken in turn: no launch made one
    assert sorted(map(id, cuda_merge._QUEUED[key])) == \
        sorted(map(id, events))


@pytest.mark.cuda
def test_uploads_from_many_threads_each_arrive_whole():
    """Sixteen threads share one device's copy stream and its event, each
    uploading distinct fields twenty times under a short switch
    interval: every upload arrives whole."""
    _card()
    from concurrent.futures import ThreadPoolExecutor

    def worker(w):
        got = []
        for k in range(20):
            fields = {f: np.full((128, 32), 1000 * w + k, np.int32)
                      for f in OpBatch._fields}
            got.append((1000 * w + k, batch_from_numpy(fields, "cuda")))
        torch.cuda.current_stream().synchronize()
        return all(bool((t == v).all()) for v, b in got for t in b)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with ThreadPoolExecutor(16) as pool:
            results = list(pool.map(worker, range(16), timeout=120))
    finally:
        sys.setswitchinterval(interval)
    assert results == [True] * 16
