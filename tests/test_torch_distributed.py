"""The port's across-hosts helpers against the JAX package's: the
single-process no-op, the (docs, seq) layout of one process's devices,
the rank's document slice, and the sequence-sharded window on that
layout equal to the reference's on every field."""
import jax
import numpy as np
import pytest
import torch

from fluidframework_tpu.ops import build_batch, encode_stream, fetch
from fluidframework_tpu.ops import make_table
from fluidframework_tpu.parallel import (
    apply_window_seq_sharded as ref_apply_seq,
)
from fluidframework_tpu.parallel import local_doc_slice as ref_doc_slice
from fluidframework_tpu.parallel import make_global_mesh as ref_global_mesh
from fluidframework_tpu.testing import FuzzConfig, record_op_stream
from fluidframework_tpu_torch import convert
from fluidframework_tpu_torch.parallel import (
    DistributedConfig,
    apply_window_seq_sharded,
    ensure_initialized,
    local_doc_slice,
    make_global_mesh,
)

CPUS = [torch.device("cpu")] * 8


def test_single_process_is_noop(monkeypatch):
    assert ensure_initialized(DistributedConfig(), device="cpu") is False
    assert ensure_initialized(DistributedConfig(
        coordinator=None, num_processes=4), device="cpu") is False
    assert ensure_initialized(DistributedConfig(
        coordinator="localhost:1234", num_processes=1),
        device="cpu") is False
    monkeypatch.setenv("FFTPU_COORDINATOR", "localhost:1234")
    monkeypatch.setenv("FFTPU_NUM_PROCESSES", "1")
    monkeypatch.setenv("FFTPU_PROCESS_ID", "0")
    cfg = DistributedConfig.from_env()
    assert (cfg.coordinator, cfg.num_processes, cfg.process_id) == (
        "localhost:1234", 1, 0)
    assert ensure_initialized(device="cpu") is False


@pytest.mark.parametrize("doc_shards", [1, 4])
def test_global_mesh_layout(doc_shards):
    want = ref_global_mesh(doc_shards=doc_shards)
    got = make_global_mesh(doc_shards=doc_shards, devices=CPUS)
    assert got.shape == dict(want.shape)
    assert got.axis_names == tuple(want.axis_names)
    with pytest.raises(ValueError, match="not divisible"):
        make_global_mesh(doc_shards=3, devices=CPUS)


@pytest.mark.parametrize("n_docs", [1, 10, 4096])
def test_local_doc_slice_single_process(n_docs):
    assert local_doc_slice(n_docs) == ref_doc_slice(n_docs) == \
        slice(0, n_docs)


def test_seq_sharded_window_on_global_mesh():
    streams = [record_op_stream(FuzzConfig(
        n_clients=3, n_steps=60, seed=7000 + i))[1] for i in range(4)]
    batch = build_batch([encode_stream(s) for s in streams])
    table = make_table(4, 128)
    want = fetch(ref_apply_seq(table, batch,
                               ref_global_mesh(doc_shards=2)))
    got = convert.table_to_numpy(apply_window_seq_sharded(
        convert.table_from_numpy(fetch(table), "cpu"), batch,
        make_global_mesh(doc_shards=2, devices=CPUS)))
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
