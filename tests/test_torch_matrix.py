"""The port's SharedMatrix plane (``ops.matrix_bridge`` axes through the
window apply, ``ops.matrix_cells`` LWW cells) on the CPU against the
JAX package: the converged ``to_lists()`` of live SharedMatrix replicas
recorded through the reference loader and through the port's own loader
and SharedMatrix (held to the reference-recorded sessions), the
reference's ``CellPack``
grids, and its axis tables and ``extract_matrix`` at bench config3's
``smoke`` and ``cpu`` scales. Exact: the work is integer-only."""
import dataclasses
import functools
import importlib
import json
import random

import numpy as np
import pytest
import torch

from fluidframework_tpu.ops import fetch as ref_fetch
from fluidframework_tpu.ops import matrix_bridge as ref_bridge
from fluidframework_tpu.ops.matrix_cells import CellPack as RefCellPack
from fluidframework_tpu.protocol.messages import MessageType
from fluidframework_tpu_torch.ops import matrix_bridge
from fluidframework_tpu_torch.ops.host_bridge import fetch
from fluidframework_tpu_torch.ops.matrix_bridge import (
    MatrixStream,
    apply_matrix_batch,
    extract_matrix,
)
from fluidframework_tpu_torch.ops.matrix_cells import (
    CellPack,
    apply_cells_kernel,
)
from fluidframework_tpu_torch.testing import (
    MATRIX_SCALES,
    matrix_messages,
    record_matrix_streams,
)


def channel_stream(server, document_id, ds_id, ch_id):
    """One channel's inner sequenced stream from the op log (the
    sidecar's envelope rule)."""
    out = []
    for msg in server.read_ops(document_id, 0):
        envelope = msg.contents if isinstance(msg.contents, dict) else {}
        if (
            msg.type == MessageType.OPERATION
            and envelope.get("kind", "op") == "op"
            and envelope.get("address") == ds_id
            and envelope.get("channel") == ch_id
        ):
            out.append(
                dataclasses.replace(msg, contents=envelope["contents"])
            )
        else:
            out.append(dataclasses.replace(
                msg, type=MessageType.NO_OP, contents=None,
                client_id=None,
            ))
    return out


def make_matrix_session(doc="m", package="fluidframework_tpu"):
    """Two writer ``Container``s on one SharedMatrix channel, through
    ``package``'s ``LocalServer``, local driver and loader."""
    service = importlib.import_module(f"{package}.service")
    drivers = importlib.import_module(f"{package}.drivers")
    loader = importlib.import_module(f"{package}.loader")
    server = service.LocalServer()
    factory = drivers.LocalDocumentServiceFactory(server)
    a = loader.Container.load(factory.create_document_service(doc),
                              client_id="alice")
    b = loader.Container.load(factory.create_document_service(doc),
                              client_id="bob")
    ma = a.runtime.create_datastore("d").create_channel("sharedmatrix", "m")
    a.flush()
    mb = b.runtime.get_datastore("d").get_channel("m")
    return server, a, b, ma, mb


def replay_port(server, doc="m"):
    """The recorded channel stream through the port on the CPU."""
    ms = MatrixStream()
    for msg in channel_stream(server, doc, "d", "m"):
        ms.add_message(msg)
    np_table = fetch(apply_matrix_batch([ms], capacity=512, device="cpu"))
    assert not np_table["overflow"].any()
    return extract_matrix(np_table, ms, 0)


def _basic(a, b, ma, mb):
    ma.insert_rows(0, 3)
    ma.insert_cols(0, 2)
    a.flush()
    ma.set_cell(0, 0, "tl")
    ma.set_cell(2, 1, "br")
    a.flush()
    mb.set_cell(1, 1, "mid")
    b.flush()


def _permutation_vs_cells(a, b, ma, mb):
    ma.insert_rows(0, 4)
    ma.insert_cols(0, 3)
    a.flush()
    for r in range(4):
        for c in range(3):
            ma.set_cell(r, c, f"{r}.{c}")
    a.flush()
    ma.remove_rows(1, 1)
    mb.set_cell(1, 0, "doomed")
    mb.set_cell(2, 0, "survives")
    a.flush()
    b.flush()


def _row_inserts_tiebreak(a, b, ma, mb):
    ma.insert_rows(0, 2)
    ma.insert_cols(0, 1)
    a.flush()
    ma.insert_rows(0, 1)
    mb.insert_rows(0, 1)
    ma.set_cell(0, 0, "a-row")
    mb.set_cell(0, 0, "b-row")
    a.flush()
    b.flush()


def _fuzz(seed, a, b, ma, mb):
    rng = random.Random(seed * 37 + 11)
    ma.insert_rows(0, 2)
    ma.insert_cols(0, 2)
    a.flush()
    clients = [(a, ma), (b, mb)]
    for _ in range(60):
        c, m = clients[rng.randint(0, 1)]
        roll = rng.random()
        try:
            if roll < 0.2:
                m.insert_rows(rng.randint(0, m.row_count), rng.randint(1, 2))
            elif roll < 0.35:
                m.insert_cols(rng.randint(0, m.col_count), 1)
            elif roll < 0.45 and m.row_count > 1:
                m.remove_rows(rng.randint(0, m.row_count - 1), 1)
            elif roll < 0.5 and m.col_count > 1:
                m.remove_cols(rng.randint(0, m.col_count - 1), 1)
            elif m.row_count and m.col_count:
                m.set_cell(rng.randint(0, m.row_count - 1),
                           rng.randint(0, m.col_count - 1),
                           rng.randint(0, 999))
        except AssertionError:
            continue  # cell outside local view mid-churn
        if rng.random() < 0.5:
            c.flush()
    a.flush()
    b.flush()


def _reconnect_resubmit(a, b, ma, mb):
    ma.insert_rows(0, 2)
    ma.insert_cols(0, 2)
    a.flush()
    a.disconnect()
    ma.insert_rows(1, 3)
    ma.set_cell(2, 0, "offline")
    mb.insert_rows(0, 1)
    b.flush()
    a.connect()
    a.flush()
    b.flush()


# the recorded sessions of the reference's test_matrix_kernel
SESSIONS = {
    "basic": _basic,
    "permutation_vs_cells": _permutation_vs_cells,
    "row_inserts_tiebreak": _row_inserts_tiebreak,
    **{f"fuzz{seed}": functools.partial(_fuzz, seed) for seed in range(10)},
    "reconnect_resubmit": _reconnect_resubmit,
}


def _recorded(name, package="fluidframework_tpu"):
    server, a, b, ma, mb = make_matrix_session(package=package)
    SESSIONS[name](a, b, ma, mb)
    assert ma.to_lists() == mb.to_lists(), f"{name} diverged"
    return server, ma


def test_matrix_kernel_basic():
    server, ma = _recorded("basic")
    assert replay_port(server) == ma.to_lists()


def test_matrix_kernel_concurrent_permutation_vs_cells():
    """Cells commute with concurrent permutation (handle stability)."""
    server, ma = _recorded("permutation_vs_cells")
    assert replay_port(server) == ma.to_lists()


def test_matrix_kernel_concurrent_row_inserts_tiebreak():
    server, ma = _recorded("row_inserts_tiebreak")
    assert replay_port(server) == ma.to_lists()


@pytest.mark.parametrize("seed", range(10))
def test_matrix_kernel_fuzz(seed):
    server, ma = _recorded(f"fuzz{seed}")
    assert replay_port(server) == ma.to_lists(), f"seed {seed}"


def test_matrix_kernel_reconnect_resubmit_handles():
    """Reconnect resubmission emits GroupOps and split inserts with
    handle=[alloc, base>0]; the handle derivation tracks both."""
    server, ma = _recorded("reconnect_resubmit")
    assert replay_port(server) == ma.to_lists()


def _channel_log(server, package):
    """The channel stream as sorted-key JSON (each package's own
    ``encode_contents``), so two packages' op dataclasses compare."""
    ser = importlib.import_module(f"{package}.protocol.serialization")
    return [json.dumps([m.sequence_number, m.client_id, int(m.type),
                        ser.encode_contents(m.contents)], sort_keys=True)
            for m in channel_stream(server, "m", "d", "m")]


@pytest.mark.parametrize("name", SESSIONS)
def test_port_session_equals_reference(name):
    """The same session through the port's own loader and SharedMatrix:
    its channel stream equals the reference-recorded one, both writers'
    ``to_lists()`` equal the reference's, and the port's matrix plane
    on the port's stream gives the reference's matrix."""
    ref_server, ref_ma = _recorded(name)
    server, ma = _recorded(name, "fluidframework_tpu_torch")
    assert (_channel_log(server, "fluidframework_tpu_torch")
            == _channel_log(ref_server, "fluidframework_tpu"))
    assert ma.to_lists() == ref_ma.to_lists()
    assert replay_port(server) == ref_ma.to_lists()


# ---- device cell path: sort + last-wins ------------------------------

def _host_lww(streams):
    """Scalar LWW oracle: dict keyed by (row, col), window order."""
    out = []
    for s in streams:
        d = {}
        for rh, ch, v in zip(s.cell_rows, s.cell_cols, s.cell_vals):
            d[(rh, ch)] = v
        out.append(d)
    return out


def _cell_streams(rng, matrices, writes, n_rows, n_cols, cls=MatrixStream):
    streams = []
    for _ in range(matrices):
        s = cls()
        for _ in range(rng.randint(0, writes)):
            s.cell_rows.append(f"r{rng.randint(0, n_rows - 1)}")
            s.cell_cols.append(f"c{rng.randint(0, n_cols - 1)}")
            s.cell_vals.append(rng.randint(0, 10**6))
        streams.append(s)
    return streams


@pytest.mark.parametrize("seed", range(6))
def test_cell_kernel_matches_host_lww(seed):
    streams = _cell_streams(random.Random(seed), 3, 120, 16, 6)
    pack = CellPack(n_rows=16, n_cols=6, device="cpu")
    pack.pack(streams)
    grid = pack.apply().numpy()
    oracle = _host_lww(streams)
    for m, s in enumerate(streams):
        for (rh, ch), want in oracle[m].items():
            assert pack.lookup(grid, m, rh, ch) == want, (seed, m, rh, ch)
        assert pack.lookup(grid, m, "r-none", "c0") is None
    for m in range(len(streams)):
        for r_h in pack.row_ids[m]:
            for c_h in pack.col_ids[m]:
                got = pack.lookup(grid, m, r_h, c_h)
                assert got == oracle[m].get((r_h, c_h))


def test_cell_kernel_empty_and_single():
    empty = MatrixStream()
    one = MatrixStream()
    one.cell_rows.append("a:0")
    one.cell_cols.append("b:0")
    one.cell_vals.append("v")
    pack = CellPack(n_rows=4, n_cols=4, device="cpu")
    pack.pack([empty, one])
    grid = pack.apply().numpy()
    assert pack.lookup(grid, 0, "a:0", "b:0") is None
    assert pack.lookup(grid, 1, "a:0", "b:0") == "v"


def test_cell_kernel_window_segmentation():
    """The composite-key split (a shrunk ``budget``) equals the single
    call and the host LWW."""
    rng = random.Random(7)
    s = MatrixStream()
    for _ in range(50):
        s.cell_rows.append(f"r{rng.randint(0, 3)}")
        s.cell_cols.append(f"c{rng.randint(0, 3)}")
        s.cell_vals.append(rng.randint(0, 999))
    pack = CellPack(n_rows=4, n_cols=4, device="cpu")
    pack.pack([s])
    full = pack.apply().numpy()
    # budget 16 * 6 => max_n = 5 => ten 5-op segments
    seg_grid = pack.apply(budget=4 * 4 * 6).numpy()
    assert np.array_equal(full, seg_grid)
    oracle = _host_lww([s])[0]
    for (rh, ch), want in oracle.items():
        assert pack.lookup(full, 0, rh, ch) == want
        assert pack.lookup(seg_grid, 0, rh, ch) == want


# ---- against the JAX package ------------------------------------------

@pytest.mark.parametrize("seed,matrices,writes,n_rows,n_cols,budget", [
    (0, 3, 120, 16, 6, None),
    (1, 5, 300, 40, 3, None),
    (2, 1, 1, 1, 1, None),
    (3, 4, 200, 12, 5, 12 * 5 * 9),   # max_n 8: 25 segments
    (4, 2, 500, 64, 8, 64 * 8 * 101),  # max_n 100: 5 segments
])
def test_cell_grid_equals_reference(seed, matrices, writes, n_rows, n_cols,
                                    budget):
    rng = random.Random(seed)
    streams = _cell_streams(rng, matrices, writes, n_rows, n_cols)
    ref_streams = []
    for s in streams:
        r = ref_bridge.MatrixStream()
        r.cell_rows, r.cell_cols, r.cell_vals = (
            list(s.cell_rows), list(s.cell_cols), list(s.cell_vals))
        ref_streams.append(r)
    ref = RefCellPack(n_rows, n_cols)
    ref.pack(ref_streams)
    port = CellPack(n_rows, n_cols, device="cpu")
    port.pack(streams)
    assert np.array_equal(port.keys, ref.keys)
    kw = {} if budget is None else {"budget": budget}
    got = port.apply(**kw)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(ref.apply(**kw)))
    if budget is not None:  # the split equals the single call too
        assert torch.equal(got, port.apply())
    assert torch.equal(
        apply_cells_kernel(torch.from_numpy(port.keys), n_rows, n_cols),
        port.apply())


@pytest.mark.parametrize("scale", ["smoke", "cpu"])
def test_config3_axes_and_extract_equal_reference(scale):
    cfg, streams = record_matrix_streams(scale)
    ref_streams = []
    for msgs in matrix_messages(scale):
        r = ref_bridge.MatrixStream()
        for msg in msgs:
            r.add_message(msg)
        ref_streams.append(r)
    assert cfg == MATRIX_SCALES[scale]
    for s, r in zip(streams, ref_streams):
        assert (s.rows.ops, s.cols.ops) == (r.rows.ops, r.cols.ops)
        assert (s.row_allocs, s.col_allocs) == (r.row_allocs, r.col_allocs)
        assert (s.cell_rows, s.cell_cols, s.cell_vals) == (
            r.cell_rows, r.cell_cols, r.cell_vals)
    batch = matrix_bridge.pack_matrix_batch(streams)
    ref_batch = ref_bridge.pack_matrix_batch(ref_streams)
    for f in batch._fields:
        assert np.array_equal(getattr(batch, f), np.asarray(
            getattr(ref_batch, f))), f
    got = fetch(matrix_bridge.dispatch_matrix_batch(
        batch, cfg.matrices, cfg.capacity, device="cpu"))
    want = ref_fetch(ref_bridge.dispatch_matrix_batch(
        ref_batch, cfg.matrices, cfg.capacity))
    for f in ("count", "min_seq", "overflow"):
        assert np.array_equal(got[f], want[f]), f
    assert not got["overflow"].any()
    for d in range(2 * cfg.matrices):
        n = int(want["count"][d])
        for f in ("length", "seq", "client", "removed_seq", "removers",
                  "op_id", "op_off", "is_marker", "prop"):
            assert np.array_equal(got[f][d, :n], want[f][d, :n]), (d, f)
    for m in range(cfg.matrices):
        assert extract_matrix(got, streams[m], m) == ref_bridge.extract_matrix(
            want, ref_streams[m], m), m
