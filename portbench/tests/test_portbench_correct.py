"""A whole run of a tiny cell on the CPU (the look for a card skipped),
the program against the plain reference; then the same run with the
timed path broken underneath, where ``correct`` has to come out false;
and the control (the program with a stale msn) read as not correct."""
import time

import numpy as np
import pytest
import torch

from portbench import cell as cells
from portbench import compare, generator, harness, reference
from portbench.tests.conftest import TINY_CONFIG

SEED = 2**31 + 12345


def run_tiny(root, lane_cls=harness.Lane, trace=False):
    cell = cells.load_cell(root, "tiny.r16")
    return cells.run(cell, SEED, 1.0, trace, "cpu", time.perf_counter(),
                     lane_cls=lane_cls)


def test_sound_run_is_correct(tiny_root):
    out = run_tiny(tiny_root)
    assert out["correct"], out["checks"]
    assert all(c["value"] == 0 for c in out["checks"].values())
    assert list(out["checks"]) == list(compare.LIMITS)
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"ops_per_s.tiny", "round_p95_ms.tiny",
                                   "setup_s"}
    assert all(m["value"] > 0 for m in out["metrics"].values())
    assert out["host_ms"]["batches"] >= 1


def test_traced_metrics_without_a_trace_are_left_out(tiny_root):
    out = run_tiny(tiny_root, trace=False)
    cell = cells.load_cell(tiny_root, "tiny.r16")
    assert "rounds_per_s" in cell.traced_metrics
    assert not set(cell.traced_metrics) & set(out["metrics"])


class Unchanged(harness.Lane):
    """A step that returns its state unchanged."""

    def apply(self, table, batch):
        return table


class HalfBatch(harness.Lane):
    """Half of the batch left out: the second half of the documents
    keeps its state."""

    def apply(self, table, batch):
        out = super().apply(table, batch)
        h = table.docs // 2
        return type(out)(*(torch.cat([o[:h], t[h:]])
                           for o, t in zip(out, table)))


class TicketAltered(harness.Lane):
    """A ticket altered where it is produced."""

    def ticket(self, seqs, rd):
        seq, msn, status = super().ticket(seqs, rd)
        seq = seq.copy()
        seq[len(seq) // 2] += 1
        return seq, msn, status


class SlotAltered(harness.Lane):
    """An answer altered where it is produced: one live slot's length."""

    def apply(self, table, batch):
        out = super().apply(table, batch)
        length = out.length.clone()
        length[1, 0] += 1
        return out._replace(length=length)


class JoinDropped(harness.Lane):
    """A client left out of every document's quorum: its messages are
    refused."""

    def open(self):
        seqs, table = super().open()
        fresh = self._seqs_cls(self.docs)
        for d in range(self.docs):
            for c in range(self.clients - 1):
                fresh.join(d, c)
        return fresh, table


@pytest.mark.parametrize("lane", [Unchanged, HalfBatch, TicketAltered,
                                  SlotAltered, JoinDropped])
def test_broken_path_is_not_correct(tiny_root, lane):
    out = run_tiny(tiny_root, lane_cls=lane)
    assert not out["correct"], out["checks"]
    if lane is JoinDropped:
        assert out["failed"] > 0


def test_corrupted_table_is_caught():
    sessions = generator.make_sessions(TINY_CONFIG, SEED)
    ref = reference.replay(sessions, TINY_CONFIG["clients"],
                           TINY_CONFIG["capacity"], 16)
    tile = np.arange(6) % len(sessions)
    last = ref["tables"][-1]

    class T:  # the program's table, as the comparison reads it
        pass

    t = T()
    for f, v in last.items():
        setattr(t, f, v[tile].clone())
    t.docs, t.capacity = 6, TINY_CONFIG["capacity"]
    assert compare.table_docs_differing(t, last, tile) == 0
    t.prop[4, 3, 1] += 7
    assert compare.table_docs_differing(t, last, tile) == 1
    t.count[0] += 1
    assert compare.table_docs_differing(t, last, tile) == 2


def test_control_stale_msn_is_not_correct(tiny_root):
    """The control: the program with a stale msn (every message of a
    round stamped with its document's msn at the round's start) in a
    whole run fails both compared numbers."""
    from portbench.control import StaleMsn

    out = run_tiny(tiny_root, lane_cls=StaleMsn)
    assert not out["correct"]
    assert out["checks"]["ticket_mismatches"]["value"] > 0
    assert out["checks"]["table_docs_differing"]["value"] > 0


@pytest.mark.cuda
def test_tiny_cell_on_the_card(tiny_root):
    """The tiny cell through B1 on a card, traced: correct, and every
    traced metric of the cell read."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = cells.load_cell(tiny_root, "tiny.r16")
    out = cells.run(cell, SEED, 2.0, True, "cuda", time.perf_counter())
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == set(cell.traced_metrics)
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]


@pytest.mark.parametrize("rows_per_msg", [1, 2])
def test_stamp_writes_each_ticket_into_its_rows(rows_per_msg):
    """Every row of a message carries its ticket; padding stays 0."""
    rng = np.random.default_rng(7)
    sessions = []
    for n in (10, 7):
        counts = np.full(n, rows_per_msg, np.int64)
        rows = rng.integers(1, 50, (n * rows_per_msg, len(generator.FIELDS)),
                            dtype=np.int32)
        sessions.append({"cids": np.zeros(n, np.int64),
                         "csns": np.arange(1, n + 1), "refs": np.zeros(n),
                         "counts": counts,
                         "row0": np.concatenate([[0], np.cumsum(counts)]),
                         "rows": rows})
    rd = generator.make_rounds(sessions, 3, 4)[1]
    seq = np.arange(100, 100 + len(rd["cids"]))
    msn = seq // 2
    out = harness.stamp(rd, seq, msn)
    want = np.zeros(rd["content"]["seq"].size, np.int32)
    want[np.flatnonzero(rd["row_mask"])] = np.repeat(seq, rd["counts"])
    assert (out["seq"].reshape(-1) == want).all()
    want[np.flatnonzero(rd["row_mask"])] = np.repeat(msn, rd["counts"])
    assert (out["min_seq"].reshape(-1) == want).all()
    assert out["seq"].dtype == np.int32


@pytest.mark.parametrize("lost", [[], [7], [200], [396]])
def test_trace_reads_a_drifting_clock_and_a_lost_launch(lost):
    """The trace's clock, 123 s off the host's and drifting 2 ms over the
    window, is carried onto the rounds: busy time inside the window only,
    every B1 kernel's time, and a launch the profiler lost counted."""
    from portbench import trace
    from portbench.lanes import array
    from portbench.readings import Window

    rng = np.random.default_rng(3)
    n = 400
    ta = np.cumsum(rng.uniform(4e-3, 9e-3, n))
    took = rng.uniform(1e-3, 3e-3, n)
    host_end = ta + 0.5e-3 + took
    drift = 2e-3 * (host_end - ta[0]) / (host_end[-1] - ta[0])
    end = host_end + 123.0 + drift
    keep = np.setdiff1d(np.arange(n), lost)

    class Fake:
        def device_events(self):
            return [("merge_window_kernel<4>", e - t, e)
                    for e, t in zip(end[keep], took[keep])] + [
                ("Memcpy HtoD", 100.0, 100.5)]   # before the window

    cols = {c: ta + 1e-4 * i for i, (c, _) in enumerate(array.PHASES)}
    cols["end"] = host_end
    win = Window(rounds=cols, opens=np.zeros((0, 2)),
                 t_start=ta[0] - 1e-3, t_end=host_end[-1] + 1e-3)
    got = trace.read(Fake(), win, array.PHASES, array.KERNEL,
                     {"b1_sum": "merge_window", "copy": "Memcpy"})
    assert got["b1_lost"] == len(lost)
    assert got["b1_kernel_s"] == pytest.approx(list(took[keep]))
    assert got["busy_s"] == pytest.approx(took[keep].sum(), rel=1e-3)
    assert got["b1_sum_s"] == pytest.approx(took[keep].sum(), rel=1e-3)
    assert got["copy_s"] == 0
    assert got["device_ops"][0][0].startswith("merge_window")
    assert len(got["device_ops"]) == 1
    with pytest.raises(RuntimeError, match="launches of 'no_such_kernel'"):
        trace.read(Fake(), win, array.PHASES, ("x", "no_such_kernel"))
