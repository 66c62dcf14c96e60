"""A second lane needs no code edit: a toy lane written as one new file,
with a configuration naming it, a traffic mix and a cell, runs through
``cell.run`` in a copied checkout. The toy is the port's deli ticket
alone (``MultiDocSequencer.ticket_boxcar``), judged against the plain
``reference.tickets``; its window kernel is one elementwise torch op a
round on the tickets."""
import json
import time

import pytest
import torch

from portbench import cell as cells
from portbench import trace

SEED = 2**31 + 777

TOY_LANE = '''"""The deli ticket alone, and one torch op a round on it."""
import math
import time

import numpy as np

from portbench import generator

CONFIG_KEYS = ("docs", "clients", "sessions", "steps", "messages", "mix")
TRAFFIC_KEYS = ("messages_per_round",)
KERNEL = ("toy", "BitwiseXor")
SUMS = {"copies": "Memcpy"}
PHASES = (("ta", "ticket"), ("tb", "upload"), ("te", "between rounds"))
WRONG = False   # ticket one message a round wrong

Recording = generator.Recording


class Run:
    def __init__(self, cell, seed, device, trace, recording, log):
        from fluidframework_tpu_torch.native.sequencer_core import (
            MultiDocSequencer,
        )
        from portbench.harness import Marks

        self.docs, self.clients = cell.config["docs"], cell.config["clients"]
        self.device, self.seqs_cls, self.marks = device, MultiDocSequencer, \\
            Marks(device)
        self.sessions = recording()
        self.rounds = generator.make_rounds(
            self.sessions, self.docs, cell.traffic["messages_per_round"])
        self.recs, self.opens = [], []
        self.marks.start()
        self.batch(math.inf)
        self.marks.resolve(wait=True)
        self.recs, self.opens = [], []

    def batch(self, deadline):
        import torch

        t0 = time.perf_counter()
        seqs = self.seqs_cls(self.docs)
        for d in range(self.docs):
            for c in range(self.clients):
                seqs.join(d, c)
        self.opens.append((t0, time.perf_counter()))
        tickets = []
        for r, rd in enumerate(self.rounds):
            if r and time.perf_counter() >= deadline:
                break
            ta = time.perf_counter()
            seq, msn, status = seqs.ticket_boxcar(
                rd["doc_start"], rd["cids"], rd["csns"], rd["refs"])
            if WRONG:
                seq = seq.copy()
                seq[len(seq) // 2] += 1
            tb = time.perf_counter()
            a = torch.from_numpy(seq).to(self.device)
            b = torch.from_numpy(msn).to(self.device)
            torch.bitwise_xor(a, b)
            after = self.marks.mark()
            te = time.perf_counter()
            rec = [len(seq), len(seq), ta, tb, te, float("nan")]
            self.marks.watch(rec, after)
            self.recs.append(rec)
            tickets.append((seq, msn, status))
        return {"rounds": len(tickets), "tickets": tickets}

    def window(self, seconds):
        from portbench.readings import Window

        self.marks.start()
        t_start = time.perf_counter()
        while time.perf_counter() < t_start + seconds:
            self.last = self.batch(t_start + seconds)
        self.marks.resolve(wait=True)
        t_end = time.perf_counter()
        cols = {k: np.array([r[i] for r in self.recs], float) for i, k in
                enumerate(("rows", "msgs", "ta", "tb", "te", "end"))}
        return Window(rounds=cols, opens=np.array(self.opens).reshape(-1, 2),
                      t_start=t_start, t_end=t_end)

    def check(self):
        from portbench import compare, reference

        ref = [reference.tickets(s, self.clients) for s in self.sessions]
        tile = np.arange(self.docs) % len(self.sessions)
        expected = compare.expected_tickets(self.rounds, ref, tile)
        bad = compare.ticket_mismatches(self.last, expected)
        refused = sum(int(np.count_nonzero(t[2]))
                      for t in self.last["tickets"])
        return {"ticket_mismatches": {"value": bad, "limit": 0}}, refused, None


def slices(r):
    return f"{len(r.rounds['ta'])} rounds"


def extras(r):
    return {}
'''

TOY_CONFIG = {
    "name": "toy", "lane": "toy", "source": "a test's own",
    "deployment": "a test's own", "reduced": [], "assumed": {},
    "guarantees": ["total order per document"],
    "docs": 6, "clients": 3, "sessions": 2, "steps": 70, "messages": 48,
    "mix": {"insert": 0.6, "remove": 0.2, "annotate": 0.1,
            "process": 0.1, "max_insert_len": 6},
}


@pytest.fixture
def toy_root(tiny_root):
    """The tiny checkout with two lanes added as files (the toy and a
    broken copy), each with its configuration and cell, a traffic mix
    and a metric reader of the toy's window kernel; no file edited."""
    pb = tiny_root / "portbench"
    (pb / "lanes" / "toy.py").write_text(TOY_LANE)
    (pb / "lanes" / "toy_wrong.py").write_text(
        TOY_LANE.replace("WRONG = False", "WRONG = True"))
    (pb / "traffic" / "toy16.json").write_text(
        json.dumps({"name": "toy16", "messages_per_round": 16}))
    (pb / "metrics" / "toy_ms.py").write_text(
        "def read(r):\n    if r.trace is None:\n        return None\n"
        "    t = r.trace['toy_kernel_s']\n    return sum(t) / len(t) * 1e3\n")
    (pb / "metrics" / "copies_ms.py").write_text(
        "def read(r):\n    if r.trace is None:\n        return None\n"
        "    return r.trace['copies_s'] * 1e3 / len(r.rounds['ta'])\n")
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    for name in ("toy", "toy_wrong"):
        (pb / "configs" / f"{name}.json").write_text(
            json.dumps(dict(TOY_CONFIG, name=name, lane=name)))
        spec["configs"].append({
            "name": name, "source": "a test's own", "reduced": [],
            "file": f"portbench/configs/{name}.json", "why": "a test"})
        spec["workloads"].append({
            "name": f"{name}.t16", "config": name, "traffic": "toy16",
            "chips": 1, "why": "a test"})
    cells_ = ["toy.t16", "toy_wrong.t16"]
    for name, unit in (("ops_per_s.toy", "ops/s"),
                       ("round_p95_ms.toy", "ms")):
        spec["end_to_end"].append({
            "name": name, "unit": unit, "better": "lower", "bound": 0.25,
            "source": "host_clock", "workloads": cells_})
    for name in ("toy_ms", "copies_ms", "device_idle_share.toy"):
        spec["per_layer"].append({
            "name": name, "unit": "ms", "better": "lower",
            "source": "device_trace", "layer": "device",
            "moves": "ops_per_s.toy", "workloads": cells_})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    return tiny_root


def run_toy(root, name="toy.t16", trace_on=False, device="cpu"):
    cell = cells.load_cell(root, name)
    return cell, cells.run(cell, SEED, 1.0, trace_on, device,
                           time.perf_counter())


def test_a_lane_added_as_a_file_runs_correct(toy_root):
    cell, out = run_toy(toy_root)
    assert cell.lane.KERNEL == ("toy", "BitwiseXor")
    assert out["correct"], out["checks"]
    assert list(out["checks"]) == ["ticket_mismatches"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"ops_per_s.toy", "round_p95_ms.toy",
                                   "setup_s"}
    assert all(m["value"] > 0 for m in out["metrics"].values())
    assert "host_ms" not in out and list(out)[-1] == "checks"


def test_a_broken_lane_added_as_a_file_is_not_correct(toy_root):
    _, out = run_toy(toy_root, "toy_wrong.t16")
    assert not out["correct"]
    assert out["checks"]["ticket_mismatches"]["value"] > 0


def test_the_array_cells_keep_the_default_lane(toy_root):
    for name in ("tiny.r16", "string16c.typing"):
        lane = cells.load_cell(toy_root, name).lane
        assert lane.KERNEL == ("b1", "merge_window")
    with pytest.raises(FileNotFoundError):
        cells.load_lane(toy_root, "no_such_lane")


@pytest.mark.cuda
def test_toy_lane_traced_on_the_card(toy_root, monkeypatch):
    """Traced on a card, the toy's window is read through its own pattern,
    with no B1 launch in it: read with B1's pattern, the same trace
    raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    read = trace.read
    seen = []

    def spy(prof, win, phases, kernel, sums=None):
        with pytest.raises(RuntimeError, match="0 launches"):
            read(prof, win, phases, ("b1", "merge_window"))
        got = read(prof, win, phases, kernel, sums)
        seen.append((got, len(win.rounds["end"])))
        return got

    monkeypatch.setattr(trace, "read", spy)
    cell, out = run_toy(toy_root, trace_on=True, device="cuda")
    assert len(seen) == 1, "the traced run read no trace"
    got, rounds = seen[0]
    names = [n for n, _ in got["device_ops"]]
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == set(cell.traced_metrics), names
    assert out["toy_lost_by_the_trace"] == 0, names
    assert len(got["toy_kernel_s"]) == rounds
    assert got["copies_s"] > 0
    assert not any("merge_window" in n for n in names)
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
