"""The array lane under a timed window: batches of fresh documents, each
replayed round by round through the port.

Per batch: ``open`` (a ``native.sequencer_core.MultiDocSequencer`` with
every client joined to every document, and ``ops.segment_table.
make_table``). Per round: ``ticket`` (``ticket_boxcar`` over every
document's messages of the round), ``stamp`` (the benchmark's own glue:
each ticket's seq / msn written into its op rows), ``upload``
(``convert.batch_from_numpy``) and ``apply`` (``ops.merge_kernel.
apply_window``, B1 on a CUDA table). The loop is closed and never syncs
on its own: round r + 1's ticket starts once round r's apply is
enqueued. At the deadline no round starts; what is in flight drains and
counts.

Host spans come from the clock around each call; each apply is followed
by a device mark (a CUDA event on a card) from which a round's end is
read after the window. Batches kept for the check are drawn from the
seed (a reservoir), the last batch always among them.
"""
from __future__ import annotations

import random
import time
from dataclasses import dataclass, field

import numpy as np
import torch


def stamp(rd: dict, seq: np.ndarray, msn: np.ndarray) -> dict:
    """The round's op arrays with each ticket's seq / msn written into
    its rows (``chip_smoke.run_config5``'s glue, made cheaper): each
    field a fresh zeroed ``[docs, win]`` int32 array (the content's own
    ``seq`` / ``min_seq`` are 0), the ticket written through the round's
    row mask, repeated over a message's rows where one makes several."""
    arrays = dict(rd["content"])
    pick = rd["msg_of_row"]
    for f, v in (("seq", seq), ("min_seq", msn)):
        stamped = np.zeros(arrays[f].shape, np.int32)
        stamped.reshape(-1)[rd["row_mask"]] = v if pick is None else v[pick]
        arrays[f] = stamped
    return arrays


class Lane:
    """The port's calls, one method per layer, so a test can break one
    underneath a whole run."""

    def __init__(self, device: str, docs: int, clients: int,
                 capacity: int):
        from fluidframework_tpu_torch.convert import batch_from_numpy
        from fluidframework_tpu_torch.native.sequencer_core import (
            MultiDocSequencer,
        )
        from fluidframework_tpu_torch.ops.merge_kernel import apply_window
        from fluidframework_tpu_torch.ops.segment_table import make_table

        self.device, self.docs = device, docs
        self.clients, self.capacity = clients, capacity
        self._seqs_cls, self._make_table = MultiDocSequencer, make_table
        self._upload, self._apply = batch_from_numpy, apply_window

    def open(self):
        seqs = self._seqs_cls(self.docs)
        for d in range(self.docs):
            for c in range(self.clients):
                seqs.join(d, c)
        return seqs, self._make_table(self.docs, self.capacity, self.device)

    def ticket(self, seqs, rd: dict) -> tuple:
        return seqs.ticket_boxcar(rd["doc_start"], rd["cids"], rd["csns"],
                                  rd["refs"])

    def upload(self, arrays: dict):
        return self._upload(arrays, self.device)

    def apply(self, table, batch):
        return self._apply(table, batch)


class Marks:
    """Device marks: a CUDA event after each apply on a card; the host
    clock after each call on the CPU, where every call has finished when
    it returns. A mark becomes a host time as soon as the device has
    passed it, and its event is dropped then: events left alive by the
    thousand slow the host's own work down as the window goes on."""

    def __init__(self, device: str):
        self.cuda = torch.device(device).type == "cuda"
        self.t0 = self.e0 = None
        self.pending = []   # (record, mark) not yet passed

    def start(self) -> None:
        """The anchor: the device idle, its mark at a known host time."""
        if self.cuda:
            torch.cuda.synchronize()
            self.e0 = torch.cuda.Event(enable_timing=True)
            self.e0.record()
            torch.cuda.synchronize()
        self.t0 = time.perf_counter()

    def mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def drain(self) -> None:
        """Wait until the device has done all the work enqueued so far."""
        if self.cuda:
            torch.cuda.current_stream().synchronize()

    def watch(self, rec: list, after) -> None:
        """``rec[-1]`` becomes the host time at which the device passed
        ``after``."""
        self.pending.append((rec, after))

    def resolve(self, wait: bool = False) -> None:
        """Resolve every pending mark the device has passed (all of them,
        after a sync, with ``wait``)."""
        if wait and self.cuda:
            torch.cuda.synchronize()
        left = []
        for rec, after in self.pending:
            if self.cuda and not (wait or after.query()):
                left.append((rec, after))
            elif self.cuda:
                rec[-1] = self.t0 + self.e0.elapsed_time(after) / 1e3
            else:
                rec[-1] = after
        self.pending = left


@dataclass
class Window:
    """What the window did: per round (batch, round, rows, messages,
    refused, the host clock at the ticket's start, at the end of the
    ticket and of the stamp, at the upload's start, at its end and at
    the apply's enqueue, the host time of the apply's end on the
    device), per batch its open span, and the batches kept for the
    check."""

    marks: Marks
    rounds: list = field(default_factory=list)
    opens: list = field(default_factory=list)
    kept: list = field(default_factory=list)
    t_start: float = 0.0
    t_end: float = 0.0


def run_batch(lane: Lane, rounds: list, marks: Marks, win: Window,
              b: int, deadline: float, traced: bool) -> dict:
    """One batch of fresh documents, round by round until its sessions
    end or the deadline passes. Returns the batch: its index, the rounds
    it applied, its last table, every round's tickets and ``whole``.

    ``convert.batch_from_numpy``'s copies from pageable memory wait for
    the device's earlier work on the stream. In a ``traced`` run the
    host waits for that work before the upload's clock starts, so that
    the upload's span holds the copies alone; the copies would have
    waited as long, so the loop keeps its pace."""
    t0 = time.perf_counter()
    seqs, table = lane.open()
    win.opens.append((t0, time.perf_counter()))
    tickets = []
    for r, rd in enumerate(rounds):
        if r and time.perf_counter() >= deadline:
            break
        ta = time.perf_counter()
        seq, msn, status = lane.ticket(seqs, rd)
        tb = time.perf_counter()
        arrays = stamp(rd, seq, msn)
        tc = time.perf_counter()
        if traced:
            marks.drain()
        tw = time.perf_counter()
        batch = lane.upload(arrays)
        td = time.perf_counter()
        marks.resolve()
        table = lane.apply(table, batch)
        after = marks.mark()
        te = time.perf_counter()
        rec = [b, r, rd["n_rows"], len(rd["cids"]),
               int(np.count_nonzero(status)), ta, tb, tc, tw, td, te,
               float("nan")]
        marks.watch(rec, after)
        win.rounds.append(rec)
        tickets.append((seq, msn, status))
    return {"batch": b, "rounds": len(tickets), "table": table,
            "tickets": tickets, "whole": len(tickets) == len(rounds)}


def run_window(lane: Lane, rounds: list, seconds: float, seed: int,
               traced: bool, keep_batches: int = 3) -> Window:
    """Batches back to back for ``seconds``; then a sync, and the window
    ends. Kept for the check: a reservoir of ``keep_batches`` whole
    batches drawn from ``seed``, and the last batch (the one the
    deadline cut, or the last whole one)."""
    marks = Marks(lane.device)
    win = Window(marks=marks)
    rng = random.Random(seed)
    reservoir, last = [], None
    marks.start()
    win.t_start = time.perf_counter()
    deadline = win.t_start + seconds
    b = 0
    while time.perf_counter() < deadline:
        last = run_batch(lane, rounds, marks, win, b, deadline, traced)
        if last["whole"]:
            if len(reservoir) < keep_batches:
                reservoir.append(last)
            elif rng.random() < keep_batches / (b + 1):
                reservoir[rng.randrange(keep_batches)] = last
        b += 1
    marks.resolve(wait=True)
    win.t_end = time.perf_counter()
    win.kept = reservoir + [k for k in [last] if k is not None and all(
        k is not x for x in reservoir)]
    return win
