"""The array lane: SharedString documents replayed through the deli
ticket, the stamp, the upload and B1 (``harness``), and judged against
the plain deli and merge step (``reference``, ``compare``).

The configuration names the documents, clients per document, capacity
and the recorder's sessions, steps, messages and mix (``generator``);
the traffic mix the messages per document per round. Set-up: the lane,
the sessions cut into rounds, and one whole batch to warm every shape
the window uses (the kernels' builds, the allocator's blocks). Then the
window; then the reference over the kept batches.

Its own columns, beside the common ones: ``batch``, ``round`` (within
the batch), ``refused`` tickets; the host clock at the end of the
ticket (``tb``) and of the stamp (``tc``), at the upload's start
(``tw``: right after the stamp, or in a traced run after the host has
drained the device, so that ``tw - tc`` is that drain) and at its end
(``td``). ``te`` is the apply's enqueue, ``end`` the apply's end on the
device.
"""
from __future__ import annotations

import math
import time

import numpy as np

from portbench import generator

CONFIG_KEYS = ("docs", "clients", "capacity", "sessions", "steps",
               "messages", "mix")
TRAFFIC_KEYS = ("messages_per_round",)
KERNEL = ("b1", "merge_window")
SUMS = {}
PHASES = (("ta", "ticket"), ("tb", "stamp"), ("tc", "wait before upload"),
          ("tw", "upload"), ("td", "apply"), ("te", "between rounds"))
COLUMNS = ("batch", "round", "rows", "msgs", "refused",
           "ta", "tb", "tc", "tw", "td", "te", "end")

Recording = generator.Recording


class Run:
    """One cell's run of the lane; ``lane_cls`` stands in for
    ``harness.Lane``."""

    def __init__(self, cell, seed: int, device: str, trace: bool,
                 recording, log, lane_cls=None):
        from portbench import harness

        cfg = cell.config
        self.seed, self.trace, self.log = seed, trace, log
        self.docs, self.clients = cfg["docs"], cfg["clients"]
        self.capacity = cfg["capacity"]
        self.per_round = cell.traffic["messages_per_round"]
        self.device = device

        t = time.perf_counter()
        self.lane = (lane_cls or harness.Lane)(device, self.docs,
                                               self.clients, self.capacity)
        log(f"lane: {time.perf_counter() - t:.3f} s")
        t = time.perf_counter()
        self.sessions = recording()
        self.rounds = generator.make_rounds(self.sessions, self.docs,
                                            self.per_round)
        self.tile = np.arange(self.docs) % len(self.sessions)
        log(f"traffic: {len(self.sessions)} sessions, messages "
            f"{[len(s['counts']) for s in self.sessions]}, "
            f"{len(self.rounds)} rounds of window {self.rounds[0]['win']} "
            f"({time.perf_counter() - t:.3f} s)")

        t = time.perf_counter()
        marks = harness.Marks(device)
        marks.start()
        harness.run_batch(self.lane, self.rounds, marks,
                          harness.Window(marks=marks), -1, math.inf, trace)
        marks.resolve(wait=True)
        log(f"warm-up batch: {time.perf_counter() - t:.3f} s")

    def window(self, seconds: float):
        from portbench import harness
        from portbench.readings import Window

        self.win = win = harness.run_window(self.lane, self.rounds, seconds,
                                            self.seed, self.trace)
        self.cols = {k: np.array([r[i] for r in win.rounds], float)
                     for i, k in enumerate(COLUMNS)}
        return Window(rounds=self.cols,
                      opens=np.array(win.opens).reshape(-1, 2),
                      t_start=win.t_start, t_end=win.t_end)

    def check(self) -> tuple:
        from portbench import compare, reference, roofline

        self.lane = None
        t = time.perf_counter()
        ref = reference.replay(self.sessions, self.clients, self.capacity,
                               self.per_round, device=self.device)
        checks = compare.judge(self.win, self.rounds, ref, self.tile)
        self.log(f"reference and check: {time.perf_counter() - t:.3f} s, "
                 f"{len(self.win.kept)} batches kept "
                 f"{[(k['batch'], k['rounds']) for k in self.win.kept]}")
        least = roofline.least_seconds(ref["live"], self.tile, self.docs,
                                       self.capacity, self.rounds[0]["win"])
        failed = compare.failed_messages(self.win, self.rounds, self.tile)
        return checks, failed, least[self.cols["round"].astype(int)]


def slices(r, width: float = 10.0) -> str:
    """Op rows per second and host ms per round (ticket, stamp, upload)
    over each ``width`` seconds of the window: how the window drifts."""
    t = r.rounds["ta"] - r.rounds["ta"][0]
    out = []
    for k in range(int(t[-1] // width) + 1):
        m = (t >= k * width) & (t < (k + 1) * width)
        span = min(width, r.window_s - k * width)
        out.append(
            f"[{r.rounds['rows'][m].sum() / span / 1e6:.3f} M/s, ticket "
            f"{(r.rounds['tb'] - r.rounds['ta'])[m].mean() * 1e3:.3f}, stamp "
            f"{(r.rounds['tc'] - r.rounds['tb'])[m].mean() * 1e3:.3f}, upload "
            f"{(r.rounds['td'] - r.rounds['tw'])[m].mean() * 1e3:.3f} ms]")
    return " ".join(out)


def extras(r) -> dict:
    """``host_ms``: host ms per round in each phase, and per batch in
    the open."""
    host = r.rounds
    return {"host_ms": {
        "ticket": float((host["tb"] - host["ta"]).mean() * 1e3),
        "stamp": float((host["tc"] - host["tb"]).mean() * 1e3),
        "upload_wait": float((host["tw"] - host["tc"]).mean() * 1e3),
        "upload": float((host["td"] - host["tw"]).mean() * 1e3),
        "apply_enqueue": float((host["te"] - host["td"]).mean() * 1e3),
        "open": float((r.opens[:, 1] - r.opens[:, 0]).mean() * 1e3),
        "rounds": int(len(host["ta"])),
        "batches": int(len(r.opens)),
    }}
