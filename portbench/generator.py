"""The one traffic generator: sessions recorded from the seed, encoded
as op rows, and cut into the rounds that a cell replays.

A configuration (``configs/<name>.json``) names the deployment: its
documents, clients per document, capacity, the recorder's mix and step
count, and how many distinct sessions a seed records. A traffic mix
(``traffic/<name>.json``) says how the sessions are replayed: messages
per document per round. Document ``d`` replays session ``d % sessions``;
round ``r`` holds each document's messages ``[r * m, (r + 1) * m)``.

Every op row carries the fields of the port's ``OpBatch`` by name. A
row's ``seq`` and ``min_seq`` are left 0: they are the ticket's, and the
stamp writes them.
"""
from __future__ import annotations

import multiprocessing
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from .recorder.fuzz import Mix, record
from .recorder.mergetree.ops import DeltaType
from .recorder.protocol import MessageType

FIELDS = ("kind", "pos1", "pos2", "seq", "refseq", "client",
          "op_id", "length", "is_marker", "prop_key", "prop_val",
          "min_seq")
KIND_INSERT, KIND_REMOVE, KIND_ANNOTATE, KIND_NOOP = 0, 1, 2, 3
PROP_CHANNELS = 4


def session_seed(seed: int, i: int) -> int:
    """The recorder's seed of session ``i`` of a run seeded ``seed``."""
    return seed * 1009 + i


def encode(stream: list) -> dict:
    """One session's operation messages as ticket inputs (``cids`` from
    ``client-N``, ``csns``, ``refs``), the op rows each makes
    (``counts``) and the rows, ``[n, len(FIELDS)]`` int32. Property keys
    and values are interned per document in order of first use (value
    0 deletes)."""
    keys, vals, inserts = {}, {}, 0
    cids, csns, refs, counts, rows = [], [], [], [], []
    for msg in stream:
        if msg.type != MessageType.OPERATION:
            continue
        cid = int(msg.client_id.rsplit("-", 1)[1])
        op = msg.contents
        made = []
        base = dict.fromkeys(FIELDS, 0)
        base.update(refseq=msg.reference_sequence_number, client=cid)
        if op.type == DeltaType.INSERT:
            marker = op.text is None
            made.append(dict(base, kind=KIND_INSERT, pos1=op.pos1,
                             op_id=inserts,
                             length=1 if marker else len(op.text),
                             is_marker=int(marker)))
            inserts += 1
        elif op.type == DeltaType.REMOVE:
            made.append(dict(base, kind=KIND_REMOVE, pos1=op.pos1,
                             pos2=op.pos2))
        elif op.type == DeltaType.ANNOTATE:
            for key, value in op.props.items():
                k = keys.setdefault(key, len(keys))
                if k >= PROP_CHANNELS:
                    raise ValueError(f"more than {PROP_CHANNELS} keys")
                v = 0 if value is None else vals.setdefault(value,
                                                            len(vals) + 1)
                made.append(dict(base, kind=KIND_ANNOTATE, pos1=op.pos1,
                                 pos2=op.pos2, prop_key=k, prop_val=v))
        else:
            raise ValueError(f"op type {op.type} is not in the mix")
        cids.append(cid)
        csns.append(msg.client_sequence_number)
        refs.append(msg.reference_sequence_number)
        counts.append(len(made))
        rows.extend(made)
    table = np.array([[r[f] for f in FIELDS] for r in rows], np.int32)
    counts = np.array(counts, np.int64)
    return {"cids": np.array(cids, np.int64),
            "csns": np.array(csns, np.int64),
            "refs": np.array(refs, np.int64),
            "counts": counts,
            "row0": np.concatenate([[0], np.cumsum(counts)]),
            "rows": table.reshape(len(rows), len(FIELDS))}


def mix_of(config: dict) -> Mix:
    m = config["mix"]
    return Mix(n_clients=config["clients"], n_steps=config["steps"],
               insert_weight=m["insert"], remove_weight=m["remove"],
               annotate_weight=m["annotate"],
               process_weight=m["process"],
               max_insert_len=m["max_insert_len"])


def record_encoded(mix: Mix, seed: int) -> dict:
    return encode(record(mix, seed)[1])


def truncate(session: dict, messages: int) -> dict:
    """The session's first ``messages`` messages (a prefix of a
    sequenced stream is one)."""
    out = {k: session[k][:messages] for k in ("cids", "csns", "refs",
                                              "counts")}
    out["row0"] = session["row0"][:messages + 1]
    out["rows"] = session["rows"][:out["row0"][-1]]
    return out


class Recording:
    """The config's distinct sessions for one seed, being recorded.
    Calling it waits for them and gives them encoded, each cut to the
    config's ``messages`` (so that every seed replays as many messages).
    With more than one worker they are recorded in spawned processes,
    which import nothing but this package's generator, so that they run
    beside the caller's own set-up; ``stop`` ends those processes."""

    def __init__(self, config: dict, seed: int, workers: int = 1):
        mix = mix_of(config)
        seeds = [session_seed(seed, i) for i in range(config["sessions"])]
        self.cut, self.pool = config["messages"], None
        if workers <= 1:
            self.sessions = [record_encoded(mix, s) for s in seeds]
            return
        self.pool = ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn"))
        self.futures = [self.pool.submit(record_encoded, mix, s)
                        for s in seeds]

    def __call__(self) -> list:
        if self.pool is not None:
            try:
                self.sessions = [f.result() for f in self.futures]
            finally:
                self.stop()
        return [truncate(s, self.cut) for s in self.sessions]

    def stop(self) -> None:
        if self.pool is not None:
            self.pool.shutdown(wait=True, cancel_futures=True)
            self.pool = None


def make_sessions(config: dict, seed: int, workers: int = 1) -> list:
    """The config's distinct sessions for ``seed``, recorded and cut
    (``Recording``, waited for)."""
    return Recording(config, seed, workers)()


def make_rounds(sessions: list, docs: int, per_round: int) -> list:
    """One batch's rounds: per round the boxcar's ticket inputs over
    every document (``doc_start``, ``cids``, ``csns``, ``refs``,
    ``counts``), its op rows as ``[docs, win]`` content windows per
    field (NOOP-padded; ``seq``, ``min_seq`` 0), ``row_mask`` the slots
    of ``[docs, win]`` that hold a row (flattened; the rows in order),
    ``msg_of_row`` each row's message (None where every message makes
    one row), ``n_rows`` and ``spans`` each session's message span.
    Every round pads to one window width ``win``."""
    tile = np.arange(docs) % len(sessions)
    n_msgs = [len(s["counts"]) for s in sessions]
    n_rounds = -(-max(n_msgs) // per_round)
    spans = [[(min(r * per_round, n), min((r + 1) * per_round, n))
              for n in n_msgs] for r in range(n_rounds)]
    win = max(1, max(int(s["row0"][m1] - s["row0"][m0])
                     for sp in spans for s, (m0, m1) in zip(sessions, sp)))
    rounds = []
    for sp in spans:
        base = np.zeros((len(sessions), win, len(FIELDS)), np.int32)
        base[..., FIELDS.index("kind")] = KIND_NOOP
        n_rows = np.zeros(len(sessions), np.int64)
        for b, (s, (m0, m1)) in enumerate(zip(sessions, sp)):
            r0, r1 = s["row0"][m0], s["row0"][m1]
            base[b, :r1 - r0] = s["rows"][r0:r1]
            n_rows[b] = r1 - r0
        content = base[tile]
        rows_of = n_rows[tile]
        msgs = np.array([m1 - m0 for m0, m1 in sp])[tile]
        row_mask = (np.arange(win)[None, :] < rows_of[:, None]).reshape(-1)

        def cat(key):
            parts = [s[key][m0:m1] for s, (m0, m1) in zip(sessions, sp)]
            return np.ascontiguousarray(np.concatenate(
                [parts[b] for b in tile]))

        counts = cat("counts")
        rounds.append({
            "doc_start": np.concatenate([[0], np.cumsum(msgs)]),
            "cids": cat("cids"), "csns": cat("csns"), "refs": cat("refs"),
            "counts": counts,
            "content": {f: np.ascontiguousarray(content[..., j])
                        for j, f in enumerate(FIELDS)},
            "row_mask": row_mask,
            "msg_of_row": (None if (counts == 1).all() else
                           np.repeat(np.arange(len(counts)), counts)),
            "n_rows": int(rows_of.sum()),
            "spans": sp,
            "win": win,
        })
    return rounds
