"""Seeded convergence fuzzing.

Reference: packages/test/stochastic-test-utils/src — deterministic
seeded PRNG (``makeRandom``, random.ts:45), weighted op generators
(generators.ts:40), reducer loops (performActions.ts:131). The pattern
fuzzes interleavings of local ops and partial sequencing, asserting all
replicas converge — the reference's substitute for race detectors
(SURVEY §5.2).

A copy of the reference's recorders (the same seeds give the same
streams), kept so the port can make its own seeded traffic.
"""
from __future__ import annotations

import random
import string
from dataclasses import dataclass

from .mocks import MockCollabSession


@dataclass
class FuzzConfig:
    n_clients: int = 3
    n_steps: int = 200
    insert_weight: float = 0.5
    remove_weight: float = 0.25
    annotate_weight: float = 0.1
    process_weight: float = 0.15
    max_insert_len: int = 8
    seed: int = 0
    # probability an insert carries initial properties
    # (insert(..., props=) — segmentPropertiesManager.ts:29)
    insert_props_weight: float = 0.0


def random_op(rng: random.Random, session: MockCollabSession,
              client_id: str, cfg: FuzzConfig) -> None:
    """Perform one weighted random local op on one client."""
    client = session.client(client_id)
    length = client.get_length()
    choices = [("insert", cfg.insert_weight)]
    if length > 0:
        choices.append(("remove", cfg.remove_weight))
        choices.append(("annotate", cfg.annotate_weight))
    kinds = [k for k, _ in choices]
    weights = [w for _, w in choices]
    kind = rng.choices(kinds, weights=weights)[0]

    if kind == "insert":
        pos = rng.randint(0, length)
        text = "".join(
            rng.choices(string.ascii_lowercase,
                        k=rng.randint(1, cfg.max_insert_len))
        )
        if rng.random() < cfg.insert_props_weight:
            key = rng.choice(["bold", "color", "size"])
            value = rng.choice([1, 2, "x"])
            session.do(client_id, "insert_text_local", pos, text,
                       {key: value})
        else:
            session.do(client_id, "insert_text_local", pos, text)
    elif kind == "remove":
        start = rng.randint(0, length - 1)
        end = rng.randint(start + 1, length)
        session.do(client_id, "remove_range_local", start, end)
    else:
        start = rng.randint(0, length - 1)
        end = rng.randint(start + 1, length)
        key = rng.choice(["bold", "color", "size"])
        value = rng.choice([None, 1, 2, "x"])
        session.do(client_id, "annotate_range_local", start, end,
                   {key: value})


def record_op_stream(cfg: FuzzConfig):
    """Run the convergence fuzz, returning (converged_text, sequenced
    stream incl. joins) — the stream feeds differential tests of the
    batched kernel."""
    rng = random.Random(cfg.seed)
    ids = [f"client-{i}" for i in range(cfg.n_clients)]
    stream: list = []
    session = MockCollabSession(ids, stream_log=stream)
    for _ in range(cfg.n_steps):
        if rng.random() < cfg.process_weight and session.pending_count:
            session.process_some(rng.randint(1, session.pending_count))
        else:
            random_op(rng, session, rng.choice(ids), cfg)
    session.process_all()
    return session.assert_converged(), stream


def record_sequential_stream(seed: int = 0, n_clients: int = 3,
                             n_steps: int = 100,
                             remove_weight: float = 0.12,
                             annotate_weight: float = 0.08):
    """Record a FULLY-SEQUENTIAL sequenced stream: every client
    processes everything before acting, so each op's refseq is the
    sequenced head when it was sent — every op is critical in the
    event-graph sense (ops/event_graph.py). This is the shape of most
    real collaborative traffic (people rarely type at the same
    instant in the same document) and the corpus the egwalker route's
    fast path is measured on (bench config14 'sequential-heavy').
    Returns (converged_text, stream)."""
    cfg = FuzzConfig(
        n_clients=n_clients, n_steps=n_steps,
        insert_weight=max(0.0, 1.0 - remove_weight - annotate_weight),
        remove_weight=remove_weight,
        annotate_weight=annotate_weight,
        process_weight=0.0,  # sequencing is explicit below
        max_insert_len=6, seed=seed,
    )
    rng = random.Random(seed)
    ids = [f"client-{i}" for i in range(n_clients)]
    stream: list = []
    session = MockCollabSession(ids, stream_log=stream)
    for _ in range(n_steps):
        random_op(rng, session, rng.choice(ids), cfg)
        # the sequential contract: fully sequence + deliver after
        # every local op, so the next op (any client) has seen it
        session.process_all()
    session.process_all()
    return session.assert_converged(), stream
