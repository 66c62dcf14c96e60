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


def run_convergence_fuzz(cfg: FuzzConfig) -> str:
    """Random interleaving of local ops and partial sequencing across
    clients; returns the converged text."""
    text, _ = record_op_stream(cfg)
    return text


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


def record_flow_stream(seed: int = 0, n_clients: int = 3,
                       n_steps: int = 160):
    """Record a webflow-mix sequenced stream at the merge level — the
    FlowDocument workload's op shape (tag-PAIR markers with pairId
    props, pair-consistent removes, css token-list annotate churn,
    block tiles) expressed directly as kernel-encodable merge ops
    (VERDICT r4 next #9: the editor workload joins the bench corpus).
    Uses exactly the four property channels the device carries
    (class/tag/pairId/heading). Returns (converged_text, stream)."""
    from ..framework.flowdoc import (
        MARKER_LINEBREAK,
        MARKER_PARAGRAPH,
        MARKER_TAG_BEGIN,
        MARKER_TAG_END,
        PROP_CLASS,
        PROP_HEADING,
        PROP_PAIR,
        PROP_TAG,
        TAGS,
        pair_consistent_remove,
    )

    rng = random.Random(seed)
    ids = [f"client-{i}" for i in range(n_clients)]
    stream: list = []
    session = MockCollabSession(ids, stream_log=stream)
    words = ("flow", "tensor", "lattice", "quorum", "spline", "glyph")
    pair_n = 0

    for _ in range(n_steps):
        if rng.random() < 0.12 and session.pending_count:
            session.process_some(
                rng.randint(1, session.pending_count))
            continue
        cid = rng.choice(ids)
        client = session.client(cid)
        n = client.get_length()
        roll = rng.random()
        if roll < 0.34 or n < 4:
            pos = rng.randint(0, n)
            props = {PROP_CLASS: rng.choice(("hero", "note"))} \
                if rng.random() < 0.3 else None
            session.do(cid, "insert_text_local", pos,
                       rng.choice(words), props)
        elif roll < 0.50:
            a = rng.randrange(n - 2)
            b = rng.randint(a + 1, min(n, a + 9))
            pair_n += 1
            pid = f"{cid}-{pair_n}"
            session.do(cid, "insert_marker_local", b,
                       MARKER_TAG_END, {PROP_PAIR: pid})
            session.do(cid, "insert_marker_local", a,
                       MARKER_TAG_BEGIN,
                       {PROP_TAG: rng.choice(TAGS), PROP_PAIR: pid})
        elif roll < 0.64:
            # the binding's OWN pair-consistent remove walk, driven
            # at the merge level (one shared copy of the index.ts:248
            # orphan cleanup — flowdoc.pair_consistent_remove)
            a = rng.randrange(n - 2)
            b = rng.randint(a + 1, min(n, a + 7))
            pair_consistent_remove(
                client.mergetree.span_content,
                lambda lo, hi: session.do(
                    cid, "remove_range_local", lo, hi),
                a, b,
            )
        elif roll < 0.86:
            a = rng.randrange(n - 2)
            b = rng.randint(a + 1, min(n, a + 10))
            tok = rng.choice(("hot", "cold", "muted", "alert", None))
            session.do(cid, "annotate_range_local", a, b,
                       {PROP_CLASS: tok})
        else:
            pos = rng.randint(0, n)
            if rng.random() < 0.5:
                session.do(cid, "insert_marker_local", pos,
                           MARKER_PARAGRAPH,
                           {PROP_HEADING: rng.choice((1, 2))})
            else:
                session.do(cid, "insert_marker_local", pos,
                           MARKER_LINEBREAK, None)
    session.process_all()
    return session.assert_converged(), stream
