"""Seeded concurrent editing sessions: a frozen copy of
``testing/fuzz.py``'s ``record_op_stream`` and ``random_op``. Each step
either sequences a random number of the queued raw ops or makes one
weighted random local edit (insert, remove, annotate) on a random
client; at the end every queued op is sequenced. The same mix and seed
give the same stream."""
from __future__ import annotations

import random
import string
from dataclasses import dataclass

from .session import Session


@dataclass(frozen=True)
class Mix:
    n_clients: int
    n_steps: int
    insert_weight: float
    remove_weight: float
    annotate_weight: float
    process_weight: float
    max_insert_len: int


def random_op(rng: random.Random, session: Session, client_id: str,
              mix: Mix) -> None:
    """One weighted random local edit on one client."""
    length = session.clients[client_id].get_length()
    choices = [("insert", mix.insert_weight)]
    if length > 0:
        choices.append(("remove", mix.remove_weight))
        choices.append(("annotate", mix.annotate_weight))
    kind = rng.choices([k for k, _ in choices],
                       weights=[w for _, w in choices])[0]
    if kind == "insert":
        pos = rng.randint(0, length)
        text = "".join(rng.choices(string.ascii_lowercase,
                                   k=rng.randint(1, mix.max_insert_len)))
        rng.random()  # the insert-props draw of the original (weight 0)
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


def record(mix: Mix, seed: int) -> tuple:
    """(converged text, sequenced stream with joins) of one session."""
    rng = random.Random(seed)
    ids = [f"client-{i}" for i in range(mix.n_clients)]
    session = Session(ids)
    for _ in range(mix.n_steps):
        if rng.random() < mix.process_weight and session.queue:
            session.process(rng.randint(1, len(session.queue)))
        else:
            random_op(rng, session, rng.choice(ids), mix)
    session.process(len(session.queue))
    return session.text(), session.stream
