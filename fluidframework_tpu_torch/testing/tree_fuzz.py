"""Seeded traffic for the tree plane: random changesets for the rebase
algebra (copied from the reference package, so the same seeds give the
same changesets) and ``record_tree_stream``, a recorded multi-writer
SharedTree session as the ordering service would sequence it.

Mirrors the reference's rebase-law fuzz pattern
(packages/dds/tree/src/test/rebase/generateFuzzyCombinedChange.spec.ts).
"""
from __future__ import annotations

import copy
import random

from ..models.tree import changeset as cs
from ..models.tree.editmanager import Commit, EditManager
from ..models.tree.forest import Forest, node, root_signature
from ..protocol.messages import ClientDetail, MessageType, SequencedMessage
from ..protocol.tree_payload import tree_change_to_json


def random_changeset(rng: random.Random, base_len: int,
                     n_edits: int = 3, move_p: float = 0.0) -> list:
    """Random ins/del/mod mark list against a base of ``base_len``
    nodes — the device-expressible subset (tree_atoms.py).

    ``move_p``: probability of emitting a standalone MOVE changeset
    (paired detach+revive, ``changeset.move``) instead of the
    ins/del/mod mix — 0 keeps the historical corpus (generator
    version 1); the move-racing workloads (test_tree_moves, bench
    config4 v2, the tree serving plane's fuzz) opt in."""
    if move_p and base_len >= 2 and rng.random() < move_p:
        src = rng.randint(0, base_len - 1)
        count = rng.randint(1, min(2, base_len - src))
        choices = [d for d in range(base_len + 1)
                   if d <= src or d >= src + count]
        dst = rng.choice(choices)
        # stamped: a bare move's rev half carries an unresolved pair
        # token — neither Forest.apply nor encode_changeset accepts it
        change = {"root": cs.move(src, count, dst)}
        cs.stamp(change, f"mv{rng.getrandbits(48)}")
        return change["root"]
    marks = []
    remaining = base_len
    for _ in range(n_edits):
        if remaining <= 0:
            break
        gap = rng.randint(0, max(0, remaining - 1))
        if gap:
            marks.append(cs.skip(gap))
            remaining -= gap
        choice = rng.random()
        if choice < 0.4:
            marks.append(cs.ins(
                [{"type": "n", "value": rng.randint(0, 99)}
                 for _ in range(rng.randint(1, 3))]
            ))
        elif choice < 0.75 and remaining > 0:
            k = rng.randint(1, min(3, remaining))
            marks.append(cs.dele(k))
            remaining -= k
        elif remaining > 0:
            marks.append(cs.mod(value={"new": rng.randint(100, 199)}))
            remaining -= 1
    return cs.normalize(marks)


def random_trunk(rng: random.Random, base: list, depth: int,
                 n_edits: int = 3,
                 move_p: float = 0.0) -> tuple[list[list], list]:
    """``depth`` successive changesets, each authored against the
    previous one's output; returns (changesets, final_sequence)."""
    overs, cur = [], list(base)
    if move_p:
        # a move's rev half needs repair data, which bare walk_apply
        # has no store for — advance through a Forest instead
        f = Forest({"root": copy.deepcopy(list(base))})
        for i in range(depth):
            o = random_changeset(rng, len(cur), n_edits,
                                 move_p=move_p)
            overs.append(o)
            f.apply({"root": o}, ("trunk", i))
            cur = f.content().get("root", [])
        return overs, cur
    for _ in range(depth):
        o = random_changeset(rng, len(cur), n_edits, move_p=move_p)
        overs.append(o)
        cur = cs.walk_apply(cur, o)
    return overs, cur


def random_change_with_moves(rng: random.Random, base_nodes: list,
                             uid: str, n_edits: int = 3,
                             move_p: float = 0.6):
    """Random STAMPED FieldChanges over ins/del/mod/MOVE against
    ``base_nodes`` — the shared generator behind the move-parity
    suites (tests/test_tree_moves.py) and the tree serving plane's
    concurrent fuzz, so the parity workload and the benchmark
    workload can't drift apart. Moves are authored standalone (the
    scalar ``changeset.move`` form: a paired detach+revive against
    one base), everything else as a positioned mark list; ``mod``
    values carry the true ``old`` for exact invertibility."""
    base_len = len(base_nodes)
    marks = []
    remaining = base_len
    pos = 0
    for _ in range(n_edits):
        if remaining <= 0:
            break
        gap = rng.randint(0, remaining - 1) if remaining > 1 else 0
        if gap:
            marks.append(cs.skip(gap))
            remaining -= gap
            pos += gap
        roll = rng.random()
        if roll < 0.3:
            marks.append(cs.ins(
                [{"type": "n", "value": 500 + i}
                 for i in range(rng.randint(1, 2))]
            ))
        elif roll < 0.55 and remaining > 0:
            k = rng.randint(1, min(2, remaining))
            marks.append(cs.dele(k))
            remaining -= k
            pos += k
        elif roll < 0.8 and remaining > 0:
            marks.append(cs.mod(value={
                "new": rng.randint(100, 199),
                "old": base_nodes[pos].get("value"),
            }))
            remaining -= 1
            pos += 1
        else:
            break  # moves are authored standalone below
    change = cs.normalize_fields({"root": marks})
    if rng.random() < move_p and base_len >= 2:
        src = rng.randint(0, base_len - 1)
        count = rng.randint(1, min(2, base_len - src))
        choices = [d for d in range(base_len + 1)
                   if d <= src or d >= src + count]
        dst = rng.choice(choices)
        change = {"root": cs.move(src, count, dst)}
    return cs.stamp(change, uid)


class _TreeSession:
    """A sequencer and one ``EditManager`` per writer, as the ordering
    service and the SharedTree replicas of a document see them. The
    minimum sequence number is the sequencer's: the least last
    reference of the joined clients (a client joins with its join seq
    minus one)."""

    def __init__(self, address: str, channel: str):
        self.address, self.channel = address, channel
        self.stream: list[SequencedMessage] = []
        self.seq = 0
        self.refs: dict[str, int] = {}
        self.csn: dict[str, int] = {}
        self.writers: dict[str, EditManager] = {}

    def _sequence(self, client, ref, mtype, contents) -> SequencedMessage:
        self.seq += 1
        if mtype == MessageType.CLIENT_JOIN:
            self.refs[contents.client_id] = self.seq - 1
            csn = -1
        else:
            self.refs[client] = ref
            self.csn[client] = self.csn.get(client, 0) + 1
            csn = self.csn[client]
        msg = SequencedMessage(
            client_id=client, sequence_number=self.seq,
            minimum_sequence_number=min(self.refs.values()),
            client_sequence_number=csn, reference_sequence_number=ref,
            type=mtype, contents=contents)
        self.stream.append(msg)
        return msg

    def join(self, client: str) -> None:
        self._sequence(None, -1, MessageType.CLIENT_JOIN,
                       ClientDetail(client_id=client))
        self.writers[client] = EditManager(session_id=client)
        # a joining replica catches up on every op sequenced so far
        for msg in self.stream:
            if msg.type == MessageType.OPERATION and \
                    msg.contents["kind"] == "op":
                self._deliver(self.writers[client], msg)

    def attach(self, client: str, ref: int) -> None:
        self._sequence(client, ref, MessageType.OPERATION, {
            "kind": "attach", "address": self.address,
            "channel": self.channel,
            "contents": {"channelType": "sharedtree"}})

    def author(self, client: str, changes: dict) -> tuple:
        """A local edit against the writer's current view: stamped by its
        EditManager, sent later by ``flush`` with the view's ref."""
        self.writers[client].add_local_change(changes)
        return client, self.seq, changes

    def flush(self, pending: tuple) -> None:
        client, ref, changes = pending
        msg = self._sequence(client, ref, MessageType.OPERATION, {
            "kind": "op", "address": self.address,
            "channel": self.channel,
            "contents": tree_change_to_json(copy.deepcopy(changes))})
        for em in self.writers.values():
            self._deliver(em, msg)

    @staticmethod
    def _deliver(em: EditManager, msg: SequencedMessage) -> None:
        em.add_sequenced_change(Commit(
            session_id=msg.client_id, seq=msg.sequence_number,
            ref_seq=msg.reference_sequence_number,
            changes=copy.deepcopy(msg.contents["contents"]["changes"]),
        ), msg.client_id == em.session_id)
        if msg.minimum_sequence_number > em.min_seq:
            em.advance_minimum_sequence_number(
                msg.minimum_sequence_number)

    def view(self, client: str) -> list:
        return self.writers[client].forest().content().get("root", [])


def record_tree_stream(seed: int, writers: int = 3, rounds: int = 24,
                       seed_nodes: int = 192, seed_chunk: int = 32,
                       address: str = "d", channel: str = "t"):
    """Record one SharedTree document's sequenced stream: writer ``w0``
    joins, attaches the tree (datastore ``address``, channel
    ``channel``) and fills it with ``seed_nodes`` nodes in commits of
    ``seed_chunk`` (one flush each, the attach in the first); writers ``w1``.. join; then, for
    each of ``rounds`` rounds, every writer authors
    ``random_change_with_moves`` against its current view before any of
    them sends, and the writers' ops are sequenced in ``rng.shuffle``
    order, each with the reference sequence number of the view it was
    authored against (a Container sends its outbox before it processes
    the next sequenced op). Returns ``(signature, stream)``: the
    writers' converged root field in ``root_signature`` form, and every
    sequenced message (joins and the attach included)."""
    rng = random.Random(seed)
    ids = [f"w{i}" for i in range(writers)]
    session = _TreeSession(address, channel)
    session.join(ids[0])
    for start in range(0, seed_nodes, seed_chunk):
        nodes = [node("n", value=v)
                 for v in range(start, min(start + seed_chunk, seed_nodes))]
        marks = ([cs.skip(start)] if start else []) + [cs.ins(nodes)]
        pending = session.author(ids[0], {"root": marks})
        if not start:  # the attach goes out in the first seed's flush
            session.attach(ids[0], ref=pending[1])
        session.flush(pending)
    for client in ids[1:]:
        session.join(client)
    for rnd in range(rounds):
        pending = [
            session.author(client, random_change_with_moves(
                rng, session.view(client), f"{chr(65 + i)}{rnd}"))
            for i, client in enumerate(ids)]
        rng.shuffle(pending)
        for p in pending:
            session.flush(p)
    views = {root_signature(session.view(c)) for c in ids}
    if len(views) != 1:
        raise AssertionError(f"seed {seed}: the writers did not converge")
    return views.pop(), session.stream
