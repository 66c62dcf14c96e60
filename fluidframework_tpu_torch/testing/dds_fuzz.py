"""Generic DDS fuzz harness: one engine, every channel type.

Reference: packages/dds/test-dds-utils (the ``ddsFuzzHarness``
pattern) layered on stochastic-test-utils: a seeded weighted action
mix — local edits on random clients, partial sequencing, disconnect/
reconnect churn — driven against full container runtimes, with a
convergence assert at the end. Every DDS registers an action
generator; the engine owns interleaving and fault scheduling.

Failures reproduce from (channel_type, seed) alone; the returned
``DdsFuzzReport.trace`` lists the actions taken for minimization.
"""
from __future__ import annotations

import random
import string
import zlib
from dataclasses import dataclass, field
from typing import Callable

from .runtime_mocks import ContainerSession


@dataclass
class DdsFuzzConfig:
    channel_type: str = "sharedmap"
    n_clients: int = 3
    n_steps: int = 300
    seed: int = 0
    p_process_some: float = 0.20   # sequence a random prefix
    p_process_all: float = 0.05
    p_reconnect_churn: float = 0.03
    reconnect_after: int = 12


@dataclass
class DdsFuzzReport:
    channel_type: str
    seed: int
    steps: int = 0
    actions: int = 0
    reconnects: int = 0
    trace: list[str] = field(default_factory=list)


def _word(rng: random.Random, n: int = 6) -> str:
    return "".join(rng.choices(string.ascii_lowercase, k=rng.randint(1, n)))


# ----------------------------------------------------------------------
# per-DDS action generators: (rng, channel, client_id) -> desc | None

def _fuzz_map(rng, m, cid):
    roll = rng.random()
    if roll < 0.70 or not len(m):
        key = f"k{rng.randrange(12)}"
        m.set(key, rng.randrange(100))
        return f"set {key}"
    if roll < 0.95:
        key = f"k{rng.randrange(12)}"
        m.delete(key)
        return f"del {key}"
    m.clear()
    return "clear"


def _fuzz_directory(rng, d, cid):
    path = rng.choice(["/", "/a", "/a/b", "/c"])
    if path != "/" and not d.has_sub_directory(path.split("/")[-1],
                                              path.rsplit("/", 1)[0] or "/"):
        parent, name = path.rsplit("/", 1)
        d.create_sub_directory(name, parent or "/")
        return f"mkdir {path}"
    key = f"k{rng.randrange(8)}"
    if rng.random() < 0.8:
        d.set(key, _word(rng), path)
        return f"dir set {path}:{key}"
    d.delete(key, path)
    return f"dir del {path}:{key}"


def _fuzz_cell(rng, c, cid):
    if rng.random() < 0.85:
        c.set(rng.randrange(1000))
        return "cell set"
    c.delete()
    return "cell delete"


def _fuzz_counter(rng, c, cid):
    delta = rng.randint(-5, 9)
    c.increment(delta)
    return f"inc {delta}"


def _fuzz_string(rng, s, cid):
    length = s.get_length()
    roll = rng.random()
    if roll < 0.02:
        # local compaction interleaving: zamboni drops aged
        # tombstones and transfers interval refs; it must never
        # change the convergence signature (VERDICT r4 next #7 —
        # intervalCollection.fuzz.spec.ts crosses stickiness with
        # compaction)
        s.client.mergetree.zamboni()
        return "zamboni"
    if roll < 0.55 or length == 0:
        pos = rng.randint(0, length)
        s.insert_text(pos, _word(rng))
        return f"ins @{pos}"
    if roll < 0.80 and length > 0:
        start = rng.randrange(length)
        end = min(length, start + rng.randint(1, 5))
        s.remove_text(start, end)
        return f"rm [{start},{end})"
    if roll < 0.92 and length > 0:
        start = rng.randrange(length)
        end = min(length, start + rng.randint(1, 6))
        s.annotate_range(start, end, {
            rng.choice(["b", "i"]): rng.choice([1, 2, None])
        })
        return f"ann [{start},{end})"
    # interval ops ride the same channel
    coll = s.get_interval_collection("fuzz")
    if len(coll) and rng.random() < 0.5:
        iv = rng.choice(list(coll))
        if rng.random() < 0.5:
            coll.delete(iv.interval_id)
            return "iv del"
        if length > 0:
            a = rng.randrange(length)
            b = min(length - 1, a + rng.randint(0, 4))
            coll.change(iv.interval_id, start=a, end=b)
            return "iv change"
        return None
    if length > 0:
        a = rng.randrange(length)
        b = min(length - 1, a + rng.randint(0, 4))
        sticky = rng.choice(("none", "start", "end", "full"))
        coll.add(a, b, {"n": rng.randrange(9)}, stickiness=sticky)
        return f"iv add {sticky}"
    return None


def _fuzz_matrix(rng, m, cid):
    rows, cols = m.row_count, m.col_count
    roll = rng.random()
    if roll < 0.25 or rows == 0 or cols == 0:
        if rng.random() < 0.5 or cols == 0:
            m.insert_rows(rng.randint(0, rows), rng.randint(1, 2))
            return "ins rows"
        m.insert_cols(rng.randint(0, cols), rng.randint(1, 2))
        return "ins cols"
    if roll < 0.35 and rows > 1:
        pos = rng.randrange(rows - 1)
        m.remove_rows(pos, 1)
        return f"rm row {pos}"
    if roll < 0.45 and cols > 1:
        pos = rng.randrange(cols - 1)
        m.remove_cols(pos, 1)
        return f"rm col {pos}"
    r, c = rng.randrange(rows), rng.randrange(cols)
    m.set_cell(r, c, rng.randrange(100))
    return f"cell ({r},{c})"


def _fuzz_tree(rng, t, cid):
    path = (rng.choice(["items", "meta"]),)
    n = len(t.get_field(path))
    roll = rng.random()
    if roll < 0.5 or n == 0:
        t.insert_nodes(path, rng.randint(0, n), [
            {"value": rng.randrange(100)}
        ])
        return f"tree ins {path[0]}"
    if roll < 0.75:
        t.delete_nodes(path, rng.randrange(n), 1)
        return f"tree del {path[0]}"
    t.set_value(path, rng.randrange(n), rng.randrange(1000))
    return f"tree set {path[0]}"


def _fuzz_register(rng, r, cid):
    key = f"reg{rng.randrange(6)}"
    r.write(key, rng.randrange(100))
    return f"write {key}"


def _fuzz_ink(rng, ink, cid):
    # single-writer-per-stroke: a client appends only to strokes it
    # created (the Ink contract; tagged via the pen)
    own = [sid for sid, s in ink._strokes.items()
           if s["pen"].get("by") == cid]
    if rng.random() < 0.4 or not own:
        ink.create_stroke({"w": rng.randrange(5), "by": cid})
        return "stroke"
    if rng.random() < 0.95:
        ink.append_point(rng.choice(own), {"x": rng.randrange(100)})
        return "point"
    ink.clear()
    return "clear"


def _fuzz_legacy_tree(rng, t, cid):
    from ..models.legacy_tree import (
        delete_,
        insert_tree,
        move,
        place_after,
        place_at_start,
        place_before,
        range_of,
        set_value,
    )

    view = t.view
    nodes = [n for n in view.nodes if n != "root"]
    roll = rng.random()
    if roll < 0.45 or not nodes:
        nid = f"n{cid}{rng.getrandbits(32):08x}"
        spec = [{"definition": "item", "identifier": nid,
                 "payload": rng.randrange(100)}]
        if nodes and rng.random() < 0.5:
            dest = rng.choice([place_before, place_after])(
                rng.choice(nodes))
        else:
            dest = place_at_start("root", f"t{rng.randrange(3)}")
        t.apply(insert_tree(spec, dest))
        return f"insert {nid}"
    target = rng.choice(nodes)
    rng_range = range_of(place_before(target), place_after(target))
    if roll < 0.65:
        t.apply(set_value(target, rng.randrange(100)))
        return f"set_value {target}"
    if roll < 0.85:
        t.apply(delete_(rng_range))
        return f"delete {target}"
    t.apply(move(rng_range,
                 place_at_start("root", f"t{rng.randrange(3)}")))
    return f"move {target}"


def _fuzz_json_ot(rng, j, cid):
    lst = j.get(["lst"])
    if lst is None:
        j.set(["lst"], [])
        return "init lst"
    roll = rng.random()
    if roll < 0.35:
        j.list_insert(["lst"], rng.randrange(len(lst) + 1),
                      _word(rng))
        return "li"
    if roll < 0.50 and lst:
        j.list_delete(["lst"], rng.randrange(len(lst)))
        return "ld"
    if roll < 0.70:
        j.set([f"k{rng.randrange(8)}"], rng.randrange(100))
        return "oi"
    if roll < 0.80:
        j.remove([f"k{rng.randrange(8)}"])
        return "od"
    key = f"num{rng.randrange(3)}"
    if j.get([key]) is None:
        j.set([key], 0)
        return "init num"
    j.add([key], rng.randrange(1, 9))
    return "na"


_FUZZ_POINT = {
    "typeid": "fuzz:pt-1.0.0",
    "properties": [
        {"id": "x", "typeid": "Float64"},
        {"id": "tag", "typeid": "String"},
    ],
}


def _fuzz_property_tree(rng, pt, cid):
    if pt.schemas.get(_FUZZ_POINT["typeid"]) is None:
        pt.schemas.register(_FUZZ_POINT)
    roll = rng.random()
    path = f"p{rng.randrange(6)}"
    if roll < 0.35:
        if pt.resolve(path) is None:
            pt.insert_property(
                path,
                rng.choice(["Int32", _FUZZ_POINT["typeid"]]))
            pt.commit()
            return f"insert {path}"
        return None
    if roll < 0.60:
        node = pt.resolve(path)
        if node is None:
            return None
        if node["typeid"] == "Int32":
            pt.set_value(path, rng.randrange(100))
        elif node["typeid"] == _FUZZ_POINT["typeid"]:
            pt.set_value(f"{path}.x", float(rng.randrange(100)))
        pt.commit()
        return f"modify {path}"
    if roll < 0.75:
        pt.remove_property(path)
        pt.commit()
        return f"remove {path}"
    # batched multi-edit commit (the squash path)
    if pt.resolve(path) is None:
        pt.insert_property(path, "Int32", rng.randrange(10))
    pt.set_value(path, rng.randrange(100))
    pt.commit()
    return f"squash-commit {path}"


ACTIONS: dict[str, Callable] = {
    "sharedmap": _fuzz_map,
    "shareddirectory": _fuzz_directory,
    "sharedcell": _fuzz_cell,
    "sharedcounter": _fuzz_counter,
    "sharedstring": _fuzz_string,
    "sharedmatrix": _fuzz_matrix,
    "sharedtree": _fuzz_tree,
    "consensusregistercollection": _fuzz_register,
    "ink": _fuzz_ink,
    "legacysharedtree": _fuzz_legacy_tree,
    "sharedjson": _fuzz_json_ot,
    "sharedpropertytree": _fuzz_property_tree,
}


# ----------------------------------------------------------------------

def run_dds_fuzz(cfg: DdsFuzzConfig) -> DdsFuzzReport:
    # stable per-type stream: Python's str hash is salted per process
    # and would break (channel_type, seed) reproducibility
    type_salt = zlib.crc32(cfg.channel_type.encode()) & 0xFFFF
    rng = random.Random((cfg.seed << 16) ^ type_salt)
    report = DdsFuzzReport(cfg.channel_type, cfg.seed)
    ids = [chr(ord("A") + i) for i in range(cfg.n_clients)]
    session = ContainerSession(ids)
    for cid in ids:
        session.runtime(cid).create_datastore("ds").create_channel(
            cfg.channel_type, "chan"
        )
    session.process_all()
    action = ACTIONS[cfg.channel_type]
    down: dict[str, int] = {}

    for step in range(cfg.n_steps):
        report.steps = step + 1
        for cid, when in list(down.items()):
            if step >= when:
                del down[cid]
                session.reconnect(cid)
                report.reconnects += 1
        roll = rng.random()
        if roll < cfg.p_reconnect_churn and len(down) < cfg.n_clients - 1:
            cid = rng.choice([c for c in ids if c not in down])
            session.flush(cid)
            session.disconnect(cid)
            down[cid] = step + cfg.reconnect_after
            report.trace.append(f"{step}: !disconnect {cid}")
            continue
        if roll < cfg.p_reconnect_churn + cfg.p_process_all:
            session.process_all()
            report.trace.append(f"{step}: process_all")
            continue
        if roll < (cfg.p_reconnect_churn + cfg.p_process_all
                   + cfg.p_process_some):
            session.flush()
            session.process_some(rng.randint(1, 6))
            report.trace.append(f"{step}: process_some")
            continue
        cid = rng.choice(ids)
        chan = session.runtime(cid).get_datastore("ds").get_channel("chan")
        desc = action(rng, chan, cid)
        if desc is not None:
            report.actions += 1
            report.trace.append(f"{step}: {cid} {desc}")

    for cid in list(down):
        session.reconnect(cid)
        report.reconnects += 1
    session.process_all()
    session.process_all()  # resubmitted pending ops
    session.assert_converged()
    return report
