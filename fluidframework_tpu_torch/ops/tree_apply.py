"""Batched forest apply — the tree serving plane's device half
(ROADMAP B9), in plain torch, with the host half (encode and pack)
copied from the reference as numpy.

Forest state lives on the device as SoA tensors ``[docs, slots]`` and
one dispatch applies a whole window of sequenced tree changesets
across every document at once. Per window step (one commit per doc):

1. **trunk-suffix rebase** — the incoming commit's atoms rebase over
   the per-doc RING of the last ``TRUNK_RING`` already-rebased trunk
   commits (``tree_kernel.rebase_atoms``, one over-step per ring
   entry, every document at once). Ring entries outside the commit's
   concurrency window — sequenced at-or-before its ref, or from the
   commit's own session — are masked by muting their atoms (a fully
   muted ``over`` is a rebase no-op). Skipping own-session trunk
   commits is the batched form of the EditManager's inverse/trunk/
   rebased sandwich (editManager.ts:223).
2. **forest apply** — the rebased atoms become attach/detach/set rows
   over the dense slot table and apply via one of two executor routes
   (``TREE_EXECUTOR_ROUTES``): ``atom``, a loop over the sorted rows
   (every row is a masked shift of the slot arrays), and ``macro``, a
   single stable-sort merge of surviving slots and attach rows. Both
   are bit-identical by construction.

State model: ``content[d, s]`` is the host content-table index of the
node in slot ``s`` (-1 empty); live nodes occupy slots ``0..count-1``
in sequence order, so an atom's input position IS its slot index.
``value[d, s]`` is the host value-table index of the node's latest SET
(-1: the birth content stands). Node payloads never reach the device:
INS/SET atoms carry host-table indices in the program's ``payload``
plane, and MOV payloads are read from the source slot before any row
applies.

Overflow: a step whose attaches could not all fit (``count + attaches
> slots``) PARKS the doc — state, ring and all later steps of the
window pass through untouched and ``overflow`` is flagged; the
sidecar re-applies the window from the pre-dispatch snapshot at the
next capacity rung, identical on both routes.

Loops run a host-counted number of times (``window_extent``): the
window stops after its deepest real step, since padded steps (seq 0,
all-NOP atoms) change nothing on any document, and the ``atom`` route
walks at most as many rows as the step's busiest document has. Nothing
in the device half reads a device value on the host.
"""
from __future__ import annotations

import copy
import functools
from typing import Any, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .bucket_ladder import BucketLadder
from .event_graph import validate_executor
from .tree_atoms import (
    ATOM_DEL,
    ATOM_INS,
    ATOM_MOV,
    ATOM_NOP,
    ATOM_SET,
    DEFAULT_ATOMS,
    TreeAtoms,
    encode_changeset,
)
from .tree_kernel import rebase_atoms

# The tree serving plane's executor routes, validated through the same
# gate as the merge plane's (event_graph.validate_executor)
TREE_EXECUTOR_ROUTES = ("atom", "macro")

# Trunk-rebase ring depth: how many already-rebased trunk commits each
# doc keeps on the device for concurrency-window rebasing. A commit
# whose ref predates the ring's oldest entry is host-path (the sidecar
# evicts — ring_safe()).
TRUNK_RING = 16

_SORT_BIG = 1 << 30


class TreeTable(NamedTuple):
    """Device forest state, docs-major SoA (int32 throughout)."""

    content: Any    # [docs, slots] host content-table index, -1 empty
    value: Any      # [docs, slots] host value-table index, -1 unset
    count: Any      # [docs] live node count
    overflow: Any   # [docs] 1 after a parked (overflowed) step
    ring: TreeAtoms  # [docs, ring, atoms] last rebased trunk commits
    ring_seq: Any   # [docs, ring] commit seq (0 = empty entry)
    ring_session: Any  # [docs, ring] session ordinal of the commit

    @property
    def docs(self) -> int:
        return self.content.shape[0]

    @property
    def slots(self) -> int:
        return self.content.shape[1]


class TreeProgram(NamedTuple):
    """One packed dispatch window, window-major for the outer loop."""

    atoms: TreeAtoms  # [window, docs, atoms]
    payload: Any      # [window, docs, atoms] host-table index or -1
    seq: Any          # [window, docs] commit seq (0 = padding)
    ref: Any          # [window, docs] commit ref seq
    session: Any      # [window, docs] session ordinal

    @property
    def window(self) -> int:
        return self.seq.shape[0]


def make_tree_table(docs: int, slots: int,
                    device: torch.device | str = "cuda",
                    ring: int = TRUNK_RING,
                    atoms: int = DEFAULT_ATOMS) -> TreeTable:
    """Fresh all-empty forest slab on ``device`` (the card unless the
    caller asks for the CPU)."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_tree_table needs a CUDA device; pass "
                           "device='cpu' for a table on the CPU")

    def z(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=device)

    return TreeTable(
        content=torch.full((docs, slots), -1, dtype=torch.int32,
                           device=device),
        value=torch.full((docs, slots), -1, dtype=torch.int32,
                         device=device),
        count=z(docs),
        overflow=z(docs),
        ring=TreeAtoms(*(z(docs, ring, atoms) for _ in TreeAtoms._fields)),
        ring_seq=z(docs, ring),
        ring_session=z(docs, ring),
    )


def pad_tree_capacity(table: TreeTable, new_slots: int) -> TreeTable:
    """Widen the slab to ``new_slots``; the new slots are empty (-1)."""
    pad = new_slots - table.slots

    def fill(a):
        return torch.cat([a, a.new_full((a.shape[0], pad), -1)], dim=1)

    return table._replace(content=fill(table.content),
                          value=fill(table.value))


# ======================================================================
# host half (numpy)


def ring_safe(history: list, ref: int, ring: int = TRUNK_RING) -> bool:
    """True iff every trunk commit a ref-``ref`` commit must rebase
    over is still inside a depth-``ring`` ring. ``history`` is the
    doc's packed-commit seqs, oldest first, trimmed to the last
    ``ring`` entries by the caller: safe when the ring is not yet full
    or when the oldest retained seq is at-or-under the ref (every
    commit older than the ring's head sequenced at-or-before it)."""
    if len(history) < ring:
        return True
    return ref >= history[0]


def noop_tree_commit(width: int = DEFAULT_ATOMS) -> dict:
    """The padding commit: all-NOP atoms, seq 0 (never pushed to the
    ring, rebases to itself, applies nothing)."""
    z = functools.partial(np.zeros, dtype=np.int32)
    return {"kind": z(width), "pos": z(width), "n": z(width),
            "muted": z(width), "pos2": z(width),
            "payload": np.full(width, -1, np.int32),
            "seq": 0, "ref": 0, "session": 0}


def encode_tree_commit(marks: list, content_table: list,
                       value_table: list, *, seq: int, ref: int,
                       session: int,
                       width: int = DEFAULT_ATOMS) -> dict:
    """Encode one sequenced changeset for the serving plane: the
    tree_atoms encoding re-granulated to UNIT inserts (each inserted
    node gets its own content-table row, so moves and decodes never
    split a width-n payload) with host-table payload indices
    assigned. Appends to ``content_table``/``value_table`` (append-
    only; a raised ``ValueError`` may leave unused tail entries —
    harmless, indices are only reachable from returned atoms).
    Raises ``ValueError`` for device-inexpressible changesets — the
    caller evicts to the scalar path."""
    enc, payloads = encode_changeset(marks, width=width)
    z = functools.partial(np.zeros, dtype=np.int32)
    kind, pos, n = z(width), z(width), z(width)
    muted, pos2 = z(width), z(width)
    payload = np.full(width, -1, np.int32)
    a = 0

    def put(k, at, mute, at2, pay):
        nonlocal a
        if a >= width:
            raise ValueError(f"changeset exceeds {width} atoms")
        kind[a], pos[a], n[a] = k, at, 1
        muted[a], pos2[a], payload[a] = mute, at2, pay
        a += 1

    for i in range(width):
        k = int(enc["kind"][i])
        if k == ATOM_NOP:
            continue
        if k == ATOM_INS:
            for node in payloads[i] or []:
                put(ATOM_INS, int(enc["pos"][i]),
                    int(enc["muted"][i]), 0, len(content_table))
                content_table.append(copy.deepcopy(node))
        elif k == ATOM_SET:
            put(k, int(enc["pos"][i]), int(enc["muted"][i]), 0,
                len(value_table))
            value_table.append(copy.deepcopy(payloads[i]))
        else:  # DEL / MOV
            put(k, int(enc["pos"][i]), int(enc["muted"][i]),
                int(enc["pos2"][i]), -1)
    return {"kind": kind, "pos": pos, "n": n, "muted": muted,
            "pos2": pos2, "payload": payload,
            "seq": seq, "ref": ref, "session": session}


def pack_tree_window(docs: int, queued: dict,
                     ladder: Optional[BucketLadder] = None,
                     bucket_floor: Optional[int] = None,
                     width: int = DEFAULT_ATOMS) -> TreeProgram:
    """Pack per-doc commit lists (``{doc_row: [encode_tree_commit
    dicts]}``) into one window-major numpy TreeProgram, window depth
    bucketed via the BucketLadder."""
    lad = ladder or BucketLadder()
    if bucket_floor is not None:
        lad = BucketLadder(bucket_floor, lad.max_bucket)
    deepest = max((len(v) for v in queued.values()), default=0)
    window = lad.window_bucket(max(deepest, 1))
    z = functools.partial(np.zeros, dtype=np.int32)
    kind = z((window, docs, width))
    pos = z((window, docs, width))
    n = z((window, docs, width))
    muted = z((window, docs, width))
    pos2 = z((window, docs, width))
    payload = np.full((window, docs, width), -1, np.int32)
    seq, ref, session = z((window, docs)), z((window, docs)), \
        z((window, docs))
    for d, commits in queued.items():
        for w, c in enumerate(commits):
            kind[w, d] = c["kind"]
            pos[w, d] = c["pos"]
            n[w, d] = c["n"]
            muted[w, d] = c["muted"]
            pos2[w, d] = c["pos2"]
            payload[w, d] = c["payload"]
            seq[w, d] = c["seq"]
            ref[w, d] = c["ref"]
            session[w, d] = c["session"]
    return TreeProgram(
        atoms=TreeAtoms(kind=kind, pos=pos, n=n, muted=muted,
                        pos2=pos2),
        payload=payload, seq=seq, ref=ref, session=session,
    )


def window_extent(program: TreeProgram) -> tuple[int, list[int]]:
    """The host-int trip counts of a numpy program's device loops:
    ``steps``, the window depth after which every step is padding, and
    ``rows[w]``, the most forest-apply rows any document has at step
    ``w`` (each non-NOP atom gives one row, a MOV two: its detach and
    its attach; a rebase can only mute rows away)."""
    real = np.nonzero((program.seq > 0).any(axis=1))[0]
    steps = int(real[-1]) + 1 if real.size else 0
    kind = program.atoms.kind[:steps]
    rows = ((kind != ATOM_NOP).sum(axis=2)
            + (kind == ATOM_MOV).sum(axis=2)).max(axis=1, initial=0)
    return steps, [int(r) for r in rows]


def decode_tree_row(content_row, value_row, count: int,
                    content_table: list, value_table: list) -> list:
    """Host read half: one settled doc row -> its node list. SET
    payloads are the algebra's ``{"new": v, "old": u}`` value dicts;
    the latest one overrides the birth content's value."""
    out = []
    for s in range(int(count)):
        node = copy.deepcopy(content_table[int(content_row[s])])
        v = int(value_row[s])
        if v >= 0:
            node["value"] = value_table[v]["new"]
        out.append(node)
    return out


# ======================================================================
# device half (torch, every document at once)


def _live_masks(atoms: TreeAtoms):
    live = atoms.muted == 0
    is_ins = (atoms.kind == ATOM_INS) & live
    is_mov = (atoms.kind == ATOM_MOV) & live
    is_det = ((atoms.kind == ATOM_DEL) | (atoms.kind == ATOM_MOV)) & live
    is_set = (atoms.kind == ATOM_SET) & live
    return is_ins, is_mov, is_det, is_set


def apply_atom_route(content, value, count, atoms: TreeAtoms, payload,
                      mov_content, mov_value, rows: int):
    """Row-loop executor: the changeset's rows in (position,
    attach-before-node-op, atom-index) order — the exact order
    ``tree_atoms.atoms_to_marks`` decodes — tracking each document's
    running attach-detach delta so every row applies at its effective
    (current-array) index as a masked shift. ``rows`` (a host int)
    bounds the loop: past a document's real rows every row is padding
    (kind 0) and changes nothing."""
    docs, slots_n = content.shape
    a_width = atoms.kind.shape[1]
    is_ins, is_mov, is_det, is_set = _live_masks(atoms)
    aidx = torch.arange(a_width, dtype=torch.int32, device=content.device)

    node_kind = torch.where(is_det, 2, torch.where(is_set, 3, 0)) \
        .to(torch.int32)
    att_kind = (is_ins | is_mov).to(torch.int32)
    att_at = torch.where(is_mov, atoms.pos2, atoms.pos)
    node_key = torch.where(node_kind > 0,
                           (atoms.pos * 2 + 1) * a_width + aidx, _SORT_BIG)
    att_key = torch.where(att_kind > 0, (att_at * 2) * a_width + aidx,
                          _SORT_BIG)

    order = torch.sort(torch.cat([node_key, att_key], dim=1), dim=1,
                       stable=True).indices[:, :rows]
    minus1 = torch.full_like(payload, -1)
    rkind, rat, rpc, rpv = (
        torch.gather(torch.cat(pair, dim=1), 1, order)
        for pair in ((node_kind, att_kind), (atoms.pos, att_at),
                     (minus1, torch.where(is_ins, payload, mov_content)),
                     (torch.where(is_set, payload, -1),
                      torch.where(is_ins, -1, mov_value))))

    slot = torch.arange(slots_n, dtype=torch.int32,
                        device=content.device).unsqueeze(0)
    last = slot == slots_n - 1
    c, v, cnt = content, value, count
    delta = torch.zeros_like(count)
    for r in range(rows):
        k, pc, pv = rkind[:, r:r + 1], rpc[:, r:r + 1], rpv[:, r:r + 1]
        eff = rat[:, r:r + 1] + delta.unsqueeze(1)
        before, at = slot < eff, slot == eff
        att_c = torch.where(before, c, torch.where(at, pc, c.roll(1, 1)))
        att_v = torch.where(before, v, torch.where(at, pv, v.roll(1, 1)))
        det_c = torch.where(before, c,
                            torch.where(last, -1, c.roll(-1, 1)))
        det_v = torch.where(before, v,
                            torch.where(last, -1, v.roll(-1, 1)))
        is_a, is_d, is_s = k == 1, k == 2, k == 3
        c = torch.where(is_a, att_c, torch.where(is_d, det_c, c))
        nv = torch.where(is_a, att_v, torch.where(is_d, det_v, v))
        v = torch.where(is_s & at, pv, nv)
        step = (is_a.to(torch.int32) - is_d.to(torch.int32)).squeeze(1)
        cnt = cnt + step
        delta = delta + step
    return c, v, cnt


def apply_macro_route(content, value, count, atoms: TreeAtoms, payload,
                       mov_content, mov_value, rows: int):
    """Macro-step executor: value registers scatter in one LWW
    pre-pass on input coordinates, then ONE stable sort merges the
    surviving slots with the attach rows (attaches keyed just before
    the node at their anchor, ordered among themselves by atom
    index) — no sequential row walk. ``rows`` is unused (the route
    has no row loop)."""
    slots_n = content.shape[1]
    a_width = atoms.kind.shape[1]
    is_ins, is_mov, is_det, is_set = _live_masks(atoms)
    dev = content.device
    slot = torch.arange(slots_n, dtype=torch.int32, device=dev)
    aidx = torch.arange(a_width, dtype=torch.int32, device=dev)

    # value-register LWW pre-pass (last atom wins): [docs, slots, atoms]
    at_slot = atoms.pos.unsqueeze(1) == slot.view(1, -1, 1)
    set_sel = is_set.unsqueeze(1) & at_slot
    chosen = torch.where(set_sel, aidx + 1, 0).argmax(dim=2)
    value = torch.where(set_sel.any(dim=2),
                        torch.gather(payload, 1, chosen), value)

    detached = (is_det.unsqueeze(1) & at_slot).any(dim=2)
    alive = (slot < count.unsqueeze(1)) & ~detached
    old_key = torch.where(alive, slot * (a_width + 1) + a_width,
                          _SORT_BIG)

    att = is_ins | is_mov
    att_at = torch.where(is_mov, atoms.pos2, atoms.pos)
    att_key = torch.where(att, att_at * (a_width + 1) + aidx, _SORT_BIG)

    key, order = torch.sort(torch.cat([old_key, att_key], dim=1), dim=1,
                            stable=True)
    key, order = key[:, :slots_n], order[:, :slots_n]
    live_out = key < _SORT_BIG
    cand_c = torch.cat([content, torch.where(is_ins, payload, mov_content)],
                       dim=1)
    cand_v = torch.cat([value, torch.where(is_ins, -1, mov_value)], dim=1)
    nc = torch.where(live_out, torch.gather(cand_c, 1, order), -1)
    nv = torch.where(live_out, torch.gather(cand_v, 1, order), -1)
    ncnt = count + att.sum(dim=1, dtype=torch.int32) \
        - is_det.sum(dim=1, dtype=torch.int32)
    return nc, nv, ncnt


_ROUTES = {"atom": apply_atom_route, "macro": apply_macro_route}


def _ring_step(ring, new, push):
    """Push ``new`` ([docs, ...]) as the newest ring entry of the docs
    where ``push``; the oldest entry drops out."""
    shifted = torch.cat([ring[:, 1:], new.unsqueeze(1)], dim=1)
    return torch.where(push.view(-1, *([1] * (ring.dim() - 1))),
                       shifted, ring)


def rebase_over_ring(tab: TreeTable, atoms: TreeAtoms, seq, ref,
                     session) -> TreeAtoms:
    """One window step's trunk rebase: each document's incoming atoms
    over its ring, oldest entry first. Entries outside the commit's
    concurrency window (sequenced at-or-before ``ref``, from the
    commit's own ``session``, or empty) are muted whole, which makes
    their over-step a no-op."""
    active = (tab.ring_seq > ref.unsqueeze(1)) \
        & (tab.ring_seq < seq.unsqueeze(1)) \
        & (tab.ring_session != session.unsqueeze(1)) & (tab.ring_seq > 0)
    for r in range(tab.ring_seq.shape[1]):
        over = TreeAtoms(*(f[:, r] for f in tab.ring))
        over = over._replace(muted=torch.where(
            active[:, r:r + 1], over.muted, 1))
        atoms = rebase_atoms(atoms, over)
    return atoms


def move_payloads(tab: TreeTable, rebased: TreeAtoms):
    """Content and value indices each live MOV atom carries, read from
    its source slot before any row applies (-1 for other atoms)."""
    _, is_mov, _, _ = _live_masks(rebased)
    src = rebased.pos.clamp(0, tab.slots - 1).long()
    return (torch.where(is_mov, torch.gather(tab.content, 1, src), -1),
            torch.where(is_mov, torch.gather(tab.value, 1, src), -1))


def _tree_step(route: str, tab: TreeTable, atoms: TreeAtoms, payload,
               seq, ref, session, rows: int) -> TreeTable:
    """One window step for every document: ring rebase -> forest apply
    -> ring push. Parked docs (overflow) pass everything through."""
    slots_n = tab.slots
    rebased = rebase_over_ring(tab, atoms, seq, ref, session)

    is_ins, is_mov, _, _ = _live_masks(rebased)
    att_n = is_ins.sum(dim=1, dtype=torch.int32) \
        + is_mov.sum(dim=1, dtype=torch.int32)
    # conservative park bound: attaches may all land before any detach
    # frees a slot, so the transient peak is count + attaches
    overflowed = tab.count + att_n > slots_n
    park = (tab.overflow > 0) | overflowed

    mov_content, mov_value = move_payloads(tab, rebased)
    nc, nv, ncnt = _ROUTES[route](tab.content, tab.value, tab.count,
                                  rebased, payload, mov_content,
                                  mov_value, rows)

    keep = park.unsqueeze(1)
    push = (seq > 0) & ~park
    return TreeTable(
        content=torch.where(keep, tab.content, nc),
        value=torch.where(keep, tab.value, nv),
        count=torch.where(park, tab.count, ncnt),
        overflow=torch.maximum(tab.overflow, overflowed.to(torch.int32)),
        ring=TreeAtoms(*(_ring_step(old, new, push)
                         for old, new in zip(tab.ring, rebased))),
        ring_seq=_ring_step(tab.ring_seq, seq, push),
        ring_session=_ring_step(tab.ring_session, session, push),
    )


def apply_tree_window(table: TreeTable, program: TreeProgram,
                      route: str = "atom", steps: Optional[int] = None,
                      rows: Optional[Sequence[int]] = None) -> TreeTable:
    """Apply one packed window (torch tensors on the table's device) on
    the chosen executor route; returns a fresh table. ``steps`` and
    ``rows`` are the host-int trip counts of ``window_extent`` (None:
    every step of the bucket, every row of the atom width — the
    reference's full program)."""
    validate_executor(route, "route", routes=TREE_EXECUTOR_ROUTES)
    if steps is None:
        steps = program.window
    if rows is None:
        rows = [2 * program.atoms.kind.shape[-1]] * steps
    tab = table
    for w in range(steps):
        tab = _tree_step(route, tab,
                         TreeAtoms(*(f[w] for f in program.atoms)),
                         program.payload[w], program.seq[w],
                         program.ref[w], program.session[w], rows[w])
    return tab
