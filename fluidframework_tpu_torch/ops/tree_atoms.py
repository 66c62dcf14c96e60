"""Tensor form of SharedTree sequence-field changesets.

The batched redesign of the reference's mark-list rebase
(packages/dds/tree/src/feature-libraries/sequence-field/rebase.ts:44,
core/rebase/rebaser.ts:138-170): a changeset becomes a fixed-width
array of ATOMS, every one expressed in the changeset's INPUT
coordinates (the mark-list invariant), so rebasing reduces to masked
position arithmetic — pairwise comparisons and row sums, no pointer
walk, no data-dependent control flow. Splits can never happen because
node-targeting marks are unit-granular by construction: a ``del n`` is
n single-node atoms, each of which independently shifts or mutes.

Atom kinds:
  NOP   padding
  INS   attach ``n`` nodes before input position ``pos`` (content
        stays host-side, keyed by the atom index — same payload rule
        as the merge kernel)
  DEL   detach the single node at ``pos``
  SET   value-set on the single node at ``pos``
  MOV   move the single node at ``pos`` to anchor position ``pos2``
        (the tensor form of changeset.move's paired detach+revive;
        delete-wins muting matches the scalar algebra)
``muted`` marks atoms whose target a rebase-over deleted (the scalar
algebra's tombstones); they ride along as zero-length anchors.

Device-inexpressible marks (unpaired rev, tomb inputs, nested
``fields``) raise ``ValueError`` — callers fall back to the scalar
path, the same eviction discipline the merge sidecar uses. MOV is
supported in both roles: in the changeset BEING REBASED (one atom
carries the del+rev pair) and in the rebased-OVER trunk (the kernel
models the over-move as a unit detach at ``pos`` plus a unit attach
at ``pos2`` — tree_kernel._rebase_one). ``allow_moves=False``
remains as a caller-chosen guard for paths that deliberately keep
trunk moves scalar (it raises so the fallback is loud, never a
silent semantic change).
"""
from __future__ import annotations

import copy
from typing import Any, NamedTuple

import numpy as np

# single source of truth for mark input-length: the algebra's in_len
# (a drift between encoder positions and the algebra would silently
# corrupt kernel-vs-scalar parity)
from ..models.tree.changeset import in_len as in_len_of
from ..models.tree.forest import Forest

ATOM_NOP = 0
ATOM_INS = 1
ATOM_DEL = 2
ATOM_SET = 3
ATOM_MOV = 4

DEFAULT_ATOMS = 64


class TreeAtoms(NamedTuple):
    """Batched changeset tensors, all [docs, atoms] int32."""

    kind: Any
    pos: Any
    n: Any      # INS width; DEL/SET/MOV are unit
    muted: Any
    pos2: Any   # MOV destination anchor (input coords); else 0

    @property
    def atoms(self) -> int:
        return self.kind.shape[-1]


def encode_changeset(marks: list, width: int = DEFAULT_ATOMS,
                     allow_moves: bool = True) -> tuple[dict, list]:
    """Mark list (one field) -> single-doc atom arrays + host content
    table (content[i] set for INS atoms, None otherwise).

    ``allow_moves=False`` is a caller-chosen guard for paths that
    keep trunk moves on the scalar path (the kernel itself models
    over-moves since the tree serving plane — see
    tree_kernel._rebase_one); it raises so the fallback stays loud."""
    kind = np.zeros(width, np.int32)
    pos = np.zeros(width, np.int32)
    n = np.zeros(width, np.int32)
    muted = np.zeros(width, np.int32)
    pos2 = np.zeros(width, np.int32)
    content: list = [None] * width
    a = 0
    p = 0

    def put(k, at, cnt, payload=None, mute=0, at2=0):
        nonlocal a
        if a >= width:
            raise ValueError(f"changeset exceeds {width} atoms")
        kind[a], pos[a], n[a], muted[a] = k, at, cnt, mute
        pos2[a] = at2
        content[a] = payload
        a += 1

    # first pass: input positions of paired move halves (del with a
    # did that a rev in the same list references)
    move_dsts: dict = {}
    q = 0
    for m in marks:
        if m["t"] == "rev":
            move_dsts.setdefault(
                (m["rev"], m["idx"]), []
            ).append((q, m["n"]))
        q += in_len_of(m)

    matched_revs = set()

    for m in marks:
        t = m["t"]
        if t == "skip":
            p += m["n"]
        elif t == "ins":
            put(ATOM_INS, p, len(m["content"]), list(m["content"]))
        elif t == "del":
            pair = move_dsts.get(tuple(m.get("did") or ()), None)
            if pair is not None and not allow_moves:
                raise ValueError(
                    "move in a rebased-over changeset: host path only"
                )
            if pair is not None and pair[0][1] == m["n"]:
                dst, _k = pair[0]
                matched_revs.add(tuple(m["did"]))
                for i in range(m["n"]):
                    put(ATOM_MOV, p + i, 1, at2=dst)
            else:
                for i in range(m["n"]):
                    put(ATOM_DEL, p + i, 1)
            p += m["n"]
        elif t == "mod":
            if m.get("fields"):
                raise ValueError("nested field changes: host path only")
            if m.get("value") is not None:
                put(ATOM_SET, p, 1, m["value"])
            # a valueless, fieldless mod is skip(1) (cs.normalize)
            p += 1
        elif t == "rev":
            if (m["rev"], m["idx"]) in move_dsts and "mods" not in m:
                continue  # the paired del emitted the MOV atoms
            raise ValueError("unpaired revive: host path only")
        else:  # tomb: repair-store machinery stays host-side
            raise ValueError(f"device-inexpressible mark {t!r}")
    # every rev we skipped must actually have been matched by its del
    for key, entries in move_dsts.items():
        if key not in matched_revs:
            raise ValueError("unpaired revive: host path only")
    return (
        {"kind": kind, "pos": pos, "n": n, "muted": muted,
         "pos2": pos2},
        content,
    )


def stack_changesets(encoded: list[dict]) -> TreeAtoms:
    """List of single-doc atom dicts -> [docs, atoms] TreeAtoms."""
    return TreeAtoms(
        kind=np.stack([e["kind"] for e in encoded]),
        pos=np.stack([e["pos"] for e in encoded]),
        n=np.stack([e["n"] for e in encoded]),
        muted=np.stack([e["muted"] for e in encoded]),
        pos2=np.stack([e["pos2"] for e in encoded]),
    )


def atoms_to_marks(atoms_np: dict, content: list) -> list:
    """Decode one doc's (rebased) atoms back into a normalized mark
    list in the post-rebase input coordinates. Muted atoms drop (their
    effect is nil; unmuting via revive is host-path work). MOV atoms
    decode back into paired del+rev marks (synthetic identities)."""
    rows = []
    for i in range(len(atoms_np["kind"])):
        k = int(atoms_np["kind"][i])
        if k == ATOM_NOP or int(atoms_np["muted"][i]):
            continue
        rows.append((int(atoms_np["pos"][i]), k != ATOM_INS, i, k))
        if k == ATOM_MOV:
            # destination half: an attach row at pos2
            rows.append((int(atoms_np["pos2"][i]), False, i, -k))
    rows.sort(key=lambda r: (r[0], r[1], r[2]))
    marks: list = []
    cursor = 0
    for at, _node_op, i, k in rows:
        if at > cursor:
            marks.append({"t": "skip", "n": at - cursor})
            cursor = at
        if k == ATOM_INS:
            marks.append({"t": "ins",
                          "content": list(content[i] or [])})
        elif k == -ATOM_MOV:
            marks.append({"t": "rev", "n": 1,
                          "rev": "__mov__", "idx": i})
        elif k == ATOM_MOV:
            marks.append({"t": "del", "n": 1,
                          "did": ["__mov__", i]})
            cursor += 1
        elif k == ATOM_DEL:
            if (marks and marks[-1]["t"] == "del"):
                marks[-1]["n"] += 1
            else:
                marks.append({"t": "del", "n": 1})
            cursor += 1
        else:  # SET
            value = content[i]
            marks.append({"t": "mod", "value": value})
            cursor += 1
    return marks


def apply_atoms(seq: list, atoms_np: dict, content: list) -> list:
    """Apply one doc's atoms to a node list (positions are input
    coordinates of ``seq``) — the host applier for parity checks and
    forest updates. Applies through a throwaway Forest so decoded
    move pairs (del+rev) resolve via the same-changeset repair
    pre-pass."""
    f = Forest({"root": copy.deepcopy(seq)})
    f.apply({"root": atoms_to_marks(atoms_np, content)}, "__atoms__")
    return f.content()["root"]
