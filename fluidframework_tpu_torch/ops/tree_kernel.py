"""Batched SharedTree rebase (ROADMAP B8), in plain torch.

Vectorized form of the scalar mark-list rebase
(models/tree/changeset.py:_rebase_marks; reference semantics:
packages/dds/tree/src/feature-libraries/sequence-field/rebase.ts:44
under the ChangeRebaser laws of core/rebase/rebaser.ts:138-170).

Because every atom of a changeset is expressed in the changeset's
input coordinates (tree_atoms.py), ``rebase(C, over=O)`` for the
sequenced path is pure position arithmetic per C-atom:

  ins_shift  = sum of O-insert widths that land at-or-before the
               atom's node (strictly-before for C attaches: the
               later-sequenced change keeps the left slot — the
               merge-tree breakTie convention, mergeTree.ts:1705)
  del_shift  = number of O-deleted nodes strictly before the atom
  muted      = O deleted the atom's target node

  pos' = pos + ins_shift - del_shift

Every document's ``[A, A]`` pairwise masks and row sums run at once
over the leading document axis. Rebasing over a trunk suffix of K
changesets is a Python loop over K (the ChangeRebaser law
``rebase(a, compose(b, c)) == rebase(rebase(a, b), c)`` makes the
sequential form exact). Sums are taken in int32, as the reference's
``jnp.sum`` of int32 stays int32 (``torch.sum`` would give int64).
"""
from __future__ import annotations

import torch

from .tree_atoms import ATOM_DEL, ATOM_INS, ATOM_MOV, ATOM_SET, TreeAtoms


def _count(mask: torch.Tensor) -> torch.Tensor:
    """Row count of a ``[..., A, A]`` mask, int32."""
    return mask.sum(dim=-1, dtype=torch.int32)


def rebase_atoms(c: TreeAtoms, o: TreeAtoms) -> TreeAtoms:
    """Rebase each document's changeset atoms ``c`` over its ``over``
    atoms ``o`` (shared input coordinates); every field ``[docs, A]``
    int32. MOV atoms in ``c`` carry a node target (pos = source) AND an
    attach anchor (pos2 = destination). MOV atoms in ``o`` contribute
    BOTH halves of the scalar del+rev pair: a unit detach at ``o.pos``
    (mutes C atoms targeting the moved node and collapses later
    positions left) and a unit attach at ``o.pos2`` (shifting positions
    at-or-after the destination)."""
    live_o = o.muted == 0
    o_ins = ((o.kind == ATOM_INS) & live_o).unsqueeze(-2)   # [D, 1, A]
    o_mov = ((o.kind == ATOM_MOV) & live_o).unsqueeze(-2)
    # the detach half of an over-move acts exactly like a unit delete
    o_det = ((o.kind == ATOM_DEL) & live_o).unsqueeze(-2) | o_mov
    o_n = o.n.unsqueeze(-2)

    cpos = c.pos.unsqueeze(-1)      # [D, A, 1]
    opos = o.pos.unsqueeze(-2)      # [D, 1, A]
    odst = o.pos2.unsqueeze(-2)     # [D, 1, A] over-move attach anchors
    node_target = (
        (c.kind == ATOM_DEL) | (c.kind == ATOM_SET) | (c.kind == ATOM_MOV)
    ) & (c.muted == 0)
    target = node_target.unsqueeze(-1)

    # O-attach widths shifting each C atom: inserts (width n at pos)
    # and over-move reattaches (width 1 at pos2). Node targets shift
    # when the attach lands at-or-before their node; attaches/anchors
    # only for strictly-before (tied position: later-sequenced C keeps
    # the left slot).
    strictly_before = opos < cpos
    ins_applies = torch.where(target, opos <= cpos, strictly_before) & o_ins
    mov_att_applies = torch.where(target, odst <= cpos, odst < cpos) & o_mov
    ins_shift = torch.where(ins_applies, o_n, 0).sum(
        dim=-1, dtype=torch.int32) + _count(mov_att_applies)

    # O unit-detaches strictly before each atom collapse positions left
    del_shift = _count(o_det & strictly_before)

    # target node detached by O -> mute (the scalar algebra's
    # tombstone; for C-MOV this is delete-wins: one atom is both
    # halves, so muting it kills detach and reattach together)
    hit = (o_det & (opos == cpos)).any(dim=-1)
    muted = torch.where(node_target & hit, 1, c.muted)

    pos = torch.where(c.kind == 0, c.pos, c.pos + ins_shift - del_shift)

    # the MOV destination anchor rebases like an attach (strictly-
    # before attaches shift it; earlier detaches collapse it left)
    cdst = c.pos2.unsqueeze(-1)
    before_dst = opos < cdst
    dst_ins_shift = torch.where(before_dst & o_ins, o_n, 0).sum(
        dim=-1, dtype=torch.int32) + _count((odst < cdst) & o_mov)
    dst_del_shift = _count(o_det & before_dst)
    pos2 = torch.where(c.kind == ATOM_MOV,
                       c.pos2 + dst_ins_shift - dst_del_shift, c.pos2)
    return TreeAtoms(kind=c.kind, pos=pos, n=c.n, muted=muted, pos2=pos2)


def rebase_over_trunk(c: TreeAtoms, trunk: TreeAtoms) -> TreeAtoms:
    """Rebase each document's changeset over its trunk suffix:
    ``trunk`` fields are ``[docs, K, A]``; the K axis runs in order
    (exact by the compose law), documents at once."""
    for k in range(trunk.kind.shape[1]):
        c = rebase_atoms(c, TreeAtoms(*(f[:, k] for f in trunk)))
    return c
