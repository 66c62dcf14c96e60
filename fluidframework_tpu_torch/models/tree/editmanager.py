"""EditManager: trunk + per-session branch bookkeeping for SharedTree.

Reference semantics: packages/dds/tree/src/core/edit-manager/
editManager.ts:30 — a trunk of sequenced commits (each rebased onto its
predecessor), a branch per peer session holding that peer's in-flight
changes in original form, and the local session's unsequenced changes
kept rebased against the trunk tip:

- ``addSequencedChange`` (:142): own commits shift from localChanges to
  the trunk verbatim (:155-176); peer commits are rebased from their
  branch to the trunk (``rebaseChangeFromBranchToTrunk`` :223) and the
  local branch is rebased over the result (``rebaseLocalBranch`` :241,
  the inverse/trunk/rebased sandwich).
- ``addLocalChange`` (:208), ``advanceMinimumSequenceNumber`` (:71)
  evicting trunk commits below the collab window.

TPU-native re-design: instead of threading incremental deltas into a
mutable forest (which forces repair-data plumbing through composed
changesets), the manager keeps a *base forest* at the trunk eviction
point and recomputes the current forest by replaying trunk + local
changes. The collab window bounds the replay; the hot batched path
(thousands of docs, totally ordered) runs in the tree kernel instead,
where no sandwich rebasing is needed at all.
"""
from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Any, Optional

from . import changeset as cs
from .anchors import AnchorSet
from .changeset import FieldChanges
from .forest import Forest


@dataclass
class Commit:
    """editManager.ts Commit<TChangeset>."""

    session_id: str
    seq: int
    ref_seq: int
    changes: FieldChanges


@dataclass
class _Branch:
    """A peer session's in-flight commits, in original (unrebased) form,
    based on trunk state at ``ref_seq``."""

    local_changes: list[Commit] = dc_field(default_factory=list)
    ref_seq: int = 0
    is_divergent: bool = False


class EditManager:
    """Rebases every arriving commit into a convergent trunk."""

    def __init__(self, session_id: str, base: Optional[Forest] = None):
        self.session_id = session_id
        self.trunk: list[Commit] = []
        self.branches: dict[str, _Branch] = {}
        # (change, local_revision_tag) pairs, rebased to the trunk tip
        self.local_changes: list[tuple[FieldChanges, Any]] = []
        self._next_local_rev = -1
        self.min_seq = 0
        # forest state at the trunk eviction point (all evicted commits
        # applied); current state = base + trunk + local_changes replay
        self.base_forest = base.clone() if base else Forest()
        self._current: Optional[Forest] = None
        # anchors rebase over exactly the deltas the VIEW experiences
        # (core/tree/anchorSet.ts)
        self.anchors = AnchorSet()

    # ------------------------------------------------------------------
    # state

    def forest(self) -> Forest:
        """Current state: base + trunk + local changes."""
        if self._current is None:
            f = self.base_forest.clone()
            for c in self.trunk:
                f.apply(c.changes, c.seq)
            for change, tag in self.local_changes:
                f.apply(change, tag)
            self._current = f
        return self._current

    # ------------------------------------------------------------------
    # edits

    def add_local_change(self, change: FieldChanges) -> Any:
        """editManager.ts:208 — record an unsequenced local change;
        returns its temporary (negative) revision tag. Freshly authored
        marks get birth identities here (``changeset.stamp``) so their
        dels/inserts stay identifiable across rebasing and the wire."""
        tag = self._next_local_rev
        self._next_local_rev -= 1
        cs.stamp(change, f"{self.session_id}:{-tag}")
        self.local_changes.append((change, tag))
        if self._current is not None:
            self._current.apply(change, tag)
        self.anchors.apply(change)
        return tag

    def add_sequenced_change(self, commit: Commit,
                             is_local: Optional[bool] = None) -> None:
        """editManager.ts:142. ``is_local`` overrides the session-id
        comparison (the runtime knows; client ids change on reconnect)."""
        if self.trunk and commit.seq <= self.trunk[-1].seq:
            raise ValueError(
                f"out-of-order sequenced change {commit.seq} after "
                f"{self.trunk[-1].seq}")
        if is_local is None:
            is_local = commit.session_id == self.session_id
        if is_local:
            # Our own op round-tripped: its rebased form is the head of
            # local_changes; move it to the trunk (editManager.ts:155).
            if not self.local_changes:
                raise ValueError("sequenced local edit with no local change")
            change, _tag = self.local_changes.pop(0)
            self.trunk.append(Commit(commit.session_id, commit.seq,
                                     commit.ref_seq, change))
            # state unchanged, but re-tag the replay so repair data is
            # captured under the final revision next time
            self._current = None
            return

        branch = self._get_or_create_branch(commit.session_id,
                                            commit.ref_seq)
        self._update_branch(branch, commit.ref_seq)
        rebased = self._rebase_branch_commit_to_trunk(commit, branch)
        self._add_commit_to_branch(branch, commit)
        self.trunk.append(Commit(commit.session_id, commit.seq,
                                 commit.ref_seq, rebased))
        old_locals = list(self.local_changes)
        self._rebase_local_branch(rebased, commit.seq)
        # anchor delta = the view's sandwich: retract old locals,
        # apply the rebased peer commit, replay the new locals
        for change, tag in reversed(old_locals):
            self.anchors.apply(cs.invert(change, tag))
        self.anchors.apply(rebased)
        for change, _tag in self.local_changes:
            self.anchors.apply(change)
        self._current = None

    def squash_local(self, tags: list) -> tuple[FieldChanges, Any]:
        """Replace the (contiguous, trailing) local changes with the
        given tags by ONE composed change — transaction commit
        (core/transaction: a transaction's edits squash to a single
        commit). Returns (composed_change, new_tag). The composed form
        uses the CURRENT (rebased) shapes, so peer commits landing
        mid-transaction are already accounted for."""
        tagset = set(tags)
        items = [(c, t) for c, t in self.local_changes if t in tagset]
        keep = [(c, t) for c, t in self.local_changes
                if t not in tagset]
        assert keep + items == self.local_changes, (
            "transaction changes must be the trailing local changes"
        )
        composed = cs.compose([c for c, _ in items])
        tag = self._next_local_rev
        self._next_local_rev -= 1
        self.local_changes = keep + [(composed, tag)]
        # state is unchanged (compose law) but replay tags differ
        self._current = None
        return composed, tag

    def drop_local(self, tags: list) -> None:
        """Remove local changes by tag — transaction abort. Repair
        data makes the rollback exact: the view is recomputed without
        the dropped changes (transaction + forestRepairDataStore)."""
        tagset = set(tags)
        dropped = [(c, t) for c, t in self.local_changes
                   if t in tagset]
        self.local_changes = [
            (c, t) for c, t in self.local_changes if t not in tagset
        ]
        for change, tag in reversed(dropped):
            self.anchors.apply(cs.invert(change, tag))
        self._current = None

    def advance_minimum_sequence_number(self, min_seq: int) -> None:
        """editManager.ts:71 — evict trunk commits below the collab
        window into the base forest. Every lazily-rebased peer branch is
        fast-forwarded to the eviction point first, because
        ``_update_branch`` can only rebase over trunk commits that still
        exist."""
        if min_seq < self.min_seq:
            raise ValueError("minimum sequence number moved backwards")
        self.min_seq = min_seq
        evict_to = None
        for c in self.trunk:
            if c.seq >= min_seq:
                break
            evict_to = c.seq
        if evict_to is None:
            return
        for branch in self.branches.values():
            if branch.ref_seq < evict_to:
                self._update_branch(branch, evict_to)
        evicted = 0
        while evicted < len(self.trunk) and self.trunk[evicted].seq < min_seq:
            c = self.trunk[evicted]
            self.base_forest.apply(c.changes, c.seq)
            evicted += 1
        if evicted:
            del self.trunk[:evicted]

    # ------------------------------------------------------------------
    # rebasing machinery

    def _get_or_create_branch(self, session: str, ref_seq: int) -> _Branch:
        if session not in self.branches:
            self.branches[session] = _Branch(ref_seq=ref_seq)
        return self.branches[session]

    def _trunk_after(self, pred: int, last: Optional[int] = None
                     ) -> list[Commit]:
        out = [c for c in self.trunk if c.seq > pred]
        if last is not None:
            out = [c for c in out if c.seq <= last]
        return out

    @staticmethod
    def _rebase_sandwich(items: list[tuple[FieldChanges, Any]],
                         trunk_changes: list[FieldChanges],
                         keep) -> list[tuple[FieldChanges, Any]]:
        """The inverse/trunk/rebased sandwich shared by branch updates
        (editManager.ts:277) and local-branch rebasing (:241): each kept
        item is rebased over the inverses of the items before it, then
        the new trunk changes, then the already-rebased kept items.
        ``items`` are (change, uid) pairs in commit order; dropped items
        (now covered by the trunk) still contribute their inverses."""
        new_items: list[tuple[FieldChanges, Any]] = []
        inverses: list[FieldChanges] = []
        for change, uid in items:
            if keep(uid):
                c = change
                for inv in inverses:
                    c = cs.rebase(c, inv)
                for t in trunk_changes:
                    c = cs.rebase(c, t)
                for nc, _u in new_items:
                    c = cs.rebase(c, nc)
                new_items.append((c, uid))
            inverses.insert(0, cs.invert(change, uid))
        return new_items

    def _update_branch(self, branch: _Branch, new_ref: int) -> None:
        """editManager.ts:277 — rebase the branch over trunk commits up
        to ``new_ref``; drop branch commits now covered by the trunk."""
        trunk_changes = [c.changes
                         for c in self._trunk_after(branch.ref_seq, new_ref)]
        if not trunk_changes:
            branch.local_changes = [c for c in branch.local_changes
                                    if c.seq > new_ref]
            branch.ref_seq = max(branch.ref_seq, new_ref)
            return
        by_seq = {c.seq: c for c in branch.local_changes}
        rebased = self._rebase_sandwich(
            [(c.changes, c.seq) for c in branch.local_changes],
            trunk_changes, keep=lambda seq: seq > new_ref)
        branch.local_changes = [
            Commit(by_seq[seq].session_id, seq, by_seq[seq].ref_seq, change)
            for change, seq in rebased]
        branch.ref_seq = new_ref

    def _rebase_branch_commit_to_trunk(self, commit: Commit,
                                       branch: _Branch) -> FieldChanges:
        """editManager.ts:223."""
        last = self.trunk[-1] if self.trunk else None
        if (not branch.is_divergent and last is not None
                and commit.session_id == last.session_id):
            return commit.changes
        change = commit.changes
        for bc in reversed(branch.local_changes):
            change = cs.rebase(change, cs.invert(bc.changes, bc.seq))
        for t in self._trunk_after(branch.ref_seq):
            change = cs.rebase(change, t.changes)
        return change

    def _add_commit_to_branch(self, branch: _Branch,
                              commit: Commit) -> None:
        """editManager.ts:197 addCommitToBranch."""
        branch.local_changes.append(commit)
        last = self.trunk[-1] if self.trunk else None
        if last is None or commit.ref_seq == last.seq:
            branch.is_divergent = False
        else:
            branch.is_divergent = (branch.is_divergent
                                   or commit.session_id != last.session_id)

    def _rebase_local_branch(self, trunk_change: FieldChanges,
                             trunk_seq: int) -> None:
        """editManager.ts:241 — the inverse/trunk/new-locals sandwich."""
        if not self.local_changes:
            return
        self.local_changes = self._rebase_sandwich(
            self.local_changes, [trunk_change], keep=lambda _tag: True)
