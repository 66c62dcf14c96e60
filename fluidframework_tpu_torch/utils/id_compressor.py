"""Distributed ID compression: UUID-sized ids as small integers.

Reference: packages/dds/tree/src/id-compressor — ``IdCompressor``
(idCompressor.ts:272): each session (client) generates *local* ids
(negative integers) immediately and without coordination; when the
creation range round-trips through the sequencer, the ids are
*finalized* into globally-agreed small positive integers allocated in
cluster blocks per session (sessionIdNormalizer.ts, numericUuid.ts).
Every replica finalizes ranges in the same (sequenced) order, so final
ids agree everywhere. Stable UUIDs derive deterministically from
(session uuid, index) so decompress() never needs a lookup table for
ids the local session created.

TPU note (SURVEY §2.4): compact dense int ids are what make tree/node
identities usable as tensor indices — this is the allocator for those.
"""
from __future__ import annotations

import uuid
from dataclasses import dataclass
from typing import Optional

DEFAULT_CLUSTER_CAPACITY = 512


@dataclass(frozen=True)
class IdCreationRange:
    """The op payload announcing a session's new local ids."""

    session_id: str
    first_local: int    # most recent range start, e.g. -1, -6, ...
    count: int


@dataclass
class _Cluster:
    session_id: str
    base_final: int     # first final id in this cluster
    base_local: int     # local index (0-based) of the first id
    capacity: int
    used: int = 0


class IdCompressor:
    def __init__(self, session_id: Optional[str] = None,
                 cluster_capacity: int = DEFAULT_CLUSTER_CAPACITY):
        self.session_id = session_id or uuid.uuid4().hex
        self.cluster_capacity = cluster_capacity
        self._local_count = 0          # ids generated by this session
        self._unranged = 0             # generated but not yet in a range
        self._next_final = 0
        # per-session allocation state
        self._clusters: list[_Cluster] = []
        self._session_finalized: dict[str, int] = {}  # finalized count
        # final id -> (session_id, index); index -> final for lookups
        self._final_by_session: dict[tuple[str, int], int] = {}
        self._session_by_final: dict[int, tuple[str, int]] = {}

    # ------------------------------------------------------------------
    # generation (session space)

    def generate_compressed_id(self) -> int:
        """A session-space id, usable immediately: -1, -2, -3, ..."""
        self._local_count += 1
        self._unranged += 1
        return -self._local_count

    def take_next_creation_range(self) -> Optional[IdCreationRange]:
        """Package un-announced local ids for submission (ops carry
        these; idCompressor.takeNextCreationRange)."""
        if self._unranged == 0:
            return None
        first = -(self._local_count - self._unranged + 1)
        rng = IdCreationRange(self.session_id, first, self._unranged)
        self._unranged = 0
        return rng

    # ------------------------------------------------------------------
    # finalization (sequenced order — identical on every replica)

    def finalize_creation_range(self, rng: IdCreationRange) -> None:
        done = self._session_finalized.get(rng.session_id, 0)
        expected_first = -(done + 1)
        assert rng.first_local == expected_first, (
            f"out-of-order range for session {rng.session_id}: got "
            f"first_local={rng.first_local}, expected {expected_first}"
        )
        for i in range(rng.count):
            index = done + i
            final = self._allocate_final(rng.session_id, index)
            self._final_by_session[(rng.session_id, index)] = final
            self._session_by_final[final] = (rng.session_id, index)
        self._session_finalized[rng.session_id] = done + rng.count

    def _allocate_final(self, session_id: str, index: int) -> int:
        cluster = next(
            (c for c in reversed(self._clusters)
             if c.session_id == session_id
             and c.base_local <= index < c.base_local + c.capacity),
            None,
        )
        if cluster is None:
            cluster = _Cluster(
                session_id=session_id,
                base_final=self._next_final,
                base_local=index,
                capacity=self.cluster_capacity,
            )
            self._next_final += self.cluster_capacity
            self._clusters.append(cluster)
        cluster.used = max(cluster.used, index - cluster.base_local + 1)
        return cluster.base_final + (index - cluster.base_local)

    # ------------------------------------------------------------------
    # normalization (sessionIdNormalizer.ts)

    def normalize_to_op_space(self, id_: int) -> int:
        """Local (negative) -> final, if our id has finalized; final
        ids pass through."""
        if id_ >= 0:
            return id_
        index = -id_ - 1
        final = self._final_by_session.get((self.session_id, index))
        assert final is not None, (
            f"local id {id_} not finalized yet (range not sequenced)"
        )
        return final

    def normalize_to_session_space(self, id_: int,
                                   origin_session: Optional[str] = None
                                   ) -> int:
        """Final -> our local form when we created it; otherwise the
        final id itself. A negative id from another session resolves
        via that session's finalized table."""
        if id_ < 0:
            origin = origin_session or self.session_id
            if origin == self.session_id:
                return id_
            index = -id_ - 1
            final = self._final_by_session.get((origin, index))
            assert final is not None, (
                f"foreign local id {id_} (session {origin}) unknown"
            )
            return final
        owner = self._session_by_final.get(id_)
        if owner is not None and owner[0] == self.session_id:
            return -(owner[1] + 1)
        return id_

    # ------------------------------------------------------------------
    # stable id round-trip (numericUuid.ts)

    def decompress(self, id_: int) -> str:
        """Compressed id -> stable uuid string."""
        if id_ < 0:
            session, index = self.session_id, -id_ - 1
        else:
            owner = self._session_by_final.get(id_)
            assert owner is not None, f"unknown final id {id_}"
            session, index = owner
        return uuid.uuid5(
            uuid.NAMESPACE_OID, f"{session}:{index}"
        ).hex

    def recompress(self, stable_id: str) -> int:
        """Stable uuid -> final id (linear over finalized ids; the
        reference keeps a numeric-uuid index — optimize if hot)."""
        for (session, index), final in self._final_by_session.items():
            if uuid.uuid5(
                uuid.NAMESPACE_OID, f"{session}:{index}"
            ).hex == stable_id:
                return final
        raise KeyError(stable_id)

    # ------------------------------------------------------------------
    # summary

    def snapshot(self) -> dict:
        return {
            "nextFinal": self._next_final,
            "clusters": [
                [c.session_id, c.base_final, c.base_local, c.capacity,
                 c.used]
                for c in self._clusters
            ],
            "finalized": dict(self._session_finalized),
        }

    @classmethod
    def restore(cls, state: dict, session_id: Optional[str] = None
                ) -> "IdCompressor":
        comp = cls(session_id)
        comp._next_final = state["nextFinal"]
        # resuming our own session: local generation continues after
        # the already-finalized ids (snapshots are taken quiescent)
        comp._local_count = state["finalized"].get(comp.session_id, 0)
        comp._clusters = [
            _Cluster(sid, bf, bl, cap, used)
            for sid, bf, bl, cap, used in state["clusters"]
        ]
        comp._session_finalized = dict(state["finalized"])
        for cluster in comp._clusters:
            for i in range(cluster.used):
                index = cluster.base_local + i
                final = cluster.base_final + i
                comp._final_by_session[(cluster.session_id, index)] = final
                comp._session_by_final[final] = (
                    cluster.session_id, index
                )
        return comp
