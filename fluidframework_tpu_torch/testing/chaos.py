"""The chaos harness's shared manual clock.

The reference's ``testing/chaos.py`` drives seeded fault schedules
end to end through the service stack and owns the one step clock every
deterministic harness shares. Only that clock is copied here: the
overload mode of ``tools/stress`` and ``tools/serve_bench`` import it.
The storm itself (``run_chaos``, ``run_chaos_storm``, the chaos
transport, crash-restart and the replicated plane's failover and
netsplit legs) waits for the port of replication, partitioning and the
broker, and comes with them.
"""
from __future__ import annotations


class ManualClock:
    """The injectable step clock every deterministic harness shares —
    ONE owner (tools/stress and tools/serve_bench import it from
    here; tools may import testing, never the reverse)."""

    def __init__(self) -> None:
        self.t = 0.0

    def __call__(self) -> float:
        return self.t
