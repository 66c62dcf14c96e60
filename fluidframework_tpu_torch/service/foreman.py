"""Foreman lambda — service-side task routing to agent workers.

Reference: server/routerlicious/packages/lambdas/src/foreman/ — the
lambda that watches the sequenced stream for help requests
("RemoteHelp" messages a runtime emits when it wants service-side
work: spell-check, translation, snapshot generation) and ROUTES each
task to a registered agent worker, rebalancing when workers come and
go. It completes the lambda inventory next to copier (raw capture),
scriptorium (log append), broadcaster (fan-out) and scribe
(summaries).

Construction here: ``ForemanLambda`` subscribes like any other
lambda (LocalOrderer stage or a Partition record hook). Help requests
are sequenced OPERATION envelopes ``{"kind": "help", "tasks": [...]}``
(the runtime-side emitter is ``request_help``). Routing is
deterministic least-loaded-first over the agents whose declared
capabilities cover the task, so every replica of the foreman reaches
the same assignment from the same stream — the same
determinism-by-sequencing rule every consensus component here uses.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from ..protocol.messages import MessageType, SequencedMessage


def help_envelope(tasks: list[str]) -> dict:
    """Contents of a help-request op (runtime -> service)."""
    return {"kind": "help", "tasks": list(tasks)}


@dataclass
class _Agent:
    name: str
    capabilities: frozenset
    run: Optional[Callable[[str, SequencedMessage], Any]]
    assigned: list = field(default_factory=list)


class ForemanLambda:
    """Routes sequenced help requests to registered agent workers."""

    def __init__(self) -> None:
        self._agents: dict[str, _Agent] = {}
        # task -> agent name (live assignments)
        self.assignments: dict[str, str] = {}
        # tasks no capable agent could take (retried on registration)
        self.unassigned: list[tuple[str, SequencedMessage]] = []

    # -- worker pool ---------------------------------------------------

    def register_agent(self, name: str, capabilities,
                       run: Optional[Callable] = None) -> None:
        """An agent worker joins the pool; queued tasks it can serve
        are handed over immediately. Re-registering a live name (a
        restarted worker) first releases its old assignments so they
        reroute instead of sticking to the dead incarnation."""
        if name in self._agents:
            self.unregister_agent(name)
        self._agents[name] = _Agent(
            name, frozenset(capabilities), run
        )
        still: list = []
        for task, msg in self.unassigned:
            if not self._assign(task, msg):
                still.append((task, msg))
        self.unassigned = still

    def unregister_agent(self, name: str) -> None:
        """Worker left (process death / rebalance): its tasks REROUTE
        to surviving capable agents or queue as unassigned."""
        agent = self._agents.pop(name, None)
        if agent is None:
            return
        for task, msg in agent.assigned:
            self.assignments.pop(task, None)
            if not self._assign(task, msg):
                self.unassigned.append((task, msg))

    def agent_load(self, name: str) -> int:
        return len(self._agents[name].assigned)

    # -- lambda surface --------------------------------------------------

    def handler(self, msg: SequencedMessage) -> None:
        """Stage hook: consume one sequenced message."""
        if msg.type != MessageType.OPERATION:
            return
        contents = msg.contents if isinstance(msg.contents, dict) \
            else {}
        if contents.get("kind") != "help":
            return
        for task in contents.get("tasks", ()):
            if task in self.assignments or any(
                t == task for t, _ in self.unassigned
            ):
                continue  # already routed/queued (duplicate request)
            if not self._assign(task, msg):
                self.unassigned.append((task, msg))

    def complete(self, task: str) -> None:
        """Agent finished a task: free its slot."""
        name = self.assignments.pop(task, None)
        if name and name in self._agents:
            agent = self._agents[name]
            agent.assigned = [
                (t, m) for t, m in agent.assigned if t != task
            ]

    # -- routing ---------------------------------------------------------

    def _assign(self, task: str, msg: SequencedMessage) -> bool:
        capable = [
            a for a in self._agents.values()
            if task in a.capabilities or "*" in a.capabilities
        ]
        if not capable:
            return False
        # deterministic: least loaded, name as tiebreak
        agent = min(capable, key=lambda a: (len(a.assigned), a.name))
        agent.assigned.append((task, msg))
        self.assignments[task] = agent.name
        if agent.run is not None:
            agent.run(task, msg)
        return True
