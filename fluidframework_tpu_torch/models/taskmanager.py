"""TaskManager: distributed task queues / exclusive locks.

Reference: packages/dds/task-manager/src/taskManager.ts (:149). Each
task id has a volunteer queue ordered by op sequencing; the queue head
holds the task. Consensus-style: queue state changes only on
sequencing (volunteering is a round-trip, not optimistic).
"""
from __future__ import annotations

from typing import Any

from ..protocol.messages import SequencedMessage
from ..runtime.shared_object import SharedObject
from ..utils.events import EventEmitter


class TaskManager(SharedObject, EventEmitter):
    type_name = "taskmanager"

    def __init__(self, channel_id: str):
        SharedObject.__init__(self, channel_id)
        EventEmitter.__init__(self)
        # task id -> ordered volunteer client ids (head = assignee)
        self._queues: dict[str, list[str]] = {}
        # tasks we have a volunteer op in flight for
        self._pending_volunteers: set[str] = set()
        # tasks we have an abandon op in flight for (a re-volunteer
        # after a pending abandon must submit: it sequences after)
        self._pending_abandons: set[str] = set()

    # ---- public API

    def volunteer(self, task_id: str) -> None:
        """Join the task's queue (lockTaskQueue). Assignment happens
        when the op sequences and every earlier volunteer abandons."""
        if task_id in self._pending_volunteers:
            return  # already in flight
        if self.queued(task_id) and task_id not in self._pending_abandons:
            return  # already queued with no pending exit
        self._pending_volunteers.add(task_id)
        self.submit_local_message({"type": "volunteer", "taskId": task_id})

    def abandon(self, task_id: str) -> None:
        self._pending_volunteers.discard(task_id)
        self._pending_abandons.add(task_id)
        self.submit_local_message({"type": "abandon", "taskId": task_id})

    def apply_stashed_op(self, contents: Any) -> Any:
        """Offline-stash rehydrate: restore the in-flight intent sets
        (queue membership only changes when ops SEQUENCE)."""
        if contents["type"] == "volunteer":
            self._pending_volunteers.add(contents["taskId"])
        else:
            self._pending_abandons.add(contents["taskId"])
        return None

    def assigned(self, task_id: str) -> str | None:
        """Current assignee (queue head) or None."""
        queue = self._queues.get(task_id)
        return queue[0] if queue else None

    def have_task(self, task_id: str) -> bool:
        return (
            self.client_id is not None
            and self.assigned(task_id) == self.client_id
        )

    def queued(self, task_id: str) -> bool:
        queue = self._queues.get(task_id, [])
        return self.client_id in queue

    def client_left(self, client_id: str) -> None:
        """Drop a departed client from every queue (the reference wires
        this to quorum removeMember; hosts call it on leave)."""
        for task_id, queue in list(self._queues.items()):
            if client_id in queue:
                was_assigned = queue[0] == client_id
                queue.remove(client_id)
                self._emit_queue_change(task_id, was_assigned)

    # ---- SharedObject contract

    def process_core(self, msg: SequencedMessage, local: bool,
                     local_op_metadata: Any = None) -> None:
        op = msg.contents
        task_id = op["taskId"]
        queue = self._queues.setdefault(task_id, [])
        if op["type"] == "volunteer":
            if local:
                self._pending_volunteers.discard(task_id)
            if msg.client_id not in queue:
                queue.append(msg.client_id)
                self._emit_queue_change(task_id, len(queue) == 1)
        elif op["type"] == "abandon":
            if local:
                self._pending_abandons.discard(task_id)
            if msg.client_id in queue:
                was_assigned = queue[0] == msg.client_id
                queue.remove(msg.client_id)
                self._emit_queue_change(task_id, was_assigned)
        else:  # pragma: no cover - forward compat
            raise ValueError(f"unknown op {op['type']!r}")

    def _emit_queue_change(self, task_id: str, assignment_changed: bool
                           ) -> None:
        if assignment_changed:
            self.emit("assigned", task_id, self.assigned(task_id))
        self.emit("queueChanged", task_id)

    def summarize_core(self) -> dict:
        return {"queues": {k: list(v) for k, v in self._queues.items()}}

    def load_core(self, summary: dict) -> None:
        self._queues = {k: list(v) for k, v in summary["queues"].items()}
