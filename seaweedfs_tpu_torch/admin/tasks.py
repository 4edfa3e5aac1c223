"""Maintenance task queue: typed tasks with claim/report lifecycle; the
port's copy of seaweedfs_tpu/admin/tasks.py.

Behavioral counterpart of the reference's maintenance queue
(weed/admin/maintenance/maintenance_queue.go): pending tasks are
deduplicated per (kind, volume), claimed by one worker at a time,
re-queued if the worker goes quiet, and retried a bounded number of times
on failure.  Ids, states and ``to_json`` are the JAX package's; outcomes
count under ``weedtpu_admin_tasks_total``.
"""

from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass, field
from enum import Enum

from seaweedfs_tpu_torch import stats


class TaskState(str, Enum):
    PENDING = "pending"
    ASSIGNED = "assigned"
    COMPLETED = "completed"
    FAILED = "failed"
    CANCELED = "canceled"


EC_ENCODE = "ec_encode"
EC_REBUILD = "ec_rebuild"
VACUUM = "vacuum"
TTL_DELETE = "ttl_delete"


@dataclass
class Task:
    id: int
    kind: str  # EC_ENCODE | EC_REBUILD | VACUUM | TTL_DELETE
    volume_id: int
    collection: str = ""
    params: dict = field(default_factory=dict)
    state: TaskState = TaskState.PENDING
    worker_id: str = ""
    created_at: float = field(default_factory=time.time)
    assigned_at: float = 0.0
    finished_at: float = 0.0
    attempts: int = 0
    error: str = ""

    def to_json(self) -> dict:
        return {
            "id": self.id,
            "kind": self.kind,
            "volume_id": self.volume_id,
            "collection": self.collection,
            "params": self.params,
            "state": self.state.value,
            "worker_id": self.worker_id,
            "attempts": self.attempts,
            "error": self.error,
        }


class TaskQueue:
    """Thread-safe queue with at-most-one active task per (kind, volume)."""

    def __init__(
        self,
        max_attempts: int = 3,
        assign_timeout: float = 600.0,
        max_finished: int = 1000,
    ):
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._tasks: dict[int, Task] = {}
        self.max_attempts = max_attempts
        self.assign_timeout = assign_timeout
        self.max_finished = max_finished

    def _prune(self) -> None:
        """Caller holds the lock.  Bound finished-task history so a
        long-running admin daemon doesn't grow without limit."""
        finished = [
            t
            for t in self._tasks.values()
            if t.state
            in (TaskState.COMPLETED, TaskState.FAILED, TaskState.CANCELED)
        ]
        if len(finished) <= self.max_finished:
            return
        finished.sort(key=lambda t: t.finished_at)
        for t in finished[: len(finished) - self.max_finished]:
            del self._tasks[t.id]

    def submit(self, kind: str, volume_id: int, collection: str = "", **params) -> Task | None:
        """Enqueue unless an active task for this (kind, volume) exists."""
        with self._lock:
            self._prune()
            for t in self._tasks.values():
                if (
                    t.kind == kind
                    and t.volume_id == volume_id
                    and t.state in (TaskState.PENDING, TaskState.ASSIGNED)
                ):
                    return None
            task = Task(
                id=next(self._ids),
                kind=kind,
                volume_id=volume_id,
                collection=collection,
                params=params,
            )
            self._tasks[task.id] = task
            return task

    def has_active(self, kind: str, volume_id: int) -> bool:
        """An undone task of this kind exists for the volume (the
        scanner's don't-fight-the-encode guard)."""
        with self._lock:
            return any(
                t.kind == kind
                and t.volume_id == volume_id
                and t.state in (TaskState.PENDING, TaskState.ASSIGNED)
                for t in self._tasks.values()
            )

    def claim(self, worker_id: str, kinds: list[str] | None = None) -> Task | None:
        """Hand the oldest eligible pending task to a worker."""
        now = time.time()
        with self._lock:
            self._requeue_stale(now)
            for task in sorted(self._tasks.values(), key=lambda t: t.id):
                if task.state is not TaskState.PENDING:
                    continue
                if kinds and task.kind not in kinds:
                    continue
                task.state = TaskState.ASSIGNED
                task.worker_id = worker_id
                task.assigned_at = now
                task.attempts += 1
                return task
            return None

    def report(self, task_id: int, worker_id: str, ok: bool, error: str = "") -> Task:
        with self._lock:
            task = self._tasks[task_id]
            if task.worker_id != worker_id or task.state is not TaskState.ASSIGNED:
                raise ValueError(
                    f"task {task_id} not assigned to {worker_id} "
                    f"(state={task.state.value}, owner={task.worker_id})"
                )
            task.finished_at = time.time()
            if ok:
                task.state = TaskState.COMPLETED
                task.error = ""
                outcome = "ok"
            elif task.attempts >= self.max_attempts:
                task.state = TaskState.FAILED
                task.error = error
                outcome = "failed"  # terminal only — retries are not failures
            else:
                task.state = TaskState.PENDING
                task.worker_id = ""
                task.error = error
                outcome = "retried"
            stats.ADMIN_TASKS.inc(kind=task.kind, outcome=outcome)
            return task

    def _requeue_stale(self, now: float) -> None:
        for task in self._tasks.values():
            if (
                task.state is TaskState.ASSIGNED
                and now - task.assigned_at > self.assign_timeout
            ):
                if task.attempts >= self.max_attempts:
                    task.state = TaskState.FAILED
                    task.error = task.error or "worker timed out"
                    stats.ADMIN_TASKS.inc(kind=task.kind, outcome="failed")
                else:
                    task.state = TaskState.PENDING
                    task.worker_id = ""
                    stats.ADMIN_TASKS.inc(kind=task.kind, outcome="retried")

    # ---- introspection --------------------------------------------------
    def cancel(self, task_id: int) -> Task:
        """Cancel a PENDING task (admin management plane; reference
        maintenance queue cancellation).  An ASSIGNED task is already
        running on a worker and cannot be recalled — report wins."""
        with self._lock:
            task = self._tasks[task_id]
            if task.state is not TaskState.PENDING:
                raise ValueError(
                    f"task {task_id} is {task.state.value}, not pending"
                )
            task.state = TaskState.CANCELED
            task.finished_at = time.time()
            return task

    def get(self, task_id: int) -> Task | None:
        with self._lock:
            return self._tasks.get(task_id)

    def all(self) -> list[Task]:
        with self._lock:
            return sorted(self._tasks.values(), key=lambda t: t.id)

    def counts(self) -> dict[str, int]:
        with self._lock:
            out: dict[str, int] = {}
            for t in self._tasks.values():
                out[t.state.value] = out.get(t.state.value, 0) + 1
            return out
