"""Dynamic data sharding: the fault-tolerance core.

Reference parity (SURVEY.md §2 #3, §3.2 [U — mount empty at survey time]):
the master splits the dataset into shard-sized "tasks"; workers pull tasks
over RPC and report results; tasks of a dead/slow worker are requeued so a
preemption loses at most the in-flight shards.  Epochs are implemented by
refilling the todo queue when a pass completes.

Thread-safe: the RPC servicer calls from gRPC threads, the pod watcher from
its own thread.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from elasticdl_tpu_torch.common import locksan, trace
from elasticdl_tpu_torch.data.reader import Shard

TASK_TRAINING = "training"
TASK_EVALUATION = "evaluation"
TASK_PREDICTION = "prediction"


class JournalReplayError(RuntimeError):
    """A journal event does not fit the state being rebuilt — the WAL
    describes a different job (or is corrupt past its header's job-shape
    guard).  The restarting master falls back to the coarse watermark."""


@dataclasses.dataclass(frozen=True)
class Task:
    task_id: int
    shard: Shard
    type: str = TASK_TRAINING
    epoch: int = 0

    def to_dict(self) -> dict:
        return {
            "task_id": self.task_id,
            "shard": dataclasses.asdict(self.shard),
            "type": self.type,
            "epoch": self.epoch,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Task":
        return cls(
            task_id=d["task_id"],
            shard=Shard(**d["shard"]),
            type=d["type"],
            epoch=d["epoch"],
        )


@dataclasses.dataclass
class _Doing:
    task: Task
    worker_id: str
    handed_at: float


class TaskDispatcher:
    """todo/doing/done task queues with requeue-on-failure semantics."""

    def __init__(
        self,
        shards: List[Shard],
        num_epochs: int = 1,
        task_type: str = TASK_TRAINING,
        task_timeout_s: float = 600.0,
        max_task_retries: int = 3,
        task_skip_budget: int = 2,
        clock: Callable[[], float] = time.monotonic,
        resume: Optional[dict] = None,
        restore: Optional[dict] = None,
        journal=None,
    ):
        if num_epochs < 1:
            raise ValueError("num_epochs must be >= 1")
        self._shards = list(shards)
        self._num_epochs = num_epochs
        self._task_type = task_type
        self._timeout = task_timeout_s
        self._max_retries = max_task_retries
        self._skip_budget = task_skip_budget
        self._clock = clock

        # Callbacks (_fire_epoch_end) and callers' locks stay outside this
        # one by design; nothing is ever acquired under it.
        self._lock = locksan.lock("TaskDispatcher._lock", leaf=True)  # lock-order: leaf
        self._todo: deque = deque()
        self._doing: Dict[int, _Doing] = {}
        self._done_count = 0
        self._abandoned = 0
        self._failed_counts: Dict[int, int] = {}
        # Deadline-skip accounting (r13, the gang boundary's safety proof):
        # per-task skip counts and a counter of late SUCCESS reports
        # REJECTED — the explicit zero-double-train check the chaos
        # artifact stamps.
        self._skip_counts: Dict[int, int] = {}
        self._skipped_events = 0
        self._duplicate_done = 0
        self._next_task_id = 0
        self._epoch = -1  # _refill brings it to 0
        self._finished = not self._shards
        self._stopped = False  # stop(): draining, nothing requeues
        # Done shards of the CURRENT epoch, for ``progress()`` — the durable
        # watermark a restarted master resumes from (SURVEY §5 "restore on
        # master restart").
        self._done_in_epoch: set = set()
        # Epoch-boundary events: (epoch, is_final) pairs queued under the
        # lock by _refill and delivered OUTSIDE it (the callback may start an
        # eval round, which has its own locks).  The master wires the
        # callback for the reference's "eval at epoch end" mode
        # (--evaluation_steps=0).
        self._on_epoch_end: Optional[Callable[[int, bool], None]] = None
        self._pending_epoch_end: List[Tuple[int, bool]] = []
        # Durable control-plane journal (r18, master/journal.py): every
        # queue mutation records one event under this lock, in mutation
        # order, so a restarted master replays to the EXACT pre-crash
        # state (not the coarse watermark's "skip finished epochs").
        # None = no journal (tests, eval/predict jobs); attached after
        # construction on the replay path (replay must not re-record).
        self._journal = journal  # guarded-by: _lock
        if restore is not None:
            # Journal-replay restore: the full pre-crash state, bit for
            # bit — supersedes the watermark resume below.
            self._restore_snapshot(restore)
        elif resume is not None and self._shards:
            self._resume(resume)
        else:
            self._refill()

    @staticmethod
    def _shard_key(shard: Shard) -> Tuple[str, int, int]:
        return (shard.name, shard.start, shard.end)

    def _resume(self, progress: dict) -> None:
        """Fast-forward to a persisted watermark: enter ``progress['epoch']``
        with its already-done shards excluded from the todo queue.  A
        watermark at/after the last epoch with everything done finishes
        immediately (the job was complete when the old master died)."""
        epoch = int(progress.get("epoch", 0))
        done_keys = {tuple(k) for k in progress.get("done_shards", [])}
        self._done_count = int(progress.get("done_count", 0))
        if epoch >= self._num_epochs:
            self._finished = True
            return
        self._epoch = epoch
        known = {self._shard_key(s) for s in self._shards}
        self._done_in_epoch = done_keys & known
        for shard in self._shards:
            if self._shard_key(shard) in self._done_in_epoch:
                continue
            self._todo.append(
                Task(self._next_task_id, shard, self._task_type, self._epoch)
            )
            self._next_task_id += 1
        if not self._todo:
            # Every shard of the watermark epoch was done: move on (or
            # finish, if it was the last).
            self._done_in_epoch = set()
            if self._epoch + 1 >= self._num_epochs:
                self._finished = True
            else:
                self._refill()
        # Epoch-end events generated while fast-forwarding describe epochs
        # that ended BEFORE the crash — their eval rounds already ran; firing
        # them again would emit duplicate metric rows.
        self._pending_epoch_end.clear()

    def progress(self) -> dict:
        """The durable watermark: epoch + done shards within it + cumulative
        done count.  Linear in done shards; the master persists it
        atomically after reports (master/main.py)."""
        with self._lock:
            return {
                "epoch": max(self._epoch, 0),
                "done_shards": sorted(self._done_in_epoch),
                "done_count": self._done_count,
                "num_epochs": self._num_epochs,
                "num_shards": len(self._shards),
            }

    def set_epoch_end_callback(self, fn: Callable[[int, bool], None]) -> None:
        self._on_epoch_end = fn

    # -- durable journal (r18): snapshot / restore / event replay --

    def attach_journal(self, journal) -> None:
        """Wire the WAL after construction (the replay path builds the
        dispatcher journal-less, then attaches the rotated journal)."""
        with self._lock:
            self._journal = journal

    def _j(self, ev: dict) -> None:  # guarded-by: _lock
        """Record one journal event.  Called under ``_lock`` immediately
        after the mutation it describes, so the WAL's physical order IS
        the mutation order (the replay contract)."""
        if self._journal is not None:
            self._journal.record(ev)

    def rotate_journal(self, extras: dict) -> None:
        """Compaction inner half: snapshot + WAL swap in ONE critical
        section of this lock, so no dispatcher event can land between the
        snapshot and the new file (it would be lost from both).  The
        caller (MasterServicer.rotate_journal) holds the group + servicer
        locks across this call, excluding ITS writers the same way."""
        with self._lock:
            if self._journal is None:
                return
            base = dict(extras)
            base["dispatcher"] = self._snapshot_locked()
            self._journal.rotate(base)

    def snapshot(self) -> dict:
        """The FULL dispatcher state, JSON-safe — the journal's base
        record.  Everything ``counts()``/``progress()`` summarize plus the
        queues themselves, so a restore is bit-identical (pinned by
        test), not a watermark approximation."""
        with self._lock:
            return self._snapshot_locked()

    def _snapshot_locked(self) -> dict:  # guarded-by: _lock
        return {
            "epoch": self._epoch,
            "todo": [t.to_dict() for t in self._todo],
            "doing": [
                {"task": d.task.to_dict(), "worker": d.worker_id}
                for d in self._doing.values()
            ],
            "done_count": self._done_count,
            "done_in_epoch": sorted(list(k) for k in self._done_in_epoch),
            "failed_counts": {
                str(k): v for k, v in self._failed_counts.items()
            },
            "skip_counts": {str(k): v for k, v in self._skip_counts.items()},
            "skipped_events": self._skipped_events,
            "duplicate_done": self._duplicate_done,
            "abandoned": self._abandoned,
            "next_task_id": self._next_task_id,
            "finished": self._finished,
            "stopped": self._stopped,
            "num_epochs": self._num_epochs,
            "num_shards": len(self._shards),
            "task_type": self._task_type,
        }

    def _restore_snapshot(self, snap: dict) -> None:
        """Adopt a ``snapshot()`` verbatim (journal-replay restore).  The
        job-shape guard lives in master/journal.py's replay — by the time
        a snapshot reaches here it describes THIS job."""
        self._epoch = int(snap["epoch"])
        self._todo = deque(Task.from_dict(t) for t in snap["todo"])
        # handed_at resets to now: the pre-crash lease ages died with the
        # old master's clock, and restarting the timeout window is the
        # conservative choice (a requeue fires late, never spuriously).
        now = self._clock()
        self._doing = {
            d["task"]["task_id"]: _Doing(
                Task.from_dict(d["task"]), d["worker"], now
            )
            for d in snap["doing"]
        }
        self._done_count = int(snap["done_count"])
        self._done_in_epoch = {tuple(k) for k in snap["done_in_epoch"]}
        self._failed_counts = {
            int(k): v for k, v in snap["failed_counts"].items()
        }
        self._skip_counts = {int(k): v for k, v in snap["skip_counts"].items()}
        self._skipped_events = int(snap["skipped_events"])
        self._duplicate_done = int(snap["duplicate_done"])
        self._abandoned = int(snap["abandoned"])
        self._next_task_id = int(snap["next_task_id"])
        self._finished = bool(snap["finished"])
        self._stopped = bool(snap["stopped"])

    def replay_event(self, ev: dict) -> None:
        """Apply one journaled event (master/journal.py's replay loop).
        Only the nondeterministic inputs were journaled — hand-out
        choices, reports, requeues — and every derived transition (epoch
        refill, retry/skip budgets, poison abandons) re-derives through
        the same code that produced it, so replayed state is bit-exact.
        Runs with the journal DETACHED (events must not re-record)."""
        kind = ev["kind"]
        if kind == "handout":
            with self._lock:
                for td in ev["tasks"]:
                    task_id = td["task_id"]
                    entry = None
                    for i, t in enumerate(self._todo):
                        if t.task_id == task_id:
                            entry = t
                            del self._todo[i]
                            break
                    if entry is None:
                        raise JournalReplayError(
                            f"handout of task {task_id} not in todo — the "
                            "journal does not describe this job"
                        )
                    self._doing[task_id] = _Doing(
                        entry, ev["worker"], self._clock()
                    )
        elif kind == "report":
            self.report(
                int(ev["task_id"]), bool(ev["success"]),
                ev.get("worker", ""),
                requeue_only=bool(ev.get("requeue", False)),
            )
        elif kind == "recover":
            self.recover_tasks(ev["worker"])
        elif kind == "skip":
            self.skip_tasks(ev["worker"])
        elif kind == "timeout":
            with self._lock:
                self._requeue_specific_locked(ev["tasks"])
        elif kind == "reconcile":
            self.reconcile_leases(ev["worker"], set(ev["held"]))
        elif kind == "stop":
            self.stop()
        else:
            raise JournalReplayError(f"unknown journal event kind {kind!r}")

    def _requeue_specific_locked(self, task_ids) -> None:  # guarded-by: _lock
        """Replay a timeout requeue: the journaled ids move doing -> todo
        (front), exactly as ``_requeue_timed_out`` moved them."""
        for tid in task_ids:
            entry = self._doing.pop(tid, None)
            if entry is not None and not self._stopped:
                self._todo.appendleft(entry.task)

    def reconcile_leases(self, worker_id: str, held_ids: set):
        """Lease reconciliation (r18): the re-register handshake after a
        master restart.  ``held_ids`` is what the worker still holds; any
        ``doing`` entry of this worker NOT held was a handout lost in
        flight during the crash — requeue it NOW (budget-free, the r9
        requeue_only stance) instead of after task_timeout_s.  Returns
        ``(requeued_tasks, stale_ids)``: stale ids are held tasks this
        dispatcher no longer attributes to the worker (already reported,
        or re-leased after a double restart) — the worker must drop them
        unstarted or their records would train twice."""
        held = {int(h) for h in held_ids}
        with self._lock:
            lost = [
                d.task for d in self._doing.values()
                if d.worker_id == worker_id and d.task.task_id not in held
            ]
            for task in lost:
                del self._doing[task.task_id]
                if not self._stopped:
                    self._todo.appendleft(task)
            stale = sorted(
                h for h in held
                if h not in self._doing
                or self._doing[h].worker_id != worker_id
            )
            self._j({
                "kind": "reconcile", "worker": worker_id,
                "held": sorted(held),
            })
            self._refill()
        if lost or stale:
            trace.instant(
                "lease:reconcile", cat="lease", worker=worker_id,
                requeued=[t.task_id for t in lost], stale=stale,
            )
        self._fire_epoch_end()
        return lost, stale

    # -- internal --

    def _refill(self) -> None:
        """Start the next epoch if the current one is exhausted."""
        if self._finished or self._todo or self._doing:
            return
        prev = self._epoch
        if self._epoch + 1 >= self._num_epochs:
            self._finished = True
            if prev >= 0:
                self._pending_epoch_end.append((prev, True))
            return
        if prev >= 0:
            self._pending_epoch_end.append((prev, False))
        self._epoch += 1
        self._done_in_epoch = set()
        for shard in self._shards:
            self._todo.append(
                Task(self._next_task_id, shard, self._task_type, self._epoch)
            )
            self._next_task_id += 1

    def _fire_epoch_end(self) -> None:
        """Deliver queued epoch-boundary events (call with the lock RELEASED)."""
        while True:
            with self._lock:
                if not self._pending_epoch_end:
                    return
                epoch, final = self._pending_epoch_end.pop(0)
            if self._on_epoch_end is not None:
                self._on_epoch_end(epoch, final)

    # -- worker-facing API (via servicer) --

    # hot-path: behind every worker GetTask poll
    def get_task(self, worker_id: str) -> Optional[Task]:
        """Hand out the next task, or None if nothing is available.

        None with ``finished() == False`` means "in-flight tasks remain;
        poll again" (their failure may requeue work).
        """
        tasks = self.get_tasks(worker_id, 1)
        return tasks[0] if tasks else None

    # hot-path: behind every (batched) worker GetTask poll
    def get_tasks(self, worker_id: str, n: int) -> List[Task]:
        """Lease up to ``n`` tasks to ``worker_id`` in one locked pass (the
        batched-lease RPC, r9).  Every handed-out task enters ``doing``
        individually, so the existing elasticity machinery — timeout
        requeue, ``recover_tasks`` on worker loss, at-least-once reports —
        covers leased-but-unstarted tasks with no new state: a lost worker's
        whole lease requeues exactly once through the same path as its
        in-flight task.  Epoch refill semantics are unchanged: a batch
        never crosses an epoch boundary mid-call (the refill only fires
        when todo AND doing are both empty)."""
        with self._lock:
            self._requeue_timed_out()
            self._refill()
            tasks: List[Task] = []
            while self._todo and len(tasks) < n:
                task = self._todo.popleft()
                self._doing[task.task_id] = _Doing(
                    task, worker_id, self._clock()
                )
                tasks.append(task)
            if tasks:
                # The WHICH of the hand-out is the nondeterministic input
                # replay cannot re-derive (full task dicts: the replayed
                # doing set must not depend on todo ordering assumptions).
                self._j({
                    "kind": "handout", "worker": worker_id,
                    "tasks": [t.to_dict() for t in tasks],
                })
        if tasks:
            # Lease lifecycle, instant-event form (non-blocking ring append
            # — hot-path legal): handout -> report/requeue/recover, so the
            # merged trace shows which worker held which task when.
            trace.instant(
                "lease:handout", cat="lease", worker=worker_id,
                tasks=[t.task_id for t in tasks],
            )
        self._fire_epoch_end()
        return tasks

    # hot-path: behind every task report
    def report(
        self,
        task_id: int,
        success: bool,
        worker_id: str = "",
        requeue_only: bool = False,
        seq: Optional[int] = None,
    ) -> bool:
        """Record a task result; requeue on failure.  Returns False for an
        unknown/stale id (e.g. a task already requeued by the timeout path —
        the late result is ignored, matching at-least-once semantics).

        ``requeue_only`` (r9): the task was returned UNSTARTED (a worker
        giving back a buffered lease or an undispatched prep on preemption
        or membership change) — requeue it without touching the retry
        budget.  Counting these as failures would let routine elastic churn
        poison-abandon a healthy task: with batched leases a task can sit
        in some worker's buffer across max_task_retries separate scale
        events without ever having run."""
        trace.instant(
            "lease:report", cat="lease", task=task_id, worker=worker_id,
            success=success, requeue=requeue_only,
        )
        with self._lock:
            # Journaled BEFORE the branch so the rejected-late-success
            # accounting (duplicate_done) replays identically too; ``seq``
            # rides along so replay rebuilds the per-worker dedup ledger
            # from the same record (master/journal.py).
            self._j({
                "kind": "report", "task_id": task_id, "success": success,
                "worker": worker_id, "requeue": requeue_only,
                **({"seq": seq} if seq is not None else {}),
            })
            entry = self._doing.pop(task_id, None)
            if entry is None:
                if success:
                    # A late SUCCESS for a task no longer in flight: a
                    # duplicate of an already-counted result, or — the
                    # double-train hazard — a task that was requeued
                    # (timeout/skip raced the report) and whose records
                    # will train again.  Either way the rejection is
                    # counted, so the chaos artifact's zero-double-train
                    # check is an observable number, not an assumption.
                    self._duplicate_done += 1
                return False
            if success:
                self._done_count += 1
                if entry.task.epoch == self._epoch:
                    self._done_in_epoch.add(self._shard_key(entry.task.shard))
            elif self._stopped:
                # Draining past --max_steps: a failed in-flight task is
                # dropped, not requeued — requeueing would re-open dispatch
                # and train past the configured limit.
                self._abandoned += 1
            elif requeue_only:
                self._todo.appendleft(entry.task)
            else:
                fails = self._failed_counts.get(task_id, 0) + 1
                self._failed_counts[task_id] = fails
                if fails <= self._max_retries:
                    self._todo.appendleft(entry.task)
                else:
                    # Poison task: a shard that fails deterministically (bad
                    # data, codec mismatch) must not stall the job forever.
                    self._abandoned += 1
            self._refill()
        self._fire_epoch_end()
        return True

    # -- elasticity hooks --

    def recover_tasks(self, worker_id: str) -> List[Task]:
        """Requeue every in-flight task of a dead worker (PodManager calls
        this on a pod-failure event; §3.2 'elasticity core').  After stop()
        the tasks are released but NOT requeued (draining)."""
        with self._lock:
            lost = [d.task for d in self._doing.values() if d.worker_id == worker_id]
            for task in lost:
                del self._doing[task.task_id]
                if not self._stopped:
                    self._todo.appendleft(task)
            if lost:
                self._j({"kind": "recover", "worker": worker_id})
        if lost:
            trace.instant(
                "lease:recover", cat="lease", worker=worker_id,
                tasks=[t.task_id for t in lost],
            )
        return lost

    def skip_tasks(self, worker_id: str) -> List[Task]:
        """Deadline-skip requeue (r13, the gang boundary's accounting):
        requeue every in-flight task of ``worker_id`` — the lockstep
        group pseudo worker whose gang just skipped a straggler — with
        BOUNDED skip accounting.  The first ``task_skip_budget`` skips of
        a task requeue free (elastic churn must not poison a healthy
        shard, the r9 requeue_only stance); past the budget a skip is
        charged like a FAILURE, so a shard that deterministically stalls
        a rank flows into the existing poison-task abandon path instead
        of ping-ponging the gang through skip-reform cycles forever.
        Exactly-once is preserved by construction: a skipped task left
        ``doing`` unreported, so it requeues exactly once here and its
        eventual success is counted once (the duplicate-done counter
        proves the claim at run time)."""
        with self._lock:
            lost = [
                d.task for d in self._doing.values()
                if d.worker_id == worker_id
            ]
            if lost:
                self._j({"kind": "skip", "worker": worker_id})
            for task in lost:
                del self._doing[task.task_id]
                self._skipped_events += 1
                if self._stopped:
                    continue  # draining: skipped work must not retrain
                skips = self._skip_counts.get(task.task_id, 0) + 1
                self._skip_counts[task.task_id] = skips
                if skips <= self._skip_budget:
                    self._todo.appendleft(task)
                    continue
                fails = self._failed_counts.get(task.task_id, 0) + 1
                self._failed_counts[task.task_id] = fails
                if fails <= self._max_retries:
                    self._todo.appendleft(task)
                else:
                    self._abandoned += 1
            self._refill()
        for task in lost:
            trace.instant(
                "lease:skip", cat="lease", task=task.task_id,
                worker=worker_id,
            )
        self._fire_epoch_end()
        return lost

    def _requeue_timed_out(self) -> None:
        now = self._clock()
        stale = [
            tid
            for tid, d in self._doing.items()
            if now - d.handed_at > self._timeout
        ]
        if stale:
            # Clock-driven, hence invisible to replay unless journaled.
            self._j({"kind": "timeout", "tasks": list(stale)})
        for tid in stale:
            task = self._doing.pop(tid).task
            if not self._stopped:
                self._todo.appendleft(task)
            trace.instant("lease:timeout", cat="lease", task=tid)

    def stop(self) -> None:
        """Stop handing out new tasks (reference: --max_steps reached).
        In-flight tasks still report normally; ``finished()`` turns True once
        they drain.  Sticky: no refill, and failed/timed-out/recovered tasks
        do not requeue afterwards."""
        with self._lock:
            self._j({"kind": "stop"})
            self._todo.clear()
            self._finished = True
            self._stopped = True

    # -- introspection --

    def finished(self) -> bool:
        with self._lock:
            return self._finished and not self._todo and not self._doing

    def counts(self) -> dict:
        with self._lock:
            return {
                "todo": len(self._todo),
                "doing": len(self._doing),
                "done": self._done_count,
                "abandoned": self._abandoned,
                "epoch": self._epoch,
                # r13 tail-tolerance accounting: total deadline-skip events,
                # per-task skip counts, and the explicit zero-double-train
                # counter (rejected late SUCCESS reports).
                "skipped": self._skipped_events,
                "skip_counts": dict(self._skip_counts),
                "duplicate_done": self._duplicate_done,
                "finished": self._finished and not self._todo and not self._doing,
            }
