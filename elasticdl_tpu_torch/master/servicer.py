"""The master RPC service: task hand-out, result/metric reports, rendezvous.

Reference parity (SURVEY.md §2 #2, §3.2 [U]; RPC names follow the upstream
Master service — GetTask / ReportTaskResult / ReportVersion — plus the
rendezvous and checkpoint surface the north star requires).  Handlers are
plain methods taking/returning dicts, so unit tests call them directly with
no network (the reference's decisive test pattern, SURVEY.md §4); ``serve()``
exposes the same handlers over gRPC for real deployments.

Method table (the wire contract):

  GetTask            {worker_id, lease?}               -> {task?, tasks?, finished}
  GetGroupTask       {worker_id, seq, version, lease?} -> {task?, finished, stale,
                                                          entries?}
  ReportTaskResult   {worker_id, task_id, success,
                      metrics?, weight?, model_version?} -> {accepted}
  ReportVersion      {worker_id, model_version}        -> {}
  RegisterWorker     {worker_id, address?, proto?}     -> membership
                      (proto != PROTOCOL_VERSION -> FAILED_PRECONDITION)
  DeregisterWorker   {worker_id}                       -> {version}
  Heartbeat          {worker_id}                       -> {version}
  GetMembership      {}                                -> membership
  GetCheckpoint      {}                                -> {path?, step}
  ReportCheckpoint   {path, step}                      -> {}
  JobStatus          {}                                -> counts + metrics
  DumpTrace          {}                                -> per-process trace
                                                         buffers + master's

Every method additionally accepts the optional ``trace`` envelope
(common/rpc.py): span context from the caller, and — on Heartbeat/Report
methods — bounded slices of the worker's trace ring buffer, which the
master accumulates per worker for DumpTrace (the live-job introspection
pull that tools/trace_dump.py merges into one Chrome trace).  Since r14
the same three methods carry the optional ``gauge`` envelope (a worker's
live-metrics registry snapshot); the master banks them per worker and
its /metrics endpoint serves the fleet-aggregated view plus the derived
goodput/SLO gauges (master/fleet_metrics.py, docs/observability.md).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent import futures
from typing import Dict, Optional

import grpc

from elasticdl_tpu_torch import chaos
from elasticdl_tpu_torch.common import locksan, trace
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.common.rpc import (
    GRPC_MESSAGE_OPTIONS,
    MASTER_SCHEMAS,
    PROTOCOL_VERSION,
    SERVICE_NAME,
    SchemaError,
    make_generic_handler,
)
from elasticdl_tpu_torch.master.evaluation_service import EvaluationService
from elasticdl_tpu_torch.master.rendezvous import RendezvousServer
from elasticdl_tpu_torch.master.task_dispatcher import (
    TASK_EVALUATION,
    TaskDispatcher,
)

logger = get_logger("master.servicer")


class MasterServicer:
    def __init__(
        self,
        dispatcher: TaskDispatcher,
        rendezvous: Optional[RendezvousServer] = None,
        evaluation: Optional[EvaluationService] = None,
        final_eval: bool = False,
        metrics_writer=None,
        max_steps: int = 0,
        epoch_end_eval: bool = False,
        gang_deadline_ms: float = 0.0,
        clock=time.monotonic,
    ):
        self.dispatcher = dispatcher
        self.rendezvous = rendezvous or RendezvousServer()
        self.evaluation = evaluation
        self.metrics_writer = metrics_writer
        # --max_steps: stop dispatching once the model version reaches it
        # (0 = until tasks exhausted).  Enforced in _bump_version.
        self._max_steps = max_steps
        self._max_steps_hit = False  # guarded-by: _lock
        # --evaluation_steps=0 ("eval at epoch end only"): an eval round at
        # every epoch boundary, driven by the dispatcher's epoch-end events.
        # Boundaries that fire while a round is in flight queue here
        # (FIFO of is_final flags) and retry from GetTask.
        self._pending_epoch_evals: list = []  # guarded-by: _lock
        self._epoch_end_eval = (
            epoch_end_eval and evaluation is not None and evaluation.enabled()
        )
        if self._epoch_end_eval:
            dispatcher.set_epoch_end_callback(self._on_epoch_end)
        self._written_eval_rounds = 0  # guarded-by: _lock
        self._lock = locksan.lock("MasterServicer._lock")
        self._model_version = 0  # guarded-by: _lock
        self._checkpoint: Dict[str, object] = {"path": None, "step": 0}  # guarded-by: _lock
        # Latest per-worker task-loop phase decomposition (cumulative
        # seconds; common/metrics.py PhaseTimers) — snapshots ride
        # ReportTaskResult/ReportCheckpoint and JobStatus republishes them,
        # so the train-job tool can attribute job-vs-bench throughput gaps
        # to named phases (VERDICT r5 Weak #1: the 5.4x gap was guessed).
        self._phase_times: Dict[str, dict] = {}  # guarded-by: _lock
        # Per-phase entry COUNTS (PhaseTimers.counts), beside the seconds:
        # sums alone cannot answer "how long is one lease RPC on average" —
        # counts make per-phase means computable from the same artifact.
        self._phase_counts: Dict[str, dict] = {}  # guarded-by: _lock
        # Per-worker trace buffers (bounded ring each, like the worker's
        # own): Heartbeat/Report-borne slices land here; DumpTrace reads
        # them.  clock_offset_us is the worker's RTT-midpoint estimate of
        # (master clock - worker clock), shipped alongside its events.
        self._trace_buffers: Dict[str, dict] = {}  # guarded-by: _lock
        # master wires _persist_progress here
        self._on_checkpoint = None  # guarded-by: _lock
        # final_eval: run one last eval round after the training tasks drain,
        # BEFORE reporting the job finished (the reference's end-of-job eval).
        # Triggered inside GetTask so workers can't race past the job end.
        # A shard-less eval service could never satisfy the trigger, so it
        # must not hold the job open.
        self._final_eval = (
            final_eval and evaluation is not None and evaluation.enabled()
        )
        self._final_eval_done = False  # guarded-by: _lock
        # A dead worker's tasks must be requeued in BOTH dispatchers.
        self.rendezvous.add_listener(self._on_membership_change)
        # Mutated by RegisterWorker (gRPC pool threads) AND the rendezvous
        # membership listener (reaper/watcher threads).
        self._known_workers: set = set()  # guarded-by: _lock
        # Multi-host lockstep task log (GetGroupTask): every process of a
        # jax.distributed world must execute the SAME task sequence, because
        # the jitted step is a collective across all their devices —
        # independent GetTask polls would deadlock the mesh (SURVEY.md §3.5;
        # VERDICT r2 Missing #2).  Entry ``seq`` is materialized through the
        # ordinary GetTask logic by whichever process asks first, attributed
        # to a per-membership-version pseudo worker so a world change
        # requeues the group's in-flight tasks.
        # GetGroupTask materializes entries through GetTask while holding
        # this lock, so it orders strictly before the state lock.
        self._group_lock = locksan.lock("MasterServicer._group_lock", before=("_lock",))  # lock-order: before(_lock)
        self._group_version: Optional[int] = None  # guarded-by: _group_lock
        self._group_log: list = []  # guarded-by: _group_lock
        # Deadline-bounded gang boundary (r13, --gang_deadline_ms): per-rank
        # lockstep ARRIVAL progress.  Heartbeats carry each rank's
        # ``gang_seq`` (entries whose dispatch it has BEGUN — see
        # _note_gang_progress_locked for why arrival, not consumption);
        # the head is the newest arrival any rank has shown plus the time
        # the gang's FRONT reached it.  A rank lagging the head past the
        # deadline is the straggler: its in-flight gang tasks requeue
        # through the dispatcher's skip accounting and the rank is
        # evicted so the gang re-forms without waiting out the full
        # task/heartbeat timeouts.  0 disables (pre-r13 behavior).
        self._gang_deadline_s = max(0.0, gang_deadline_ms) / 1e3
        self._clock = clock
        self._gang_arrivals: Dict[str, tuple] = {}  # guarded-by: _group_lock
        self._gang_head: tuple = (0, None)  # (seq, first-ask t)  guarded-by: _group_lock
        self._skipped_ranks: Dict[str, int] = {}  # guarded-by: _lock
        # r15 in-collective exclusions: newest cumulative count per
        # worker, heartbeat-borne (the in-step layer of the same
        # bounded-skip story _skipped_ranks tracks at the boundary).
        self._collective_skips: Dict[str, int] = {}  # guarded-by: _lock
        # Ranks maybe_skip_straggler evicted whose processes are still
        # alive: their background liveness beats keep arriving, and the
        # rendezvous heartbeat would REVIVE an unknown worker — re-adding
        # an unconfirmable wedged rank to the very membership the skip
        # just cut it from.  Heartbeat refuses the revival while a rank
        # is marked here; a deliberate RegisterWorker (the restart path)
        # clears the mark.  Bounded by the job's historical rank count.
        self._deadline_evicted: set = set()  # guarded-by: _lock
        # Warm-standby pool introspection (r13): master main wires the
        # PodManager's depth here; Heartbeat/JobStatus republish it so a
        # DRAINED pool is visible before the next failure needs it.
        self._standby_depth_fn = None  # guarded-by: _lock
        # Durable control-plane journal (r18, master/journal.py): the
        # servicer records its OWN nondeterministic inputs — lockstep
        # group-log entries, membership/model-version advances, the
        # per-worker report-seq ledger — beside the dispatcher's queue
        # events, all into one WAL.  None until the master wires it
        # (before the server starts); the REFERENCE is then read-only —
        # single-op reads from any handler thread — and rotation swaps
        # the fd INSIDE the journal while holding every recording lock
        # (rotate_journal), never this reference.
        self._journal = None  # single-writer: main
        # Per-worker highest report seq accepted (r18): the exactly-once
        # dedup ledger.  A worker's proxy retries a report whose first
        # attempt a dying master may or may not have applied; the seq
        # makes the retry idempotent — journaled with the report, so the
        # ledger survives the restart the retry is riding out.
        self._report_seqs: Dict[str, int] = {}  # guarded-by: _lock
        # Stale (seq-deduped) reports rejected since start — the
        # observable half of "rejects a stale pre-restart report exactly
        # once" (JobStatus republishes it).
        self._stale_reports = 0  # guarded-by: _lock
        # Last incarnation nonce each worker id registered with: a CHANGED
        # incarnation is a fresh process whose seq counter restarts at 1,
        # so its ledger entry resets — without this, a respawned worker
        # under a replayed ledger would have its first reports silently
        # deduped as pre-restart duplicates.  Deliberately NOT journaled:
        # a ride-through worker's retried report dedups BEFORE its
        # reconcile re-registration can reset anything (the task loop is
        # blocked inside that very call), and post-reset seqs only grow.
        self._worker_incarnations: Dict[str, str] = {}  # guarded-by: _lock
        # Journal replay stats stamped by a restarted master (JobStatus
        # republishes; the masterfail bench asserts on them).
        self._journal_stats: Dict[str, object] = {}  # guarded-by: _lock
        # graftgauge (r14): the fleet metrics plane.  Workers ship their
        # registry snapshot on the same heartbeat/report channel as the
        # trace slices (the additive ``gauge`` envelope); FleetMetrics
        # banks them and computes the aggregated view + goodput/SLO
        # gauges at SCRAPE time — the master's /metrics endpoint
        # (master/main.py) serves fleet.render().  Constructed here
        # unconditionally (stdlib, a dict bank: negligible without an
        # endpoint) so in-process tests and every master share one path.
        from elasticdl_tpu_torch.master.fleet_metrics import FleetMetrics

        self.fleet = FleetMetrics(self)

    # -- rendezvous listener: requeue tasks of evicted workers --

    def _on_membership_change(self, version: int, members) -> None:
        # Runs on rendezvous reaper/watcher threads while RegisterWorker
        # mutates the set from the gRPC pool: snapshot-and-swap under the
        # lock, requeue outside it (the dispatchers take their own locks —
        # holding ours across their calls would couple lock orders).
        with self._lock:
            gone = self._known_workers - set(members)
            self._known_workers = set(members)
            self._bound_departed_trace_buffers(set(members))
        for worker_id in gone:
            lost = self.dispatcher.recover_tasks(worker_id)
            lost_eval = (
                self.evaluation.recover_tasks(worker_id) if self.evaluation else []
            )
            if lost or lost_eval:
                logger.info(
                    "requeued %d train + %d eval tasks of %s",
                    len(lost), len(lost_eval), worker_id,
                )
        # The lockstep group's in-flight tasks are attributed to a
        # per-version pseudo worker, invisible to the per-worker requeue
        # above.  Any version change orphans them (every member restarts),
        # and waiting for a NEW group to pull is not enough — after a
        # scale-to-one the successor runs single-host and never calls
        # GetGroupTask.  Requeue now.
        with self._group_lock:
            gv, self._group_version = self._group_version, None
            self._group_log = []
            # Gang-boundary progress is per-world: a new membership gets a
            # fresh deadline clock (stale arrivals from the old world must
            # not instantly "skip" a member of the new one).
            self._gang_arrivals = {}
            self._gang_head = (0, None)
            if gv is not None:
                self._journal_record({"kind": "group_version", "version": None})
        with self._lock:
            # Under _lock like every servicer-side record: rotation holds
            # it, so this membership advance cannot land on the old fd
            # after the base snapshot was composed (and then exist in
            # neither file — a lost version that a restarted master would
            # re-issue to stale peers).
            self._journal_record({"kind": "membership", "version": version})
        if gv is not None and gv != version:
            lost = self.dispatcher.recover_tasks(self.group_worker_id(gv))
            if self.evaluation is not None:
                lost += self.evaluation.recover_tasks(self.group_worker_id(gv))
            if lost:
                logger.info(
                    "requeued %d lockstep tasks of group v%d", len(lost), gv
                )

    # -- durable journal (r18) --

    def _journal_record(self, ev: dict) -> None:
        """Record one servicer-side journal event.  Callers hold the lock
        of the subsystem whose state the event describes (``_group_lock``
        for group entries, ``_lock`` for version/seq advances) — the same
        under-the-owning-lock ordering contract the dispatcher keeps, and
        what makes the no-lock fd append safe (master/journal.py)."""
        if self._journal is not None:
            self._journal.record(ev)

    def set_journal(self, journal) -> None:
        """Wire the WAL (master main, after construction/replay).  The
        dispatcher shares the same journal object (attach_journal)."""
        with self._lock:
            self._journal = journal

    def adopt_replayed(self, replayed) -> None:
        """Adopt a ``journal.ReplayResult``'s servicer half: the restored
        lockstep log (so a reconnecting gang can keep walking its seq),
        the model version, and the report-seq dedup ledger.  Called
        before the server starts — no concurrent handlers yet."""
        with self._group_lock:
            self._group_version = replayed.group_version
            self._group_log = list(replayed.group_log)
        with self._lock:
            self._model_version = max(
                self._model_version, replayed.model_version
            )
            self._report_seqs = dict(replayed.report_seqs)
            self._worker_incarnations = dict(replayed.incarnations)
            self._journal_stats = {
                "restarts": replayed.restarts + 1,
                "replayed_events": replayed.events_applied,
                "torn_tail": replayed.torn_tail,
            }

    def rotate_journal(self) -> None:
        """Compaction: swap the WAL for a fresh file whose base record is
        the CURRENT full control-plane state.  Holds ``_group_lock`` +
        ``_lock`` across the dispatcher-side rotate (which holds the
        dispatcher's own lock around its snapshot + the fd swap), so
        every journal writer — each records under one of those three
        locks — is excluded while the file changes hands: no event can
        land between the base snapshot and the swap and be lost."""
        with self._group_lock:
            with self._lock:
                if self._journal is None:
                    return
                extras = {
                    "group_version": self._group_version,
                    "group_log": [dict(e) for e in self._group_log],
                    "model_version": self._model_version,
                    "membership_version": self.rendezvous.version(),
                    "report_seqs": dict(self._report_seqs),
                    "incarnations": dict(self._worker_incarnations),
                    "restarts": int(
                        self._journal_stats.get("restarts", 0) or 0
                    ),
                }
                self.dispatcher.rotate_journal(extras)

    # -- handlers (dict in, dict out) --

    # hot-path: one call per worker poll interval; must never sleep/block
    def GetTask(self, req: dict) -> dict:
        worker_id = req["worker_id"]
        # Batched lease (r9): hand out up to ``lease`` training tasks in
        # one RPC — the response's "tasks" carries the whole batch and
        # "task" stays its first element for pre-lease consumers.  Eval
        # tasks are never batched: a round wants its tasks spread across
        # workers and scored against one model version, so an eval hand-out
        # preempts the batch exactly as it preempted the single task.
        lease = max(1, int(req.get("lease", 1)))
        if self._epoch_end_eval:
            self._drain_pending_epoch_evals()
        # Eval rounds preempt training tasks so metrics snapshot a consistent
        # model version quickly (reference behavior: eval tasks share the queue
        # with priority).
        if self.evaluation is not None:
            # _final_eval is set-once at construction; _final_eval_done is
            # re-checked under the lock below (the old unlocked fast-path
            # read raced the setter).
            if self._final_eval and self.dispatcher.finished():
                # The flag is only set once trigger() actually starts the
                # round; a False return (periodic round still in flight)
                # leaves it unset, so job_finished() stays False and the
                # final round is retried on a later GetTask.  The lock
                # serializes concurrent GetTask callers.
                with self._lock:
                    version = self._model_version
                    if not self._final_eval_done and self.evaluation.trigger(
                        version
                    ):
                        self._final_eval_done = True
            task = self.evaluation.get_task(worker_id)
            if task is not None:
                return {"task": task.to_dict(), "finished": False}
        tasks = self.dispatcher.get_tasks(worker_id, lease)
        if not tasks:
            return {"task": None, "finished": self.job_finished()}
        dicts = [t.to_dict() for t in tasks]
        return {"task": dicts[0], "tasks": dicts, "finished": False}

    @staticmethod
    def group_worker_id(version: int) -> str:
        return f"__group_v{version}__"

    # hot-path: every rank polls this each task boundary
    def GetGroupTask(self, req: dict) -> dict:
        """Lockstep task hand-out for a multi-host worker group.

        All processes of membership ``version`` walk the same ``seq``-indexed
        log; a response with ``stale`` means the caller's world is gone and it
        must re-check membership (which restarts it in multihost mode).  A
        transient ``{task: None, finished: False}`` is NOT logged — callers
        retry the same seq.

        ``lease`` (r9) batches the log walk: the response's ``entries``
        carries up to ``lease`` consecutive log entries starting at ``seq``
        (materializing through GetTask as needed), and ``task``/``finished``
        mirror the first entry for pre-lease consumers.  Batching is pure
        read-ahead of the shared log — whichever member asks first
        materializes, every member sees the identical sequence, and a
        membership change still invalidates the whole log (and requeues its
        in-flight tasks) exactly as before.
        """
        seq = int(req["seq"])
        version = int(req["version"])
        lease = max(1, int(req.get("lease", 1)))
        # The boundary polices its own deadline: every crossing checks for
        # a rank lagging the gang head (Heartbeat covers the wedged-gang
        # case where no rank polls the boundary at all).
        self.maybe_skip_straggler()
        stale = {"task": None, "finished": False, "stale": True}
        if version != self.rendezvous.version():
            return stale
        with self._group_lock:
            if self._group_version != version:
                if self._group_version is not None:
                    # New world: the old group's in-flight tasks can never be
                    # reported (every member restarts) — requeue them now
                    # rather than waiting out the task timeout.
                    old = self.group_worker_id(self._group_version)
                    self.dispatcher.recover_tasks(old)
                    if self.evaluation is not None:
                        self.evaluation.recover_tasks(old)
                self._group_version = version
                self._group_log = []
                self._gang_arrivals = {}
                self._gang_head = (0, None)
                self._journal_record(
                    {"kind": "group_version", "version": version}
                )
            if seq > len(self._group_log):
                # A process can only be at most one entry ahead of the log;
                # anything else is a protocol bug or a stale world — restart.
                logger.warning(
                    "GetGroupTask seq %d ahead of log %d (v%d)",
                    seq, len(self._group_log), version,
                )
                return stale
            entries = []
            s = seq
            while len(entries) < lease:
                if s < len(self._group_log):
                    entries.append(self._group_log[s])
                else:
                    if entries and self._under_drain_or_eval_pressure():
                        # Every materialized entry commits the WHOLE gang
                        # to training it (lockstep contract), so read-ahead
                        # under a max-steps drain or a pending eval round
                        # would widen the overshoot/skew by up to
                        # lease_batch-1 tasks — fall back to the pre-lease
                        # one-entry-per-call walk until the pressure
                        # clears.  Already-logged entries above still
                        # serve: the gang is committed to those.
                        break
                    if not self.rendezvous.all_confirmed(version):
                        # A member still holds (or may hold) an older
                        # topology view; issuing a collective task now would
                        # wedge the others inside the collective waiting for
                        # it.  Withhold until every member has confirmed
                        # this version (heartbeat/registration).
                        break
                    resp = self.GetTask(
                        {"worker_id": self.group_worker_id(version)}
                    )
                    if resp["task"] is None and not resp["finished"]:
                        break  # transient: not logged, caller retries seq
                    entry = {"task": resp["task"], "finished": resp["finished"]}
                    self._group_log.append(entry)
                    # Journaled at materialization: every rank of a
                    # reconnecting gang resumes the SAME seq walk against
                    # the replayed log (the whole-gang lockstep contract
                    # must survive the master, not just the dispatcher).
                    self._journal_record({
                        "kind": "group_entry",
                        "seq": len(self._group_log) - 1,
                        "entry": dict(entry),
                    })
                    entries.append(entry)
                s += 1
                if entries[-1]["finished"]:
                    break  # the job-end marker closes the log
            if not entries:
                return {"task": None, "finished": False, "stale": False}
            return dict(
                entries[0], stale=False, entries=[dict(e) for e in entries]
            )

    def _note_gang_progress_locked(self, worker_id: str, seq: int) -> None:  # guarded-by: _group_lock
        """Monotonic per-rank lockstep ARRIVAL progress, fed exclusively
        from the heartbeat's ``gang_seq`` — the count of group entries
        whose device dispatch the rank has BEGUN (Worker._gang_dispatched).
        That counter is the one signal that separates the straggler from
        its victims once the gang wedges: the ranks blocked INSIDE the
        collective have counted the entry (they arrived, then blocked)
        while the rank that never reached the boundary has not — and it
        rides the background liveness beat, which keeps flowing when
        every task loop in the gang is blocked.  Consumption signals
        (boundary ask seq, popped-entry counts) are deliberately NOT fed
        here: lease batching and prep-ahead freeze every rank's
        consumption at the same value the moment the gang wedges, which
        would mask the lag this deadline exists to see."""
        now = self._clock()
        prev = self._gang_arrivals.get(worker_id)
        if prev is None or seq > prev[0]:
            self._gang_arrivals[worker_id] = (seq, now)
        if seq > self._gang_head[0] or self._gang_head[1] is None:
            self._gang_head = (seq, now)

    def note_gang_progress(self, worker_id: str, seq: int, version) -> None:
        """Heartbeat-side progress feed (see _note_gang_progress_locked);
        version-gated so a beat from a stale world cannot seed the new
        world's deadline clock."""
        with self._group_lock:
            if self._group_version is None or version != self._group_version:
                return
            self._note_gang_progress_locked(worker_id, seq)

    # hot-path: rides every Heartbeat and GetGroupTask — the steady state
    # is a bounded dict scan under the group lock; the eviction branch
    # fires at most once per deadline window
    def maybe_skip_straggler(self) -> Optional[str]:
        """Deadline-bounded gang boundary (r13): when a rank lags the
        gang's newest lockstep seq past ``gang_deadline_ms``, SKIP it —
        requeue the gang's in-flight tasks through the dispatcher's
        bounded skip accounting, then evict the rank so the membership
        bump re-forms the gang without it (the straggler's own restart
        path re-joins it at the next reform).  Driven from Heartbeat as
        well as GetGroupTask because a wedged gang stops polling the
        boundary: the fast ranks are blocked inside the collective on the
        straggler, and only the background heartbeat threads still reach
        the master.  Returns the skipped worker id, or None."""
        if not self._gang_deadline_s:
            return None
        with self._group_lock:
            version = self._group_version
            head_seq, head_t = self._gang_head
            if version is None or head_t is None:
                return None
            now = self._clock()
            if now - head_t < self._gang_deadline_s:
                return None
            behind = [
                (s, w) for w, (s, _) in self._gang_arrivals.items()
                if s < head_seq
            ]
            if not behind:
                return None
            behind.sort()
            seq_behind, straggler = behind[0]
            # One eviction per deadline window: the clock restarts so a
            # second laggard gets its own full deadline against the
            # (re-formed) gang rather than being batch-evicted with the
            # first — skips must stay attributable one rank at a time.
            self._gang_head = (head_seq, now)
            self._gang_arrivals.pop(straggler, None)
        trace.instant(
            "gang:skip", cat="gang", worker=straggler, seq=seq_behind,
            head_seq=head_seq, version=version,
            deadline_ms=self._gang_deadline_s * 1e3,
        )
        with self._lock:
            self._skipped_ranks[straggler] = (
                self._skipped_ranks.get(straggler, 0) + 1
            )
            # Marked BEFORE rendezvous.remove below: a beat landing in the
            # gap would otherwise revive the rank the moment it is removed.
            self._deadline_evicted.add(straggler)
        # Skip-accounted requeue BEFORE the membership bump: the generic
        # invalidation path (_on_membership_change) would requeue the same
        # tasks without charging the skip budget, and unbounded free skips
        # are exactly what lets a poison shard wedge the gang forever.
        skipped = self.dispatcher.skip_tasks(self.group_worker_id(version))
        logger.warning(
            "gang deadline: rank %s lags boundary seq %d (gang head %d) "
            "past %.0f ms — skipping it (%d in-flight gang task(s) "
            "requeued with skip accounting)",
            straggler, seq_behind, head_seq, self._gang_deadline_s * 1e3,
            len(skipped),
        )
        self.rendezvous.remove(straggler)
        return straggler

    def _under_drain_or_eval_pressure(self) -> bool:
        """True when new lockstep-log entries should not be materialized
        ahead of need: the max-steps drain has begun, or an eval round has
        undispatched tasks (the group-mode twin of the worker-side
        draining/eval_pending heartbeat handling, which group workers
        deliberately skip — the log, not the worker, owns the gang's
        order)."""
        with self._lock:
            if self._max_steps_hit:
                return True
        return self.evaluation is not None and self.evaluation.tasks_pending()

    def job_finished(self) -> bool:
        """True when training tasks drained AND any pending/in-flight eval is done."""
        if not self.dispatcher.finished():
            return False
        if self.evaluation is None:
            return True
        with self._lock:
            if self._final_eval and not self._final_eval_done:
                return False
            if self._pending_epoch_evals:
                return False  # queued epoch-boundary rounds still owed
        return not self.evaluation.round_in_flight()

    # hot-path: rides every completed task's report RPC
    def ReportTaskResult(self, req: dict) -> dict:
        task_id = int(req["task_id"])
        success = bool(req.get("success", True))
        task_type = req.get("task_type", "")
        self._record_phase_times(req)
        self._record_trace(req)
        # stream=True: one JSONL "gauge" record per successful training
        # report, beside the "phase" record — the same crash-safe channel
        # and cadence.
        self._record_gauges(req, stream=True)
        # Report-seq dedup (r18): the worker numbers its reports, the
        # proxy's outage ride-through may RETRY one whose first attempt
        # the dying master already applied+journaled — the replayed seq
        # ledger rejects the duplicate here, before any counter moves, so
        # exactly-once holds across the restart without inflating
        # duplicate_done (that counter keeps meaning what r13 defined:
        # late success for a task requeued by timeout/skip).
        seq = req.get("seq")
        worker_id = req.get("worker_id", "")
        if seq is not None and worker_id:
            seq = int(seq)
            # CHECK here, ADVANCE only after the report has applied (and
            # therefore journaled, inside dispatcher.report's critical
            # section).  Advancing first opened a crash window where a
            # rotation between ledger update and report journal persisted
            # a base whose ledger was AHEAD of its task state — the
            # retried report then deduped against work the replay never
            # counted (silent double-train).  With check-then-apply-then-
            # advance, the worst interleaving is the mirror image — a
            # base with the report counted but the ledger behind — and a
            # replayed retry lands in the r13 late-success path instead:
            # rejected, observable in duplicate_done, nothing retrained.
            # Per-worker seqs arrive serialized (one task loop, and the
            # preemption hand-off parks it), so check-then-later-advance
            # does not race itself.
            with self._lock:
                stale = seq <= self._report_seqs.get(worker_id, 0)
                if stale:
                    self._stale_reports += 1
            if stale:
                trace.instant(
                    "lease:dedup", cat="lease", worker=worker_id,
                    task=task_id, seq=seq,
                )
                logger.info(
                    "deduplicated stale report seq %d from %s (task %d) — "
                    "already applied before the restart", seq, worker_id,
                    task_id,
                )
                return {"accepted": True, "duplicate": True}
        if task_type == TASK_EVALUATION and self.evaluation is not None:
            # Metrics BEFORE report_task: completing the round's last task
            # snapshots the aggregate.
            eval_metrics = req.get("metrics")
            if success and eval_metrics:
                self.evaluation.report_metrics(
                    # Scalars coerce to float; histogram metrics (streaming
                    # AUC) arrive as lists and aggregate elementwise.
                    {
                        k: v if isinstance(v, (list, tuple)) else float(v)
                        for k, v in eval_metrics.items()
                    },
                    float(req.get("weight", 1.0)),
                )
            accepted = self.evaluation.report_task(task_id, success)
            self._maybe_write_eval_metrics()
            if seq is not None and worker_id:
                # Eval rounds are not journal-replayed (a restart re-runs
                # them), but the seq LEDGER must still survive or a
                # retried eval report could double-apply after a restart.
                with self._lock:
                    self._journal_record(
                        {"kind": "report_seq", "worker": worker_id,
                         "seq": seq}
                    )
                    self._report_seqs[worker_id] = max(
                        self._report_seqs.get(worker_id, 0), seq
                    )
        else:
            accepted = self.dispatcher.report(
                task_id, success, req.get("worker_id", ""),
                requeue_only=bool(req.get("requeue", False)),
                seq=seq if worker_id else None,
            )
            if seq is not None and worker_id:
                # Advance AFTER the apply+journal (see the check above).
                with self._lock:
                    self._report_seqs[worker_id] = max(
                        self._report_seqs.get(worker_id, 0), seq
                    )
            train_metrics = req.get("metrics")
            if success and accepted and train_metrics and self.metrics_writer:
                with self._lock:
                    fallback_version = self._model_version
                self.metrics_writer.write(
                    "train",
                    int(req.get("model_version", fallback_version)),
                    train_metrics,
                )
        model_version = req.get("model_version")
        if model_version is not None:
            self._bump_version(int(model_version))
        # graftchaos (r18): kill:target=master,step=N fires HERE, after
        # the report is applied AND journaled — the crash the masterfail
        # bench injects lands exactly where a real one is hardest: a
        # worker whose acked-but-unanswered report must dedup, not
        # double-train, across the restart.  ``step`` is the dispatcher's
        # cumulative done count; gated so the unarmed path never pays the
        # counts() lock.
        if chaos.enabled():
            chaos.hook(
                "master:report", step=self.dispatcher.counts()["done"]
            )
        return {"accepted": accepted}

    # hot-path: called from every report AND every heartbeat
    def _record_phase_times(self, req: dict, stream: bool = True) -> None:
        """Keep the newest phase snapshot per worker (cumulative, so latest
        wins) and mirror it to the metrics stream when one is configured —
        one "phase" JSONL record per successful training report, the same
        crash-safe channel the train/eval scalars use.  ``stream=False``
        updates only the in-memory slot (heartbeat-borne snapshots arrive
        every poll interval; mirroring each would flood the JSONL)."""
        phases = req.get("phase_times")
        if not phases:
            return
        worker_id = req.get("worker_id", "")
        if not worker_id:
            # A snapshot that cannot be keyed to its worker would sit
            # beside the same worker's real entry and double-count in any
            # consumer summing across workers (the timers are cumulative).
            return
        counts = req.get("phase_counts")
        with self._lock:
            self._phase_times[worker_id] = dict(phases)
            if counts:
                self._phase_counts[worker_id] = dict(counts)
            fallback_version = self._model_version
        if (
            stream
            and self.metrics_writer is not None
            and req.get("success", True)
            and req.get("task_type", "") not in (TASK_EVALUATION,)
        ):
            try:
                self.metrics_writer.write(
                    "phase",
                    int(req.get("model_version", fallback_version)),
                    {k: float(v) for k, v in phases.items()},
                )
            except Exception:  # malformed values must not fail the report
                logger.exception("phase_times metrics write failed")

    #: Bound on each worker's master-side trace ring (events).  A straggler
    #: hunt wants the RECENT window, so overwrite-oldest per worker — the
    #: same policy as the worker's own ring.
    TRACE_BUFFER_EVENTS = 65536

    #: How many DEPARTED workers' trace rings the master retains (most
    #: recently updated win).  Keeping some is deliberate — a finished
    #: worker's job-end tail is dumped AFTER it exits, and a crashed
    #: straggler's final window is exactly what an investigation wants —
    #: but each ring is up to ~10 MB, so without a cap a long elastic job
    #: would grow memory with HISTORICAL membership, not current world
    #: size.  (The per-worker phase_times/phase_counts dicts stay for all
    #: departed workers on purpose: they are a few floats each, and the
    #: gang artifacts read them after the fleet exits.)
    TRACE_DEPARTED_KEEP = 8

    def _bound_departed_trace_buffers(self, members: set) -> None:  # guarded-by: _lock
        # Plain loop, no sort-key closure: a lambda would not inherit the
        # caller-holds-lock annotation (lock-discipline's closure rule).
        by_age = []
        for w, buf in self._trace_buffers.items():
            if w not in members:
                by_age.append((buf["updated"], w))
        by_age.sort()  # oldest-updated first
        for _, w in by_age[: max(0, len(by_age) - self.TRACE_DEPARTED_KEEP)]:
            del self._trace_buffers[w]

    # hot-path: rides every report and heartbeat — a bounded deque extend
    # under the state lock, never an RPC or an export
    def _record_trace(self, req: dict) -> None:
        """Bank a Heartbeat/Report-borne trace slice into the sender's
        master-side ring.  Slices are DRAINED from the worker's buffer, so
        this is the sole surviving copy — DumpTrace republishes it."""
        payload = req.get("trace")
        if not isinstance(payload, dict):
            return
        events = payload.get("events")
        if not events:
            return
        worker_id = req.get("worker_id", "")
        if not worker_id:
            return  # unattributable events cannot merge into a per-process view
        with self._lock:
            buf = self._trace_buffers.get(worker_id)
            if buf is None:
                buf = self._trace_buffers[worker_id] = {
                    "events": deque(maxlen=self.TRACE_BUFFER_EVENTS),
                    "clock_offset_us": None,
                    "dropped": 0,
                    "updated": 0.0,
                }
            buf["updated"] = trace.now_us()
            buf["events"].extend(e for e in events if isinstance(e, dict))
            # Type-checked, never coerced: telemetry riding a heartbeat
            # must not be able to crash the heartbeat — a peer shipping a
            # malformed offset would otherwise never beat again and time
            # out of the membership.
            offset = payload.get("clock_offset_us")
            if isinstance(offset, (int, float)) and not isinstance(offset, bool):
                buf["clock_offset_us"] = float(offset)
            dropped = payload.get("dropped")
            if isinstance(dropped, int) and not isinstance(dropped, bool):
                buf["dropped"] = dropped

    def DumpTrace(self, req: dict) -> dict:
        """The live-job introspection pull: every process's shipped trace
        window plus the master's own recorder.  Non-draining — operators
        dump a RUNNING job without perturbing what the next dump sees
        (beyond the rings' natural overwrite)."""
        with self._lock:
            processes = {
                w: {
                    "events": list(b["events"]),
                    "clock_offset_us": b["clock_offset_us"],
                    "dropped": b["dropped"],
                }
                for w, b in self._trace_buffers.items()
            }
        return {
            "processes": processes,
            # The master's own spans (rpc.server, dispatcher lease events)
            # — already on the reference clock every offset aims at.
            "master_events": trace.default().export(),
            "master_dropped": trace.default().dropped,
            "master_now_us": trace.now_us(),
        }

    # hot-path: rides every report and heartbeat — a dict-bank assignment
    # plus one rate-window append, never an aggregation walk (that is
    # scrape-side work, the gauge-discipline split)
    def _record_gauges(self, req: dict, stream: bool = False) -> None:
        """Bank a Heartbeat/Report-borne gauge envelope into the fleet
        view.  ``stream=True`` (checkpoint reports — bounded frequency,
        the phase-mirror stance inverted: heartbeats arrive every poll
        interval and would flood the JSONL) also mirrors the envelope's
        ``JSONL_GAUGE_FAMILIES`` scalars into the metrics stream under
        the SAME family names the live scrape serves — the one naming
        table, so offline JSONL analysis and live scrapes cannot
        drift."""
        payload = req.get("gauge")
        if not isinstance(payload, dict):
            return
        worker_id = req.get("worker_id", "")
        if not worker_id:
            return  # unattributable families cannot join a per-worker view
        self.fleet.record_envelope(worker_id, payload)
        if stream and (
            not req.get("success", True)
            or req.get("task_type", "") == TASK_EVALUATION
        ):
            stream = False  # the phase-mirror gating, same reasons
        if stream and self.metrics_writer is not None:
            mirror = self.fleet.jsonl_mirror(worker_id, payload)
            if mirror:
                with self._lock:
                    version = self._model_version
                try:
                    self.metrics_writer.write("gauge", version, mirror)
                except Exception:  # malformed values must not fail the RPC
                    logger.exception("gauge metrics write failed")

    def gang_lag_snapshot(self) -> Dict[str, float]:
        """Per-rank seconds behind the gang head's lockstep arrival
        (r13's deadline signal, read live for the metrics plane).  Ranks
        at the head read 0.0; a trailing rank reads ``now - head_t`` —
        the exact clock ``maybe_skip_straggler`` judges against (time
        since the head arrived with this rank still absent), NOT time
        since the rank's own previous arrival, which would overstate lag
        by a full step even on a healthy gang.  Empty outside group
        mode."""
        with self._group_lock:
            head_seq, head_t = self._gang_head
            if self._group_version is None or head_t is None:
                return {}
            now = self._clock()
            return {
                w: (round(max(now - head_t, 0.0), 3) if seq < head_seq
                    else 0.0)
                for w, (seq, _t) in self._gang_arrivals.items()
            }

    def fleet_state_snapshot(self) -> dict:
        """The master-side state the fleet collector aggregates, read
        under the state lock in one place (FleetMetrics must not grope
        guarded attributes cross-class)."""
        with self._lock:
            state = {
                "model_version": self._model_version,
                "skipped_ranks": dict(self._skipped_ranks),
                "collective_skips": dict(self._collective_skips),
                "phase_times": {
                    w: dict(p) for w, p in self._phase_times.items()
                },
            }
            depth_fn = self._standby_depth_fn
        state["standby_depth"] = depth_fn() if depth_fn is not None else None
        return state

    def _maybe_write_eval_metrics(self) -> None:
        """Record each completed eval round's aggregate exactly once.  The
        check-and-set runs under the lock: ReportTaskResult handlers run on
        the gRPC thread pool, and two workers finishing a round's last tasks
        concurrently must not both (or neither) write it."""
        if self.metrics_writer is None or self.evaluation is None:
            return
        with self._lock:
            rounds = self.evaluation.completed_rounds()
            if rounds <= self._written_eval_rounds:
                return
            self._written_eval_rounds = rounds
            version = self._model_version
            # Snapshot INSIDE the lock: if round N+1 completes while this
            # thread is descheduled, a late read would record N+1's
            # aggregate under N's slot and lose N's entirely.
            metrics = self.evaluation.latest_metrics()
        self.metrics_writer.write("eval", version, metrics)

    def ReportVersion(self, req: dict) -> dict:
        self._bump_version(int(req["model_version"]))
        return {}

    def _on_epoch_end(self, epoch: int, final: bool) -> None:
        """Epoch-boundary eval (--evaluation_steps=0).  A boundary whose
        round cannot start yet (previous round still in flight — routine,
        since eval and training tasks run concurrently) is QUEUED and
        retried from GetTask, never dropped; job_finished holds the job open
        until the queue drains.  The final epoch's round doubles as the
        end-of-job eval."""
        with self._lock:
            self._pending_epoch_evals.append(final)
        logger.info("epoch %d ended (final=%s): eval round queued", epoch, final)
        self._drain_pending_epoch_evals()

    def _drain_pending_epoch_evals(self) -> None:
        with self._lock:
            if not self._pending_epoch_evals:
                return
            version = self._model_version
            final = self._pending_epoch_evals[0]
        if not self.evaluation.trigger(version):
            return  # round in flight; retried on a later GetTask
        with self._lock:
            self._pending_epoch_evals.pop(0)
            if final:
                self._final_eval_done = True

    def _bump_version(self, version: int) -> None:
        with self._lock:
            advanced = version > self._model_version
            self._model_version = max(self._model_version, version)
            current = self._model_version
            if advanced:
                # The restored version seeds max_steps/eval triggers on
                # restart; monotone, so replay max()es duplicates away.
                self._journal_record(
                    {"kind": "model_version", "version": current}
                )
            # Check-and-set under the lock: two reports crossing max_steps
            # concurrently must not both win the "first to hit" test (the
            # log fired twice and dispatcher.stop() ran twice).
            hit = bool(
                self._max_steps
                and current >= self._max_steps
                and not self._max_steps_hit
            )
            if hit:
                self._max_steps_hit = True
        if hit:
            logger.info(
                "max_steps %d reached (version %d): draining task queue",
                self._max_steps, current,
            )
            self.dispatcher.stop()
        if self.evaluation is not None:
            self.evaluation.maybe_trigger(current)

    def RegisterWorker(self, req: dict) -> dict:
        # Wire-version negotiation: a mismatched worker is turned away HERE,
        # at its first RPC, with an error naming both versions — not N tasks
        # later with an opaque schema violation.  Absent field = accepted
        # (pre-versioning peer; proto3 unknown-field stance).
        proto = req.get("proto")
        if proto is not None and proto != PROTOCOL_VERSION:
            raise SchemaError(
                f"protocol version mismatch: worker speaks v{proto}, "
                f"master speaks v{PROTOCOL_VERSION} — upgrade the older side"
            )
        with self._lock:
            # A deliberate (re-)registration is the restart path out of a
            # deadline eviction — lift the Heartbeat revival block first so
            # the rank's beats count again the moment it is a member.
            self._deadline_evicted.discard(req["worker_id"])
        self.rendezvous.register(req["worker_id"], req.get("address", ""))
        with self._lock:
            self._known_workers.add(req["worker_id"])
        membership = self.rendezvous.membership()
        incarnation = req.get("incarnation")
        if incarnation:
            with self._lock:
                prev = self._worker_incarnations.get(req["worker_id"])
                if prev != incarnation:
                    self._worker_incarnations[req["worker_id"]] = incarnation
                    stale_ledger = self._report_seqs.pop(
                        req["worker_id"], None
                    )
                    # The reset is JOURNALED (under _lock, rotation-safe):
                    # without it a replay would max() the base's dead-
                    # incarnation seq back over the fresh incarnation's
                    # low seqs and wrongly dedup its in-flight retry — a
                    # second-order double-train window.
                    self._journal_record({
                        "kind": "incarnation",
                        "worker": req["worker_id"],
                        "incarnation": incarnation,
                    })
                else:
                    stale_ledger = None
            if stale_ledger is not None:
                logger.info(
                    "worker %s registered a fresh incarnation (%s): "
                    "report-seq ledger reset from %d (its counter "
                    "restarts at 1)",
                    req["worker_id"], incarnation, stale_ledger,
                )
        # Lease reconciliation (r18): a worker declaring what it HOLDS —
        # the reconnect handshake after a master restart (held = its
        # buffered leases + in-flight preps + pending report), and the
        # fresh-boot declaration (held = []), which requeues a dead
        # incarnation's leases NOW instead of after task_timeout_s.  The
        # response's stale_tasks names held work this master no longer
        # attributes to the worker; training it would double-train.
        held = req.get("held_tasks")
        if held is not None:
            requeued, stale_ids = self.dispatcher.reconcile_leases(
                req["worker_id"],
                {int(t) for t in held if isinstance(t, (int, float))},
            )
            if requeued or stale_ids:
                logger.info(
                    "reconciled %s (incarnation %s): requeued %d lost "
                    "lease(s) %s, %d stale held id(s) %s",
                    req["worker_id"], req.get("incarnation", "?"),
                    len(requeued), [t.task_id for t in requeued],
                    len(stale_ids), stale_ids,
                )
            membership = dict(membership, stale_tasks=stale_ids)
        return membership

    def DeregisterWorker(self, req: dict) -> dict:
        """Active leave.  A lockstep group member that failed a task calls
        this before restarting: the version bump makes every peer resync
        instead of wedging in a collective the failed member will never
        join (and requeues the member's in-flight tasks)."""
        with self._lock:
            self._deadline_evicted.discard(req["worker_id"])
        return {"version": self.rendezvous.remove(req["worker_id"])}

    # hot-path: every worker beats every poll interval
    def Heartbeat(self, req: dict) -> dict:
        # Group-mode non-rank-0 members attach their phase snapshot here
        # (their reports are rank-0-gated away); slot update only, no
        # metrics-stream mirror — heartbeats arrive every poll interval.
        self._record_phase_times(req, stream=False)
        # Trace slices ride the heartbeat (the pull path's supply side).
        self._record_trace(req)
        # Gauge envelopes too (r14): the beat is the one RPC still
        # flowing from a wedged gang, so the fleet view stays live
        # exactly when the operator needs it.  Bank-only — the JSONL
        # mirror rides checkpoint reports (bounded frequency).
        self._record_gauges(req)
        # In-collective skip ledger (r15): the worker's cumulative
        # in-step exclusions — newest value wins (the counter only
        # grows), banked beside the r13 per-rank boundary skips so
        # JobStatus serves both layers of the deadline story.
        cs = req.get("collective_skips")
        if cs is not None:
            with self._lock:
                self._collective_skips[req["worker_id"]] = int(cs)
        # Gang-deadline watchdog (r13): heartbeats are the only RPCs still
        # arriving when the whole gang is wedged in a collective on a
        # straggler — the beat both FEEDS the per-rank progress signal
        # (gang_seq, the dispatch counter boundary asks cannot carry) and
        # drives the skip decision on it.
        if self._gang_deadline_s:
            # Whole block gated: with the deadline off, _deadline_evicted
            # has no writer — non-gang jobs keep the pre-r13 per-beat cost.
            with self._lock:
                evicted = req["worker_id"] in self._deadline_evicted
            if not evicted:
                gang_seq = req.get("gang_seq")
                if gang_seq is not None:
                    self.note_gang_progress(
                        req["worker_id"], int(gang_seq), req.get("version")
                    )
                self.maybe_skip_straggler()
                # Re-check: the skip above can evict THIS rank — the
                # straggler's own beat is often the one that trips the
                # deadline — and a concurrent beat can evict it at any
                # point before the rendezvous call below.
                with self._lock:
                    evicted = req["worker_id"] in self._deadline_evicted
            if evicted:
                # A refused beat can be arbitrarily delayed between the
                # checks above and here while the rank deliberately
                # re-registers (clearing the mark): confirm the mark one
                # final time right before acting, so the remove below
                # cannot eject a legitimately re-joined member.  This
                # shrinks the raced-removal window from an arbitrary
                # handler delay to a few instructions (it cannot be zero:
                # holding _lock across the remove would invert against
                # the membership listener, which takes _lock).
                with self._lock:
                    evicted = req["worker_id"] in self._deadline_evicted
            if evicted:
                # Deadline-skipped rank whose process is still alive: its
                # beat must NOT feed gang progress (it is no longer a
                # member of the boundary) and must NOT reach
                # rendezvous.heartbeat, whose unknown-worker path would
                # re-register it unconfirmed — undoing the eviction and
                # wedging the reform on a rank that cannot confirm.  Two
                # self-healing undos cover the inherent check-then-act
                # races against a concurrent beat's eviction: drop any
                # stale arrival this rank's note_gang_progress re-seeded
                # after the skip popped it (left behind, it could fake a
                # SECOND eviction of the same stall a deadline later,
                # double-charging the skip budget), and the remove below
                # both reads the CURRENT version (a bump-free read when
                # the rank is already out, the steady state) and undoes a
                # raced revival.  The version mismatch drives the rank's
                # own restart (loop heartbeat → WorkerRestartRequired, or
                # the death-push grace); the relaunch re-registers
                # deliberately, clearing the mark.
                with self._group_lock:
                    self._gang_arrivals.pop(req["worker_id"], None)
                return {
                    "version": self.rendezvous.remove(req["worker_id"]),
                    "server_ts_us": trace.now_us(),
                }
            # Mark lifted while this beat was in flight: fall through to
            # the normal beat — the rank is a member again.
        resp = {
            "version": self.rendezvous.heartbeat(
                req["worker_id"], req.get("version")
            ),
            # Master clock stamp for the worker's RTT-midpoint clock-offset
            # estimate (clients measure t0/t1 locally around this RPC);
            # cheap enough to ride every beat unconditionally.
            "server_ts_us": trace.now_us(),
        }
        # Eval-preemption hint (r9): batched leases would otherwise let a
        # worker train up to lease_batch-1 buffered tasks before its next
        # GetTask sees a pending eval round, widening the round's
        # model-version skew — the hint makes lease-holding workers return
        # their buffer (immediate requeue) and pull the eval work instead.
        if self.evaluation is not None and self.evaluation.tasks_pending():
            resp["eval_pending"] = True
        # Standby-pool depth (r13): riding the beat keeps a DRAINED warm
        # pool visible to operators/benches before the next failure needs
        # a spare (the fn reads one leaf lock; None = no pool wired).
        with self._lock:
            depth_fn = self._standby_depth_fn
        if depth_fn is not None:
            depth = depth_fn()
            if depth is not None:
                resp["standby_pool"] = int(depth)
        # Drain hint (r9): past --max_steps the dispatcher stops, but it
        # cannot recall leases a worker already buffers — without the hint
        # the worker would train up to lease_batch-1 tasks beyond the
        # configured limit.  On seeing it the worker returns its buffer;
        # the STOPPED dispatcher drops the returned tasks (they must not
        # retrain), restoring the pre-lease overshoot bound.
        with self._lock:
            if self._max_steps_hit:
                resp["draining"] = True
        return resp

    def GetMembership(self, req: dict) -> dict:
        return self.rendezvous.membership()

    def GetCheckpoint(self, req: dict) -> dict:
        with self._lock:
            return dict(self._checkpoint)

    def ReportCheckpoint(self, req: dict) -> dict:
        self._record_phase_times(req)
        self._record_trace(req)
        self._record_gauges(req, stream=True)
        with self._lock:
            if int(req["step"]) >= int(self._checkpoint["step"] or 0):
                self._checkpoint = {"path": req["path"], "step": int(req["step"])}
            cb = self._on_checkpoint
        if cb is not None:
            # Master persists the task watermark HERE — coupled to the model
            # checkpoint, never ahead of it (a watermark newer than the
            # restorable model would skip shards whose updates the restored
            # model never saw).
            cb(int(req["step"]))
        return {}

    def set_checkpoint_callback(self, fn) -> None:
        with self._lock:
            self._on_checkpoint = fn

    def set_standby_depth(self, fn) -> None:
        """Wire a callable returning the warm-standby pool depth (master
        main passes PodManager.standby_depth); Heartbeat/JobStatus
        republish it."""
        with self._lock:
            self._standby_depth_fn = fn

    def JobStatus(self, req: dict) -> dict:
        status = self.dispatcher.counts()
        with self._lock:
            status["model_version"] = self._model_version
            status["phase_times"] = {
                w: dict(p) for w, p in self._phase_times.items()
            }
            status["phase_counts"] = {
                w: dict(c) for w, c in self._phase_counts.items()
            }
            # r13 tail tolerance: per-rank deadline-skip counts, beside
            # the dispatcher's per-task accounting already in ``status``.
            status["skipped_ranks"] = dict(self._skipped_ranks)
            # r15 graftreduce: in-collective exclusions per worker (the
            # in-step layer of the same bounded-skip accounting).
            status["collective_skips"] = dict(self._collective_skips)
            # r18 master crash survivability: seq-deduped stale reports
            # (the exactly-once proof's second counter, beside
            # duplicate_done) and the journal replay stats of a restarted
            # master (restarts / replayed_events / torn_tail).
            status["stale_reports"] = self._stale_reports
            if self._journal_stats:
                status["journal"] = dict(self._journal_stats)
            depth_fn = self._standby_depth_fn
        if depth_fn is not None:
            depth = depth_fn()
            if depth is not None:
                status["standby_pool"] = int(depth)
        if self.evaluation is not None:
            status["eval_metrics"] = self.evaluation.latest_metrics()
            status["eval_rounds"] = self.evaluation.completed_rounds()
        return status

    # -- wiring --

    def method_table(self) -> dict:
        return {
            name: getattr(self, name)
            for name in (
                "GetTask",
                "GetGroupTask",
                "ReportTaskResult",
                "ReportVersion",
                "RegisterWorker",
                "DeregisterWorker",
                "Heartbeat",
                "GetMembership",
                "GetCheckpoint",
                "ReportCheckpoint",
                "JobStatus",
                "DumpTrace",
            )
        }


class MasterServer:
    """gRPC server hosting a MasterServicer on ``port`` (0 = ephemeral)."""

    def __init__(
        self,
        servicer: MasterServicer,
        port: int = 0,
        max_workers: int = 32,
        advertise_host: str = "localhost",
    ):
        self.servicer = servicer
        # Message cap raised on both sides (GRPC_MESSAGE_OPTIONS): the
        # DumpTrace response can carry several full per-process trace
        # rings — far past the 4 MB control-plane default.
        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=max_workers),
            options=GRPC_MESSAGE_OPTIONS,
        )
        self._server.add_generic_rpc_handlers(
            (
                make_generic_handler(
                    SERVICE_NAME, servicer.method_table(), schemas=MASTER_SCHEMAS
                ),
            )
        )
        self.port = self._server.add_insecure_port(f"[::]:{port}")
        # The host workers dial; for cluster deployments this must be a
        # cross-pod-reachable address (pod IP / headless-service name), not
        # localhost — see Master._advertise_host.
        self.advertise_host = advertise_host

    @property
    def address(self) -> str:
        return f"{self.advertise_host}:{self.port}"

    def start(self) -> "MasterServer":
        self._server.start()
        logger.info("master gRPC service on %s", self.address)
        return self

    def stop(self, grace: float = 1.0) -> None:
        self._server.stop(grace)
