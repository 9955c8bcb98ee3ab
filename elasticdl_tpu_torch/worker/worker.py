"""The worker task loop of the PyTorch port: one device a process, alone
or in a gang of processes.

Port of ``elasticdl_tpu/worker/worker.py`` for a single process on one
device: lease a task from the master -> read its shard -> run its full
minibatches as one ``Trainer.train_scan`` (one CUDA-graph replay a task on
the card) and its wrap-padded tail as one more step -> report; evaluation
and prediction tasks between them (evaluation fused too, ``eval_scan``); a background checkpoint every ``checkpoint_steps`` that the serving
tier picks up from the published manifest; restore from the newest
checkpoint at start, and after a failed step the newest live state
(``TrainLoopError.state``) or else the newest checkpoint.

What stays the reference's: the two master proxies (``DirectMasterProxy``,
``RpcMasterProxy`` with its outage ride-through), the lease loop
(``_next_lease``, batched leases returned on an eval-pending or draining
heartbeat), task-level pipelining (``_flush``: the previous task's
metrics fetch, report and checkpoint hook after this task's steps are
dispatched), prep-ahead (``_prep_queue``: the host half of up to
``prep_depth`` leased tasks read, decoded and stacked on prep threads, the
oldest dispatched once the queue exceeds its depth), the wrap-padded tails
with their ``__mask__``, count-weighted eval means reported raw, report
sequence numbers, phase timers (with the card's own clock on each training
task: ``device_task`` and ``device_gap``, ``DeviceTaskClock``), the
checkpoint watermark with its rollback on a failed background save,
preemption snapshots (``preemption_snapshot``,
driven by ``worker/main.py``'s SIGTERM handler), the one-task profiler
(``profile_dir``, a ``torch.profiler`` Chrome trace) and the worker-loop
chaos hooks (``worker:task``, ``worker:prep``, ``worker:step``).

Gang mode (``multihost``): the worker processes of one membership form a
``torch.distributed`` world before the ``Worker`` is built
(``worker/main.py``), each on one device, and train one model in lockstep:
every rank walks the master's group task log (``GetGroupTask``) in the
same order, takes its slice of each global batch and sums the gradients
over the group (``parallel/trainer.py``), a task's full minibatches as one
``train_scan`` as alone (one replay over NCCL, the steps eagerly over
gloo); only rank 0 reports tasks and
writes checkpoints.  Under the ParameterServer strategy or the sharded
optimizer no rank holds the whole state (``Trainer.sharded_state``): every
rank takes part in each checkpoint's snapshot, whose gathers are
collectives, on the task loop's thread, and there is no survivor's
snapshot (below).  A gang settles each task
(metrics, rank 0's report, checkpoint) right after its steps, so between
tasks the state holds exactly the tasks rank 0 has reported.  A membership
change raises ``WorkerRestartRequired``: the process exits 3 and its
relaunch forms the new world, as in the reference.  Before it, the old
world's rank 0, if it survived, snapshots the state the master's record
holds: the state at the failed task's start (a device copy taken there),
and only when the master counted its last report; it alone knows what it
reported.  Otherwise, and always with sharded state, the relaunch resumes
from the periodic checkpoint, as the reference's gangs do; the tasks the
master counted since that checkpoint are not trained again.  A collective that fails on a dead peer
leaves the state of the last completed step (``CollectiveError``), so the
survivor waits for the master to see the departure and takes the same
snapshot-and-restart path; a member blocked in a collective that never
returns is exited by the death push (``death_watch_tick``).  The in-step
collective gate (``collective_deadline_ms``) is the reference's with its
guard: it acts on single-process meshes of more than one device, and a
port worker's single-process mesh is one device, so it is inert.

Host-tier tables (``spec.host_io``): the trainer pulls and pushes their
rows around each step (``use_async`` pipelines the pulls against the
device steps), from an in-process store or the PS fleet named by
``ps_addresses`` (the master's PS pods).  Every checkpoint saves them with
the dense state (in process: on the task loop, at the step the snapshot
holds; on a fleet: one Save fan-out from rank 0) and every restore takes
both halves of one step or neither.  A task's host half fans
out over the parallel ingest pool (``ingest_threads``,
``data/ingest_pool.py``): minibatch-aligned chunks read and decoded on
pool threads, reassembled in order.  Prep and ingest threads build host
arrays only; every upload to the card runs on the task loop's thread.
Metrics may be vectors (the AUC score histograms): a task's per-step
metrics come back in one copy of one flattened row per step and reduce on
the host as the reference's do.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterable, List, NamedTuple, Optional

import grpc
import numpy as np
import torch

from elasticdl_tpu_torch import chaos
from elasticdl_tpu_torch.common import gauge as gaugelib
from elasticdl_tpu_torch.common import locksan, trace
from elasticdl_tpu_torch.common.checkpoint import CheckpointManager, state_nbytes
from elasticdl_tpu_torch.common.config import JobConfig
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.common.metrics import DeviceTaskClock, PhaseTimers, finalize_metrics
from elasticdl_tpu_torch.common.rpc import (
    PROTOCOL_VERSION,
    BackoffPolicy,
    JsonRpcClient,
    call_with_backoff,
)
from elasticdl_tpu_torch.data.ingest_pool import IngestPool, plan_chunks
from elasticdl_tpu_torch.data.prefetch import prefetch
from elasticdl_tpu_torch.data.reader import AbstractDataReader, Shard
from elasticdl_tpu_torch.master.task_dispatcher import (
    TASK_EVALUATION,
    TASK_PREDICTION,
    TASK_TRAINING,
    Task,
)
from elasticdl_tpu_torch.models.spec import ModelSpec, load_model_spec_for_job
from elasticdl_tpu_torch.parallel.mesh import Mesh, mesh_shape
from elasticdl_tpu_torch.parallel.trainer import (
    MASK_KEY,
    CollectiveError,
    ScanMetrics,
    Trainer,
    TrainLoopError,
    outputs_to_numpy,
)

logger = get_logger("worker")

#: The exit code of a worker process that must be relaunched without
#: charging its failure budget (a preemption snapshot, a SIGTERM, a
#: membership change in gang mode).
RESTART_EXIT_CODE = 3

#: How long a gang member whose collective failed waits for the master to
#: publish the membership without its lost peer before it resyncs the gang
#: itself (leaving the membership).
PEER_LOSS_WAIT_S = 30.0

#: Task ids kept in ``Worker.task_log`` (a bounded window: a long job keeps
#: its newest tasks).
TASK_LOG_WINDOW = 4096


class WorkerRestartRequired(RuntimeError):
    """A membership change needs a process restart (gang mode: a process
    group is fixed per process).  The worker main exits with
    RESTART_EXIT_CODE; the pod manager relaunches without charging the
    failure budget."""


class DirectMasterProxy:
    """In-process master (the reference's no-cluster test pattern).  Applies
    the same wire schemas as the gRPC path so in-process tests catch
    contract drift."""

    def __init__(self, servicer):
        self._s = servicer

    def call(self, method: str, request: dict) -> dict:
        from elasticdl_tpu_torch.common.rpc import MASTER_SCHEMAS, validate_message

        validate_message(method, request, MASTER_SCHEMAS)
        return self._s.method_table()[method](request)


class RpcMasterProxy:
    """The worker's wire boundary to the master: every ``master.call`` in
    this file funnels here, so the per-call deadline lives here.  A master
    RPC that outlives the deadline surfaces as an error at the call site
    instead of wedging the task loop forever on a half-dead master.

    Master-outage ride-through: a transport-level failure (UNAVAILABLE —
    the master process is down or restarting) does NOT surface to the call
    site while ``outage_tolerance_s`` lasts; the call retries under the
    shared exponential-backoff-with-jitter helper
    (common/rpc.call_with_backoff).  The first call that succeeds after
    failures marks the proxy RECONNECTED (``take_reconnected``): the
    worker then re-registers with its held-lease inventory so a restarted
    master reconciles against its replayed journal.  Report retries across
    the outage are exactly-once by the report-seq dedup.  Chaos drop_rpc
    faults raise ``ChaosRpcDropped`` — not a grpc error, deliberately NOT
    retried."""

    #: Transport-level codes worth riding out: the server is not there.
    #: DEADLINE_EXCEEDED is deliberately absent — the call may have
    #: EXECUTED (only reports are dedup-protected), and a deadline on a
    #: live master is a latency pathology the caller should see.
    _TRANSIENT_CODES = (grpc.StatusCode.UNAVAILABLE,)

    def __init__(
        self,
        address: str,
        timeout_s: float = 30.0,
        call_timeout_s: float = 60.0,
        outage_tolerance_s: float = 120.0,
        gauges: Optional[gaugelib.Registry] = None,
    ):
        self._address = address
        self._client = JsonRpcClient(address)
        # Startup vs a slow master: short readiness probes under the
        # shared backoff, with a clear terminal error naming the flag.
        call_with_backoff(
            lambda: self._client.wait_ready(5.0),
            service="master",
            is_transient=lambda e: isinstance(
                e, (grpc.FutureTimeoutError, grpc.RpcError)
            ),
            policy=BackoffPolicy(
                base_s=0.5, max_s=4.0, budget_s=max(timeout_s, 1.0)
            ),
            terminal=lambda e, n, t: RuntimeError(
                f"master at {address} not reachable after {t:.0f}s "
                f"({n} attempt(s)) — check --master_addr / the master pod"
            ),
        )
        self._call_timeout_s = call_timeout_s
        self._tolerance_s = outage_tolerance_s
        # Reconnect flag, read-then-cleared by the task loop's membership
        # check; sets/reads are single ops.
        self._reconnected = False  # gil-atomic
        self._g_outage = (gauges or gaugelib.default()).counter(
            "edl_master_outage_seconds_total",
            "seconds this worker spent riding out master outages "
            "(proxy reconnect backoff)",
        )

    def call(self, method: str, request: dict) -> dict:
        if self._tolerance_s <= 0:
            return self._client.call(
                method, request, timeout_s=self._call_timeout_s
            )
        state = {"t0": None}

        def _on_retry(e, attempt, delay):
            if state["t0"] is None:
                state["t0"] = time.monotonic()
                logger.warning(
                    "master at %s unreachable (%s on %s); riding out up "
                    "to %.0fs", self._address, type(e).__name__, method,
                    self._tolerance_s,
                )
            self._g_outage.inc(delay)

        def _attempt():
            if state["t0"] is not None:
                # Post-failure attempts force a re-dial first: after a few
                # fail-fast RPCs against a down server, the gRPC channel
                # parks in TRANSIENT_FAILURE; a readiness probe re-dials.
                self._client.wait_ready(5.0)
            return self._client.call(
                method, request, timeout_s=self._call_timeout_s
            )

        resp = call_with_backoff(
            _attempt,
            service="master",
            is_transient=self._is_transient,
            policy=BackoffPolicy(
                base_s=0.5, multiplier=2.0, max_s=8.0, jitter=0.25,
            ),
            budget_s_fn=lambda: self._tolerance_s,
            on_retry=_on_retry,
            terminal=lambda e, n, t: RuntimeError(
                f"master outage outlived --master_outage_tolerance_s: "
                f"{self._address} unreachable for {t:.0f}s across {n} "
                f"attempt(s) of {method}"
            ),
        )
        if state["t0"] is not None:
            outage_s = time.monotonic() - state["t0"]
            self._reconnected = True
            trace.instant(
                "worker:reconnect", cat="elastic", method=method,
                outage_s=round(outage_s, 3),
            )
            logger.warning(
                "master back after %.1fs outage (%s); reconcile pending",
                outage_s, method,
            )
        return resp

    @classmethod
    def _is_transient(cls, e: BaseException) -> bool:
        if isinstance(e, grpc.FutureTimeoutError):
            # The post-failure readiness probe timed out: still down.
            return True
        return (
            isinstance(e, grpc.RpcError)
            and getattr(e, "code", lambda: None)() in cls._TRANSIENT_CODES
        )

    def take_reconnected(self) -> bool:
        """True once per ridden-out outage: the caller owes the master a
        re-register + lease-reconcile handshake."""
        if not self._reconnected:
            return False
        self._reconnected = False
        return True

    def limit_outage_tolerance(self, budget_s: float) -> None:
        """Shrink (never grow) the ride-through budget: the preemption path
        calls this with a couple of seconds, since a process that must be
        gone inside ``PREEMPTION_EXIT_S`` cannot park in the outage backoff
        waiting for a master that may be restarting."""
        self._tolerance_s = min(self._tolerance_s, max(0.0, budget_s))

    def close(self) -> None:
        self._client.close()


def _minibatches(
    records: List[bytes], batch_size: int, train: bool
) -> Iterable[tuple]:
    """Split shard records into fixed-size minibatches.  The tail is
    wrap-padded to full size; yields (records, true_count) so eval
    weighting can use the real example count."""
    for start in range(0, len(records), batch_size):
        chunk = records[start : start + batch_size]
        true_count = len(chunk)
        if true_count < batch_size:
            chunk = list(chunk)
            reps = (batch_size + true_count - 1) // true_count
            chunk = (chunk * reps)[:batch_size]
        yield chunk, true_count


def _real_mask(batch_size: int, true_count: int) -> np.ndarray:
    """The ``__mask__`` of a wrap-padded minibatch: real rows 1.0."""
    return (np.arange(batch_size) < true_count).astype(np.float32)


class HostPrep(NamedTuple):
    """The host half of a training task (read + decode + stack).

    ``stacked``: the ``[T, mb, ...]`` host arrays of the ``n_full`` full
    minibatches (None when the task has none); ``tail``: the decoded
    wrap-padded minibatch past them, with its ``__mask__`` (None when the
    records divide evenly); ``total``: the task's record count."""

    total: int
    n_full: int
    stacked: Optional[dict]
    tail: Optional[dict]


class Worker:
    """One worker process's task loop on one device (``device``: ``"cuda"``
    unless the caller asks for ``"cpu"``; no CUDA and no explicit ``"cpu"``
    raises)."""

    def __init__(
        self,
        config: JobConfig,
        master,
        reader: AbstractDataReader,
        worker_id: str = "worker-0",
        spec: Optional[ModelSpec] = None,
        device: Any = None,
        poll_interval_s: float = 0.05,
        gauges: Optional[gaugelib.Registry] = None,
        incarnation: Optional[str] = None,
        mesh: Optional[Mesh] = None,
    ):
        self.config = config
        self.master = master
        self.reader = reader
        self.worker_id = worker_id
        self.spec = spec or load_model_spec_for_job(config)
        self._poll = poll_interval_s
        # Built here, so a worker asked for the card on a machine without
        # one fails at once.  ``mesh``: the gang's world (worker/main.py
        # forms it before the Worker); None is this device alone.
        self.trainer = Trainer(self.spec, device=device, mesh=mesh, config=config)
        self.state = None  # single-writer: main
        self._membership_version = -1  # single-writer: main (the beat reads one int)
        self._rank = 0  # single-writer: main
        # Replaced wholesale on membership changes; the beat thread sees the
        # old or the new dict.
        self._ranks: Dict[str, int] = {}  # single-writer: main
        self._addresses: Dict[str, str] = {}  # single-writer: main
        # Gang mode: every process of the world walks the master's group
        # task log in one order (GetGroupTask seq); only rank 0 reports.
        self._group_mode = False  # single-writer: main
        self._task_seq = 0
        # The task ids this loop ran, in order (the newest TASK_LOG_WINDOW).
        self.task_log: deque = deque(maxlen=TASK_LOG_WINDOW)
        # Group-log entries whose device dispatch this rank has begun (the
        # gang boundary's per-rank arrival signal, read by the beat).
        self._gang_dispatched = 0  # single-writer: main
        self._gang_last_task = -1
        # Set while the task loop handles a lost peer itself (it is not
        # blocked in a collective): the death push stands down.
        self._reforming = False  # single-writer: main
        # ``checkpoint_hook(step, arrays)``: called on every rank at each
        # periodic checkpoint with the canonical arrays of the state: rank
        # 0's device snapshot, the other ranks' live tensors (worker/main.py
        # digests them when asked to); with sharded state every rank's
        # gathered snapshot, at the final checkpoint too.
        self.checkpoint_hook = None
        # Gang mode, rank 0 with a checkpoint directory: (step, device copy)
        # of the state at the current training task's start, which a
        # collective failing inside the task leaves the survivor to save.
        self._task_start: Optional[tuple] = None  # single-writer: main
        # Whether the master counted the last successful training report
        # (False after a refusal or a lost report): the state then holds a
        # task the master requeues, and no survivor snapshot is taken.
        self._record_counted = True
        self._ckpt: Optional[CheckpointManager] = None
        # Checkpoint watermark + background-save thread handle: touched by
        # the task loop, the background save thread (failure rollback) and
        # the preemption thread.
        self._ckpt_lock = locksan.lock("Worker._ckpt_lock", leaf=True)  # lock-order: leaf
        self._last_ckpt_step = 0  # guarded-by: _ckpt_lock
        self._ckpt_thread = None  # guarded-by: _ckpt_lock
        # One entry per checkpoint save: step, bytes, the seconds of the
        # device snapshot (enqueue, on the loop; periodic saves only), the
        # host copy and the write, and the wall clock of the publish.
        self.checkpoint_log: List[Dict[str, float]] = []  # guarded-by: _ckpt_lock
        self.recoveries = 0  # failed steps rebuilt from a checkpoint
        # Seconds of the restores: the seeded init of the state they fill,
        # the checkpoint read, the load into the module and optimizer.
        self.restore_times = {"init_s": 0.0, "read_s": 0.0, "load_s": 0.0}
        self._training_tasks_done = 0  # gates the one-task profiler trace
        # Task-level pipeline: the previous training task's (report, device
        # metrics), fetched + reported only after the NEXT task's steps are
        # dispatched (see run()).
        self._pending: Optional[tuple] = None
        # Prep-ahead: a bounded queue of (task, report, host-prep future)
        # for leased tasks whose host half runs on the prep pool while
        # earlier tasks' steps run (see run()).  The pool is built at the
        # first submission.
        self._prep_queue: deque = deque()
        self._prep_pool: Optional[ThreadPoolExecutor] = None
        # Intra-task parallel ingest: one pool per worker, shared by every
        # concurrent task prep (config.ingest_threads; 0 = auto).
        self._ingest = IngestPool(config.ingest_threads)
        # Set by preemption_snapshot (the SIGTERM thread): the task loop
        # parks at its next boundary; _parked acknowledges the park, after
        # which the loop only sleeps and the preemption thread alone touches
        # the state and sends reports.
        self._preempting = False  # single-writer: thread:preemption
        self._parked = False  # single-writer: main
        # Locally buffered task leases (batched GetTask): tasks the master
        # leased in one RPC beyond the one being started, returned on an
        # eval-pending or draining heartbeat.
        self._leased: deque = deque()
        self._tasks_done = 0
        # Report sequence numbers: every ReportTaskResult carries a
        # per-worker monotone seq so the master can DEDUPE a retried report
        # across its own restart.
        self._report_seq = 0
        self._incarnation = (
            incarnation or f"{os.getpid()}-{int(time.time() * 1e3)}"
        )
        # Python-side step counter mirroring state.step.
        self._steps_dispatched = 0  # single-writer: main
        # The dispatch path last logged: (fused, why not).
        self._dispatch_logged: Optional[tuple] = None
        self.gauges = gauges if gauges is not None else gaugelib.Registry()
        self._g_examples = self.gauges.counter(
            gaugelib.EXAMPLES_TRAINED, "examples trained (records dispatched)"
        )
        self._g_steps = self.gauges.counter(
            gaugelib.STEPS_DISPATCHED, "device steps dispatched"
        )
        self._g_tasks = self.gauges.counter(
            gaugelib.TASKS_DONE, "training/eval/predict tasks completed"
        )
        self.gauges.add_collector(self._collect_gauges)
        self._gauge_ship_interval_s = 1.0
        self._last_gauge_ship = 0.0  # gil-atomic
        # Per-phase wall decomposition of the task loop (common/metrics.py
        # PhaseTimers); snapshots ride every report.
        self.phases = PhaseTimers(gauges=self.gauges)
        # The trainer counts its graph captures in the same timers.
        self.trainer.phases = self.phases
        # Each training task's device time and the card's wait before it,
        # from timing events on the loop's stream (the card only).
        self._device_clock = DeviceTaskClock(self.phases)
        if config.trace:
            trace.configure(
                enabled=True, capacity=config.trace_buffer_events
            )
        self._trace_clock_offset_us: Optional[float] = None  # single-writer: main
        if config.chaos:
            chaos.configure(config.chaos)
        chaos.set_context(worker_id=worker_id, rank=self._rank)
        if config.checkpoint_dir:
            self._ckpt = CheckpointManager(
                config.checkpoint_dir, keep_max=config.keep_checkpoint_max
            )

    # ---- membership ----

    def _apply_membership(self, membership: dict, initial: bool = False) -> None:
        """Adopt a membership view (the reference's ``_apply_membership``).

        Version churn with identical ranks and addresses is adopted without
        re-forming.  In gang mode (``multihost``) any other change after the
        first view snapshots and raises ``WorkerRestartRequired``: the world
        is fixed per process.  The old world's rank 0 saves, if it survived.
        The reference saves only when the old world was one process, because
        its multi-process saves are collective; the port's state is
        replicated and one rank writes it alone, so rank 0 of a gang saves
        too.  It saves the state the master's record holds
        (``_record_state``), and nothing when the master did not count its
        last report; no other rank knows whether rank 0's last report
        landed.  With sharded state (tables row-sharded, the sharded
        optimizer: ``Trainer.sharded_state``) rank 0 never held the other
        ranks' rows and moments, so no rank saves, as the reference's
        multi-process gangs never do: the relaunch resumes from the newest
        periodic checkpoint.  Without gang mode this worker's device is its
        whole world, which no view changes."""
        version = membership["version"]
        if version == self._membership_version:
            return
        ranks = dict(membership["ranks"])
        addresses = dict(membership.get("addresses") or {})
        if not initial and ranks == self._ranks and addresses == self._addresses:
            logger.info(
                "membership v%d has identical topology; adopting without "
                "re-forming", version,
            )
            self._membership_version = version
            return
        world = max(membership["world_size"], 1)
        prev_ranks = self._ranks
        self._ranks, self._addresses = ranks, addresses
        self._rank = ranks.get(self.worker_id, 0)
        chaos.set_context(rank=self._rank)
        self._group_mode = self.config.multihost and len(ranks) > 1
        if self.config.multihost and not initial:
            saver = prev_ranks.get(self.worker_id) == 0 and self.worker_id in ranks
            if self._ckpt is not None and saver and self.state is not None:
                if self.trainer.sharded_state():
                    logger.warning(
                        "no pre-restart snapshot: the state is sharded over the gang's "
                        "ranks; the relaunch resumes from the periodic checkpoint "
                        "(step %s)", self._ckpt.latest_step(),
                    )
                elif not self._record_counted:
                    logger.warning(
                        "no pre-restart snapshot: the master did not count the last "
                        "task this state holds; the relaunch resumes from the "
                        "periodic checkpoint"
                    )
                else:
                    try:
                        # A background save may be mid-flight on the manager.
                        self._join_ckpt()
                        step, snap = self._record_state()
                        if self._ckpt.latest_step() != step:
                            self._save_snapshot(step, wait=True, state=snap)
                        logger.info("pre-restart snapshot at step %d", step)
                    except Exception:
                        # The periodic checkpoint covers the resume.
                        logger.exception("pre-restart snapshot failed; restarting anyway")
            trace.instant(
                "elastic:restart_required", cat="elastic", version=version, world=world,
            )
            raise WorkerRestartRequired(
                f"membership v{version}: world changed to {world} workers"
            )
        if not initial:
            logger.info(
                "membership v%d keeps this worker's device; adopting "
                "without re-forming", version,
            )
        self._membership_version = version

    def _restore_checkpoint(self, state_like, step: Optional[int] = None):
        """Restore a checkpoint step into ``state_like``: the canonical
        arrays the manager reads, laid into the live module and optimizer
        (the reference's restore_template + adopt_restored pair).  Adds the
        seconds of the read and of the load to ``restore_times``."""
        t0 = time.perf_counter()
        arrays = self._ckpt.restore(step)
        t1 = time.perf_counter()
        state = self.trainer.adopt_restored(arrays, state_like)
        self.restore_times["read_s"] += t1 - t0
        self.restore_times["load_s"] += time.perf_counter() - t1
        return state

    def _collect_gauges(self) -> None:
        """Scrape-time collector (never the task loop)."""
        g = self.gauges
        g.gauge("edl_membership_version", "applied membership version").set(
            float(self._membership_version)
        )
        g.gauge("edl_rank", "rank in the current membership").set(
            float(self._rank)
        )
        g.gauge(
            gaugelib.LEASE_DEPTH, "locally buffered task leases"
        ).set(float(len(self._leased)))
        # The mesh's (dp, tp) shape (a 1-D mesh reads dp=n, tp=1), one
        # sample per axis.
        dp, tp = mesh_shape(self.trainer.mesh)
        for ax, val in (("dp", dp), ("tp", tp)):
            g.gauge(
                "edl_mesh_shape",
                "current mesh extent per axis (dp=data, tp=model)",
                labels={"axis": ax},
            ).set(float(val))
        for name, secs in self.phases.snapshot().items():
            g.gauge(
                "edl_phase_seconds_total",
                "cumulative seconds per task-loop phase",
                labels={"phase": name},
            ).set(secs)
        for name, n in self.phases.counts().items():
            g.gauge(
                "edl_phase_entries_total",
                "entries per task-loop phase",
                labels={"phase": name},
            ).set(float(n))

    def gauge_payload(self, force: bool = False) -> Optional[dict]:
        """The Heartbeat/Report ``gauge`` envelope (throttled to ~1/s
        unless ``force``)."""
        if not self.gauges.enabled:
            return None
        now = time.monotonic()
        if not force and now - self._last_gauge_ship < self._gauge_ship_interval_s:
            return None
        self._last_gauge_ship = now
        return {"families": self.gauges.snapshot()}

    def _trace_payload(self) -> Optional[dict]:
        """One bounded slice of this process's trace ring for the
        heartbeat/report channel, or None when tracing is off or empty."""
        rec = trace.default()
        if not rec.enabled:
            return None
        events = rec.drain_slice(trace.SHIP_BATCH)
        if not events:
            return None
        payload: dict = {"events": events, "dropped": rec.dropped}
        if self._trace_clock_offset_us is not None:
            payload["clock_offset_us"] = self._trace_clock_offset_us
        return payload

    # thread-role: thread:heartbeat
    def death_watch_tick(self, state: dict, now: float, master_version=None) -> bool:
        """One death-push decision of the liveness heartbeat thread
        (``worker/main.py``): True when this process must exit RESTART
        because a gang peer DEPARTED while the task loop has not applied
        the change within ``death_push_grace_s`` (it is blocked in a
        collective).  Pure joins, identical-topology churn, a task loop
        that handles the loss itself (``_reforming``) and worlds of one
        never force an exit.  ``state`` carries ``pending_since`` between
        ticks."""
        if (
            not self._group_mode
            or self.config.death_push_grace_s <= 0
            or self._reforming
        ):
            state["pending_since"] = None
            return False
        if master_version is not None and master_version == self._membership_version:
            state["pending_since"] = None
            return False
        try:
            membership = self.master.call("GetMembership", {})
        except Exception:
            return False  # master briefly unreachable: retry next beat
        if membership["version"] == self._membership_version:
            state["pending_since"] = None
            return False
        same_topology = dict(membership["ranks"]) == self._ranks and dict(
            membership.get("addresses") or {}
        ) == self._addresses
        departed = set(self._ranks) - set(membership["ranks"])
        if same_topology or not departed:
            state["pending_since"] = None
            return False
        since = state.get("pending_since")
        if since is None:
            state["pending_since"] = now
            return False
        if now - since < self.config.death_push_grace_s:
            return False
        logger.warning(
            "death push: peer(s) %s departed (membership v%s vs applied v%s) "
            "and the task loop has not re-formed within %.1fs: assuming a "
            "blocked collective; forcing RESTART now",
            sorted(departed), membership["version"], self._membership_version,
            self.config.death_push_grace_s,
        )
        return True

    # thread-role: thread:heartbeat
    def gang_beat_fields(self) -> dict:
        """What the liveness beat adds to its Heartbeat in gang mode: the
        arrival counter and the applied version (the task loop's own
        heartbeat is silent while it is blocked in a collective)."""
        if not self._group_mode:
            return {}
        return {"gang_seq": self._gang_dispatched, "version": self._membership_version}

    def _held_task_ids(self) -> List[int]:
        """Every training-task id this worker still HOLDS: buffered leases,
        queued preps and the pipelined pending slot — the reconcile
        handshake's inventory."""
        held = [int(e["task"]["task_id"]) for e in self._leased if e.get("task")]
        held.extend(task.task_id for task, _r, _f in self._prep_queue)
        if self._pending is not None:
            held.append(int(self._pending[0]["task_id"]))
        return held

    def _reconcile_with_master(self) -> None:
        """Post-outage handshake: re-register declaring the leases this
        worker holds; drop the held ones the restarted master no longer
        attributes to it (``stale_tasks``).  Gang mode declares nothing: the
        group log owns the gang's leases, and a membership change requeues
        them on the master."""
        held = [] if self._group_mode else self._held_task_ids()
        resp = self.master.call(
            "RegisterWorker",
            {
                "worker_id": self.worker_id,
                "address": self._advertised_address(),
                "proto": PROTOCOL_VERSION,
                "incarnation": self._incarnation,
                "held_tasks": held,
            },
        )
        stale = set() if self._group_mode else {int(t) for t in resp.get("stale_tasks") or []}
        kept = deque(
            e for e in self._leased
            if not (e.get("task") and int(e["task"]["task_id"]) in stale)
        )
        dropped = len(self._leased) - len(kept)
        self._leased = kept
        # Stale preps are cancelled unstarted: training them would
        # double-train records the restarted master already re-leased.
        kept_prep: deque = deque()
        for task, report, fut in self._prep_queue:
            if task.task_id in stale:
                fut.cancel()
                dropped += 1
            else:
                kept_prep.append((task, report, fut))
        self._prep_queue = kept_prep
        trace.instant(
            "worker:reconcile", cat="elastic",
            held=len(held), stale=len(stale), dropped=dropped,
            version=resp.get("version"),
        )
        logger.info(
            "reconciled with restarted master: declared %d held lease(s), "
            "dropped %d stale", len(held), dropped,
        )

    def _advertised_address(self) -> str:
        if not self.config.multihost:
            return ""
        from elasticdl_tpu_torch.parallel.distributed import advertised_address

        return advertised_address(self.config.master_addr)

    def _check_membership(self) -> None:
        take = getattr(self.master, "take_reconnected", None)
        if take is not None and take():
            self._reconcile_with_master()
        # The applied version: the master's group log withholds collective
        # tasks until every member confirms the current topology.
        hb = {"worker_id": self.worker_id, "version": self._membership_version}
        if self._group_mode:
            hb["gang_seq"] = self._gang_dispatched
            if self._rank != 0:
                # Reports are rank 0's, so the other ranks' phase snapshots
                # ride the heartbeat.
                hb["phase_times"] = self.phases.snapshot()
                hb["phase_counts"] = self.phases.counts()
        tp = self._trace_payload()
        if tp is not None:
            hb["trace"] = tp
        gp = self.gauge_payload()
        if gp is not None:
            hb["gauge"] = gp
        t0_us = trace.now_us()
        resp = self.master.call("Heartbeat", hb)
        t1_us = trace.now_us()
        server_ts = resp.get("server_ts_us")
        if server_ts is not None:
            # RTT-midpoint clock alignment for the merged trace.
            self._trace_clock_offset_us = server_ts - (t0_us + t1_us) / 2.0
        # Gang mode takes neither hint: the group log fixes the order.
        if resp.get("draining") and not self._group_mode:
            # Max-steps drain: buffered leases and undispatched preps carry
            # no device work yet — return them all (requeue-flagged).
            self._abandon_prep()
            self._abandon_leases()
        elif resp.get("eval_pending") and self._leased and not self._group_mode:
            # A pending eval round that buffered leases would delay: return
            # them so the next lease pulls the eval task; prepped tasks
            # keep their decode and still train.
            self._abandon_leases()
        if resp["version"] != self._membership_version:
            if self._group_mode:
                self._drop_prep()
            else:
                self._drain_prep()
            self._abandon_leases()
            self._apply_membership(self.master.call("GetMembership", {}))

    # ---- checkpointing ----

    def _maybe_checkpoint(self) -> None:
        if self._ckpt is None or self.config.checkpoint_steps <= 0:
            return
        # The python-side step mirror: it equals the step the live state
        # settles to, which is the step the snapshot will carry.
        step = self._steps_dispatched
        with self._ckpt_lock:
            behind = step - self._last_ckpt_step
        if behind < self.config.checkpoint_steps:
            return
        with self.phases.phase("checkpoint"):
            if self._group_mode:
                self._save_group_snapshot_background(step)
            elif self._rank == 0:
                self._save_snapshot_background(step)

    def _save_snapshot(self, step: int, wait: bool = False, state=None,
                       record: Optional[Dict[str, float]] = None,
                       host_tier_saved: bool = False) -> None:
        """Write + publish + report one checkpoint: the dense state, then the
        host-tier stores (``host_tier_saved``: already saved on the task
        loop), then the publish.  ``state``: a canonical snapshot
        (``Trainer.snapshot_state``, device or host arrays) to save instead
        of the live state.  ``record`` collects the host-copy and write
        seconds and the bytes."""
        record = {} if record is None else record
        t0 = time.perf_counter()
        if state is None:
            host = self.trainer.host_state(self.state)
        else:
            host = self.trainer.to_host(state)
        record["host_s"] = time.perf_counter() - t0
        record["bytes"] = state_nbytes(host)
        t1 = time.perf_counter()
        self._ckpt.save(step, host, wait=wait)
        record["write_s"] = time.perf_counter() - t1
        if not host_tier_saved:
            self._save_host_stores(step)
        if wait:
            # Publish LAST: the manifest is the serving watcher's only
            # trigger, so it must name a step that is completely on disk.
            self._ckpt.publish(step)
            record["published_at"] = time.time()
            logger.info("published checkpoint step %d", step)
        with self._ckpt_lock:
            self._last_ckpt_step = step
            self.checkpoint_log.append(dict(record, step=step))
        logger.info(
            "checkpoint step %d saved: %d bytes, host copy %.3f s, write %.3f s",
            step, record["bytes"], record["host_s"], record["write_s"],
        )
        self.master.call(
            "ReportCheckpoint", self._checkpoint_report(step)
        )

    def _save_host_stores(self, step: int) -> None:
        """The host-tier half of checkpoint ``step`` (nothing without
        host-tier tables): in-process stores write their files, a PS fleet
        gets one Save fan-out (every caller is rank 0)."""
        self.trainer.save_host_stores(
            self._ckpt.directory, step, keep_max=self.config.keep_checkpoint_max)

    def _checkpoint_report(self, step: int) -> dict:
        report = {
            "path": self._ckpt.directory,
            "step": step,
            "worker_id": self.worker_id,
            "phase_times": self.phases.snapshot(),
            "phase_counts": self.phases.counts(),
        }
        tp = self._trace_payload()
        if tp is not None:
            report["trace"] = tp
        gp = self.gauge_payload(force=True)
        if gp is not None:
            report["gauge"] = gp
        return report

    def _join_ckpt(self, timeout: float = None) -> None:
        with self._ckpt_lock:
            t = self._ckpt_thread
        if t is not None and t.is_alive():
            t.join(timeout)  # outside the lock: the join itself may block

    def _snapshot_state(self):
        """Device-side copies of the live state in the canonical layout
        (``Trainer.snapshot_state``): enqueued on the stream behind the
        steps already dispatched, never waited for here."""
        return self.trainer.snapshot_state(self.state)

    def _record_state(self) -> tuple:
        """(step, snapshot or None for the live state): the state that
        holds exactly the tasks this rank has settled.  That is the live
        state unless a collective failed inside a task after some of its
        steps: then it is the copy taken at that task's start
        (``_task_start``)."""
        start = self._task_start
        if start is None or self.state.step == start[0]:
            return self.state.step, None
        return start

    def _save_snapshot_background(self, step: int) -> None:
        """Periodic checkpoint OFF the task loop's critical path: the
        device-side snapshot is enqueued here, then the host copy, the
        write, the publish and the report run on a background thread while
        training continues.  Saves are serialized (join before starting
        the next); a failed background save logs loudly and rolls the
        watermark back so the next boundary retries."""
        self._join_ckpt()
        t0 = time.perf_counter()
        snap = self._snapshot_state()
        record = {"snapshot_s": time.perf_counter() - t0}
        # In-process host stores save here, on the task loop: the rows at
        # exactly the step the snapshot holds (the next steps push into
        # them).  A PS fleet's Save fans out from the background thread.
        local = self.trainer.has_local_host_stores()
        if local:
            t0 = time.perf_counter()
            self._save_host_stores(step)
            record["host_tier_s"] = time.perf_counter() - t0
        with self._ckpt_lock:
            prev_watermark, self._last_ckpt_step = self._last_ckpt_step, step

        def _bg():
            try:
                with self.phases.phase("checkpoint_bg"):
                    self._save_snapshot(step, wait=True, state=snap, record=record,
                                        host_tier_saved=local)
            except Exception:
                logger.exception(
                    "background checkpoint at step %d failed; next "
                    "boundary retries", step,
                )
                with self._ckpt_lock:
                    self._last_ckpt_step = prev_watermark

        t = threading.Thread(target=_bg, name="edl-ckpt", daemon=True)
        with self._ckpt_lock:
            self._ckpt_thread = t
        t.start()

    def _save_group_snapshot_background(self, step: int) -> None:
        """The gang's periodic checkpoint: every rank moves its watermark at
        the same boundary (the lockstep order makes the arithmetic equal);
        rank 0 writes, publishes and reports it in the background, as
        ``_save_snapshot_background``.  A replicated state needs no other
        rank: rank 0 alone takes the device snapshot.  A sharded state's
        snapshot is a collective (``Trainer.snapshot_state`` gathers the
        rows and moments), so every rank takes it here, on the task loop's
        thread between the same two steps: issued from the background
        thread, its gathers would interleave with the next step's
        collectives on the same process group.  Only the host copy and the
        write go to the background.  A failed save keeps the watermark: a
        rollback on one rank would desynchronise the ranks' save
        schedules."""
        self._join_ckpt()
        with self._ckpt_lock:
            self._last_ckpt_step = step
        sharded = self.trainer.sharded_state()
        if self._rank != 0:
            if sharded:
                snap = self._snapshot_state()  # this rank's part of the gathers
                if self.checkpoint_hook is not None:
                    self.checkpoint_hook(step, snap)
            elif self.checkpoint_hook is not None:
                self.checkpoint_hook(step, self.trainer.snapshot_state(self.state, copy=False))
            return
        snap = self._snapshot_state()
        if self.checkpoint_hook is not None:
            self.checkpoint_hook(step, snap)
        record = {}

        def _bg():
            try:
                with self.phases.phase("checkpoint_bg"):
                    self._save_snapshot(step, wait=True, state=snap, record=record)
            except Exception:
                logger.exception(
                    "group background checkpoint at step %d failed; the next "
                    "boundary saves (watermark kept)", step,
                )

        t = threading.Thread(target=_bg, name="edl-ckpt", daemon=True)
        with self._ckpt_lock:
            self._ckpt_thread = t
        t.start()

    def preemption_snapshot(self) -> bool:
        """Best-effort save of the live state on SIGTERM (a preemption
        notice), run on the preemption thread of ``worker/main.py``, not in
        the signal frame.  Returns True when a snapshot was written and
        published.  The task loop must acknowledge the park within 5 s
        (``_parked``: from then on it only sleeps, so the state holds still
        and this thread sends every report); only rank 0 with a checkpoint
        directory saves, and a background save still running after a
        bounded join means no fresh snapshot (the relaunch resumes from the
        last periodic one)."""
        self._preempting = True  # parks the task loop at its next boundary
        # FIRST, before anything can block: every remaining master call of
        # this exiting process fails fast instead of riding out an outage.
        limit = getattr(self.master, "limit_outage_tolerance", None)
        if limit is not None:
            limit(2.0)
        trace.instant("elastic:preempt", cat="elastic", rank=self._rank)
        deadline = time.time() + 5.0
        while not self._parked and time.time() < deadline:
            time.sleep(0.05)
        if self._parked:
            # Every report from here on goes from this thread, so the
            # master sees their sequence numbers in order (it drops a
            # report whose number is not above the last it applied):
            # undispatched preps and unstarted leases go back first.
            self._abandon_prep()
            self._abandon_leases()
        if self._group_mode:
            # As the reference: a gang member never saves alone here (its
            # peers are being preempted too, and one blocked in a step with
            # a parked peer could not park); the gang resumes from its
            # periodic checkpoint, of which an in-flight save may finish.
            self._join_ckpt(timeout=5.0)
            logger.info("preemption snapshot skipped (gang mode, rank %d)", self._rank)
            return False
        if self._rank != 0 or self._ckpt is None or self.state is None:
            logger.info(
                "preemption snapshot skipped (rank=%d ckpt=%s state=%s)",
                self._rank, self._ckpt is not None, self.state is not None,
            )
            return False
        if not self._parked:
            # A loop blocked in a master call would resume after we give up
            # and race this thread on the state and the pending slot.
            logger.warning(
                "preemption snapshot skipped (task loop never parked "
                "within 5s — likely blocked in a master RPC)",
            )
            return False
        # The pipelined task's steps are in this state: report it now, or
        # the master requeues work the snapshot already holds.
        try:
            self._flush_pending()
        except Exception:
            logger.exception("preemption flush of pending report failed")
        step = self.state.step
        try:
            self._join_ckpt(timeout=10.0)
            with self._ckpt_lock:
                bg = self._ckpt_thread
                saved_this_step = self._last_ckpt_step == step
            if bg is not None and bg.is_alive():
                # A fresh save beside it would tear both step directories.
                logger.warning(
                    "preemption: background checkpoint still in flight "
                    "after 10s join; exiting without a fresh snapshot",
                )
                return False
            if not saved_this_step:
                self._save_snapshot(step, wait=True)
        except Exception:
            logger.exception("preemption snapshot incomplete")
            return False
        logger.info("preemption snapshot at step %d", step)
        return True

    # ---- profiling ----

    def _maybe_start_profile(self):
        """Trace the SECOND training task (the first pays the kernels'
        build and the allocator's warm-up) into ``config.profile_dir`` with
        ``torch.profiler``, with the operators' input shapes and the port's
        ranges (``edl:<phase>``, ``lm:head_loss``, ``optim:step``, the
        lookup's); returns the running profiler or None.  Counts training
        tasks only, so eval and prediction tasks neither skip the trace nor
        shift it."""
        if not self.config.profile_dir or self._training_tasks_done != 1:
            return None
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.trainer.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        try:
            prof = profile(activities=activities, record_shapes=True)
            prof.start()
        except Exception:
            logger.exception("profiler start failed")
            return None
        logger.info("profiling this task into %s", self.config.profile_dir)
        return prof

    def _stop_profile(self, prof, task_id: int) -> None:
        """Settle the profiled task's device work, stop the trace and write
        it as a Chrome trace into ``config.profile_dir``."""
        if self.trainer.device.type == "cuda":
            torch.cuda.synchronize(self.trainer.device)
        prof.stop()
        os.makedirs(self.config.profile_dir, exist_ok=True)
        path = os.path.join(
            self.config.profile_dir,
            f"{self.worker_id}-task-{task_id}.pt.trace.json",
        )
        prof.export_chrome_trace(path)
        logger.info("profile of task %d written to %s", task_id, path)

    # ---- task execution ----

    def _read_records(self, shard):
        """Shard records, packed (one bulk read — data/packed.py) when the
        reader offers it, else a plain list."""
        fast = getattr(self.reader, "read_records_packed", None)
        if fast is not None:
            records = fast(shard)
            if records is not None:
                return records
        return list(self.reader.read_records(shard))

    def _stack_full_minibatches(self, records, mb: int, n_full: int) -> dict:
        """Feed every full minibatch in ONE call and stack the result into
        ``[T, mb, ...]`` host arrays (the reference's fused-scan wire
        format)."""
        big = self.spec.feed(records[: n_full * mb])
        return {
            k: np.ascontiguousarray(v).reshape((n_full, mb) + np.shape(v)[1:])
            for k, v in dict(big).items()
        }

    def _fused_eligible(self) -> Optional[str]:
        """Why a task's full minibatches cannot run as one fused scan
        (``Trainer.train_scan``/``eval_scan``), or None: the flag off, or a
        trainer that cannot scan (host-tier tables).  Gang mode scans too,
        a row-sharded table on either lookup route among them (captured
        over NCCL, eager over gloo: the trainer's choice); a capture that
        fails fails the task, with no per-step fallback.  Every rank of a
        gang picks the same path, since the answer depends only on the
        replicated config and the trainer's capability."""
        if not self.config.fused_task_scan:
            return "--fused_task_scan=False"
        return self.trainer.scan_unsupported()

    def _fused_path(self) -> bool:
        """Whether this task runs fused; the path and the reason for it are
        logged once (again only if they change)."""
        why = self._fused_eligible()
        if self._dispatch_logged != (why is None, why):
            self._dispatch_logged = (why is None, why)
            if why is None:
                logger.info("task dispatch: fused, one train_scan / eval_scan a task (%s) "
                            "plus one step for a ragged tail", self.trainer.device.type)
            else:
                logger.info("task dispatch: per step (%s)", why)
        return why is None

    def _train_feed(self, chunk, true_count: int) -> dict:
        """Feed a training chunk; a wrap-padded tail gets the ``__mask__``
        that gives its duplicated examples zero gradient."""
        batch = self.spec.feed(chunk)
        if true_count < self.config.minibatch_size:
            batch = dict(batch)
            batch[MASK_KEY] = _real_mask(self.config.minibatch_size, true_count)
        return batch

    # thread-role: pool:_prep_fused_host
    def _prep_fused_host(self, task: Task) -> HostPrep:
        """The host half of a fused training task: read, decode, stack the
        full minibatches, decode and mask the tail.  Touches neither
        ``self.state`` nor the device, so prep-ahead runs it on a prep
        thread while earlier tasks' steps run.

        With ``ingest_threads`` > 1 (and a reader declaring
        ``thread_safe_ranges``) the record range splits into
        minibatch-aligned chunks read and decoded at once on the ingest
        pool and reassembled in chunk order: the feed decodes each record
        on its own, so the chunks concatenate to the serial path's bytes
        (record order, the ragged tail, its ``__mask__``)."""
        # graftchaos: stall(point=prep), the host-side straggler.
        chaos.hook("worker:prep", rank=self._rank, step=self._steps_dispatched)
        mb = self.config.minibatch_size
        shard = task.shard
        chunks = (
            plan_chunks(shard.start, shard.end, mb, self._ingest.threads)
            if self._ingest.parallel and getattr(self.reader, "thread_safe_ranges", False)
            else [(shard.start, shard.end)]
        )

        def _decode_chunk(span):
            recs = self._read_records(Shard(shard.name, span[0], span[1]))
            t = len(recs) // mb
            stacked = self._stack_full_minibatches(recs, mb, t) if t else None
            return len(recs), t, stacked, recs[t * mb:]

        def _decode_on_pool(span):
            # Runs on an ingest-pool thread; its time lands in the
            # off-critical-path ``decode_parallel`` phase (the phase stack
            # is per thread, so it never subtracts from the loop's phases).
            with self.phases.phase("decode_parallel"):
                return _decode_chunk(span)

        if len(chunks) < 2:
            parts = [_decode_chunk(chunks[0])]
        else:
            parts = self._ingest.map_ordered(_decode_on_pool, chunks)
        total = sum(p[0] for p in parts)
        n_full = sum(p[1] for p in parts)
        stacks = [p[2] for p in parts if p[2] is not None]
        if len(stacks) > 1:
            # Chunk i's [t_i, mb, ...] rows precede chunk i+1's: the serial
            # reshape's layout.
            stacked = {k: np.concatenate([st[k] for st in stacks]) for k in stacks[0]}
        else:
            stacked = stacks[0] if stacks else None
        if stacked is not None and self._fused_eligible() is None:
            # Pinned here, off the task loop: its dispatch only enqueues
            # the copy.
            stacked = self.trainer.pin_stacked(stacked)
        # plan_chunks puts the ragged tail on the LAST chunk.
        rest = parts[-1][3]
        tail = None
        if len(rest):
            tail = self._train_feed(next(_minibatches(rest, mb, True))[0], len(rest))
        return HostPrep(total, n_full, stacked, tail)

    def _dispatch_training_task(
        self, task: Task, prep: Optional[HostPrep] = None
    ) -> tuple:
        """Dispatch every step of a training task; returns (the started
        metrics fetch, n_steps).  On the card the steps are enqueued
        without waiting for them (the metrics fetch in
        ``_finalize_training_metrics`` is the wait).

        With ``fused_task_scan`` (the default) the task's host half is a
        ``HostPrep``: ``prep`` when prep-ahead made it on a prep thread,
        else made here.  On the fused path (``_fused_path``) its full
        minibatches go up in one copy a leaf (``shard_stacked_batch``) and
        run as ONE ``train_scan``, the tail as one more step; otherwise
        (host-tier tables, the flag off) every minibatch runs through
        ``Trainer.run_train_steps``.  Without ``fused_task_scan`` each
        minibatch is fed on the prefetch thread as the steps consume them.  A failed step's task is reported
        failed and requeued either way; the state goes on from
        ``TrainLoopError.state`` when the failure came before a step
        touched the module and the optimizer, else from the newest
        checkpoint."""
        if self._group_mode and task.task_id != self._gang_last_task:
            # Gang-boundary arrival: counted before the first collective of
            # the entry, once per entry.
            self._gang_last_task = task.task_id
            self._gang_dispatched += 1
        if (self._group_mode and self._rank == 0 and self._ckpt is not None
                and not self.trainer.sharded_state()):
            # The survivor's snapshot if a collective fails after some of
            # this task's steps (``_record_state``); the old copy goes first.
            # Sharded state has no survivor's snapshot (``_apply_membership``).
            self._task_start = None
            self._task_start = (self.state.step, self._snapshot_state())
        # graftchaos: stall(point=step), a dispatch-side straggler.
        chaos.hook("worker:step", rank=self._rank, step=self._steps_dispatched)
        self._collective_gate(task)
        mb = self.config.minibatch_size
        try:
            if prep is None and self.config.fused_task_scan:
                with self.phases.phase("prep_wait"):
                    prep = self._prep_fused_host(task)
            fused = prep is not None and prep.n_full > 0 and self._fused_path()
            if prep is not None:
                total, n_full, stacked, tail = prep
                batches = [] if fused else [
                    {k: v[i] for k, v in stacked.items()} for i in range(n_full)
                ]
                if tail is not None:
                    batches.append(tail)
            else:
                with self.phases.phase("prep_wait"):
                    records = self._read_records(task.shard)
                total = len(records)
                batches = prefetch(
                    (self._train_feed(chunk, n)
                     for chunk, n in _minibatches(records, mb, True)),
                    self.config.prefetch_depth,
                    name=f"prefetch:{task.task_id}",
                )
            # The task's start on the device's clock (DeviceTaskClock): the
            # trainer records it before the first replay or eager step.
            self.trainer.task_start = None
            with self.phases.phase("dispatch"):
                head = []
                if fused:
                    self.state, scan = self.trainer.train_scan(
                        self.state, self.trainer.shard_stacked_batch(stacked))
                    head = [scan]
                # With host-tier tables the pulls and pushes run here too
                # (--use_async pipelines the pulls against the device steps).
                self.state, metrics_list = self.trainer.run_train_steps(
                    self.state, batches, use_async=self.config.use_async
                )
                metrics_list = head + metrics_list
            self._task_start = None  # every step of the task is in the state
        except TrainLoopError as e:
            # The reference's recovery: the newest live state when no step
            # touched it, else the newest checkpoint.  The python-side step
            # mirror follows, since later reports derive model_version
            # from it.
            if e.state is not None:
                self.state = e.state
            else:
                self._recover_state()
            self._steps_dispatched = self.state.step
            raise
        n_steps = (total + mb - 1) // mb
        self._g_examples.inc(total)
        self._g_steps.inc(n_steps)
        fetch = self._start_metrics_fetch(metrics_list)
        start = self.trainer.task_start
        if start is not None and fetch[3] is not None:
            self._device_clock.dispatched(start, fetch[3])
        return fetch, n_steps

    def _collective_gate(self, task: Task) -> None:
        """The in-step collective gate (the reference's ``_collective_gate``)
        with its guard: a deadline of 0, a mesh of one contributor or gang
        mode crosses every contribution inline, accounted to the
        ``collective_gate`` phase when chaos hooks can stall it.  The armed
        gate (a straggling shard excluded by the contributor mask) needs
        more than one contributor in one process; a port worker is one
        device, so the guard always holds here, and
        ``collective_deadline_ms > 0`` is accepted and inert, as it is on
        the reference's one-device workers and gangs."""
        n = self.trainer.num_contributors()
        deadline_s = self.config.collective_deadline_ms / 1e3
        if deadline_s <= 0 or n <= 1 or self._group_mode:
            if chaos.enabled():
                with self.phases.phase("collective_gate"):
                    for shard in range(n):
                        chaos.hook("worker:collective", rank=self._rank,
                                   step=self._steps_dispatched, shard=shard)
            return
        raise AssertionError("a port worker's process holds one contributor")

    def _start_metrics_fetch(self, metrics_list) -> tuple:
        """Start the host copy of a task's per-step metrics NOW, behind its
        last step on the stream: the deferred fetch then waits for THIS
        task's steps only.  A plain ``.cpu()`` at the fetch would wait for
        every step queued by then — the next task's too — and leave the
        card idle while the loop reports and leases.  A metric may be a
        vector (the AUC histograms): each step's metrics flatten into one
        row, so a task is one copy.  An entry is one step's metrics or a
        scan's (``ScanMetrics``: ``[T, ...]`` each, T rows).  Returns
        (keys, shapes, host tensor [steps, row], event or None); the event
        is a timing one, the end of a training task on the device's clock
        (``DeviceTaskClock``)."""
        keys = list(metrics_list[0]) if metrics_list else []
        if not keys:
            return keys, [], torch.zeros((0, 0)), None
        first = metrics_list[0]
        stacked = isinstance(first, ScanMetrics)
        shapes = [tuple(first[k].shape[1:] if stacked else first[k].shape) for k in keys]
        rows = torch.cat([
            torch.cat([m[k].detach().float().reshape(len(m[keys[0]]), -1) for k in keys], dim=1)
            if isinstance(m, ScanMetrics)
            else torch.cat([m[k].detach().float().reshape(-1) for k in keys])[None]
            for m in metrics_list
        ])
        if rows.device.type != "cuda":
            return keys, shapes, rows, None
        host = torch.empty(rows.shape, dtype=rows.dtype, pin_memory=True)
        host.copy_(rows, non_blocking=True)
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return keys, shapes, host, event

    @staticmethod
    def _unflatten(keys, shapes, row: np.ndarray) -> Dict[str, np.ndarray]:
        """One flattened metrics row back into ``{key: array}``."""
        out, at = {}, 0
        for key, shape in zip(keys, shapes):
            size = int(np.prod(shape, dtype=np.int64))
            out[key] = row[at : at + size].reshape(shape)
            at += size
        return out

    def _recover_state(self) -> None:
        """Rebuild training state after a failed step: newest restorable
        checkpoint if any, else fresh init (loudly — a training job loses
        at most the work since the last checkpoint)."""
        logger.error(
            "training state lost to a failed step; rebuilding from checkpoint"
        )
        self.recoveries += 1
        self._join_ckpt()  # a mid-flight background save should land first
        self.state = self.trainer.init_state(0)
        steps = self._ckpt.all_steps() if self._ckpt is not None else []
        for step in steps:
            try:
                self.state = self._restore_step(step)
                logger.info("recovered from checkpoint step %d", step)
                return
            except FileNotFoundError:
                continue
        self.trainer.reset_host_stores()
        logger.error(
            "no restorable checkpoint; training state re-initialized fresh"
        )

    def _restore_step(self, step: int):
        """Both halves of checkpoint ``step``: the host-tier rows first (a
        missing or unreadable file raises ``FileNotFoundError`` before the
        module changes; a PS fleet is checked, not loaded), then the dense
        state into ``self.state``."""
        self.trainer.restore_host_stores(self._ckpt.directory, step)
        return self._restore_checkpoint(self.state, step=step)

    def _finalize_training_metrics(self, fetch: tuple) -> Dict[str, float]:
        """Wait for a task's metrics copy (``_start_metrics_fetch``), then
        aggregate on the host; each step weighs equally."""
        keys, shapes, host, event = fetch
        # The wait is where the task's steps drain ("step_wait"), distinct
        # from the host math after it ("metrics").
        with self.phases.phase("step_wait"):
            if event is not None:
                event.synchronize()
                # The task's events have completed: its device time and the
                # card's wait before it, read without a further wait.
                self._device_clock.settled(event)
        with self.phases.phase("metrics"):
            values = host.numpy().astype(np.float64)
            # Vector entries sum over the steps like the scalars; the
            # histogram pairs become their scalar (AUC) in finalize.
            mean = values.sum(axis=0) / max(len(values), 1)
            return finalize_metrics(self._unflatten(keys, shapes, mean))

    def _run_training_task(self, task: Task) -> Dict[str, float]:
        """Synchronous task execution (task_pipelining off)."""
        fetch, _ = self._dispatch_training_task(task)
        return self._finalize_training_metrics(fetch)

    def _next_report_seq(self) -> int:
        self._report_seq += 1
        return self._report_seq

    def _report_result(self, report: dict) -> None:
        """ReportTaskResult with the cumulative phase decomposition and the
        gauge envelope riding along."""
        report["phase_times"] = self.phases.snapshot()
        report["phase_counts"] = self.phases.counts()
        report["seq"] = self._next_report_seq()
        gp = self.gauge_payload(force=True)
        if gp is not None:
            report["gauge"] = gp
        training = report["success"] and report.get("task_type") == TASK_TRAINING
        if training:
            # Its steps are in the state: until the master answers, and
            # after a refusal (the task was requeued), the state holds a
            # task the master's record does not.
            self._record_counted = False
        with self.phases.phase("metrics"):
            resp = self.master.call("ReportTaskResult", report)
        if training:
            self._record_counted = bool((resp or {}).get("accepted", True))
            logger.info("training task %d reported at step %d: accepted=%s",
                        report["task_id"], report.get("model_version", -1),
                        self._record_counted)

    def _group_resync(self, report: dict, context: str, cause: Optional[BaseException] = None) -> None:
        """A gang member that failed a task is out of step: its peers' next
        collective would wait for it.  A collective that failed
        (``CollectiveError``: a peer is gone) left the state of the last
        completed step, so the member waits for the master to publish the
        new membership and restarts through ``_apply_membership`` (the
        survivor's snapshot).  Any other failure, or no new membership
        within ``PEER_LOSS_WAIT_S``, takes the reference's resync: report
        the task failed (requeued), leave the membership (the version bump
        resyncs the peers) and restart.  Raises WorkerRestartRequired."""
        if isinstance(cause, CollectiveError) or isinstance(
                getattr(cause, "cause", None), CollectiveError):
            self._reforming = True  # not blocked: the death push stands down
            deadline = time.monotonic() + PEER_LOSS_WAIT_S
            while time.monotonic() < deadline:
                try:
                    membership = self.master.call("GetMembership", {})
                except Exception:
                    membership = None
                if membership is not None and membership["version"] != self._membership_version:
                    logger.warning(
                        "collective failed in lockstep mode (%s); membership "
                        "v%d is published: re-forming", context, membership["version"],
                    )
                    self._drop_prep()
                    self._apply_membership(membership)  # raises
                time.sleep(self._poll)
        report["success"] = False
        report.pop("metrics", None)
        report["seq"] = self._next_report_seq()
        for call, payload in (
            ("ReportTaskResult", report),
            ("DeregisterWorker", {"worker_id": self.worker_id}),
        ):
            try:
                self.master.call(call, payload)
            except Exception:  # master unreachable: the peers will still
                pass           # reap this worker by heartbeats
        raise WorkerRestartRequired(
            f"task {report['task_id']} failed in lockstep mode ({context}); "
            "deregistered for group resync"
        )

    def _flush(self, pending: Optional[tuple]) -> None:
        """Settle a pipelined task: fetch its device metrics, report (rank
        0 only in gang mode), and run the checkpoint hook.  A fetch failure
        fails THAT task's report (requeued by the master), never the task
        whose dispatch triggered the flush; in gang mode it resyncs the
        gang (``_group_resync``).  A gang report that fails is swallowed: the
        checkpoint hook after it must run on every rank alike, and the
        master's task timeout requeues a lost report."""
        if pending is None:
            return
        report, fetch = pending
        try:
            report["metrics"] = self._finalize_training_metrics(fetch)
        except Exception as e:
            logger.exception(
                "task %d failed at metrics fetch", report["task_id"]
            )
            if self._group_mode:
                self._group_resync(report, "metrics fetch", e)  # raises
            report["success"] = False
            report.pop("metrics", None)
        if not self._group_mode:
            self._report_result(report)
        elif self._rank == 0:
            try:
                self._report_result(report)
            except Exception:
                logger.exception(
                    "group report for task %d lost (master task timeout "
                    "requeues it)", report["task_id"],
                )
        if report["success"]:
            self._tasks_done += 1
            self._g_tasks.inc()
            self._maybe_checkpoint()

    def _flush_pending(self) -> None:
        pending, self._pending = self._pending, None
        self._flush(pending)

    # ---- prep-ahead ----

    def _prep_ahead_eligible(self) -> bool:
        """Prep-ahead runs the next tasks' host half on prep threads while
        the current task's steps run: only with task pipelining and the
        fused path, never with host-tier tables (their pulls run with the
        steps, on the task loop) and never in a profiling session (a
        profiled task is traced in isolation)."""
        return (
            self.config.task_pipelining
            and self.config.fused_task_scan
            and not self.spec.host_io
            and not self.config.profile_dir
        )

    def _submit_prep(self, task: Task):
        if self._prep_pool is None:
            # One prep thread per pipeline slot, so a slow shard never
            # serializes the preps queued behind it.  A reader that does not
            # declare thread_safe_ranges (a shared-connection source, such
            # as the SQLite table reader) gets one thread: the queue still
            # holds prep_depth leased tasks, but their reads run one at a
            # time, as such a reader requires.
            safe = bool(getattr(self.reader, "thread_safe_ranges", False))
            width = max(1, self.config.prep_depth) if safe else 1
            self._prep_pool = ThreadPoolExecutor(
                max_workers=width, thread_name_prefix="edl-prep",
            )
            logger.info("prep pool: %d thread(s) for prep_depth %d (reader "
                        "thread_safe_ranges=%s)", width, self.config.prep_depth, safe)
        return self._prep_pool.submit(self._prep_fused_host, task)

    def _dispatch_prepped(self, prepped: tuple) -> None:
        """Dispatch a prepped task's steps, rotate it into the pending
        (report-deferred) slot, and settle the PREVIOUS pending task.  A
        failure (prep or dispatch) fails THIS task's report and raises
        nothing: the caller has often just queued a new task whose report
        the run loop's handler would wrongly fail."""
        task, report, fut = prepped
        try:
            with self.phases.phase("prep_wait"):
                prep = fut.result()
            fetch, n_steps = self._dispatch_training_task(task, prep=prep)
        except Exception as e:
            logger.exception("task %d failed", task.task_id)
            if self._group_mode:
                self._group_resync(report, "prep/dispatch", e)  # raises
            report["success"] = False
            try:
                self._report_result(report)
            except Exception:
                logger.exception(
                    "failure report for task %d lost (master task timeout "
                    "will requeue it)", task.task_id,
                )
            return
        self._steps_dispatched += n_steps
        report["model_version"] = self._steps_dispatched
        self._training_tasks_done += 1
        settle = (report, fetch)
        if not self._group_mode:
            # Report pipelining; a gang settles each task now (module doc).
            settle, self._pending = self._pending, settle
        try:
            self._flush(settle)
        except WorkerRestartRequired:
            raise  # gang resync: the process restarts
        except Exception:
            # What escapes _flush is the report call itself: the settled
            # task's steps are in the state, and the master's task timeout
            # requeues it if the report never landed.
            logger.exception(
                "report of previous pipelined task lost (master task "
                "timeout will requeue it)",
            )

    def _drain_prep(self) -> None:
        """Dispatch every prepped task, then settle the pending slot:
        whenever something must see a settled task order (eval and
        prediction tasks, membership changes, idle polls, the job's end)."""
        while self._prep_queue:
            self._dispatch_prepped(self._prep_queue.popleft())
        self._flush_pending()

    def _drop_prep(self) -> None:
        """Gang mode, the membership changed: cancel the prepped tasks
        without training them.  They are entries of the group log, which
        the version change requeued on the master; trained, their steps
        would sit in a state whose record does not hold them."""
        while self._prep_queue:
            self._prep_queue.popleft()[2].cancel()

    def _abandon_prep(self) -> None:
        """Give every undispatched prepped task back to the master with a
        requeue-flagged failure report (no device work ran: the retry
        budget is not charged)."""
        while self._prep_queue:
            task, report, fut = self._prep_queue.popleft()
            fut.cancel()
            report["success"] = False
            report["requeue"] = True
            report["seq"] = self._next_report_seq()
            try:
                self.master.call("ReportTaskResult", report)
            except Exception:
                logger.exception("abandoning prepped task %d failed", task.task_id)

    def _abandon_leases(self) -> None:
        """Return locally buffered (never-started) task leases to the
        master: a requeue-flagged failure report requeues each immediately
        without charging its retry budget.  In gang mode the buffer is
        read-ahead of the group log, which a membership change requeues on
        the master: it is dropped here."""
        leased, self._leased = self._leased, deque()
        if self._group_mode:
            return
        for entry in leased:
            t = entry.get("task")
            if not t:
                continue
            report = {
                "worker_id": self.worker_id,
                "task_id": t["task_id"],
                "task_type": t["type"],
                "success": False,
                "requeue": True,
                "seq": self._next_report_seq(),
            }
            try:
                self.master.call("ReportTaskResult", report)
            except Exception:
                logger.exception(
                    "abandoning leased task %d failed (master task "
                    "timeout will requeue it)", t["task_id"],
                )

    def _next_lease(self) -> dict:
        """The next task entry: from the local lease buffer when one is
        held, else one batched GetTask RPC (up to ``lease_batch`` tasks)."""
        if self._leased:
            return self._leased.popleft()
        n = max(1, self.config.lease_batch)
        if self._group_mode:
            # Lockstep: every rank walks the master's group log by seq, so
            # every rank runs the same tasks in the same order.
            with self.phases.phase("lease_wait"):
                with trace.span(
                    "gang_boundary", cat="gang", seq=self._task_seq,
                    rank=self._rank, version=self._membership_version,
                ):
                    resp = self.master.call(
                        "GetGroupTask",
                        {
                            "worker_id": self.worker_id,
                            "seq": self._task_seq,
                            "version": self._membership_version,
                            "lease": n,
                        },
                    )
            if resp.get("stale"):
                return resp
            entries = resp.get("entries") or [
                {"task": resp.get("task"), "finished": resp["finished"]}
            ]
            self._leased.extend(
                {"task": e["task"], "finished": e["finished"], "stale": False}
                for e in entries[1:]
            )
            return {"task": entries[0]["task"], "finished": entries[0]["finished"],
                    "stale": False}
        with self.phases.phase("lease_wait"):
            resp = self.master.call(
                "GetTask", {"worker_id": self.worker_id, "lease": n}
            )
        tasks = resp.get("tasks")
        if tasks:
            self._leased.extend(
                {"task": t, "finished": False, "stale": False}
                for t in tasks[1:]
            )
            return {"task": tasks[0], "finished": False, "stale": False}
        return {
            "task": resp.get("task"), "finished": resp["finished"],
            "stale": False,
        }

    def _run_evaluation_task(self, task: Task) -> tuple:
        """Count-weighted means of the eval step's metrics over the task's
        records (the wrap-padded tail weighs by its real rows and carries
        ``__mask__``), reported RAW so the master's cross-worker
        aggregation stays exact."""
        records = self._read_records(task.shard)
        mb = self.config.minibatch_size
        steps, counts = [], []
        n_full = len(records) // mb
        if n_full and self._fused_path():
            # The reference's fused eval: every full chunk in one decode,
            # one copy and one eval_scan; the tail as one masked step.
            stacked = self._stack_full_minibatches(records, mb, n_full)
            steps.append(self.trainer.eval_scan(
                self.state, self.trainer.shard_stacked_batch(stacked)))
            counts += [mb] * n_full
            records = records[n_full * mb:]

        def _batches():
            for chunk, true_count in _minibatches(records, mb, False):
                batch = dict(self.spec.feed(chunk))
                batch[MASK_KEY] = _real_mask(mb, true_count)
                yield batch, true_count

        for batch, true_count in prefetch(
            _batches(), self.config.prefetch_depth,
            name=f"prefetch:{task.task_id}",
        ):
            steps.append(self.trainer.run_eval_step(self.state, batch))
            counts.append(true_count)
        if not steps:
            return {}, 0.0
        keys, shapes, host, event = self._start_metrics_fetch(steps)
        if event is not None:  # waits for every eval step
            event.synchronize()
        # Histogram metrics (the AUC's) are vectors: accumulated in float64
        # with the scalars' count weighting and reported as lists, so the
        # master's cross-worker aggregation stays exact.
        weights = np.asarray(counts, np.float64)
        total = float(weights.sum())
        sums = (host.numpy().astype(np.float64) * weights[:, None]).sum(axis=0)
        means = self._unflatten(keys, shapes, sums / max(total, 1e-12))
        return {k: (v.tolist() if v.ndim else float(v)) for k, v in means.items()}, total

    def _run_prediction_task(self, task: Task) -> None:
        records = self._read_records(task.shard)
        outs = []
        for batch, true_count in prefetch(
            (
                (self.spec.feed(chunk), count)
                for chunk, count in _minibatches(
                    records, self.config.minibatch_size, False
                )
            ),
            self.config.prefetch_depth,
            name=f"prefetch:{task.task_id}",
        ):
            out = self.trainer.run_predict_step(self.state.model, batch)
            outs.append(outputs_to_numpy(out)[:true_count])
        if self.config.prediction_outputs:
            os.makedirs(self.config.prediction_outputs, exist_ok=True)
            np.save(
                os.path.join(
                    self.config.prediction_outputs, f"task-{task.task_id}.npy"
                ),
                np.concatenate(outs, axis=0),
            )

    def _ship_trace_tail(self, max_beats: int = 8) -> None:
        """Drain the remaining trace buffer to the master over bounded
        extra heartbeats (job end).  Best-effort."""
        rec = trace.default()
        for _ in range(max_beats):
            if not rec.enabled:
                return
            tp = self._trace_payload()
            if tp is None:
                return
            try:
                self.master.call(
                    "Heartbeat",
                    {
                        "worker_id": self.worker_id,
                        "version": self._membership_version,
                        "trace": tp,
                    },
                )
            except Exception:
                logger.info("trace tail ship failed; dropping the tail")
                return

    def _restore_at_start(self) -> None:
        """Adopt the newest restorable step of the LOCAL checkpoint
        directory (not gated on the master's GetCheckpoint: a fresh master
        has no reported checkpoint yet).  Evaluation and prediction jobs
        refuse to score freshly initialized weights."""
        t0 = time.perf_counter()
        self.state = self.trainer.init_state(0)
        self.restore_times["init_s"] += time.perf_counter() - t0
        # Newest first; a step counts only when both halves restore (dense
        # state and host-tier rows): an older intact step beats a torn one.
        steps = self._ckpt.all_steps() if self._ckpt is not None else []
        for step in steps:
            try:
                self.state = self._restore_step(step)
                logger.info("joined from checkpoint step %d", step)
                return
            except FileNotFoundError as e:
                logger.warning(
                    "checkpoint step %d torn (%s); trying older", step, e
                )
        self.trainer.reset_host_stores()
        if self.config.job_type in ("evaluation", "prediction"):
            if self._ckpt is not None:
                raise RuntimeError(
                    f"{self.config.job_type} job found no restorable "
                    f"checkpoint under {self._ckpt.directory} "
                    f"(steps seen: {steps}); refusing to score "
                    "freshly initialized weights"
                )
            logger.warning(
                "%s job has no --checkpoint_dir: scoring FRESHLY "
                "INITIALIZED weights", self.config.job_type,
            )
        if steps:
            logger.error(
                "every retained checkpoint step %s was torn; training from "
                "freshly initialized state", steps,
            )

    def _final_checkpoint(self) -> None:
        """Final checkpoint so a completed job is resumable and servable.
        When the newest complete step already holds this state (a periodic
        save at the same step), it is not written twice; it is reported
        either way.  Rank 0 writes; with sharded state every rank of the
        gang takes part in the snapshot's gathers first, deciding by the
        watermark, which all ranks share (the directory's newest step is
        rank 0's to move)."""
        with self.phases.phase("checkpoint"):
            self._join_ckpt()
            step = self.state.step
            if self._group_mode and self.trainer.sharded_state():
                with self._ckpt_lock:
                    saved = self._last_ckpt_step == step
                snap = None if saved else self._snapshot_state()
                if snap is not None and self.checkpoint_hook is not None:
                    self.checkpoint_hook(step, snap)
                if self._rank != 0:
                    return
                if snap is not None:
                    self._save_snapshot(step, wait=True, state=snap)
                elif self._ckpt.latest_step() == step:
                    self.master.call("ReportCheckpoint", self._checkpoint_report(step))
                else:
                    # No rank holds the whole state to save it again alone.
                    logger.error("the periodic save at step %d failed; the state is "
                                 "sharded, so no final checkpoint", step)
                return
            if self._ckpt.latest_step() != step:
                self._save_snapshot(step, wait=True)
            else:
                self.master.call("ReportCheckpoint", self._checkpoint_report(step))

    # ---- main loop ----

    def run(self, membership: Optional[dict] = None) -> Dict[str, Any]:
        """Main loop.  ``membership``: the view an earlier RegisterWorker
        returned; without it the worker registers here."""
        if membership is None:
            membership = self.master.call(
                "RegisterWorker",
                {
                    "worker_id": self.worker_id,
                    "address": self._advertised_address(),
                    "proto": PROTOCOL_VERSION,
                    "incarnation": self._incarnation,
                    "held_tasks": [],
                },
            )
        self._apply_membership(membership, initial=True)
        if self.state is None:
            self._restore_at_start()

        self._tasks_done = 0
        self._steps_dispatched = self.state.step
        while True:
            if self._preempting:
                # SIGTERM: the preemption thread owns the exit and every
                # report from here on; the loop acknowledges and idles.
                self._parked = True
                time.sleep(self._poll)
                continue
            with self.phases.phase("control"):
                self._check_membership()
                resp = self._next_lease()
            if resp.get("stale"):
                # The world changed under the gang: the next membership
                # check restarts this process.
                time.sleep(self._poll)
                continue
            if resp["task"] is None:
                if resp["finished"]:
                    break
                # Nothing to overlap with: settle the pipelined tasks now —
                # the dispatcher cannot finish (or start an eval round
                # gated on their model_version) until they land.
                self._drain_prep()
                time.sleep(self._poll)
                continue
            task = Task.from_dict(resp["task"])
            # graftchaos: kill / stall(point=task) at the task boundary —
            # after the lease, before any device work.
            chaos.hook(
                "worker:task", rank=self._rank,
                step=self._steps_dispatched, task_id=task.task_id,
            )
            self._task_seq += 1
            self.task_log.append(task.task_id)
            report = {
                "worker_id": self.worker_id,
                "task_id": task.task_id,
                "task_type": task.type,
                "success": True,
            }
            try:
                if task.type == TASK_TRAINING:
                    prof = self._maybe_start_profile()
                    try:
                        if prof is None and self.config.task_pipelining:
                            if self._prep_ahead_eligible():
                                # Queue this task's host half; dispatch the
                                # OLDEST prepped task once the queue holds
                                # more than prep_depth.
                                self._prep_queue.append(
                                    (task, report, self._submit_prep(task))
                                )
                                while len(self._prep_queue) > max(1, self.config.prep_depth):
                                    self._dispatch_prepped(self._prep_queue.popleft())
                                continue
                            # Dispatch this task's steps, then settle the
                            # PREVIOUS task's metrics fetch, report and
                            # checkpoint hook while they run on the card (a
                            # gang settles this one).
                            fetch, n_steps = self._dispatch_training_task(task)
                            self._steps_dispatched += n_steps
                            report["model_version"] = self._steps_dispatched
                            self._training_tasks_done += 1
                            settle = (report, fetch)
                            if not self._group_mode:
                                settle, self._pending = self._pending, settle
                            try:
                                self._flush(settle)
                            except WorkerRestartRequired:
                                raise
                            except Exception:
                                # A report-RPC failure must not fail THIS
                                # task's report (its steps are in the state).
                                logger.exception(
                                    "report of previous pipelined task lost "
                                    "(master task timeout requeues)",
                                )
                            continue
                        metrics = self._run_training_task(task)
                    finally:
                        if prof is not None:
                            self._stop_profile(prof, task.task_id)
                    self._training_tasks_done += 1
                    report["metrics"] = metrics
                    report["model_version"] = self.state.step
                    self._steps_dispatched = self.state.step
                elif task.type == TASK_EVALUATION:
                    # The pipelined train tasks first: their reports must
                    # not trail this round, and the eval scores a settled
                    # state.
                    self._drain_prep()
                    metrics, weight = self._run_evaluation_task(task)
                    report["metrics"] = metrics
                    report["weight"] = weight
                elif task.type == TASK_PREDICTION:
                    self._drain_prep()
                    self._run_prediction_task(task)
                else:
                    raise ValueError(f"unknown task type {task.type}")
            except WorkerRestartRequired:
                raise  # the gang resync already reported and deregistered
            except Exception as e:
                logger.exception("task %d failed", task.task_id)
                report["success"] = False
                if self._group_mode:
                    self._group_resync(report, "synchronous task", e)  # raises
            if not self._group_mode or self._rank == 0:
                # Every rank ran the task's collectives; one report.
                self._report_result(report)
            if report["success"]:
                self._tasks_done += 1
                self._g_tasks.inc()
                self._maybe_checkpoint()

        self._drain_prep()
        if self._prep_pool is not None:
            self._prep_pool.shutdown(wait=True)
            self._prep_pool = None
        self._ingest.shutdown()
        if self._ckpt is not None and (
                self._rank == 0 or (self._group_mode and self.trainer.sharded_state())):
            self._final_checkpoint()
        with self.phases.phase("control"):
            self._ship_trace_tail()
        return {
            "tasks_done": self._tasks_done,
            "step": self.state.step,
            "phase_times": self.phases.snapshot(),
            "tasks": list(self.task_log),
        }
