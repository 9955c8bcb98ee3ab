"""The worker task loop of the PyTorch port, on one device.

Port of ``elasticdl_tpu/worker/worker.py`` for a single process on one
device: lease a task from the master -> read its shard -> feed its
minibatches through ``Trainer.run_train_steps`` (the counterpart of the
fused ``train_scan``) -> report; evaluation and prediction tasks between
them; a background checkpoint every ``checkpoint_steps`` that the serving
tier picks up from the published manifest; restore from the newest
checkpoint at start and after a failed step.

What stays the reference's: the two master proxies (``DirectMasterProxy``,
``RpcMasterProxy`` with its outage ride-through), the lease loop
(``_next_lease``, batched leases returned on an eval-pending or draining
heartbeat), task-level pipelining (``_flush``: the previous task's
metrics fetch and report after this task's steps are dispatched), the
wrap-padded tails with their ``__mask__``, count-weighted eval means
reported raw, report sequence numbers, phase timers, and the checkpoint
watermark with its rollback on a failed background save.

What is left out, each raising ``NotImplementedError`` that names its
ROADMAP item: gang mode (``multihost``), a worker over more than one
device (the membership reform over a mesh), the in-step collective gate
(``collective_deadline_ms``), host-tier I/O (``use_async``, PS
addresses), the profiler (``profile_dir``) and preemption snapshots.  The
worker's one device is its whole mesh, so a membership change is adopted
without re-forming, as the reference does when the mesh is unchanged.
The host half of a task (read + decode) runs inline; prep-ahead and the
parallel ingest pool (``prep_depth``, ``ingest_threads``) are a later
slice.  The worker-loop chaos hooks (``worker:task/prep/step``) come with
the process-level job.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Any, Dict, Iterable, List, Optional

import grpc
import numpy as np
import torch

from elasticdl_tpu_torch import chaos
from elasticdl_tpu_torch.common import gauge as gaugelib
from elasticdl_tpu_torch.common import locksan, trace
from elasticdl_tpu_torch.common.checkpoint import CheckpointManager, state_nbytes
from elasticdl_tpu_torch.common.config import JobConfig
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.common.metrics import PhaseTimers, finalize_metrics
from elasticdl_tpu_torch.common.rpc import (
    PROTOCOL_VERSION,
    BackoffPolicy,
    JsonRpcClient,
    call_with_backoff,
)
from elasticdl_tpu_torch.data.prefetch import prefetch
from elasticdl_tpu_torch.data.reader import AbstractDataReader
from elasticdl_tpu_torch.master.task_dispatcher import (
    TASK_EVALUATION,
    TASK_PREDICTION,
    TASK_TRAINING,
    Task,
)
from elasticdl_tpu_torch.models.spec import ModelSpec, load_model_spec_for_job
from elasticdl_tpu_torch.parallel.trainer import MASK_KEY, Trainer, outputs_to_numpy

logger = get_logger("worker")


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP, PyTorch port queue: {item})"
    )


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
    ):
        if config.multihost:
            raise _not_ported("gang mode (multihost)", "collectives and elastic reform")
        if config.collective_deadline_ms > 0:
            raise _not_ported(
                "the in-step collective gate (collective_deadline_ms)",
                "collectives and elastic reform",
            )
        if config.use_async or config.ps_addresses or config.num_ps_pods:
            raise _not_ported("host-tier I/O (use_async, PS pods)", "the PS host tier")
        if config.profile_dir:
            raise _not_ported("the per-task profiler (profile_dir)", "the process-level job")
        self.config = config
        self.master = master
        self.reader = reader
        self.worker_id = worker_id
        self.spec = spec or load_model_spec_for_job(config)
        self._poll = poll_interval_s
        # The device is this worker's whole mesh: built here, so a worker
        # asked for the card on a machine without one fails at once.
        self.trainer = Trainer(self.spec, device=device)
        self.state = None  # single-writer: main
        self._membership_version = -1  # single-writer: main
        self._rank = 0  # single-writer: main
        self._ckpt: Optional[CheckpointManager] = None
        # Checkpoint watermark + background-save thread handle: touched by
        # the task loop and the background save thread (failure rollback).
        self._ckpt_lock = locksan.lock("Worker._ckpt_lock", leaf=True)  # lock-order: leaf
        self._last_ckpt_step = 0  # guarded-by: _ckpt_lock
        self._ckpt_thread = None  # guarded-by: _ckpt_lock
        # One entry per checkpoint save: step, bytes, the seconds of the
        # device snapshot (enqueue, on the loop; periodic saves only), the
        # host copy and the write, and the wall clock of the publish.
        self.checkpoint_log: List[Dict[str, float]] = []  # guarded-by: _ckpt_lock
        self.recoveries = 0  # failed steps rebuilt from a checkpoint
        # Task-level pipeline: the previous training task's (report, device
        # metrics), fetched + reported only after the NEXT task's steps are
        # dispatched (see run()).
        self._pending: Optional[tuple] = None
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
        """Adopt a membership view.  This worker's one device is its whole
        mesh, so no view changes it: the version is adopted and the trainer
        kept, as the reference does when the mesh is unchanged."""
        version = membership["version"]
        if version == self._membership_version:
            return
        self._rank = dict(membership["ranks"]).get(self.worker_id, 0)
        chaos.set_context(rank=self._rank)
        if not initial:
            logger.info(
                "membership v%d keeps this worker's device; adopting "
                "without re-forming", version,
            )
        self._membership_version = version

    def _restore_checkpoint(self, state_like, step: Optional[int] = None):
        """Restore a checkpoint step into ``state_like``: the canonical
        arrays the manager reads, laid into the live module and optimizer
        (the reference's restore_template + adopt_restored pair)."""
        return self.trainer.adopt_restored(self._ckpt.restore(step), state_like)

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

    def _held_task_ids(self) -> List[int]:
        """Every training-task id this worker still HOLDS: buffered leases
        and the pipelined pending slot — the reconcile handshake's
        inventory."""
        held = [int(e["task"]["task_id"]) for e in self._leased if e.get("task")]
        if self._pending is not None:
            held.append(int(self._pending[0]["task_id"]))
        return held

    def _reconcile_with_master(self) -> None:
        """Post-outage handshake: re-register declaring the leases this
        worker holds; drop the held ones the restarted master no longer
        attributes to it (``stale_tasks``)."""
        held = self._held_task_ids()
        resp = self.master.call(
            "RegisterWorker",
            {
                "worker_id": self.worker_id,
                "address": "",
                "proto": PROTOCOL_VERSION,
                "incarnation": self._incarnation,
                "held_tasks": held,
            },
        )
        stale = {int(t) for t in resp.get("stale_tasks") or []}
        kept = deque(
            e for e in self._leased
            if not (e.get("task") and int(e["task"]["task_id"]) in stale)
        )
        dropped = len(self._leased) - len(kept)
        self._leased = kept
        trace.instant(
            "worker:reconcile", cat="elastic",
            held=len(held), stale=len(stale), dropped=dropped,
            version=resp.get("version"),
        )
        logger.info(
            "reconciled with restarted master: declared %d held lease(s), "
            "dropped %d stale", len(held), dropped,
        )

    def _check_membership(self) -> None:
        take = getattr(self.master, "take_reconnected", None)
        if take is not None and take():
            self._reconcile_with_master()
        hb = {"worker_id": self.worker_id, "version": self._membership_version}
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
        if resp.get("draining") or (resp.get("eval_pending") and self._leased):
            # Max-steps drain, or a pending eval round that buffered leases
            # would delay: return the unstarted leases (requeue-flagged).
            self._abandon_leases()
        if resp["version"] != self._membership_version:
            self._flush_pending()
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
            if self._rank == 0:
                self._save_snapshot_background(step)

    def _save_snapshot(self, step: int, wait: bool = False, state=None,
                       record: Optional[Dict[str, float]] = None) -> None:
        """Write + publish + report one checkpoint.  ``state``: a canonical
        snapshot (``Trainer.snapshot_state``, device or host arrays) to save
        instead of the live state.  ``record`` collects the host-copy and
        write seconds and the bytes."""
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
        if wait:
            # Publish LAST: the manifest is the serving watcher's only
            # trigger, so it must name a step that is completely on disk.
            self._ckpt.publish(step)
            record["published_at"] = time.time()
        with self._ckpt_lock:
            self._last_ckpt_step = step
            self.checkpoint_log.append(dict(record, step=step))
        self.master.call(
            "ReportCheckpoint", self._checkpoint_report(step)
        )

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
        with self._ckpt_lock:
            prev_watermark, self._last_ckpt_step = self._last_ckpt_step, step

        def _bg():
            try:
                with self.phases.phase("checkpoint_bg"):
                    self._save_snapshot(step, wait=True, state=snap, record=record)
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

    def preemption_snapshot(self) -> bool:
        raise _not_ported("preemption snapshots", "the process-level job")

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

    def _dispatch_training_task(self, task: Task) -> tuple:
        """Dispatch every step of a training task through
        ``Trainer.run_train_steps``; returns (the started metrics fetch,
        n_steps).  The minibatches are decoded ahead on the prefetch thread;
        on the card the steps are enqueued without waiting for them (the
        metrics fetch in ``_finalize_training_metrics`` is the wait).  A
        wrap-padded tail carries ``__mask__`` so its duplicated examples
        carry zero gradient."""
        mb = self.config.minibatch_size
        with self.phases.phase("prep_wait"):
            records = self._read_records(task.shard)
        total = len(records)
        n_steps = (total + mb - 1) // mb

        def _gen():
            for chunk, true_count in _minibatches(records, mb, True):
                batch = self.spec.feed(chunk)
                if true_count < mb:
                    batch = dict(batch)
                    batch[MASK_KEY] = _real_mask(mb, true_count)
                yield batch

        try:
            with self.phases.phase("dispatch"):
                self.state, metrics_list = self.trainer.run_train_steps(
                    self.state,
                    prefetch(
                        _gen(), self.config.prefetch_depth,
                        name=f"prefetch:{task.task_id}",
                    ),
                )
        except Exception:
            # The steps update the module and the optimizer in place, so a
            # step that failed part-way leaves a state no one can vouch
            # for: rebuild from the newest checkpoint.  The task is
            # reported failed and requeued either way.
            self._recover_state()
            self._steps_dispatched = self.state.step
            raise
        self._g_examples.inc(total)
        self._g_steps.inc(n_steps)
        return self._start_metrics_fetch(metrics_list), n_steps

    def _start_metrics_fetch(self, metrics_list) -> tuple:
        """Start the host copy of a task's per-step metrics NOW, behind its
        last step on the stream: the deferred fetch then waits for THIS
        task's steps only.  A plain ``.cpu()`` at the fetch would wait for
        every step queued by then — the next task's too — and leave the
        card idle while the loop reports and leases.  Returns (keys, host
        tensor [steps, keys], event or None)."""
        keys = list(metrics_list[0]) if metrics_list else []
        if not keys:
            return keys, torch.zeros((0, 0)), None
        stacked = torch.stack(
            [torch.stack([m[k].detach().float() for k in keys]) for m in metrics_list]
        )
        if stacked.device.type != "cuda":
            return keys, stacked, None
        host = torch.empty(stacked.shape, dtype=stacked.dtype, pin_memory=True)
        host.copy_(stacked, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return keys, host, event

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
                self.state = self._restore_checkpoint(self.state, step=step)
                logger.info("recovered from checkpoint step %d", step)
                return
            except FileNotFoundError:
                continue
        logger.error(
            "no restorable checkpoint; training state re-initialized fresh"
        )

    def _finalize_training_metrics(self, fetch: tuple) -> Dict[str, float]:
        """Wait for a task's metrics copy (``_start_metrics_fetch``), then
        aggregate on the host; each step weighs equally."""
        keys, host, event = fetch
        # The wait is where the task's steps drain ("step_wait"), distinct
        # from the host math after it ("metrics").
        with self.phases.phase("step_wait"):
            if event is not None:
                event.synchronize()
        with self.phases.phase("metrics"):
            values = host.numpy().astype(np.float64)
            return finalize_metrics({k: values[:, i].mean() for i, k in enumerate(keys)})

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
        with self.phases.phase("metrics"):
            self.master.call("ReportTaskResult", report)

    def _flush(self, pending: Optional[tuple]) -> None:
        """Settle a pipelined task: fetch its device metrics, report, and
        run the checkpoint hook.  A fetch failure fails THAT task's report
        (requeued by the master), never the task whose dispatch triggered
        the flush."""
        if pending is None:
            return
        report, fetch = pending
        try:
            report["metrics"] = self._finalize_training_metrics(fetch)
        except Exception:
            logger.exception(
                "task %d failed at metrics fetch", report["task_id"]
            )
            report["success"] = False
            report.pop("metrics", None)
        self._report_result(report)
        if report["success"]:
            self._tasks_done += 1
            self._g_tasks.inc()
            self._maybe_checkpoint()

    def _flush_pending(self) -> None:
        pending, self._pending = self._pending, None
        self._flush(pending)

    def _abandon_leases(self) -> None:
        """Return locally buffered (never-started) task leases to the
        master: a requeue-flagged failure report requeues each immediately
        without charging its retry budget."""
        leased, self._leased = self._leased, deque()
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

        def _batches():
            for chunk, true_count in _minibatches(records, mb, False):
                batch = dict(self.spec.feed(chunk))
                batch[MASK_KEY] = _real_mask(mb, true_count)
                yield batch, true_count

        steps = []
        for batch, true_count in prefetch(
            _batches(), self.config.prefetch_depth,
            name=f"prefetch:{task.task_id}",
        ):
            steps.append((self.trainer.run_eval_step(self.state, batch), true_count))
        sums: Dict[str, Any] = {}
        total = 0.0
        for metrics, true_count in steps:  # the first fetch waits for all
            for k, v in metrics.items():
                sums[k] = sums.get(k, 0.0) + float(v) * true_count
            total += true_count
        return {k: s / max(total, 1e-12) for k, s in sums.items()}, total

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
        self.state = self.trainer.init_state(0)
        steps = self._ckpt.all_steps() if self._ckpt is not None else []
        for step in steps:
            try:
                self.state = self._restore_checkpoint(self.state, step=step)
                logger.info("joined from checkpoint step %d", step)
                return
            except FileNotFoundError as e:
                logger.warning(
                    "checkpoint step %d torn (%s); trying older", step, e
                )
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
        either way."""
        with self.phases.phase("checkpoint"):
            self._join_ckpt()
            step = self.state.step
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
                    "address": "",
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
            with self.phases.phase("control"):
                self._check_membership()
                resp = self._next_lease()
            if resp["task"] is None:
                if resp["finished"]:
                    break
                # Nothing to overlap with: settle the pipelined task now —
                # the dispatcher cannot finish (or start an eval round
                # gated on its model_version) until it lands.
                self._flush_pending()
                time.sleep(self._poll)
                continue
            task = Task.from_dict(resp["task"])
            report = {
                "worker_id": self.worker_id,
                "task_id": task.task_id,
                "task_type": task.type,
                "success": True,
            }
            try:
                if task.type == TASK_TRAINING:
                    if self.config.task_pipelining:
                        # The periodic checkpoint at this task boundary,
                        # before more steps are dispatched: the snapshot
                        # then lands on the step the synchronous loop
                        # would save (the flush below sees the next task's
                        # steps in the mirror already).
                        self._maybe_checkpoint()
                        # Dispatch this task's steps, then settle the
                        # PREVIOUS task's metrics fetch + report while they
                        # run on the card.
                        fetch, n_steps = self._dispatch_training_task(task)
                        self._steps_dispatched += n_steps
                        report["model_version"] = self._steps_dispatched
                        prev, self._pending = self._pending, (report, fetch)
                        try:
                            self._flush(prev)
                        except Exception:
                            # A report-RPC failure must not fail THIS task's
                            # report (its steps are already in the state).
                            logger.exception(
                                "report of previous pipelined task lost "
                                "(master task timeout requeues)",
                            )
                        continue
                    metrics = self._run_training_task(task)
                    report["metrics"] = metrics
                    report["model_version"] = self.state.step
                    self._steps_dispatched = self.state.step
                elif task.type == TASK_EVALUATION:
                    # The pipelined train task first: its report must not
                    # trail this round, and the eval scores a settled state.
                    self._flush_pending()
                    metrics, weight = self._run_evaluation_task(task)
                    report["metrics"] = metrics
                    report["weight"] = weight
                elif task.type == TASK_PREDICTION:
                    self._flush_pending()
                    self._run_prediction_task(task)
                else:
                    raise ValueError(f"unknown task type {task.type}")
            except Exception:
                logger.exception("task %d failed", task.task_id)
                report["success"] = False
            self._report_result(report)
            if report["success"]:
                self._tasks_done += 1
                self._g_tasks.inc()
                self._maybe_checkpoint()

        self._flush_pending()
        if self._ckpt is not None and self._rank == 0:
            self._final_checkpoint()
        with self.phases.phase("control"):
            self._ship_trace_tail()
        return {
            "tasks_done": self._tasks_done,
            "step": self.state.step,
            "phase_times": self.phases.snapshot(),
        }
