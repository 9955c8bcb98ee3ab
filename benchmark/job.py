"""The elastic job a cell runs, built from the program's own parts: the
master (``TaskDispatcher``, an ``EvaluationService`` where the traffic
evaluates, ``MasterServicer`` behind a ``MasterServer`` on localhost gRPC)
and one ``Worker`` over ``RpcMasterProxy``, the path a user's worker
takes.

The benchmark only watches: ``TimedProxy`` stamps every lease and report
on the host clock, and ``BenchWorker`` records what the correctness check
needs (the order of the training batches, the first tasks' per-step
losses, the state after them, the evaluation rounds it ran) and, when
asked, runs ``torch.profiler`` on the task loop's thread with a named
range around each part of the loop.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Any, Dict, List, Optional

import torch

from elasticdl_tpu_torch.common.config import JobConfig
from elasticdl_tpu_torch.data.reader import RecordIODataReader
from elasticdl_tpu_torch.master.evaluation_service import EvaluationService
from elasticdl_tpu_torch.master.servicer import MasterServer, MasterServicer
from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
from elasticdl_tpu_torch.worker.main import build_job_reader
from elasticdl_tpu_torch.worker.worker import RpcMasterProxy, Worker

#: Passes over the training file the dispatcher may hand out: more than a
#: run reaches; the harness stops the dispatcher when the window closes.
EPOCHS = 1_000_000


class TaskLog:
    """Host-clock stamps of the job's leases and reports (thread-safe: the
    task loop reports while the harness reads)."""

    def __init__(self):
        self._lock = threading.RLock()
        self.leased: Dict[int, float] = {}
        self.shards: Dict[int, tuple] = {}
        #: (report time, task id, type, success, records, lease time)
        self.reports: List[tuple] = []
        self._done: Dict[str, int] = {}  # successful reports by task type
        self.changed = threading.Condition(self._lock)

    def lease(self, task: dict, now: float) -> None:
        with self._lock:
            self.leased[task["task_id"]] = now
            s = task["shard"]
            self.shards[task["task_id"]] = (s["start"], s["end"])

    def report(self, request: dict, now: float) -> None:
        with self._lock:
            tid = request["task_id"]
            start, end = self.shards.get(tid, (0, 0))
            ok = bool(request.get("success", True))
            self.reports.append((now, tid, request.get("task_type"), ok, end - start,
                                 self.leased.get(tid, now)))
            if ok:
                kind = request.get("task_type")
                self._done[kind] = self._done.get(kind, 0) + 1
            self.changed.notify_all()

    def count(self, task_type: str) -> int:
        """Successful reports of ``task_type`` so far."""
        with self._lock:
            return self._done.get(task_type, 0)


class TimedProxy(RpcMasterProxy):
    """The worker's gRPC proxy to the master, with each lease and report
    stamped when its call returns."""

    def __init__(self, address: str, log: TaskLog, on_event=None, **kwargs):
        super().__init__(address, **kwargs)
        self.log = log
        self._on_event = on_event

    def call(self, method: str, request: dict) -> dict:
        resp = super().call(method, request)
        now = time.perf_counter()
        if method == "GetTask":
            for task in resp.get("tasks") or ([resp["task"]] if resp.get("task") else []):
                self.log.lease(task, now)
        elif method == "ReportTaskResult" and not request.get("requeue"):
            self.log.report(request, now)
        if self._on_event is not None:
            self._on_event(method, request)
        return resp


class Profiling:
    """A request to profile the task loop from one host-clock time to
    another, served by the loop itself at task boundaries (the profiler
    records the CPU ranges of the thread that starts it). The first
    boundary starts and stops a profile at once, so that the profiler's
    own first start falls in the set-up."""

    def __init__(self, start: float, stop: float):
        self.start_at, self.stop_at = start, stop
        self.warm = False
        self.active = None  # the running profile
        self.result = None  # the profile once stopped
        self.window = None  # (host start, host stop) of the result


class BenchWorker(Worker):
    """``Worker`` with the benchmark's records; it trains exactly as the
    program's ``Worker`` does."""

    def __init__(self, *args, family=None, cfg: dict = None, record_tasks: int = 2, **kwargs):
        super().__init__(*args, **kwargs)
        self._family, self._cfg = family, cfg
        self._record_tasks = record_tasks
        #: (start, end) rows of every training step, in dispatch order.
        self.steps: List[tuple] = []
        #: Per-step losses of the first ``record_tasks`` training tasks.
        self.first_losses: List[float] = []
        #: Host copies of the parameters and first moments after them.
        self.first_state: Optional[dict] = None
        self.first_state_step = 0
        #: (step, metrics) of each evaluation task.
        self.evals: List[tuple] = []
        self.profiling: Optional[Profiling] = None
        self._fetches: Dict[int, int] = {}
        self._dispatched = 0

    # ---- records ----

    def _dispatch_training_task(self, task, prep=None) -> tuple:
        with self._range("dispatch"):
            fetch, n_steps = super()._dispatch_training_task(task, prep)
        mb = self.config.minibatch_size
        s = task.shard
        self.steps += [(a, min(a + mb, s.end)) for a in range(s.start, s.end, mb)]
        if self._dispatched < self._record_tasks:
            self._fetches[id(fetch)] = self._dispatched
        self._dispatched += 1
        if self._dispatched == self._record_tasks:
            self.first_state_step = self.state.step
            self.first_state = _to_host(self._family.read_state(
                self._cfg, self.state.model, self.state.optimizer))
        return fetch, n_steps

    def _finalize_training_metrics(self, fetch: tuple) -> Dict[str, float]:
        with self._range("step_wait+metrics"):
            out = super()._finalize_training_metrics(fetch)
        if self._fetches.pop(id(fetch), None) is not None:
            keys, shapes, host, _ = fetch
            at = sum(int(torch.Size(s).numel()) for s in shapes[:keys.index("loss")])
            self.first_losses += host[:, at].tolist()
        return out

    def _run_evaluation_task(self, task) -> tuple:
        with self._range("evaluation"):
            metrics, weight = super()._run_evaluation_task(task)
        self.evals.append((self.state.step, dict(metrics)))
        return metrics, weight

    # ---- profiling ----

    def _range(self, name: str):
        if self.profiling is None or self.profiling.active is None:
            return contextlib.nullcontext()
        return torch.profiler.record_function(f"bench:{name}")

    def _serve_profiling(self) -> None:
        p = self.profiling
        if p is None or p.result is not None:
            return
        from torch.profiler import ProfilerActivity, profile

        if not p.warm:
            warm = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            warm.start()
            warm.stop()
            p.warm = True
        now = time.perf_counter()
        if p.active is None and now >= p.start_at:
            p.active = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            p.active.start()
            p.window = (time.perf_counter(), None)
        elif p.active is not None and now >= p.stop_at:
            torch.cuda.synchronize()
            p.window = (p.window[0], time.perf_counter())
            p.active.stop()
            p.result, p.active = p.active, None

    def _next_lease(self) -> dict:
        self._serve_profiling()
        with self._range("lease"):
            return super()._next_lease()

    def _dispatch_prepped(self, prepped: tuple) -> None:
        with self._range("prep_wait+settle"):
            super()._dispatch_prepped(prepped)

    def _report_result(self, report: dict) -> None:
        with self._range("report"):
            super()._report_result(report)

    def _maybe_checkpoint(self) -> None:
        with self._range("checkpoint"):
            super()._maybe_checkpoint()

    def _check_membership(self) -> None:
        with self._range("control"):
            super()._check_membership()

    def finish_profiling(self) -> None:
        """Stop a profile the loop left running (it ended first)."""
        p = self.profiling
        if p is not None and p.active is not None:
            p.stop_at = 0.0
            self._serve_profiling()


def _to_host(state: Dict[str, Dict[str, torch.Tensor]]) -> Dict[str, Dict[str, torch.Tensor]]:
    """Copies of ``state``'s tensors in pinned host memory, enqueued behind
    the steps already on the stream (the caller synchronises before it
    reads them)."""
    out = {}
    for group, tensors in state.items():
        out[group] = {}
        for k, t in tensors.items():
            if t.is_cuda:
                host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                host.copy_(t, non_blocking=True)
            else:
                host = t.detach().clone()
            out[group][k] = host
    return out


def job_config(cfg: dict, traffic: dict, family, data: dict, run_dir: str) -> JobConfig:
    """The cell's ``JobConfig``: the model from the configuration, the
    schedule and the pipeline from the traffic, the rest the job's
    defaults."""
    ckpt = traffic.get("checkpoint_steps", 0)
    return JobConfig(
        model_def=cfg["model_def"],
        model_params=family.model_params(cfg),
        learning_rate=cfg["learning_rate"],
        compute_dtype=cfg["compute_dtype"],
        training_data=data["train_path"],
        validation_data=data.get("val_path", ""),
        minibatch_size=traffic["minibatch_size"],
        num_minibatches_per_task=traffic["num_minibatches_per_task"],
        num_epochs=EPOCHS,
        evaluation_steps=traffic.get("evaluation_steps", 0),
        prep_depth=traffic.get("prep_depth", JobConfig.prep_depth),
        ingest_threads=traffic.get("ingest_threads", JobConfig.ingest_threads),
        checkpoint_steps=ckpt,
        checkpoint_dir=os.path.join(run_dir, "checkpoints") if ckpt else "",
        keep_checkpoint_max=traffic.get("keep_checkpoint_max", JobConfig.keep_checkpoint_max),
    )


class Job:
    """The master and one worker of a cell, the worker's loop on a thread
    of its own."""

    def __init__(self, job: JobConfig, family, cfg: dict, device: Any, record_tasks: int,
                 log=lambda msg: None):
        records_per_task = job.minibatch_size * job.num_minibatches_per_task
        t0 = time.monotonic()
        reader = RecordIODataReader(job.training_data)
        shards = reader.create_shards(records_per_task)
        log(f"[bench] the training file indexed in {time.monotonic() - t0:.2f} s")
        self.dispatcher = TaskDispatcher(shards, num_epochs=EPOCHS,
                                         task_timeout_s=job.task_timeout_s)
        self.evaluation = None
        if job.validation_data:
            val = RecordIODataReader(job.validation_data)
            self.evaluation = EvaluationService(val.create_shards(records_per_task),
                                                evaluation_steps=job.evaluation_steps,
                                                task_timeout_s=job.task_timeout_s)
        self.servicer = MasterServicer(self.dispatcher, evaluation=self.evaluation)
        self.server = MasterServer(self.servicer, port=0).start()
        self.log = TaskLog()
        self._hooks: List = []
        self.proxy = TimedProxy(self.server.address, self.log, on_event=self._on_event,
                                call_timeout_s=job.master_call_timeout_s,
                                outage_tolerance_s=job.master_outage_tolerance_s)
        log(f"[bench] master up in {time.monotonic() - t0:.2f} s")
        self.worker = BenchWorker(job, self.proxy, build_job_reader(job), family=family, cfg=cfg,
                                  device=device, record_tasks=record_tasks)
        self.error: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None

    def on_event(self, hook) -> None:
        """Call ``hook(method, request)`` after each master call of the
        worker (on the calling thread)."""
        self._hooks.append(hook)

    def _on_event(self, method: str, request: dict) -> None:
        for hook in list(self._hooks):
            hook(method, request)

    def start(self) -> None:
        def run():
            try:
                self.worker.run()
            except BaseException as e:  # re-raised by the harness's waits
                self.error = e
            finally:
                with self.log.changed:
                    self.log.changed.notify_all()

        self._thread = threading.Thread(target=run, name="bench-worker", daemon=True)
        self._thread.start()

    def wait_for(self, predicate, timeout: float) -> None:
        """Block until ``predicate()`` holds; raise if the worker failed or
        ended first, or on ``timeout``."""
        deadline = time.monotonic() + timeout
        with self.log.changed:
            while not predicate():
                if self.error is not None:
                    raise RuntimeError("the worker failed") from self.error
                if not self._thread.is_alive():
                    raise RuntimeError("the worker ended before the window")
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"the job's warm-up took more than {timeout:.0f} s")
                self.log.changed.wait(min(left, 1.0))

    def stop(self, timeout: float) -> None:
        """Stop handing out tasks, let the worker settle what it holds and
        end, then stop the master."""
        self.dispatcher.stop()
        self._thread.join(timeout)
        alive = self._thread.is_alive()
        self.proxy.close()
        self.server.stop(grace=1.0)
        if alive:
            raise TimeoutError(f"the worker did not end within {timeout:.0f} s of the window")
        if self.error is not None:
            raise RuntimeError("the worker failed") from self.error
