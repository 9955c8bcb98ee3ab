"""Evaluation scheduling + metric aggregation.

Reference parity (SURVEY.md §2 #6 [U — mount empty at survey time]): the
master schedules evaluation jobs at ``--evaluation_steps`` intervals (and at
epoch end), fans the validation set out as eval tasks through the same task
queue workers already poll, and aggregates the metrics workers report.

Metrics are aggregated as (sum, count) pairs so partial shards and unequal
batch sizes weight correctly.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from elasticdl_tpu_torch.common import locksan
from elasticdl_tpu_torch.data.reader import Shard
from elasticdl_tpu_torch.master.task_dispatcher import (
    TASK_EVALUATION,
    Task,
    TaskDispatcher,
)


class EvaluationService:
    def __init__(
        self,
        eval_shards: List[Shard],
        evaluation_steps: int = 0,
        task_timeout_s: float = 600.0,
    ):
        self._shards = list(eval_shards)
        self._every = evaluation_steps
        self._task_timeout_s = task_timeout_s
        # Held while consulting the round dispatcher's finished()/counts —
        # so it orders before TaskDispatcher._lock, never after.
        self._lock = locksan.lock("EvaluationService._lock")
        self._dispatcher: Optional[TaskDispatcher] = None
        self._last_triggered_version = 0
        self._sums: Dict[str, float] = {}
        self._counts: Dict[str, float] = {}
        self._completed_rounds = 0
        self._latest: Dict[str, float] = {}

    # -- scheduling --

    def maybe_trigger(self, model_version: int) -> bool:
        """Called by the master as training progresses (model_version = global
        step).  Starts an eval round when the interval elapses."""
        if not self._shards or self._every <= 0:
            return False
        with self._lock:
            if self._dispatcher is not None and not self._dispatcher.finished():
                return False  # round in flight
            if model_version - self._last_triggered_version < self._every:
                return False
            self._start_round_locked(model_version)
            return True

    def trigger(self, model_version: int = 0) -> bool:
        """Unconditional round start (epoch end / final eval)."""
        if not self._shards:
            return False
        with self._lock:
            if self._dispatcher is not None and not self._dispatcher.finished():
                return False
            self._start_round_locked(model_version)
            return True

    def _start_round_locked(self, model_version: int) -> None:
        self._dispatcher = TaskDispatcher(
            self._shards,
            num_epochs=1,
            task_type=TASK_EVALUATION,
            task_timeout_s=self._task_timeout_s,
        )
        self._last_triggered_version = model_version
        self._sums, self._counts = {}, {}

    # -- task plumbing (master's get_task consults this first) --

    def get_task(self, worker_id: str) -> Optional[Task]:
        with self._lock:
            dispatcher = self._dispatcher
        if dispatcher is None:
            return None
        return dispatcher.get_task(worker_id)

    def report_task(self, task_id: int, success: bool) -> bool:
        with self._lock:
            dispatcher = self._dispatcher
        if dispatcher is None:
            return False
        ok = dispatcher.report(task_id, success)
        if ok and dispatcher.finished():
            with self._lock:
                self._completed_rounds += 1
                self._latest = self._result_locked()
        return ok

    def recover_tasks(self, worker_id: str) -> List[Task]:
        with self._lock:
            dispatcher = self._dispatcher
        return dispatcher.recover_tasks(worker_id) if dispatcher else []

    def tasks_pending(self) -> bool:
        """True while the in-flight round still has UNDISPATCHED tasks —
        the servicer's heartbeat hint (r9) that a worker holding buffered
        training leases should return them and pull the eval work, keeping
        the round's model-version skew at the pre-lease bound."""
        with self._lock:
            dispatcher = self._dispatcher
        return dispatcher is not None and dispatcher.counts()["todo"] > 0

    # -- metric aggregation --

    def report_metrics(self, metrics: Dict[str, float], weight: float) -> None:
        """Worker reports per-shard metric means with their example count.
        Histogram metrics (streaming AUC — lists) accumulate elementwise
        under the same weighting; histograms are linear, so the weighted
        mean of per-shard histograms IS the pooled histogram up to a scale
        the derived AUC is invariant to."""
        import numpy as np

        with self._lock:
            for name, value in metrics.items():
                value = np.asarray(value, np.float64)
                self._sums[name] = self._sums.get(name, 0.0) + value * weight
                self._counts[name] = self._counts.get(name, 0.0) + weight

    def _result_locked(self) -> Dict[str, float]:
        from elasticdl_tpu_torch.common.metrics import finalize_metrics

        return finalize_metrics({
            name: self._sums[name] / max(self._counts[name], 1e-12)
            for name in self._sums
        })

    def latest_metrics(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._latest)

    def completed_rounds(self) -> int:
        with self._lock:
            return self._completed_rounds

    def enabled(self) -> bool:
        """False when there is no validation data to evaluate on."""
        return bool(self._shards)

    def round_in_flight(self) -> bool:
        with self._lock:
            return self._dispatcher is not None and not self._dispatcher.finished()
