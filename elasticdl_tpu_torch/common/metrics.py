"""Metrics writer — the master's structured observability sink.

Reference parity (SURVEY.md §5 "Metrics/logging/observability" [U — mount
empty at survey time]): the reference surfaces eval metrics via gRPC to the
master and optionally TensorBoard through Keras callbacks.  Here the master
appends every training/eval metric report to a JSONL stream (one
machine-parseable record per event, crash-safe append) and mirrors scalars
to TensorBoard when ``tensorboardX`` is importable.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Dict, Optional

from elasticdl_tpu_torch.common import locksan, trace
from elasticdl_tpu_torch.common.log_utils import get_logger

logger = get_logger("metrics")

#: The master's JSONL scalar stream under its metrics directory.  Durable
#: in the WAL-reader sense (torn-tail-tolerant reads via durable.read_wal)
#: but written ADVISORY: records are flushed, never fsync'd — losing the
#: page-cache tail of a metrics stream costs observability, not
#: correctness, and an fsync per scalar report would serialize the
#: master's report handlers on the disk.
METRICS_FILENAME = "metrics.jsonl"  # durable-file

#: Metric keys with this prefix carry HISTOGRAM vectors, not scalars.  They
#: flow through every aggregation layer (device psum, worker minibatch sums,
#: master cross-worker weighted means) unchanged in meaning — histograms are
#: linear, and the scalars derived from them (AUC) are scale-invariant, so
#: weighted MEANS aggregate as exactly as sums would.  ``finalize_metrics``
#: converts them to their scalar at the last step of each pipeline.
HIST_PREFIX = "__hist__"

#: The one histogram-derived metric so far: ROC AUC from score histograms
#: (the reference evaluates Criteo/DeepFM on AUC via TF's bucketed streaming
#: AUC — same construction).
AUC_POS = HIST_PREFIX + "auc_pos"
AUC_NEG = HIST_PREFIX + "auc_neg"


def auc_from_histograms(pos, neg) -> float:
    """ROC AUC from per-score-bucket positive/negative counts.

    Rank-statistic identity: AUC = P(score_pos > score_neg) + 0.5 *
    P(tie).  Bucketed: each positive in bucket b beats every negative in
    buckets < b and half-ties the negatives in bucket b.  Exact for scores
    quantized to the bucket grid; O(1/n_bins) bias otherwise — identical to
    TF's thresholded streaming AUC.  Degenerate sets (no positives or no
    negatives) return 0.5.
    """
    import numpy as np

    pos = np.asarray(pos, np.float64)
    neg = np.asarray(neg, np.float64)
    p, n = pos.sum(), neg.sum()
    if p <= 0 or n <= 0:
        return 0.5
    neg_below = np.concatenate([[0.0], np.cumsum(neg)[:-1]])
    wins = float(np.sum(pos * (neg_below + 0.5 * neg)))
    # Plain python float: np.float64 leaks would crash json.dumps on the
    # gRPC JobStatus / metrics-report paths.
    return float(wins / (p * n))


def finalize_metrics(metrics: Dict) -> Dict[str, float]:
    """Scalar-ize a metrics dict: plain entries -> float, histogram pairs ->
    their derived scalar ("auc"), raw histogram vectors dropped."""
    out: Dict[str, float] = {}
    for k, v in metrics.items():
        if not k.startswith(HIST_PREFIX):
            out[k] = float(v)
    if AUC_POS in metrics and AUC_NEG in metrics:
        out["auc"] = auc_from_histograms(metrics[AUC_POS], metrics[AUC_NEG])
    return out


class PhaseTimers:
    """Cumulative wall-clock per named worker task-loop phase.

    The job-vs-bench throughput gap (TRAINJOB_r05 53k ex/s/chip vs BENCH_r05
    289k) was guessed at until these timers: the worker decomposes its task
    wall into named phases so the gap is attributable instead of folklore.
    Phase names used by the worker loop:

    - ``prep_wait``   blocked on host ingest (bulk read + decode + stack, or
                      the prep-ahead future when pipelined)
    - ``dispatch``    issuing device work (H2D transfer + step/scan dispatch;
                      includes the first task's XLA compile)
    - ``step_wait``   draining device execution at the deferred metrics fetch
    - ``metrics``     host-side metric aggregation + the report RPC
    - ``checkpoint``  task-loop boundary cost of periodic checkpoints
                      (snapshot dispatch + in-flight-save joins + final save)
    - ``control``     task-boundary control-plane overhead (heartbeat +
                      membership checks; the lease RPC nests under it and
                      keeps only its own time)
    - ``lease_wait``  the task-lease RPC itself (GetTask/GetGroupTask) —
                      with batched leases (r9) this fires once per batch,
                      so its per-task share is the lease amortization win
    - ``checkpoint_bg``  background checkpoint write + commit-barrier time —
                      OFF the critical path, excluded from wall sums
    - ``decode_parallel``  cumulative ingest-pool thread time in parallel
                      chunk read+decode (r9) — runs CONCURRENTLY with the
                      foreground phases (and with itself, across threads),
                      so it is off the critical path like ``checkpoint_bg``;
                      compare it against ``prep_wait`` to see how much
                      decode the pool hid

    The snapshot rides every ReportTaskResult/ReportCheckpoint, so the
    master's view (JobStatus ``phase_times``) and the train-job artifact get
    the decomposition without a new RPC.  Cost per entry: two
    ``perf_counter`` calls and a locked dict add — noise next to any phase
    worth timing.

    Thread-safe: the background checkpoint thread records under its own key
    while the task loop records the foreground phases.

    Nested phases record SELF-time: a phase entered inside another phase
    (e.g. a membership change inside the ``control`` heartbeat draining a
    pipelined task through its dispatch/metrics/checkpoint phases)
    subtracts its wall from the enclosing phase, so each second of the
    task loop lands in exactly one bucket and the decomposition stays a
    partition of (bounded by) wall time.  The nesting stack is per-thread
    — a background phase never subtracts from a foreground one.
    """

    def __init__(self, gauges=None):
        self._lock = locksan.lock("PhaseTimers._lock", leaf=True)  # lock-order: leaf
        self._seconds: Dict[str, float] = {}
        self._counts: Dict[str, int] = {}
        self._local = threading.local()
        # graftgauge (r14): with a registry wired, every phase ENTRY also
        # observes into a per-phase duration histogram (shared log grid),
        # so a live scrape shows the phase tail SHAPE — the cumulative
        # seconds alone cannot tell "one 2 s stall" from "2000 stalls of
        # 1 ms".  Histogram handles are cached per phase name: the add()
        # path pays one dict lookup + an O(1) observe, not a registry
        # walk.
        self._gauges = gauges
        self._phase_hists: Dict[str, object] = {}  # guarded-by: _lock

    @contextlib.contextmanager
    def phase(self, name: str):
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        child_wall = [0.0]
        stack.append(child_wall)
        # Every phase doubles as a trace span (category "phase") when the
        # process recorder is on: the cross-process trace view decomposes
        # by the SAME names as the cumulative timers, and the span's
        # independent self-time arithmetic is pinned against ours by tests.
        # Disabled, span() is a shared no-op — one attribute check.
        sp = trace.span(name, cat="phase")
        sp.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            elapsed = time.perf_counter() - t0
            sp.__exit__(None, None, None)
            stack.pop()
            if stack:
                # Report the full wall to the enclosing phase so IT can
                # subtract; this phase keeps only its self-time.
                stack[-1][0] += elapsed
            self.add(name, elapsed - child_wall[0])

    def add(self, name: str, seconds: float) -> None:
        with self._lock:
            self._seconds[name] = self._seconds.get(name, 0.0) + seconds
            self._counts[name] = self._counts.get(name, 0) + 1
            hist = self._phase_hists.get(name)
        if self._gauges is None:
            return
        if hist is None:
            # Created OUTSIDE our leaf lock (the registry lookup takes
            # the registry's own leaf; nesting the two would break both
            # declarations).  Registry.histogram is idempotent, so a
            # racing creation converges on the same series.
            hist = self._gauges.histogram(
                "edl_phase_ms",
                "per-entry wall of each task-loop phase (self-time)",
                labels={"phase": name},
            )
            with self._lock:
                self._phase_hists[name] = hist
        hist.observe(seconds * 1e3)

    def snapshot(self) -> Dict[str, float]:
        """Cumulative seconds per phase (plain floats — JSON/RPC-safe)."""
        with self._lock:
            return {k: round(v, 6) for k, v in self._seconds.items()}

    def counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)


#: Phases that consume task-loop wall-clock (everything but the background
#: checkpoint write and the ingest pool's parallel decode time, which run
#: concurrently with the foreground phases).  Consumers summing a
#: decomposition against wall time must restrict to these.
CRITICAL_PATH_PHASES = (
    "prep_wait", "dispatch", "step_wait", "metrics", "checkpoint", "control",
    "lease_wait", "collective_gate",
)


def critical_path_seconds(phase_times: Dict[str, float]) -> float:
    """Sum of the wall-consuming phases of one worker's snapshot."""
    return float(
        sum(v for k, v in phase_times.items() if k in CRITICAL_PATH_PHASES)
    )


class MetricsWriter:
    """Append-only JSONL scalar stream + optional TensorBoard mirror.

    One append handle for the stream's whole life (closed in ``close()``):
    the old open-per-record idiom paid an open/close syscall pair per
    report AND left a window where a crash mid-write tore the final line
    with no reader-side tolerance.  Crash-safe append now means what it
    says: each record is one ``write`` of a full line followed by a flush
    (the OS appends atomically for these sizes), and ``read_metrics``
    drops a torn FINAL line instead of raising.
    """

    def __init__(self, directory: str, tensorboard: bool = True):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self._path = os.path.join(self.directory, METRICS_FILENAME)
        self._lock = locksan.lock("MetricsWriter._lock", leaf=True)  # lock-order: leaf
        # graftlint: allow[durable-write-discipline] metrics are advisory: buffered flush-only appends by contract (fsync per scalar would serialize report handlers on the disk); reader is torn-tolerant
        self._f = open(self._path, "a")  # guarded-by: _lock
        self._tb = None
        if tensorboard:
            try:
                from tensorboardX import SummaryWriter  # type: ignore

                self._tb = SummaryWriter(
                    logdir=os.path.join(self.directory, "tensorboard")
                )
            except Exception:  # pragma: no cover - tensorboardX optional
                logger.info("tensorboardX unavailable; JSONL metrics only")

    def write(self, kind: str, step: int, metrics: Dict[str, float]) -> None:
        """Record one scalar group: kind is "train" | "eval" | custom."""
        record = {
            "ts": time.time(),
            "kind": kind,
            "step": int(step),
            **{k: float(v) for k, v in metrics.items()},
        }
        line = json.dumps(record, sort_keys=True)
        with self._lock:
            if self._f is None:
                # A report racing close() (gRPC pool thread vs master
                # teardown) must not crash the handler: reopen for the
                # straggler record — append keeps the stream consistent.
                # graftlint: allow[durable-write-discipline] same advisory-append contract as the primary handle above
                self._f = open(self._path, "a")
            self._f.write(line + "\n")
            self._f.flush()
            if self._tb is not None:
                for key, value in metrics.items():
                    self._tb.add_scalar(f"{kind}/{key}", float(value), int(step))

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None
            if self._tb is not None:
                self._tb.close()
                self._tb = None


# recovery-path
def read_metrics(directory: str) -> list:
    """All records of a job's metrics.jsonl (tests, CLI inspection).

    Tolerates a torn FINAL line — the one legal artifact of a crash mid-
    append — by dropping it; garbage anywhere earlier still raises (that is
    corruption, not a crash tail, and silently skipping it would hide it).
    The r12 stance, generalized: durable.read_wal is the one definition.
    """
    from elasticdl_tpu_torch.common import durable

    path = os.path.join(os.path.abspath(directory), METRICS_FILENAME)
    if not os.path.exists(path):
        return []
    records, _torn = durable.read_wal(path)
    return records
