# The PyTorch port's own copy of elasticdl_tpu/serving/micro_batcher.py: the
# port imports nothing of the JAX package.
"""Micro-batching for the online serving tier.

Concurrent single-example ``Predict`` RPCs are individually far too small to
feed a jitted forward efficiently — but the r9 lease work proved the repo's
amortization move: batch many small requests into ONE hot-path crossing.
This module is that move for inference.  gRPC handler threads ``submit()``
their examples; a flusher thread coalesces them into ONE fixed-shape padded
batch and runs the jitted forward once, then fans each request's slice of
the outputs back to its waiting handler.

Flush policy — deadline-or-full:

- **full**: queued examples fill ``max_batch`` (or the next request would
  overflow it) -> flush immediately; under load the batcher converges to
  back-to-back full batches and per-request latency ~= one forward.
- **deadline**: the OLDEST queued request has waited ``max_delay_ms`` ->
  flush whatever is queued; under light load a lone request pays at most
  the deadline plus one forward, never an unbounded wait for company.

Padding is BUCKETED (r19): each flush zero-pads to the smallest declared
``batch_buckets`` size that holds its real rows (``__mask__`` marking the
real ones), so the jitted forward compiles once PER BUCKET — a bounded,
budget-declared set of shapes (serving/server.py registers the bucket count
as the jitsan ``expected_variants`` budget) instead of either extreme:
padding every deadline flush to ``max_batch`` (SERVE_r10 measured 94% of
flushed rows as padding) or recompiling per arbitrary batch size (XLA
compiles are milliseconds-to-seconds, i.e. death on a latency SLO).

Requests ride in PRIORITY LANES (r19): ``online`` (the latency-SLO traffic)
and ``bulk`` (eval scoring, backfills).  Admission is weighted — a flush
takes online requests first and reserves at most a ``bulk_weight`` fraction
of the batch for bulk when both lanes are queued, so bulk saturation cannot
starve online p99s while bulk still drains at a guaranteed trickle.
Overload sheds bulk FIRST: the bulk lane's queue share is bounded at
``bulk_queue_frac`` of the row bound, and an online submit that finds the
queue full evicts the newest queued bulk requests before it would ever shed
itself.  Every shed/expiry is attributed to its lane in ``stats()``.

The runner executes in the flusher thread and is HANDED the current model
snapshot by the server (serving/server.py) — requests in flight during a
hot reload keep the weights they started with; the swap is a reference
assignment, never a drain.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from elasticdl_tpu_torch.common import locksan, trace
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.common.rpc import RpcOverloaded

logger = get_logger("serving.micro_batcher")

MASK_KEY = "__mask__"

#: Priority lanes, highest priority first.  ``online`` is the latency-SLO
#: lane; ``bulk`` is throughput traffic that is admitted at a bounded
#: weight and shed first under overload.
LANES = ("online", "bulk")
DEFAULT_LANE = "online"


class BatcherClosed(RuntimeError):
    """submit() after close(): the server is shutting down."""


class BatcherOverloaded(RpcOverloaded):
    """submit() with the queue at its row bound: the replica is past its
    knee — shed THIS request now (the caller sees a fast structured
    RESOURCE_EXHAUSTED, via the RpcOverloaded mapping at the generic
    handler) instead of queueing it into a wait it cannot survive."""


class PredictionHandle:
    """One request's slot in a future flush: the handler thread parks on
    ``result()`` until the flusher fans the outputs back."""

    __slots__ = ("count", "features", "arrival", "lane", "_event",
                 "_outputs", "_meta", "_error")

    def __init__(self, count: int, features: Dict[str, np.ndarray],
                 arrival: float, lane: str = DEFAULT_LANE):
        self.count = count
        self.features = features
        self.arrival = arrival
        self.lane = lane
        self._event = threading.Event()
        self._outputs: Any = None
        self._meta: Dict[str, Any] = {}
        self._error: Optional[BaseException] = None

    def _resolve(self, outputs: Any, meta: Dict[str, Any]) -> None:
        self._outputs = outputs
        self._meta = meta
        self._event.set()

    def _fail(self, error: BaseException) -> None:
        self._error = error
        self._event.set()

    def result(self, timeout_s: float = 30.0) -> Tuple[Any, Dict[str, Any]]:
        """(outputs sliced to this request's rows, flush metadata).  Raises
        the runner's error, or TimeoutError when no flush resolved us."""
        if not self._event.wait(timeout_s):
            raise TimeoutError(
                f"prediction not served within {timeout_s}s "
                "(flusher wedged or overloaded)"
            )
        if self._error is not None:
            raise self._error
        return self._outputs, self._meta


def _slice_outputs(outputs: Any, lo: int, hi: int) -> Any:
    """Per-request view of the flush outputs: arrays slice on the leading
    (example) dim; dicts slice leaf-wise — covers every model-zoo output
    shape without a jax dependency."""
    if isinstance(outputs, dict):
        return {k: _slice_outputs(v, lo, hi) for k, v in outputs.items()}
    return np.asarray(outputs)[lo:hi]


class _LaneState:
    """One priority lane's queue + attribution counters (guarded-by the
    batcher's _cond, like every other piece of queue state)."""

    __slots__ = ("queue", "queued_rows", "submitted", "shed", "expired",
                 "rows_served")

    def __init__(self) -> None:
        self.queue: List[PredictionHandle] = []
        self.queued_rows = 0
        self.submitted = 0
        self.shed = 0
        self.expired = 0
        self.rows_served = 0


class MicroBatcher:
    """Deadline-or-full request coalescing in front of a batch runner.

    ``runner(batch, n_real) -> (outputs, meta)``: ``batch`` is a dict of
    numpy arrays padded to one of the ``batch_buckets`` row counts (plus
    ``__mask__`` f32 [bucket], 1.0 on real rows); outputs must keep the
    leading example dim; ``meta`` is attached to every request of the flush
    (the server stamps the serving model step).  Runs on the flusher
    thread — blocking there is the design (it IS the accounted inference),
    which is why the runner is not a ``# hot-path`` function but ``submit``
    is.
    """

    def __init__(
        self,
        runner: Callable[[Dict[str, np.ndarray], int], Tuple[Any, Dict]],
        template: Dict[str, np.ndarray],
        max_batch: int = 64,
        max_delay_ms: float = 5.0,
        name: str = "serving",
        max_queue_rows: Optional[int] = None,
        drop_after_s: float = 30.0,
        batch_buckets: Optional[Sequence[int]] = None,
        bulk_weight: float = 0.25,
        bulk_queue_frac: float = 0.5,
    ):
        """Overload policy (sustained load past the replica's knee):

        - ``max_queue_rows`` (default 32 * max_batch): submit() sheds with
          :class:`BatcherOverloaded` once the queue holds this many rows —
          a fast structured error beats queueing into a wait the request
          cannot survive, and it bounds queue memory.
        - ``drop_after_s`` (default 30.0, matching ``PredictionHandle.
          result``'s timeout): a queued request older than this at flush
          time fails with TimeoutError instead of occupying flush slots —
          its handler already gave up, and running a padded forward for
          nobody would deepen the very backlog that expired it.

        Shape policy:

        - ``batch_buckets`` (default ``(max_batch,)``): the padded batch
          sizes this batcher emits.  Each flush pads to the smallest bucket
          holding its real rows; ``max_batch`` is always a bucket so a full
          flush stays legal.  The server declares ``len(batch_buckets)`` as
          the predict step's jitsan variant budget.

        Lane policy:

        - ``bulk_weight``: fraction of a flush reserved for the bulk lane
          while BOTH lanes are queued (weighted admission — bulk cannot
          starve, online keeps the rest).  0.0 = strict priority.
        - ``bulk_queue_frac``: the bulk lane's share of ``max_queue_rows``;
          bulk sheds at this bound (and at the total bound) so a bulk flood
          can never consume the queue capacity online admission relies on.
        """
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if not 0.0 <= bulk_weight < 1.0:
            raise ValueError(f"bulk_weight must be in [0, 1), got {bulk_weight}")
        if not 0.0 < bulk_queue_frac <= 1.0:
            raise ValueError(
                f"bulk_queue_frac must be in (0, 1], got {bulk_queue_frac}"
            )
        buckets = sorted(set(int(b) for b in (batch_buckets or ())) | {max_batch})
        if buckets[0] < 1 or buckets[-1] > max_batch:
            raise ValueError(
                f"batch_buckets must lie in 1..max_batch={max_batch}, "
                f"got {buckets}"
            )
        self.batch_buckets: Tuple[int, ...] = tuple(buckets)
        self._runner = runner
        # Per-feature zero rows at the padded batch shape: built once at
        # max_batch (the largest bucket); a smaller-bucket flush slices the
        # leading rows off these, so a flush only copies request rows in
        # (padded buffers are fresh per flush, the model may donate them).
        self._template = {
            k: np.zeros((max_batch,) + tuple(np.asarray(v).shape[1:]),
                        np.asarray(v).dtype)
            for k, v in template.items()
        }
        self.max_batch = max_batch
        self.max_delay_s = max_delay_ms / 1e3
        self.max_queue_rows = (
            max_queue_rows if max_queue_rows is not None else 32 * max_batch
        )
        self.bulk_weight = bulk_weight
        self.bulk_max_rows = max(1, int(self.max_queue_rows * bulk_queue_frac))
        self.drop_after_s = drop_after_s
        self._lock = locksan.lock("MicroBatcher._lock", leaf=True)  # lock-order: leaf
        self._cond = threading.Condition(self._lock)
        self._lanes: Dict[str, _LaneState] = {ln: _LaneState() for ln in LANES}  # guarded-by: _cond
        self._closed = False  # guarded-by: _cond
        # Counters (stats()): mutated only under the condition lock.
        self._flushes_full = 0  # guarded-by: _cond
        self._flushes_deadline = 0  # guarded-by: _cond
        self._flushes_close = 0  # guarded-by: _cond
        self._rows_served = 0  # guarded-by: _cond
        self._rows_padded = 0  # guarded-by: _cond
        self._flushes_by_bucket: Dict[int, int] = {b: 0 for b in self.batch_buckets}  # guarded-by: _cond
        self._thread = threading.Thread(
            target=self._flush_loop, name=f"edl-serve-flush:{name}", daemon=True
        )
        self._thread.start()

    # -- request side --

    def _queued_rows_locked(self) -> int:  # guarded-by: _cond
        return sum(ln.queued_rows for ln in self._lanes.values())

    # hot-path: the per-request enqueue on the serving critical path — one
    # lock hand-off and a notify, never a device touch or an RPC
    def submit(
        self, features: Dict[str, np.ndarray], lane: str = DEFAULT_LANE
    ) -> PredictionHandle:
        """Queue ``features`` (dict of [n, ...] arrays covering the template
        keys, consistent leading dim 1 <= n <= max_batch) on priority
        ``lane`` for a future flush.  Validation is exhaustive HERE, in the
        offender's own stack frame: a malformed request that only failed
        during batch assembly would fan its error to every innocent request
        co-batched with it."""
        if lane not in LANES:  # the lane SET is a module constant; _lanes stays behind _cond
            raise ValueError(f"unknown priority lane {lane!r}; expected {LANES}")
        missing = [k for k in self._template if k not in features]
        if missing:
            raise ValueError(f"request missing feature(s) {missing}")
        arrays: Dict[str, np.ndarray] = {}
        n = None
        for k, tmpl in self._template.items():
            arr = np.asarray(features[k], tmpl.dtype)
            if arr.shape[1:] != tmpl.shape[1:]:
                raise ValueError(
                    f"feature {k!r} has shape {arr.shape}, expected "
                    f"[n, ...] with trailing dims {tmpl.shape[1:]}"
                )
            if n is None:
                n = arr.shape[0] if arr.ndim else 0
            elif arr.shape[0] != n:
                raise ValueError(
                    f"feature {k!r} carries {arr.shape[0]} examples, "
                    f"earlier features carry {n}"
                )
            arrays[k] = arr
        if not 1 <= (n or 0) <= self.max_batch:
            raise ValueError(
                f"request carries {n} examples; must be 1..{self.max_batch} "
                "(split larger requests client-side)"
            )
        handle = PredictionHandle(n, arrays, time.monotonic(), lane)
        with self._cond:
            if self._closed:
                raise BatcherClosed("micro-batcher is closed")
            st = self._lanes[lane]
            bulk = self._lanes["bulk"]
            if lane == "bulk" and bulk.queued_rows + n > self.bulk_max_rows:
                st.shed += 1
                raise BatcherOverloaded(
                    f"bulk lane holds {bulk.queued_rows} rows (lane bound "
                    f"{self.bulk_max_rows}); shedding bulk — the online lane "
                    "keeps the remaining queue capacity"
                )
            if self._queued_rows_locked() + n > self.max_queue_rows:
                if lane == "online":
                    # Shed bulk first: evict the NEWEST queued bulk requests
                    # (they have waited least) until this online request
                    # fits.  The evicted callers see the same structured
                    # BatcherOverloaded a front-door shed produces.
                    while (bulk.queue
                           and self._queued_rows_locked() + n > self.max_queue_rows):
                        evicted = bulk.queue.pop()
                        bulk.queued_rows -= evicted.count
                        bulk.shed += 1
                        evicted._fail(BatcherOverloaded(
                            "bulk request evicted from the serving queue to "
                            "admit online traffic (shed-bulk-first overload "
                            "policy)"
                        ))
                if self._queued_rows_locked() + n > self.max_queue_rows:
                    st.shed += 1
                    raise BatcherOverloaded(
                        f"queue holds {self._queued_rows_locked()} rows (bound "
                        f"{self.max_queue_rows}); shedding — the replica is "
                        "past its knee, add replicas or lower the offered load"
                    )
            st.queue.append(handle)
            st.queued_rows += n
            st.submitted += 1
            self._cond.notify()
        return handle

    # -- flusher side --

    def _expire_locked(self, now: float) -> None:  # guarded-by: _cond
        """Shed expired requests (queued longer than drop_after_s — their
        handlers have already timed out): running a forward for nobody
        would deepen the backlog that expired them.  Arrival-ordered per
        lane, so each lane's expired set is a prefix."""
        for st in self._lanes.values():
            while st.queue and now - st.queue[0].arrival > self.drop_after_s:
                h = st.queue.pop(0)
                st.queued_rows -= h.count
                st.expired += 1
                h._fail(TimeoutError(
                    f"request expired after {self.drop_after_s}s in the "
                    "serving queue (replica overloaded)"
                ))

    def _take_locked(self) -> Tuple[List[PredictionHandle], str]:  # guarded-by: _cond
        """(requests to flush now, reason) or ([], "") to keep waiting.
        Whole requests only — a request never splits across flushes, so its
        outputs fan back from exactly one runner call.

        Weighted admission: online packs first, but while BOTH lanes are
        queued at most ``1 - bulk_weight`` of the batch goes to online so
        bulk drains at a guaranteed trickle; bulk then fills whatever rows
        remain.  An overflow in either lane flushes immediately ("full") —
        the leftover requests lead the very next flush, so the online cap
        delays online rows by one flush at most, never stalls them."""
        self._expire_locked(time.monotonic())
        online, bulk = self._lanes["online"], self._lanes["bulk"]
        if not online.queue and not bulk.queue:
            return [], ""
        cap_online = self.max_batch
        if bulk.queue and online.queue:
            cap_online = max(1, self.max_batch - int(self.max_batch * self.bulk_weight))
        take: List[PredictionHandle] = []
        rows = 0
        overflow = False
        for i, h in enumerate(online.queue):
            # The weighted cap never blocks the HEAD online request: a
            # request wider than the cap would otherwise starve behind a
            # standing bulk queue (bulk just trickles less that flush).
            limit = self.max_batch if i == 0 else cap_online
            if rows + h.count > limit:
                overflow = True
                break
            take.append(h)
            rows += h.count
        for h in bulk.queue:
            if rows + h.count > self.max_batch:
                overflow = True
                break
            take.append(h)
            rows += h.count
        if rows == self.max_batch or overflow:
            return take, "full"
        if self._closed:
            return take, "close"
        oldest = min(
            q[0].arrival for q in (online.queue, bulk.queue) if q
        )
        if time.monotonic() - oldest >= self.max_delay_s:
            return take, "deadline"
        return [], ""

    def _flush_loop(self) -> None:
        while True:
            with self._cond:
                take, reason = self._take_locked()
                while not take:
                    queues = [st.queue for st in self._lanes.values() if st.queue]
                    if self._closed and not queues:
                        return
                    if queues:
                        # Sleep exactly to the oldest request's deadline.
                        remaining = (
                            min(q[0].arrival for q in queues)
                            + self.max_delay_s - time.monotonic()
                        )
                        self._cond.wait(max(remaining, 0.0))
                    else:
                        self._cond.wait()
                    take, reason = self._take_locked()
                n_real = 0
                for h in take:
                    st = self._lanes[h.lane]
                    st.queue.remove(h)
                    st.queued_rows -= h.count
                    st.rows_served += h.count
                    n_real += h.count
                bucket = next(b for b in self.batch_buckets if b >= n_real)
                if reason == "full":
                    self._flushes_full += 1
                elif reason == "deadline":
                    self._flushes_deadline += 1
                else:
                    self._flushes_close += 1
                self._rows_served += n_real
                self._rows_padded += bucket - n_real
                self._flushes_by_bucket[bucket] += 1
            self._run_flush(take, n_real, bucket)

    def _run_flush(
        self, take: List[PredictionHandle], n_real: int, bucket: int
    ) -> None:
        """Assemble the bucket-padded batch, run it, fan outputs back.
        Runner failures resolve every request of THIS flush with the error
        and the flusher survives — one poisoned batch must not wedge the
        server."""
        try:
            # The flush span IS the serving tier's unit of work: request
            # count + real/padded rows + the chosen bucket beside its wall
            # make batching efficiency (and the padding tax) visible in the
            # merged trace.
            with trace.span(
                "serving:flush", cat="serving", n_requests=len(take),
                n_real=n_real, n_padded=bucket - n_real, bucket=bucket,
            ):
                batch = {
                    k: t[:bucket].copy() for k, t in self._template.items()
                }
                mask = np.zeros((bucket,), np.float32)
                mask[:n_real] = 1.0
                batch[MASK_KEY] = mask
                lo = 0
                for h in take:
                    for k in self._template:
                        arr = np.asarray(
                            h.features[k], self._template[k].dtype
                        )
                        batch[k][lo : lo + h.count] = arr
                    lo += h.count
                outputs, meta = self._runner(batch, n_real)
            lo = 0
            for h in take:
                h._resolve(_slice_outputs(outputs, lo, lo + h.count), meta)
                lo += h.count
        except BaseException as e:  # noqa: BLE001 — fan the failure back
            logger.exception("micro-batch flush of %d request(s) failed", len(take))
            for h in take:
                h._fail(e)

    # -- lifecycle / observability --

    def stats(self) -> Dict[str, Any]:
        """Counters since construction.  Top-level keys are lane-summed
        totals (the pre-lane surface, kept stable for dashboards and the
        bench); ``lanes`` attributes submission/shed/expiry/service to each
        priority lane and ``flushes_by_bucket`` counts flushes per padded
        batch size (JSON-string keys — the stats dict travels in ModelInfo
        responses and stamped artifacts)."""
        with self._cond:
            lanes = {
                name: {
                    "submitted": st.submitted,
                    "queued": len(st.queue),
                    "queued_rows": st.queued_rows,
                    "shed": st.shed,
                    "expired": st.expired,
                    "rows_served": st.rows_served,
                }
                for name, st in self._lanes.items()
            }
            return {
                "submitted": sum(s["submitted"] for s in lanes.values()),
                "queued": sum(s["queued"] for s in lanes.values()),
                "flushes_full": self._flushes_full,
                "flushes_deadline": self._flushes_deadline,
                "flushes_close": self._flushes_close,
                "rows_served": self._rows_served,
                "rows_padded": self._rows_padded,
                "shed_overload": sum(s["shed"] for s in lanes.values()),
                "expired": sum(s["expired"] for s in lanes.values()),
                "lanes": lanes,
                "flushes_by_bucket": {
                    str(b): n for b, n in self._flushes_by_bucket.items()
                },
            }

    def close(self, timeout_s: float = 10.0) -> None:
        """Stop accepting requests, flush what is queued, join the flusher."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._thread.join(timeout_s)
