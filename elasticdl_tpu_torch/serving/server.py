"""The online serving tier of the PyTorch port: micro-batched inference
over gRPC, for one model-zoo model on one device.

Port of ``elasticdl_tpu/serving/server.py``, with the same Predict /
ModelInfo wire contract (``common/rpc.py`` SERVING_SCHEMAS):

- **Forward**: the port's ``Trainer.run_predict_step`` on the card (or the
  CPU, when asked), one forward per micro-batcher flush, on a batch padded
  to a declared bucket.
- **Micro-batching**: ``serving/micro_batcher.MicroBatcher``, unchanged —
  deadline-or-full flush, bucketed padding, priority lanes, per-request
  fan-back.
- **Weights**: a training job's checkpoint directory — the newest
  PUBLISHED step loads at startup and ``CheckpointWatcher`` hot-reloads
  every later publish (any change of step, backwards too) — or fresh
  (from ``seed``), or carried in through ``state`` (for example a JAX
  model's weights via ``transformer_lm.params_from_jax``).  A reload
  builds a private module on the watcher thread (restore, device
  placement, one forward at the smallest bucket so the first request after
  the cut-over pays no weight casts) while serving continues; the cut-over
  is one reference swap under a leaf lock.  The PS host tier with its
  hot-id cache is a later slice of the port; asking for it raises.

Live metrics as in the reference, plus ``edl_kernel_launches_total{kernel=}``
— the hand-written kernels' launch counts (``ops/kernels.py``), read at
scrape time.
"""

from __future__ import annotations

import time
from concurrent import futures
from typing import Any, Dict, Optional, Sequence, Tuple

import grpc
import numpy as np
import torch

from elasticdl_tpu_torch.common import gauge as gaugelib
from elasticdl_tpu_torch.common import locksan
from elasticdl_tpu_torch.common.checkpoint import CheckpointManager, read_manifest
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.common.rpc import (
    SERVING_SCHEMAS,
    SERVING_SERVICE_NAME,
    SchemaError,
    make_generic_handler,
)
from elasticdl_tpu_torch.ops import kernels
from elasticdl_tpu_torch.parallel.trainer import (
    PARAMS,
    STEP_KEY,
    Trainer,
    TrainState,
    outputs_to_numpy,
)
from elasticdl_tpu_torch.serving.checkpoint_watcher import CheckpointWatcher
from elasticdl_tpu_torch.serving.micro_batcher import (
    DEFAULT_LANE,
    LANES,
    MASK_KEY,
    MicroBatcher,
)

logger = get_logger("serving.server")

#: The canonical-state paths a replica reads: the parameters and the step
#: (the optimizer's moments stay on disk).
SERVED_PATHS = (PARAMS, STEP_KEY)

#: Feature keys of the model's example batch that are NOT client features.
_NON_FEATURE_KEYS = ("labels", MASK_KEY)


def _listify(outputs: Any) -> Any:
    """Flush outputs -> JSON-ready nested lists, leaf-wise for dict-shaped
    model outputs (the shapes micro_batcher._slice_outputs fans back)."""
    if isinstance(outputs, dict):
        return {k: _listify(v) for k, v in outputs.items()}
    return np.asarray(outputs).tolist()


class _LiveModel:
    """One immutable serving snapshot: the unit the hot reload swaps.
    Requests in flight keep the instance they were handed — the swap can
    never tear a half-old/half-new forward."""

    __slots__ = ("step", "state")

    def __init__(self, step: int, state: Any):
        self.step = step
        self.state = state


class ServingServer:
    """Micro-batched prediction service over one model-zoo model.

    ``device``: ``"cuda"`` unless the caller asks for ``"cpu"`` (no CUDA
    and no explicit ``"cpu"`` raises).  ``checkpoint_dir``: a training
    job's checkpoint directory; the newest published step loads at startup
    (fresh weights otherwise, logged loudly) and the watcher, polling every
    ``poll_interval_s``, hot-reloads each later publish.  ``state``:
    weights to serve instead of fresh ones from ``seed``, already on that
    device.
    """

    def __init__(
        self,
        spec: Any,
        checkpoint_dir: str = "",
        ps_addresses: str = "",
        max_batch: int = 64,
        max_delay_ms: float = 5.0,
        poll_interval_s: float = 0.5,
        port: int = 0,
        max_workers: int = 16,
        seed: int = 0,
        gauges: Optional[gaugelib.Registry] = None,
        gauge_port: int = -1,
        target_p99_ms: float = 100.0,
        batch_buckets: Optional[Sequence[int]] = None,
        bulk_weight: float = 0.25,
        max_queue_rows: Optional[int] = None,
        state: Optional[torch.nn.Module] = None,
        device: Any = None,
    ):
        if ps_addresses:
            raise NotImplementedError(
                "the PS host tier is not ported yet (ROADMAP, PyTorch port "
                "queue: the PS host tier)"
            )
        self.spec = spec
        self.max_batch = max_batch
        self.max_delay_ms = max_delay_ms
        self.trainer = Trainer(spec, device=device)
        # The padded-shape buckets this replica serves: each flush pads to
        # the smallest bucket that holds its real rows.
        self._shape_buckets = tuple(
            sorted(set(int(b) for b in (batch_buckets or ())) | {max_batch})
        )
        # The step to serve from checkpoint_dir at startup, if any: its
        # restore builds the module, and no fresh weights are made.
        self._ckpt: Optional[CheckpointManager] = None
        start: Optional[Tuple[int, Dict[str, Any]]] = None
        if checkpoint_dir:
            self._ckpt = CheckpointManager(checkpoint_dir)
            manifest = read_manifest(checkpoint_dir)
            if manifest is not None:
                start = (int(manifest["step"]), manifest)
            else:
                # No published manifest: serve the newest complete step
                # once, loudly; the watcher keys strictly off the manifest
                # from here on.
                step = self._ckpt.latest_step()
                if step is not None:
                    logger.warning(
                        "no published manifest under %s; serving the newest "
                        "step %d", checkpoint_dir, step,
                    )
                    start = (int(step), {})
                else:
                    logger.warning(
                        "no checkpoint under %s: serving FRESHLY "
                        "INITIALIZED weights", checkpoint_dir,
                    )
        if state is None and start is None:
            state = self.spec.init(seed=seed, device=self.trainer.device)
        self._state_lock = locksan.lock("ServingServer._state_lock", leaf=True)  # lock-order: leaf
        # None until the startup restore below swaps its module in.
        self._live = _LiveModel(-1, None if state is None else state.eval())  # guarded-by: _state_lock
        self._requests = 0  # guarded-by: _state_lock
        self._reloads = 0  # guarded-by: _state_lock
        self._last_swap_ms = 0.0  # guarded-by: _state_lock
        self._last_load_s = 0.0  # guarded-by: _state_lock
        # (step, load seconds, swap ms, wall clock of the cut-over) per
        # reload: the publish-to-live reading.
        self.reload_log: list = []  # guarded-by: _state_lock

        # Client-facing feature template (dtype/shape contract, ModelInfo).
        example = spec.example_batch(max_batch) if spec.example_batch else None
        if example is None:
            raise ValueError(
                f"model {spec.name!r} declares no example_batch; the serving "
                "tier needs it for the feature template"
            )
        self._features = {
            k: np.asarray(v)
            for k, v in example.items()
            if k not in _NON_FEATURE_KEYS
        }
        self._batcher = MicroBatcher(
            self._run_batch,
            self._features,
            max_batch=max_batch,
            max_delay_ms=max_delay_ms,
            name=spec.name,
            batch_buckets=self._shape_buckets,
            bulk_weight=bulk_weight,
            # The batcher's bounded queue must be THE queue: size the gRPC
            # handler pool (max_workers) at or above the expected in-flight
            # request count, or excess load parks invisibly in the executor.
            max_queue_rows=max_queue_rows,
        )

        self._watcher: Optional[CheckpointWatcher] = None
        if checkpoint_dir:
            if start is not None:
                self._reload(*start)
            with self._state_lock:
                loaded = self._live.step
            self._watcher = CheckpointWatcher(
                checkpoint_dir, self._reload, poll_interval_s, name=spec.name,
                initial_step=None if loaded < 0 else loaded,
            )
        else:
            logger.warning(
                "serving without checkpoint_dir: fixed weights, no hot "
                "reload (smoke/bench mode)"
            )

        self.target_p99_ms = float(target_p99_ms)
        self.gauges = gauges if gauges is not None else gaugelib.default()
        self._g_requests = self.gauges.counter(
            "edl_serving_requests_total", "Predict requests answered"
        )
        # Per-lane latency histograms: the SLO gauges are defined over the
        # ONLINE lane only.
        self._g_request_ms = {
            lane: self.gauges.histogram(
                "edl_serving_request_ms",
                "per-request wall inside the Predict handler (parse + "
                "queue + flush + fan-back), by priority lane",
                labels={"lane": lane},
            )
            for lane in LANES
        }
        self._g_lane_requests = {
            lane: self.gauges.counter(
                "edl_serving_lane_requests_total",
                "Predict requests answered, by priority lane",
                labels={"lane": lane},
            )
            for lane in LANES
        }
        self.gauges.add_collector(self._collect_gauges)
        self._gauge_port = gauge_port
        self._metrics_server = None

        self._server = grpc.server(futures.ThreadPoolExecutor(max_workers))
        self._server.add_generic_rpc_handlers(
            (
                make_generic_handler(
                    SERVING_SERVICE_NAME,
                    {"Predict": self._predict, "ModelInfo": self._model_info},
                    SERVING_SCHEMAS,
                ),
            )
        )
        self.port = self._server.add_insecure_port(f"[::]:{port}")
        # Loud bind: an advertised port that silently rebinds serves
        # nothing while looking healthy.
        if self.port == 0 or (port and self.port != port):
            raise RuntimeError(
                f"serving server failed to bind port {port} (got {self.port})"
            )

    # ---- model lifecycle ----

    def warmup(self) -> float:
        """Run the forward once at EVERY serving batch bucket (one padded
        zero batch per bucket through the real path), so the first request
        of any bucket pays RPC + forward and not kernel build, library
        handles or allocator growth.  Returns the total warmup wall
        seconds."""
        t0 = time.perf_counter()
        for bucket in self._shape_buckets:
            batch = {
                k: np.zeros((bucket,) + t.shape[1:], t.dtype)
                for k, t in self._batcher._template.items()
            }
            batch[MASK_KEY] = np.zeros((bucket,), np.float32)
            self._run_batch(batch, 0)
        return time.perf_counter() - t0

    def _reload(self, step: int, manifest: Dict[str, Any]) -> None:
        """Load checkpoint ``step`` and swap it live (the watcher callback).

        The expensive half — the read (parameters only), device placement,
        and one forward at the smallest bucket (weight casts, allocator
        growth) — runs on the CALLING thread against a private module while
        serving continues on the old snapshot.  The live path is touched only by
        the reference swap at the end."""
        t0 = time.perf_counter()
        arrays = self._ckpt.restore(step, prefixes=SERVED_PATHS)
        # On the card, on a side stream: the compute stream carries the
        # flushes (and, sharing a card, a trainer's steps), which must not
        # queue behind the upload.  The warm forward's host copy waits for
        # the side stream's work, so the module is whole before the swap.
        stream = torch.cuda.Stream(self.trainer.device) if self.trainer.device.type == "cuda" else None
        with torch.cuda.stream(stream):
            model = self.spec.init(seed=None, device=self.trainer.device)
            model = self.trainer.adopt_restored(arrays, TrainState(0, model, None)).model.eval()
            bucket = self._shape_buckets[0]
            batch = {
                k: np.zeros((bucket,) + t.shape[1:], t.dtype)
                for k, t in self._batcher._template.items()
            }
            outputs_to_numpy(self.trainer.run_predict_step(model, batch))
        load_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        with self._state_lock:
            self._live = _LiveModel(step, model)
        swap_ms = (time.perf_counter() - t1) * 1e3
        with self._state_lock:
            self._reloads += 1
            self._last_swap_ms = swap_ms
            self._last_load_s = load_s
            self.reload_log.append((step, load_s, swap_ms, time.time()))
        logger.info(
            "serving step %d live (load %.2fs off-path, swap %.3fms)",
            step, load_s, swap_ms,
        )

    @property
    def live_step(self) -> int:
        """The step of the weights being served (-1: not a checkpoint)."""
        with self._state_lock:
            return self._live.step

    # ---- request path ----

    def _parse_features(self, features: Dict[str, Any]) -> Dict[str, np.ndarray]:
        """Client JSON -> typed numpy per the model template.  Violations
        raise SchemaError: the handler surfaces them as structured
        FAILED_PRECONDITION at the boundary, never a KeyError mid-flush."""
        out: Dict[str, np.ndarray] = {}
        n = None
        for key, tmpl in self._features.items():
            if key not in features:
                raise SchemaError(
                    f"Predict: missing feature {key!r} "
                    f"(model {self.spec.name} expects {sorted(self._features)})"
                )
            try:
                arr = np.asarray(features[key], dtype=tmpl.dtype)
            except (TypeError, ValueError) as e:
                raise SchemaError(
                    f"Predict: feature {key!r} not convertible to "
                    f"{tmpl.dtype}: {e}"
                ) from e
            if arr.ndim == tmpl.ndim - 1:
                arr = arr[None]  # single example without the batch dim
            if arr.ndim != tmpl.ndim or arr.shape[1:] != tmpl.shape[1:]:
                raise SchemaError(
                    f"Predict: feature {key!r} has shape {arr.shape}, "
                    f"expected [n{''.join(f', {d}' for d in tmpl.shape[1:])}]"
                )
            if n is None:
                n = arr.shape[0]
            elif arr.shape[0] != n:
                raise SchemaError(
                    f"Predict: feature {key!r} carries {arr.shape[0]} "
                    f"examples but earlier features carry {n}"
                )
            out[key] = arr
        if not 1 <= (n or 0) <= self.max_batch:
            raise SchemaError(
                f"Predict: {n} examples; must be 1..{self.max_batch}"
            )
        if self.spec.check_batch is not None:
            # The model's own range checks, here so that a bad request fails
            # alone instead of failing the flush it would share.
            with self._state_lock:
                state = self._live.state
            try:
                self.spec.check_batch(state, out)
            except ValueError as e:
                raise SchemaError(f"Predict: {e}") from e
        return out

    # hot-path: the per-request gRPC handler — parse, enqueue, park on the
    # flush fan-back; never a device touch (the flusher owns the forward)
    def _predict(self, req: Dict[str, Any]) -> Dict[str, Any]:
        t0 = time.perf_counter()
        lane = req.get("lane", DEFAULT_LANE)
        if lane not in LANES:
            raise SchemaError(
                f"Predict: unknown priority lane {lane!r}; expected one "
                f"of {list(LANES)}"
            )
        features = self._parse_features(req["features"])
        handle = self._batcher.submit(features, lane=lane)
        outputs, meta = handle.result(timeout_s=30.0)
        with self._state_lock:
            self._requests += 1
        self._g_requests.inc()
        self._g_lane_requests[lane].inc()
        self._g_request_ms[lane].observe((time.perf_counter() - t0) * 1e3)
        return {
            "outputs": _listify(outputs),
            "model": self.spec.name,
            "step": meta.get("step", -1),
        }

    def _run_batch(self, batch: Dict[str, np.ndarray], n_real: int) -> Tuple[Any, Dict]:
        """The flusher's runner: ONE forward of the padded batch on the
        serving snapshot current at flush time; the host copy of the
        outputs waits for the device."""
        with self._state_lock:
            live = self._live
        out = self.trainer.run_predict_step(live.state, batch)
        return outputs_to_numpy(out), {"step": live.step}

    def _collect_gauges(self) -> None:
        """Scrape-time collector (never the request path): batcher state
        re-published from its stats() surface, the SLO gauges, and the
        kernels' launch counts."""
        g = self.gauges
        stats = self._batcher.stats()
        g.gauge("edl_serving_queue_depth", "requests parked in the "
                "micro-batcher").set(float(stats["queued"]))
        g.gauge("edl_serving_shed_overload", "requests shed at the "
                "queue-row bound").set(float(stats["shed_overload"]))
        g.gauge("edl_serving_expired", "requests expired at flush time"
                ).set(float(stats["expired"]))
        for lane, ls in stats["lanes"].items():
            g.counter(
                "edl_serving_shed_total",
                "requests shed at admission or evicted, by priority lane",
                labels={"lane": lane},
            ).set_total(float(ls["shed"]))
            g.counter(
                "edl_serving_expired_total",
                "requests expired at flush time, by priority lane",
                labels={"lane": lane},
            ).set_total(float(ls["expired"]))
            g.gauge(
                "edl_serving_lane_queued_rows",
                "rows parked in the micro-batcher, by priority lane",
                labels={"lane": lane},
            ).set(float(ls["queued_rows"]))
        for bucket, n in stats["flushes_by_bucket"].items():
            g.counter(
                "edl_serving_bucket_flushes_total",
                "flushes per padded batch bucket",
                labels={"bucket": bucket},
            ).set_total(float(n))
        served = stats["rows_served"]
        g.gauge(
            "edl_serving_batch_fill_ratio",
            "real rows / flushed rows (padding waste is 1 - this)",
        ).set(served / (served + stats["rows_padded"])
              if served + stats["rows_padded"] else 0.0)
        for name, n in kernels.counts().items():
            g.counter(
                "edl_kernel_launches_total",
                "launches of each hand-written CUDA kernel in this process",
                labels={"kernel": name},
            ).set_total(float(n))
        with self._state_lock:
            step, reloads = self._live.step, self._reloads
        g.gauge("edl_serving_step", "live model step").set(float(step))
        g.gauge("edl_serving_reloads", "hot reloads performed").set(
            float(reloads)
        )
        p99 = self._g_request_ms["online"].quantile(0.99)
        if p99 is not None:
            g.gauge(
                "edl_serving_p99_ms",
                "live online-lane request p99 (bucket-grid estimate)",
            ).set(p99)
            g.gauge(
                "edl_serving_p99_target_ms", "operator SLO target"
            ).set(self.target_p99_ms)
            g.gauge(
                "edl_serving_slo_ratio",
                "live p99 over the target — > 1.0 means the SLO is "
                "blown right now",
            ).set(p99 / self.target_p99_ms if self.target_p99_ms else 0.0)

    def _model_info(self, req: Dict[str, Any]) -> Dict[str, Any]:
        with self._state_lock:
            step = self._live.step
            requests = self._requests
            reloads = self._reloads
            last_swap_ms = self._last_swap_ms
            last_load_s = self._last_load_s
        # cache: the reference's host-tier field, empty until that slice
        # is ported.
        return {
            "model": self.spec.name,
            "step": step,
            "max_batch": self.max_batch,
            "max_delay_ms": self.max_delay_ms,
            "batch_buckets": list(self._shape_buckets),
            "features": {
                k: {"dtype": str(v.dtype), "example_shape": list(v.shape[1:])}
                for k, v in self._features.items()
            },
            "requests": requests,
            "reloads": reloads,
            "last_swap_ms": round(last_swap_ms, 3),
            "last_load_s": round(last_load_s, 3),
            "batcher": self._batcher.stats(),
            "cache": {},
        }

    # ---- lifecycle ----

    @property
    def address(self) -> str:
        return f"localhost:{self.port}"

    @property
    def metrics_address(self) -> Optional[str]:
        """host:port of the live /metrics endpoint (after start(); None
        when gauge_port < 0 or the bind failed)."""
        return (
            self._metrics_server.address
            if self._metrics_server is not None else None
        )

    def start(self) -> "ServingServer":
        self._server.start()
        if self._watcher is not None:
            self._watcher.start()
        from elasticdl_tpu_torch.common.metrics_http import maybe_start

        self._metrics_server = maybe_start(
            self._gauge_port,
            self.gauges.render_prometheus,
            health_fn=lambda: {"role": "serving", "model": self.spec.name},
            registry=self.gauges,
        )
        logger.info(
            "serving %s on port %d (max_batch %d, deadline %.1fms, device %s)",
            self.spec.name, self.port, self.max_batch, self.max_delay_ms,
            self.trainer.device,
        )
        return self

    def wait(self) -> None:
        self._server.wait_for_termination()

    def stop(self, grace: float = 1.0) -> None:
        if self._watcher is not None:
            self._watcher.stop()
        if self._metrics_server is not None:
            self._metrics_server.stop()
            self._metrics_server = None
        self.gauges.remove_collector(self._collect_gauges)
        # grpc's stop() is non-blocking (it returns an Event); WAIT the
        # grace window out before closing the batcher, or a handler
        # admitted pre-stop would hit BatcherClosed at submit().
        self._server.stop(grace).wait(grace + 5.0)
        self._batcher.close()
