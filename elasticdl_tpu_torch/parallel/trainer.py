"""The trainer of the PyTorch port: single-device training, evaluation
and prediction, and the canonical state checkpoints store.

Port of ``elasticdl_tpu/parallel/trainer.py``: ``TrainState``,
``Trainer.init_state``, ``run_train_step``, the synchronous loop of
``run_train_steps``, ``train_step`` (the single-device reading of
``build_train_step``'s ``local_step``), the eval step (``eval_step``,
``run_eval_step``, ``build_eval_step``), the predict path
(``run_predict_step``, ``build_predict_step``) the serving tier runs, and
the canonical state (``host_state``, ``snapshot_state``,
``adopt_restored``: the reference's ``host_state``, ``snapshot_state``,
``restore_template`` and ``adopt_restored``).  One device, no mesh:
host-tier tables, the fused scan variants, meshes and collectives are
later slices of the port.

The canonical state is a flat ``{path: numpy array}`` dict:

- ``params/<p>``: each parameter, ``<p>`` its module path with ``/`` for
  ``.`` — the JAX parameter-tree path (``params/blocks/b0/wqkv``), as
  ``transformer_lm.params_to_jax`` gives it;
- ``opt_state/mu/<p>`` and ``opt_state/nu/<p>``: the AdamW moments (optax's
  ``ScaleByAdamState`` ``mu``/``nu``; torch's ``exp_avg``/``exp_avg_sq``);
- ``opt_state/count``: the optimizer's update count; ``step``: the step.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from elasticdl_tpu_torch.common.device import resolve_device, set_matmul_precision
from elasticdl_tpu_torch.models.spec import ModelSpec

#: The padding mask of a batch: real examples 1.0, padding 0.0.  The loss
#: weighs by it; the model never sees it (the reference pops it too).
MASK_KEY = "__mask__"

#: Canonical-state path prefixes and keys (see the module docstring).
PARAMS, MU, NU = "params/", "opt_state/mu/", "opt_state/nu/"
COUNT_KEY, STEP_KEY = "opt_state/count", "step"


@dataclasses.dataclass
class TrainState:
    """The reference's ``TrainState(step, params, opt_state)``: here the
    module holds the parameters and the optimizer its moments.  A train
    step updates both in place (the reference donates its state) and
    returns a state with the next step number."""

    step: int
    model: torch.nn.Module
    optimizer: Optional[torch.optim.Optimizer]


class Snapshot(dict):
    """A canonical state of device copies (``Trainer.snapshot_state``);
    ``ready``: on the card, the event recorded after the copies."""

    ready: Optional[Any] = None


class Trainer:
    """Owns the device; trains the model and runs its predict forward."""

    def __init__(self, spec: ModelSpec, device: Any = None):
        self.spec = spec
        self.device = resolve_device(device)
        set_matmul_precision()
        self._loss_takes_mask = spec.loss is not None and (
            "mask" in inspect.signature(spec.loss).parameters
        )
        self._metrics_take_mask = spec.metrics is not None and (
            "mask" in inspect.signature(spec.metrics).parameters
        )

    # ---- state ----

    def init_state(self, seed: Optional[int]) -> TrainState:
        """Step 0: fresh weights from ``seed`` (None: uninitialised storage,
        for a restore to fill) on this trainer's device and, when the spec
        trains, their optimizer."""
        model = self.spec.init(seed=seed, device=self.device)
        optimizer = self.spec.optimizer(model.parameters()) if self.spec.optimizer else None
        return TrainState(step=0, model=model, optimizer=optimizer)

    def _to_device(self, value: Any) -> torch.Tensor:
        if isinstance(value, torch.Tensor):
            return value.to(self.device)
        host = torch.from_numpy(np.ascontiguousarray(value))
        if self.device.type == "cuda":
            # Pinned and without waiting: a pageable upload synchronises the
            # stream, and the host could not queue the next step while the
            # card runs this one.
            return host.pin_memory().to(self.device, non_blocking=True)
        return host.to(self.device)

    def shard_batch(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """A host batch (numpy arrays or tensors) on the device.  One device:
        placing is all the reference's sharding comes to."""
        return {k: self._to_device(v) for k, v in batch.items()}

    # ---- training ----

    def train_step(
        self, state: TrainState, batch: Dict[str, torch.Tensor]
    ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One step on a device batch: the loss (weighted by ``__mask__``
        when the loss takes one), its gradients, the optimizer update.
        Metrics stay on the device: ``loss`` is the weighted loss the step
        minimised; the others come from ``spec.metrics`` without the mask."""
        spec = self.spec
        if spec.loss is None or state.optimizer is None:
            raise ValueError(f"model {spec.name!r} declares no loss or optimizer: it cannot train")
        batch = dict(batch)
        mask = batch.pop(MASK_KEY, None)
        model, optimizer = state.model, state.optimizer
        optimizer.zero_grad(set_to_none=True)
        out = spec.apply(model, batch, train=True)
        if mask is not None and self._loss_takes_mask:
            # The reference weighs a shard's loss by count/total over the
            # mesh; on one device the total is this batch's own count, so
            # the weight is 1, and 0 for an all-padding batch.
            count = mask.float().sum()
            loss = spec.loss(out, batch, mask=mask) * count / count.clamp_min(1e-12)
        else:
            loss = spec.loss(out, batch)
        loss.backward()
        optimizer.step()
        with torch.no_grad():
            metrics = dict(spec.metrics(out.detach(), batch)) if spec.metrics else {}
        metrics["loss"] = loss.detach()
        return TrainState(state.step + 1, model, optimizer), metrics

    def run_train_step(self, state: TrainState, batch: Dict[str, Any]):
        """A training step from a HOST batch: place, then step."""
        return self.train_step(state, self.shard_batch(batch))

    def run_train_steps(
        self,
        state: TrainState,
        batches: Iterable[Dict[str, Any]],
        pre_sharded: bool = False,
    ) -> Tuple[TrainState, List[Dict[str, torch.Tensor]]]:
        """Train over an iterable of host batches (``pre_sharded``: already
        on the device), synchronously: the reference's loop without
        host-tier tables, whose async pull pipeline is not ported yet.
        Returns (state, [metrics per batch])."""
        step = self.train_step if pre_sharded else self.run_train_step
        metrics_out = []
        for batch in batches:
            state, metrics = step(state, batch)
            metrics_out.append(metrics)
        return state, metrics_out

    # ---- evaluation ----

    def eval_step(
        self, state: TrainState, batch: Dict[str, torch.Tensor]
    ) -> Dict[str, torch.Tensor]:
        """Metrics of the module on a device batch, without gradients and
        with the module in eval mode (``build_eval_step``'s ``local_eval``
        on one device).  A metrics function that takes a ``mask`` gets the
        batch's ``__mask__`` and returns means over real examples (the
        reference's psum(v * count) / psum(count) is v * count /
        max(count, 1e-12) here); one without it gets the whole padded
        batch, as in the reference.  Metrics stay on the device."""
        spec = self.spec
        if spec.metrics is None:
            raise ValueError(f"model {spec.name!r} declares no metrics: it cannot evaluate")
        batch = dict(batch)
        mask = batch.pop(MASK_KEY, None)
        model = state.model
        was_training = model.training
        model.eval()
        try:
            with torch.no_grad():
                out = spec.apply(model, batch, train=False)
                if mask is not None and self._metrics_take_mask:
                    metrics = spec.metrics(out, batch, mask=mask)
                    count = mask.float().sum()
                    return {
                        k: v * count / count.clamp_min(1e-12) for k, v in metrics.items()
                    }
                return dict(spec.metrics(out, batch))
        finally:
            model.train(was_training)

    def run_eval_step(self, state: TrainState, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """An eval step from a HOST batch: place, then evaluate."""
        return self.eval_step(state, self.shard_batch(batch))

    # ---- the canonical state ----

    @staticmethod
    def _param_paths(model: torch.nn.Module) -> List[Tuple[str, torch.nn.Parameter]]:
        return [(name.replace(".", "/"), p) for name, p in model.named_parameters()]

    def snapshot_state(self, state: TrainState) -> "Snapshot":
        """The canonical state as fresh DEVICE copies (one clone per array,
        enqueued on the current stream): no later step's in-place update
        reaches them, so the host copy and the write can run off the task
        loop while training continues.  Never waits for the device; on the
        card, ``ready`` marks the clones' end on the stream."""
        snap = Snapshot({STEP_KEY: np.asarray(state.step, np.int64)})
        count = 0
        opt_state = state.optimizer.state if state.optimizer is not None else {}
        for path, p in self._param_paths(state.model):
            snap[PARAMS + path] = p.detach().clone()
            if state.optimizer is None:
                continue
            st = opt_state.get(p)
            if st:
                snap[MU + path] = st["exp_avg"].detach().clone()
                snap[NU + path] = st["exp_avg_sq"].detach().clone()
                count = st["step"]
            else:
                snap[MU + path] = torch.zeros_like(p, memory_format=torch.contiguous_format)
                snap[NU + path] = torch.zeros_like(p, memory_format=torch.contiguous_format)
        if state.optimizer is not None:
            # torch keeps the count as a float tensor per parameter (all
            # equal); optax as one int32.
            snap[COUNT_KEY] = (
                count.detach().clone() if isinstance(count, torch.Tensor)
                else np.asarray(count, np.int32)
            )
        if self.device.type == "cuda":
            snap.ready = torch.cuda.Event()
            snap.ready.record()
        return snap

    @staticmethod
    def to_host(snapshot: Dict[str, Any]) -> Dict[str, np.ndarray]:
        """A canonical snapshot as host numpy arrays (the count back to
        optax's int32).  Card tensors copy into pinned host tensors (PyTorch's
        caching host allocator, so repeated saves reuse the blocks) on a side
        stream that waits only for the snapshot's ``ready`` event: a copy on
        the compute stream would queue the steps dispatched since the
        snapshot behind it, and a pageable copy would hold the driver, and
        every launch of the task loop, for its whole length."""
        out: Dict[str, Any] = {}
        on_card = [k for k, v in snapshot.items() if isinstance(v, torch.Tensor) and v.is_cuda]
        if on_card:
            stream = torch.cuda.Stream(snapshot[on_card[0]].device)
            ready = getattr(snapshot, "ready", None)
            if ready is not None:
                stream.wait_event(ready)
            with torch.cuda.stream(stream):
                for key in on_card:
                    value = snapshot[key].detach()
                    host = torch.empty(value.shape, dtype=value.dtype, pin_memory=True)
                    out[key] = host.copy_(value, non_blocking=True).numpy()
            stream.synchronize()
        for key, value in snapshot.items():
            if key in out:
                continue
            if isinstance(value, torch.Tensor):
                value = value.detach().to("cpu", copy=True).numpy()
            out[key] = np.asarray(value)
        if COUNT_KEY in out:
            out[COUNT_KEY] = out[COUNT_KEY].astype(np.int32)
        return {k: out[k] for k in snapshot}

    def host_state(self, state: TrainState) -> Dict[str, np.ndarray]:
        """The canonical state as host numpy arrays: the ONE layout
        checkpoints store and every restore reads."""
        return self.to_host(self.snapshot_state(state))

    def adopt_restored(
        self, arrays: Dict[str, Any], state: Optional[TrainState] = None
    ) -> TrainState:
        """Load a canonical state into ``state`` (default: a new one from
        ``init_state(None)``) on this trainer's device: parameters copied in
        place, AdamW moments and count set, the step taken.  The paths
        must match the model's exactly; a state without an optimizer (a
        serving replica's) takes the parameters and the step only."""
        if state is None:
            state = self.init_state(None)
        model, optimizer = state.model, state.optimizer
        paths = self._param_paths(model)
        params = {STEP_KEY} | {PARAMS + path for path, _ in paths}
        opt = {COUNT_KEY} | {MU + path for path, _ in paths} | {NU + path for path, _ in paths}
        required = params | opt if optimizer is not None else params
        missing = required - set(arrays)
        unexpected = set(arrays) - params - opt
        if missing or unexpected:
            raise ValueError(
                "canonical state does not match the model: missing "
                f"{sorted(missing)[:8]}, unexpected {sorted(unexpected)[:8]}"
            )

        def load(value: Any, dst: torch.Tensor) -> torch.Tensor:
            arr = np.asarray(value, np.float32)
            if tuple(arr.shape) != tuple(dst.shape):
                raise ValueError(f"shape {arr.shape} does not match {tuple(dst.shape)}")
            # On the card from pinned memory on the current stream, as
            # _to_device places a batch (a replica's reload runs on its own
            # stream while steps or flushes run on another).
            host = torch.from_numpy(np.ascontiguousarray(arr))
            dst.copy_(host.pin_memory() if dst.is_cuda else host, non_blocking=True)
            return dst

        def moment(value: Any, p: torch.Tensor) -> torch.Tensor:
            return load(value, torch.empty_like(p, memory_format=torch.contiguous_format))

        with torch.no_grad():
            for path, p in paths:
                load(arrays[PARAMS + path], p)
            if optimizer is not None:
                count = int(np.asarray(arrays[COUNT_KEY]))
                optimizer.state.clear()
                if count > 0:
                    for path, p in paths:
                        optimizer.state[p] = {
                            "step": torch.tensor(float(count), dtype=torch.float32),
                            "exp_avg": moment(arrays[MU + path], p),
                            "exp_avg_sq": moment(arrays[NU + path], p),
                        }
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
        return TrainState(int(np.asarray(arrays[STEP_KEY])), model, optimizer)

    # ---- prediction ----

    def run_predict_step(self, state: torch.nn.Module, batch: Dict[str, Any]) -> Any:
        """Per-example outputs of the module ``state`` on ``batch`` (numpy
        arrays or tensors; ``__mask__`` is dropped), as tensors on the
        device."""
        batch = dict(batch)
        batch.pop(MASK_KEY, None)
        tensors = self.shard_batch(batch)
        with torch.inference_mode():
            if self.spec.predict is not None:
                return self.spec.predict(state, tensors)
            return self.spec.apply(state, tensors, train=False)


def outputs_to_numpy(outputs: Any) -> Any:
    """Device outputs -> host numpy, leaf-wise for dict-shaped outputs (the
    reference's ``jax.device_get``)."""
    if isinstance(outputs, dict):
        return {k: outputs_to_numpy(v) for k, v in outputs.items()}
    return outputs.detach().cpu().numpy()
