"""The trainer of the PyTorch port: single-device training and prediction.

Port of ``elasticdl_tpu/parallel/trainer.py``: ``TrainState``,
``Trainer.init_state``, ``run_train_step``, the synchronous loop of
``run_train_steps``, ``train_step`` (the single-device reading of
``build_train_step``'s ``local_step``), and the predict path
(``run_predict_step``, ``build_predict_step``) the serving tier runs.  One
device, no mesh: host-tier tables, the fused scan variants, meshes and
collectives are later slices of the port.
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


@dataclasses.dataclass
class TrainState:
    """The reference's ``TrainState(step, params, opt_state)``: here the
    module holds the parameters and the optimizer its moments.  A train
    step updates both in place (the reference donates its state) and
    returns a state with the next step number."""

    step: int
    model: torch.nn.Module
    optimizer: Optional[torch.optim.Optimizer]


class Trainer:
    """Owns the device; trains the model and runs its predict forward."""

    def __init__(self, spec: ModelSpec, device: Any = None):
        self.spec = spec
        self.device = resolve_device(device)
        set_matmul_precision()
        self._loss_takes_mask = spec.loss is not None and (
            "mask" in inspect.signature(spec.loss).parameters
        )

    # ---- state ----

    def init_state(self, seed: int) -> TrainState:
        """Step 0: fresh weights from ``seed`` on this trainer's device and,
        when the spec trains, their optimizer."""
        model = self.spec.init(seed=seed, device=self.device)
        optimizer = self.spec.optimizer(model.parameters()) if self.spec.optimizer else None
        return TrainState(step=0, model=model, optimizer=optimizer)

    def _to_device(self, value: Any) -> torch.Tensor:
        if isinstance(value, torch.Tensor):
            return value.to(self.device)
        return torch.from_numpy(np.ascontiguousarray(value)).to(self.device)

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
