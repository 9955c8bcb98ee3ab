"""The trainer of the PyTorch port — its predict slice.

Port of the predict path of ``elasticdl_tpu/parallel/trainer.py``
(``Trainer.run_predict_step`` and ``build_predict_step``): the serving
tier's forward.  One device, no mesh: an online replica scales by running
more replicas, not by sharding one request's forward.  Training steps,
optimizers, checkpoints and collectives are later slices of the port.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from elasticdl_tpu_torch.common.device import resolve_device, set_matmul_precision
from elasticdl_tpu_torch.models.spec import ModelSpec

#: The micro-batcher's padding mask: fan-back bookkeeping the model must
#: not see (the reference's ``local_predict`` pops it too).
MASK_KEY = "__mask__"


class Trainer:
    """Owns the device and runs the model's predict forward."""

    def __init__(self, spec: ModelSpec, device: Any = None):
        self.spec = spec
        self.device = resolve_device(device)
        set_matmul_precision()

    def init_state(self, seed: int) -> torch.nn.Module:
        """Fresh weights from ``seed``, on this trainer's device, in eval
        mode."""
        model = self.spec.init(seed=seed, device=self.device)
        return model.eval()

    def _to_device(self, value: Any) -> torch.Tensor:
        if isinstance(value, torch.Tensor):
            return value.to(self.device)
        return torch.from_numpy(np.ascontiguousarray(value)).to(self.device)

    def run_predict_step(self, state: torch.nn.Module, batch: Dict[str, Any]) -> Any:
        """Per-example outputs of ``state`` on ``batch`` (numpy arrays or
        tensors; ``__mask__`` is dropped), as tensors on the device."""
        batch = dict(batch)
        batch.pop(MASK_KEY, None)
        tensors = {k: self._to_device(v) for k, v in batch.items()}
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

