"""The model contract of the PyTorch port: what a model-zoo entry provides.

Port of ``elasticdl_tpu/models/spec.py``, cut to the fields the serving
path reads.  The JAX contract is pure functions over pytrees; here the
state is an ``nn.Module`` and the functions take it:

- ``init(seed, device) -> nn.Module``       fresh weights from a seeded
  ``torch.Generator``
- ``apply(model, batch, train) -> outputs`` the forward (``batch``: dict of
  tensors on the model's device)
- ``predict(model, batch) -> outputs``      client-ready serving outputs
  (None = serve ``apply(train=False)``)
- ``check_batch(model, batch)``             optional host-side check of a
  request's numpy batch, run where requests arrive (raises ValueError)
- ``example_batch(n) -> {name: ndarray}``   the feature template
- ``batch_shard_dim``                       which batch dim a mesh would
  shard (recorded for parity; the port runs on one device so far)
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable, Dict, Optional

import numpy as np


@dataclasses.dataclass
class ModelSpec:
    name: str
    init: Callable[..., Any]  # (seed, device) -> nn.Module
    apply: Callable[..., Any]  # (model, batch, train=bool) -> outputs
    example_batch: Optional[Callable[[int], Dict[str, np.ndarray]]] = None
    predict: Optional[Callable[..., Any]] = None
    check_batch: Optional[Callable[..., None]] = None  # (model, numpy batch)
    batch_shard_dim: int = 0


def load_model_spec(model_zoo: str, model_def: str, **params: Any) -> ModelSpec:
    """Load ``model_spec`` from a zoo module.

    ``model_def`` is "module.function" relative to the ``model_zoo`` package,
    mirroring the reference's ``--model_zoo``/``--model_def`` resolution.
    """
    module_name, _, fn_name = model_def.rpartition(".")
    if not module_name:
        raise ValueError(
            f"--model_def must look like 'module.function', got {model_def!r}"
        )
    module = importlib.import_module(f"{model_zoo}.{module_name}")
    fn = getattr(module, fn_name)
    spec = fn(**params)
    if not isinstance(spec, ModelSpec):
        raise TypeError(f"{model_def} returned {type(spec)}, expected ModelSpec")
    return spec
