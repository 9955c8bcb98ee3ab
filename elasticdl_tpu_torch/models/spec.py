"""The model contract of the PyTorch port: what a model-zoo entry provides.

Port of ``elasticdl_tpu/models/spec.py``, cut to the fields the serving
and single-device training paths read.  The JAX contract is pure functions
over pytrees; here the state is an ``nn.Module`` and the functions take it:

- ``init(seed, device) -> nn.Module``       fresh weights from a seeded
  ``torch.Generator``; ``seed=None``: the storage only, uninitialised,
  for a restore to fill
- ``apply(model, batch, train) -> outputs`` the forward (``batch``: dict of
  tensors on the model's device)
- ``predict(model, batch) -> outputs``      client-ready serving outputs
  (None = serve ``apply(train=False)``)
- ``check_batch(model, batch)``             optional host-side check of a
  request's numpy batch, run where requests arrive (raises ValueError)
- ``example_batch(n) -> {name: ndarray}``   the feature template
- ``batch_shard_dim``                       0: examples shard over every
  mesh axis; 1: examples over the outer axes, the sequence over the inner
  one (``parallel/trainer.py``)
- ``loss(outputs, batch[, mask]) -> scalar`` the training loss (a ``mask``
  parameter makes the trainer pass the batch's ``__mask__``)
- ``metrics(outputs, batch[, mask]) -> {name: scalar}`` (a ``mask``
  parameter makes the eval step pass the batch's ``__mask__``)
- ``optimizer(parameters) -> torch.optim.Optimizer``  a factory: the
  reference's optax transformation is state-free, a torch optimizer owns
  the parameters it updates
- ``feed(records) -> {name: ndarray}``      decodes a batch of records
- ``embedding_tables``                      the row-shardable tables
  (``EmbeddingTableSpec``): under the ParameterServer strategy the
  trainer keeps only this rank's rows of each (``parallel/trainer.py``)
  and ``apply`` takes the trainer's ``ParallelContext`` as ``ctx``

The training fields default to None: a spec without them serves but does
not train.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class EmbeddingTableSpec:
    """One row-shardable embedding table of the model.

    ``path`` names the module parameter that holds it (``("fm_table",)``;
    nested modules as in ``named_parameters``, one name a level), in the
    padded packed ``[P, pack*stride]`` layout of ``ops/embedding.py``.
    Sharded over ``n`` ranks, rank ``i`` holds the contiguous physical rows
    ``[i*P/n, (i+1)*P/n)``, the reference's div-sharded layout."""

    path: Tuple[str, ...]
    vocab_size: int
    dim: int


@dataclasses.dataclass
class ModelSpec:
    name: str
    init: Callable[..., Any]  # (seed or None, device) -> nn.Module
    apply: Callable[..., Any]  # (model, batch, train=bool) -> outputs
    example_batch: Optional[Callable[[int], Dict[str, np.ndarray]]] = None
    predict: Optional[Callable[..., Any]] = None
    check_batch: Optional[Callable[..., None]] = None  # (model, numpy batch)
    batch_shard_dim: int = 0
    loss: Optional[Callable[..., Any]] = None  # (outputs, batch[, mask]) -> scalar
    metrics: Optional[Callable[..., Dict[str, Any]]] = None  # (outputs, batch[, mask])
    optimizer: Optional[Callable[..., Any]] = None  # (parameters) -> Optimizer
    feed: Optional[Callable[[Sequence[bytes]], Dict[str, np.ndarray]]] = None
    embedding_tables: List[EmbeddingTableSpec] = dataclasses.field(default_factory=list)


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


def load_model_spec_for_job(config: Any) -> ModelSpec:
    """Load the model for a JobConfig, plumbing job-level knobs.

    ``--learning_rate`` / ``--compute_dtype`` flags are forwarded to the model
    fn when it accepts them; explicit ``--model_params`` entries win (same
    precedence the reference gives model-module definitions over defaults).
    """
    import inspect

    params: dict = {}
    module_name, _, fn_name = config.model_def.rpartition(".")
    module = importlib.import_module(f"{config.model_zoo}.{module_name}")
    accepted = inspect.signature(getattr(module, fn_name)).parameters
    if "learning_rate" in accepted:
        params["learning_rate"] = config.learning_rate
    if "compute_dtype" in accepted:
        params["compute_dtype"] = config.compute_dtype
    params.update(config.parsed_model_params())
    return load_model_spec(config.model_zoo, config.model_def, **params)
