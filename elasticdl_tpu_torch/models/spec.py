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
- ``tensor_sharding(module) -> {path: dim}`` the tensor-parallel plan:
  which dim of each weight splits over a ``(dp, tp)`` mesh's ``tp`` axis
  (Megatron's column and row splits; paths as the canonical state's,
  ``blocks/b0/wqkv``); the trainer keeps this rank's contiguous slice of
  each (``shard_parameters``) and ``apply`` takes the trainer's
  ``ParallelContext`` as ``ctx``.  None: the model never splits a weight
- ``host_io``                               the host-tier tables
  (``HostTableIO``), keyed by the batch key ``apply`` reads their rows
  under: the rows live in the native host store, not on the device

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


@dataclasses.dataclass(frozen=True)
class HostTableIO:
    """One HOST-TIER embedding table: its rows live in the native C++ store
    (``ps/host_store.HostEmbeddingStore``, or the PS service's shards), not
    on the device; the reference's external-PS tier, for tables too large
    for the card.

    Each step the trainer computes the batch's ids on the host (``ids_fn``:
    numpy batch -> int64 ids ``[b, F]``, equal to the model's own id math),
    pulls their rows, places them on the device under the table's batch key
    as a leaf the step differentiates, and pushes the rows' gradients back;
    the store applies its own optimizer per distinct id with duplicates
    summed first (IndexedSlices semantics, server side).
    """

    ids_fn: Callable[[Dict[str, np.ndarray]], Any]
    dim: int
    optimizer: str = "adagrad"
    learning_rate: float = 0.01
    init_scale: float = 0.05
    # Sequence-parallel models only: ids_fn returns per-TOKEN ids [b, S(,
    # ...)] whose dim 1 is the sequence dim, so the rows may shard with the
    # sequence; without it the trainer refuses such a model.
    per_token: bool = False


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
    # Host-tier tables: batch key -> HostTableIO.  ``apply`` reads the
    # injected rows from the batch under the key instead of looking up a
    # parameter table.
    host_io: Dict[str, HostTableIO] = dataclasses.field(default_factory=dict)
    # (module) -> {parameter path: dim split over the tp axis}.
    tensor_sharding: Optional[Callable[[Any], Dict[str, int]]] = None


def shard_parameters(model: Any, dims: Dict[str, int], index: int, n: int) -> None:
    """Replace each parameter named in ``dims`` (``{path: dim}``, ``/``
    between module names) by its ``index``-th of ``n`` contiguous equal
    slices along ``dim``, in place: a row-sharded table's rows, a
    tensor-parallel weight's columns or rows.  A dim ``n`` does not divide
    raises."""
    import torch

    for path, d in dims.items():
        module = model
        names = path.split("/")
        for name in names[:-1]:
            module = getattr(module, name)
        full = getattr(module, names[-1]).detach()
        if full.shape[d] % n:
            raise ValueError(f"parameter {path}: dim {d} of {tuple(full.shape)} does not "
                             f"split over {n} ranks")
        k = full.shape[d] // n
        setattr(module, names[-1], torch.nn.Parameter(full.narrow(d, index * k, k).clone()))


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
