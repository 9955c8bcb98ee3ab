"""DeepFM on Criteo — the PyTorch port of ``elasticdl_tpu/models/deepfm.py``:
the device tier (the fused table a parameter) and the host tier (the table
in the native host store).

Criteo schema: 13 numeric features (log1p-normalised) and 26 categorical
ones, hashed into ONE fused table (``models/tabular.py``).  The model is a
first-order linear term, the FM second-order pairwise interactions and an
MLP over [embeddings; normalised numerics]; the three heads sum into one
logit.  f32 parameters and loss, the FM and MLP in ``compute_dtype``
(bfloat16 by default).

The parameters carry the JAX tree's names and shapes, so the canonical
state (``params/fm_table``, ``params/mlp/layer0/w``, ...) matches the
reference's arrays one for one and :func:`params_from_jax` /
:func:`params_to_jax` carry weights across untransposed:

- ``fm_table``: the packed ``[P, 8*16]`` table (``ops/embedding.py``) of
  ``embedding_dim + 1`` values per id: the FM embedding (normal x 0.01)
  and, in the last column, the first-order weight (zero);
- ``dense_linear.w`` ``[13, 1]``, ``dense_linear.b`` ``[1]``;
- ``mlp.layer{i}.w`` ``[in, out]``, ``mlp.layer{i}.b``, ``mlp.out.*``:
  truncated-normal Glorot weights (``jax.nn.initializers.glorot_normal``),
  zero biases.

Batches come raw (``criteo_feed``: float32 dense, int32 hex ids, hashed
here) or preprocessed by the native decoder (``criteo_feed_pre``, the
default: float16 log1p dense, uint16 bucket ids, uint8 labels, 79 bytes an
example), which the trainer uploads as they are and the model widens on
the device.  The optimizer is ``torch.optim.Adam`` with optax.adam's
constants, dense over the whole table (not ``SparseAdam``, which updates
only the touched rows).

The host tier (``host_tier=True``, or ``"auto"`` past the HBM guard): the
module holds no ``fm_table``; the FM rows (``embedding_dim + 1`` values an
id, as in the device table) live in the native host store under
``HOST_FM_KEY`` (``spec.host_io``: adagrad at ten times the learning rate,
init scale 0.01), the trainer pulls each batch's rows by ``_host_ids`` (the
raw 32-bit ids hashed on the host, ``fuse_feature_ids_np``) and the forward
reads them from ``batch[HOST_FM_KEY]``.  It needs raw batches
(``criteo_feed``): the preprocessed feed's uint16 ids are bucket ids, not
the raw ids the host hash takes.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from elasticdl_tpu_torch.common.device import resolve_device
from elasticdl_tpu_torch.data.codecs import criteo_feed, criteo_feed_pre
from elasticdl_tpu_torch.models.spec import EmbeddingTableSpec, HostTableIO, ModelSpec
from elasticdl_tpu_torch.models.tabular import (
    adam,
    bce_loss,
    binary_metrics,
    fuse_feature_ids,
    fuse_feature_ids_np,
    log_normalize,
)
from elasticdl_tpu_torch.ops.embedding import (
    ParallelContext,
    embedding_lookup,
    exceeds_hbm_guard,
    pack_table,
    table_shape,
)

NUM_DENSE = 13
NUM_CAT = 26

#: The batch key of the host-tier FM rows (the reference's).
HOST_FM_KEY = "__host__fm_table"

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class _Linear(nn.Module):
    """``x @ w + b`` with the reference's ``[in, out]`` weight."""

    def __init__(self, n_in: int, n_out: int, device: torch.device):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(n_in, n_out, device=device))
        self.b = nn.Parameter(torch.zeros(n_out, device=device))


class DeepFM(nn.Module):
    def __init__(
        self,
        buckets_per_feature: int,
        embedding_dim: int,
        hidden: tuple,
        compute_dtype: torch.dtype,
        device: torch.device,
        host_tier: bool = False,
    ):
        super().__init__()
        self.buckets_per_feature = buckets_per_feature
        self.embedding_dim = embedding_dim
        self.compute_dtype = compute_dtype
        self.host_tier = host_tier
        if not host_tier:
            # The host tier keeps no device table: its rows arrive in the batch.
            rows, width = table_shape(NUM_CAT * buckets_per_feature, embedding_dim + 1)
            self.fm_table = nn.Parameter(torch.zeros(rows, width, device=device))
        self.dense_linear = _Linear(NUM_DENSE, 1, device)
        layers: Dict[str, nn.Module] = {}
        in_dim = NUM_CAT * embedding_dim + NUM_DENSE
        for i, width_i in enumerate(hidden):
            layers[f"layer{i}"] = _Linear(in_dim, width_i, device)
            in_dim = width_i
        layers["out"] = _Linear(in_dim, 1, device)
        self.mlp = nn.ModuleDict(layers)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The reference's init from a seeded generator: the FM columns
        normal x 0.01, the first-order column and every bias zero, the MLP
        weights truncated-normal Glorot (std sqrt(2/(in+out)) / .8796, cut
        at two of them).  The host tier's rows are the store's to init."""
        vocab, dim = NUM_CAT * self.buckets_per_feature, self.embedding_dim
        with torch.no_grad():
            if not self.host_tier:
                logical = torch.zeros(vocab, dim + 1, device=self.fm_table.device)
                logical[:, :dim].normal_(0.0, 1.0, generator=generator).mul_(0.01)
                self.fm_table.copy_(pack_table(logical, dim + 1))
                del logical
            for layer in self.mlp.values():
                fan_in, fan_out = layer.w.shape
                std = math.sqrt(2.0 / (fan_in + fan_out)) / 0.87962566103423978
                nn.init.trunc_normal_(layer.w, 0.0, std, -2 * std, 2 * std, generator=generator)
                layer.b.zero_()
            self.dense_linear.w.zero_()
            self.dense_linear.b.zero_()

    def load_jax_params(self, tree: Dict[str, Any]) -> "DeepFM":
        """Copy a JAX ``deepfm`` params tree (numpy arrays) into this module
        (a host-tier tree has no ``fm_table``, as this module then has none)."""

        def put(p: torch.Tensor, value: Any) -> None:
            arr = np.array(value, np.float32)  # a writable copy
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"shape {arr.shape} does not match {tuple(p.shape)}")
            p.copy_(torch.from_numpy(arr))

        if ("fm_table" in tree) == self.host_tier:
            raise ValueError(
                f"params tree {'with' if 'fm_table' in tree else 'without'} fm_table "
                f"does not fit a model with host_tier={self.host_tier}")
        with torch.no_grad():
            if not self.host_tier:
                put(self.fm_table, tree["fm_table"])
            put(self.dense_linear.w, tree["dense_linear"]["w"])
            put(self.dense_linear.b, tree["dense_linear"]["b"])
            if sorted(tree["mlp"]) != sorted(self.mlp):
                raise ValueError(f"mlp layers {sorted(tree['mlp'])} != {sorted(self.mlp)}")
            for name, layer in self.mlp.items():
                put(layer.w, tree["mlp"][name]["w"])
                put(layer.b, tree["mlp"][name]["b"])
        return self

    def forward(self, batch: Dict[str, torch.Tensor],
                ctx: ParallelContext = ParallelContext()) -> torch.Tensor:
        cd, dim = self.compute_dtype, self.embedding_dim
        # Preprocessed batches (criteo_feed_pre) arrive with the host
        # transforms applied: float16 dense is log1p'd, uint16 cat ids are
        # bucket ids (viewed as int16 and widened: the card's uint16 support
        # is thin).
        d = batch["dense"]
        dense = d.float() if d.dtype == torch.float16 else log_normalize(d)
        if HOST_FM_KEY in batch:
            # The host tier: rows pulled from the store and placed by the
            # trainer; their gradient goes back to the store.
            vecs = batch[HOST_FM_KEY]  # [b, 26, dim + 1]
        else:
            c = batch["cat"]
            if c.dtype == torch.uint16:
                offsets = torch.arange(NUM_CAT, dtype=torch.int64, device=c.device)
                ids = (c.view(torch.int16).to(torch.int64) & 0xFFFF) + offsets * self.buckets_per_feature
            else:
                ids = fuse_feature_ids(c, self.buckets_per_feature)  # [b, 26]
            vecs = embedding_lookup(self.fm_table, ids, ctx, dim=dim + 1)
        emb, lin = vecs[..., :dim], vecs[..., dim]  # [b, 26, dim], [b, 26]

        emb = emb.to(cd)
        dense_c = dense.to(cd)

        # First order: sparse linear + dense linear, in f32.
        dl = self.dense_linear
        first = lin.sum(dim=-1, dtype=torch.float32) + (dense @ dl.w)[:, 0] + dl.b[0]

        # Second-order FM: 0.5 * sum_d[(sum_f v)^2 - sum_f v^2].
        sum_v = emb.sum(dim=1)
        sum_v2 = (emb * emb).sum(dim=1)
        fm = 0.5 * (sum_v * sum_v - sum_v2).sum(dim=-1).float()

        # Deep head.
        x = torch.cat([emb.reshape(emb.shape[0], -1), dense_c], dim=-1)
        n_hidden = len(self.mlp) - 1
        for i in range(n_hidden):
            layer = self.mlp[f"layer{i}"]
            x = torch.relu(x @ layer.w.to(cd) + layer.b.to(cd))
        out = self.mlp["out"]
        deep = (x @ out.w.to(cd) + out.b.to(cd))[:, 0].float()
        return first + fm + deep


def _apply(model: DeepFM, batch: Dict[str, torch.Tensor], train: bool = False,
           ctx: ParallelContext = ParallelContext()) -> torch.Tensor:
    return model(batch, ctx)


def _predict(model: DeepFM, batch: Dict[str, torch.Tensor],
             ctx: ParallelContext = ParallelContext()) -> torch.Tensor:
    """Inference entry: the click probability in [0, 1], not the logit."""
    return torch.sigmoid(model(batch, ctx))


def _loss(logits: torch.Tensor, batch: Dict[str, torch.Tensor], mask=None) -> torch.Tensor:
    return bce_loss(logits, batch["labels"], mask)


def _metrics(logits: torch.Tensor, batch: Dict[str, torch.Tensor], mask=None) -> dict:
    return binary_metrics(logits, batch["labels"], mask)


def _example_batch(batch_size: int, pre: bool = False) -> Dict[str, np.ndarray]:
    if pre:
        return {
            "dense": np.zeros((batch_size, NUM_DENSE), np.float16),
            "cat": np.zeros((batch_size, NUM_CAT), np.uint16),
            "labels": np.zeros((batch_size,), np.uint8),
        }
    return {
        "dense": np.zeros((batch_size, NUM_DENSE), np.float32),
        "cat": np.zeros((batch_size, NUM_CAT), np.int32),
        "labels": np.zeros((batch_size,), np.int32),
    }


def _init(
    seed: Optional[int],
    device: Any = None,
    buckets_per_feature: int = 65536,
    embedding_dim: int = 8,
    hidden: tuple = (400, 400),
    compute_dtype: torch.dtype = torch.bfloat16,
    host_tier: bool = False,
) -> DeepFM:
    dev = resolve_device(device)
    model = DeepFM(buckets_per_feature, embedding_dim, hidden, compute_dtype, dev, host_tier)
    if seed is not None:
        model.reset_parameters(torch.Generator(device=dev).manual_seed(seed))
    return model


def params_from_jax(
    tree: Dict[str, Any],
    buckets_per_feature: int,
    embedding_dim: int = 8,
    compute_dtype: str = "bfloat16",
    device: Any = None,
) -> DeepFM:
    """The port's model holding a JAX ``deepfm`` params tree (numpy arrays,
    as ``jax.device_get`` returns them); a tree without ``fm_table`` (the
    host tier's) gives a host-tier model, whose rows carry across as the
    native store's file."""
    n_hidden = len(tree["mlp"]) - 1
    hidden = tuple(np.shape(tree["mlp"][f"layer{i}"]["w"])[1] for i in range(n_hidden))
    model = _init(None, device, buckets_per_feature, embedding_dim, hidden,
                  _DTYPES[compute_dtype], host_tier="fm_table" not in tree)
    return model.load_jax_params(tree)


def params_to_jax(model: DeepFM) -> Dict[str, Any]:
    """The reverse of :func:`params_from_jax`: the parameters as a JAX
    ``deepfm`` params tree of f32 numpy arrays."""

    def get(p: torch.Tensor) -> np.ndarray:
        # A copy on either device: a CPU tensor's numpy view would follow
        # the module's later in-place updates.
        return p.detach().to("cpu", torch.float32, copy=True).numpy()

    def linear(layer: _Linear) -> Dict[str, np.ndarray]:
        return {"w": get(layer.w), "b": get(layer.b)}

    tree = {
        "dense_linear": linear(model.dense_linear),
        "mlp": {name: linear(layer) for name, layer in model.mlp.items()},
    }
    if not model.host_tier:
        tree["fm_table"] = get(model.fm_table)
    return tree


def model_spec(
    learning_rate: float = 1e-3,
    compute_dtype: str = "bfloat16",
    buckets_per_feature: int = 65536,
    embedding_dim: int = 8,
    hidden: Any = (400, 400),
    host_tier: Any = "auto",
    pipeline_preprocess: Any = "auto",
) -> ModelSpec:
    """The reference's arguments and their ``"auto"`` resolution.

    ``host_tier``: True places the FM table in the native host store;
    "auto" does so when the padded table and its Adam moments would exceed
    the HBM guard (``ops.embedding.exceeds_hbm_guard``, one device).
    ``pipeline_preprocess``: the feature transforms in the native decoder
    (``criteo_feed_pre``); "auto" turns it on for the device tier whenever
    the bucket count fits uint16, and never for the host tier, whose host
    hash needs the raw ids.
    """
    if isinstance(hidden, (list, tuple)):
        hidden = tuple(int(h) for h in hidden)
    else:  # "400,400" via --model_params
        hidden = tuple(int(h) for h in str(hidden).split(",") if h)
    if compute_dtype not in _DTYPES:
        raise ValueError(f"compute_dtype must be one of {sorted(_DTYPES)}, got {compute_dtype!r}")
    vocab, dim = NUM_CAT * buckets_per_feature, embedding_dim
    if host_tier == "auto":
        host_tier = exceeds_hbm_guard(vocab, dim + 1)
    host_tier = bool(host_tier)
    if pipeline_preprocess == "auto":
        pipeline_preprocess = not host_tier and buckets_per_feature <= 65536
    pipeline_preprocess = bool(pipeline_preprocess)
    if pipeline_preprocess and (host_tier or buckets_per_feature > 65536):
        raise ValueError(
            "pipeline_preprocess requires the mesh-tier model and "
            "buckets_per_feature <= 65536"
        )
    return ModelSpec(
        name="deepfm",
        init=functools.partial(
            _init, buckets_per_feature=buckets_per_feature, embedding_dim=dim,
            hidden=hidden, compute_dtype=_DTYPES[compute_dtype], host_tier=host_tier,
        ),
        apply=_apply,
        predict=_predict,
        loss=_loss,
        metrics=_metrics,
        optimizer=functools.partial(adam, learning_rate=learning_rate),
        feed=(
            functools.partial(criteo_feed_pre, buckets=buckets_per_feature)
            if pipeline_preprocess
            else criteo_feed
        ),
        example_batch=functools.partial(_example_batch, pre=pipeline_preprocess),
        embedding_tables=[] if host_tier else [EmbeddingTableSpec(("fm_table",), vocab, dim + 1)],
        host_io=(
            {
                HOST_FM_KEY: HostTableIO(
                    ids_fn=functools.partial(_host_ids, buckets_per_feature=buckets_per_feature),
                    dim=dim + 1,
                    optimizer="adagrad",
                    learning_rate=learning_rate * 10,
                    init_scale=0.01,
                )
            }
            if host_tier
            else {}
        ),
    )


def _host_ids(batch: Dict[str, np.ndarray], buckets_per_feature: int) -> np.ndarray:
    """The host tier's fused ids of a numpy batch: the device hash's, bit
    for bit (``fuse_feature_ids_np``)."""
    return fuse_feature_ids_np(batch["cat"], buckets_per_feature)
