"""Wide&Deep on Census income — the PyTorch port of
``elasticdl_tpu/models/wide_deep.py`` (BASELINE config 3, "Wide&Deep on
Census income, ParameterServer mode + elasticdl.layers.Embedding").

Census schema (UCI adult): 5 numerics (age, education_num, capital_gain,
capital_loss, hours_per_week; log1p-normalised) and 9 categoricals, which
the feed hashes to 31-bit ids and this model re-buckets on the device
(``models/tabular.py``).  Two row-shardable tables, in the packed layout of
``ops/embedding.py``:

- ``wide``: dim 1 (a dim-1 table packs 128 logical rows to a physical
  row), ``(9 + 36) * buckets`` rows: the linear weights of the hashed
  singles and of the 36 pairwise crosses, each slot in its own row range;
  zero at init;
- ``deep_embedding``: dim ``embedding_dim``, ``9 * buckets`` rows, normal
  x 0.05 (``init_table``).

The logit is the wide sum plus an MLP over [embeddings; numerics] plus a
bias.  f32 parameters and loss, the MLP in ``compute_dtype``; Adam with
optax.adam's constants, dense over both tables.  The parameters carry the
JAX tree's names and shapes (``wide``, ``deep_embedding``,
``mlp.layer{i}.w``, ``mlp.out.b``, ``bias``), so ``params_from_jax`` and
``params_to_jax`` carry weights across untransposed.

A cross is ``a * 1000003 + b`` in uint32 arithmetic, which wraps; torch
has no uint32 multiply on the card, so it is taken in int64 (a < 2^32, so
no overflow) and masked to the low 32 bits before ``hash_buckets``.
"""

from __future__ import annotations

import functools
import itertools
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from elasticdl_tpu_torch.common.device import resolve_device
from elasticdl_tpu_torch.data.codecs import census_feed
from elasticdl_tpu_torch.models import common
from elasticdl_tpu_torch.models.spec import EmbeddingTableSpec, ModelSpec
from elasticdl_tpu_torch.models.tabular import (
    adam,
    bce_loss,
    binary_metrics,
    fuse_feature_ids,
    hash_buckets,
    log_normalize,
)
from elasticdl_tpu_torch.ops.embedding import (
    ParallelContext,
    embedding_lookup,
    init_table,
    table_shape,
)

NUM_DENSE = 5
NUM_CAT = 9
_CROSSES = tuple(itertools.combinations(range(NUM_CAT), 2))  # all 36 pairs
_CROSS_MULT = 1000003
_U32 = 0xFFFFFFFF


def wide_vocab(buckets: int) -> int:
    return (NUM_CAT + len(_CROSSES)) * buckets


def deep_vocab(buckets: int) -> int:
    return NUM_CAT * buckets


def wide_ids(cat: torch.Tensor, buckets: int) -> torch.Tensor:
    """[b, 9 + 36] fused wide-table ids: the hashed singles, then the
    hashed pairwise crosses, each slot with its own row range."""
    singles = fuse_feature_ids(cat, buckets)  # [b, 9]
    c = cat.to(torch.int64) & _U32
    # The pairs (i < j) in itertools.combinations' order, made on the
    # device (no host copy a step).
    left, right = torch.triu_indices(NUM_CAT, NUM_CAT, 1, device=cat.device)
    crossed = hash_buckets((c[:, left] * _CROSS_MULT + c[:, right]) & _U32, buckets)
    offsets = (NUM_CAT + torch.arange(len(_CROSSES), device=cat.device)) * buckets
    return torch.cat([singles, crossed + offsets], dim=-1)


class _Linear(nn.Module):
    """``x @ w + b`` with the reference's ``[in, out]`` weight."""

    def __init__(self, n_in: int, n_out: int, device: torch.device):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(n_in, n_out, device=device))
        self.b = nn.Parameter(torch.zeros(n_out, device=device))


class WideDeep(nn.Module):
    def __init__(self, buckets: int, embedding_dim: int, hidden: tuple,
                 compute_dtype: torch.dtype, device: torch.device):
        super().__init__()
        self.buckets = buckets
        self.embedding_dim = embedding_dim
        self.compute_dtype = compute_dtype
        self.wide = nn.Parameter(torch.zeros(table_shape(wide_vocab(buckets), 1), device=device))
        self.deep_embedding = nn.Parameter(
            torch.zeros(table_shape(deep_vocab(buckets), embedding_dim), device=device))
        layers: Dict[str, nn.Module] = {}
        in_dim = NUM_CAT * embedding_dim + NUM_DENSE
        for i, width in enumerate(hidden):
            layers[f"layer{i}"] = _Linear(in_dim, width, device)
            in_dim = width
        layers["out"] = _Linear(in_dim, 1, device)
        self.mlp = nn.ModuleDict(layers)
        self.bias = nn.Parameter(torch.zeros(1, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The reference's init: the wide table, the biases and ``bias``
        zero, the deep table normal x 0.05, glorot_normal MLP weights."""
        with torch.no_grad():
            self.wide.zero_()
            self.deep_embedding.copy_(init_table(
                generator, deep_vocab(self.buckets), self.embedding_dim, scale=0.05,
                device=self.deep_embedding.device))
            for layer in self.mlp.values():
                common.glorot_normal_dense_(layer.w, generator)
                layer.b.zero_()
            self.bias.zero_()

    def forward(self, batch: Dict[str, torch.Tensor],
                ctx: ParallelContext = ParallelContext()) -> torch.Tensor:
        cd, dim = self.compute_dtype, self.embedding_dim
        cat = batch["cat"]
        dense = log_normalize(batch["dense"])
        wide_w = embedding_lookup(self.wide, wide_ids(cat, self.buckets), ctx, dim=1)
        emb = embedding_lookup(self.deep_embedding, fuse_feature_ids(cat, self.buckets),
                               ctx, dim=dim)  # [b, 9, dim]
        wide = wide_w[..., 0].sum(dim=-1, dtype=torch.float32)
        x = torch.cat([emb.reshape(emb.shape[0], -1), dense], dim=-1).to(cd)
        for i in range(len(self.mlp) - 1):
            layer = self.mlp[f"layer{i}"]
            x = torch.relu(x @ layer.w.to(cd) + layer.b.to(cd))
        out = self.mlp["out"]
        deep = (x @ out.w.to(cd) + out.b.to(cd))[:, 0].float()
        return wide + deep + self.bias[0]

    def load_jax_params(self, tree: Dict[str, Any]) -> "WideDeep":
        """Copy a JAX ``wide_deep`` params tree (numpy arrays) into this
        module."""
        if sorted(tree["mlp"]) != sorted(self.mlp):
            raise ValueError(f"mlp layers {sorted(tree['mlp'])} != {sorted(self.mlp)}")
        common.load_tree([(n.replace(".", "/"), p) for n, p in self.named_parameters()],
                        tree, convs=())
        return self


def _apply(model: WideDeep, batch: Dict[str, torch.Tensor], train: bool = False,
           ctx: ParallelContext = ParallelContext()) -> torch.Tensor:
    return model(batch, ctx)


def _predict(model: WideDeep, batch: Dict[str, torch.Tensor],
             ctx: ParallelContext = ParallelContext()) -> torch.Tensor:
    """Inference entry: the income-bracket probability in [0, 1], not the
    logit."""
    return torch.sigmoid(model(batch, ctx))


def _loss(logits: torch.Tensor, batch: Dict[str, torch.Tensor], mask=None) -> torch.Tensor:
    return bce_loss(logits, batch["labels"], mask)


def _metrics(logits: torch.Tensor, batch: Dict[str, torch.Tensor], mask=None) -> dict:
    return binary_metrics(logits, batch["labels"], mask)


def _example_batch(batch_size: int) -> Dict[str, np.ndarray]:
    return {
        "dense": np.zeros((batch_size, NUM_DENSE), np.float32),
        "cat": np.zeros((batch_size, NUM_CAT), np.int32),
        "labels": np.zeros((batch_size,), np.int32),
    }


def _init(seed: Optional[int], device: Any = None, buckets: int = 1024,
          embedding_dim: int = 8, hidden: tuple = (100, 50),
          compute_dtype: torch.dtype = torch.bfloat16) -> WideDeep:
    dev = resolve_device(device)
    model = WideDeep(buckets, embedding_dim, hidden, compute_dtype, dev)
    if seed is not None:
        model.reset_parameters(torch.Generator(device=dev).manual_seed(seed))
    return model


def params_from_jax(tree: Dict[str, Any], buckets: int, embedding_dim: int = 8,
                    compute_dtype: str = "bfloat16", device: Any = None) -> WideDeep:
    """The port's model holding a JAX ``wide_deep`` params tree (numpy
    arrays, as ``jax.device_get`` returns them)."""
    n_hidden = len(tree["mlp"]) - 1
    hidden = tuple(np.shape(tree["mlp"][f"layer{i}"]["w"])[1] for i in range(n_hidden))
    model = _init(None, device, buckets, embedding_dim, hidden,
                  common.compute_dtype(compute_dtype))
    return model.load_jax_params(tree)


def params_to_jax(model: WideDeep) -> Dict[str, Any]:
    """The reverse of :func:`params_from_jax`: a JAX ``wide_deep`` params
    tree of f32 numpy copies."""
    return common.dump_tree([(n.replace(".", "/"), p) for n, p in model.named_parameters()],
                           convs=())


def model_spec(
    learning_rate: float = 1e-3,
    compute_dtype: str = "bfloat16",
    buckets: int = 1024,
    embedding_dim: int = 8,
    hidden: Any = (100, 50),
) -> ModelSpec:
    if isinstance(hidden, (list, tuple)):
        hidden = tuple(int(h) for h in hidden)
    else:  # "100,50" via --model_params
        hidden = tuple(int(h) for h in str(hidden).split(",") if h)
    return ModelSpec(
        name="wide_deep",
        init=functools.partial(_init, buckets=buckets, embedding_dim=embedding_dim,
                               hidden=hidden, compute_dtype=common.compute_dtype(compute_dtype)),
        apply=_apply,
        predict=_predict,
        loss=_loss,
        metrics=_metrics,
        optimizer=functools.partial(adam, learning_rate=learning_rate),
        embedding_tables=[
            EmbeddingTableSpec(path=("wide",), vocab_size=wide_vocab(buckets), dim=1),
            EmbeddingTableSpec(path=("deep_embedding",), vocab_size=deep_vocab(buckets),
                               dim=embedding_dim),
        ],
        feed=census_feed,
        example_batch=_example_batch,
    )
