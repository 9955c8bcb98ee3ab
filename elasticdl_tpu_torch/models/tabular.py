"""Shared helpers of the tabular models — the port of
``elasticdl_tpu/models/tabular.py``.

All categorical features share ONE fused id space: feature ``f``'s hashed
bucket ``h`` maps to global id ``f * buckets + h``, so one table and one
lookup serve every feature.  The hash is the reference's multiplicative
uint32 hash (Knuth's constant); torch has no uint32 arithmetic on the card
for most ops, so :func:`hash_buckets` computes it in int64 without
overflow and equals :func:`fuse_feature_ids_np` bit for bit on ids across
the whole 32-bit range, negative int32 ids included.
"""

from __future__ import annotations

import numpy as np
import torch

from elasticdl_tpu_torch.models.metrics import auc_histograms, masked_mean

_HASH_MULT = 2654435761
_U32 = 0xFFFFFFFF


def hash_buckets(ids: torch.Tensor, num_buckets: int) -> torch.Tensor:
    """Hash integer ids (their low 32 bits, as uint32) into
    [0, num_buckets): ``h = ids * 2654435761 mod 2^32; h ^= h >> 16;
    h % num_buckets``.  The product is taken in 16-bit halves, so no
    intermediate leaves int64."""
    x = ids.to(torch.int64) & _U32
    lo, hi = x & 0xFFFF, x >> 16
    h = (lo * _HASH_MULT + (((hi * _HASH_MULT) & 0xFFFF) << 16)) & _U32
    h = h ^ (h >> 16)
    return h % num_buckets


def fuse_feature_ids(cat_ids: torch.Tensor, buckets_per_feature: int) -> torch.Tensor:
    """[batch, n_features] raw ids -> fused int64 global ids in one shared
    table: feature ``f`` occupies rows ``[f*B, (f+1)*B)``."""
    n_features = cat_ids.shape[-1]
    offsets = torch.arange(n_features, dtype=torch.int64, device=cat_ids.device)
    return hash_buckets(cat_ids, buckets_per_feature) + offsets * buckets_per_feature


def fuse_feature_ids_np(cat_ids, buckets_per_feature: int):
    """Numpy twin of :func:`fuse_feature_ids` (bit-for-bit identical ids)."""
    ids = np.asarray(cat_ids)
    h = ids.astype(np.uint32) * np.uint32(_HASH_MULT)
    h ^= h >> np.uint32(16)
    hashed = (h % np.uint32(buckets_per_feature)).astype(np.int64)
    offsets = np.arange(ids.shape[-1], dtype=np.int64) * buckets_per_feature
    return hashed + offsets


def log_normalize(dense: torch.Tensor) -> torch.Tensor:
    """log(1+x) for non-negative numeric features (the Criteo recipe)."""
    return torch.log1p(torch.clamp_min(dense.float(), 0.0))


def _bce(logits: torch.Tensor, labels_f: torch.Tensor) -> torch.Tensor:
    """Per-example binary cross-entropy on logits, the reference's stable
    form."""
    return torch.clamp_min(logits, 0) - logits * labels_f + torch.log1p(torch.exp(-logits.abs()))


def binary_metrics(logits: torch.Tensor, labels: torch.Tensor, mask=None) -> dict:
    """Loss, accuracy, calibration and the AUC score histograms of a binary
    CTR task (``mask``: the padded tail's real rows)."""
    prob = torch.sigmoid(logits)
    pred = (prob >= 0.5).to(torch.int32)
    labels_f = labels.float()
    return {
        "loss": masked_mean(_bce(logits, labels_f), mask),
        "accuracy": masked_mean(pred == labels, mask),
        # mean(prob) / mean(label): ~1.0 when calibrated.
        "calibration": masked_mean(prob, mask)
        / torch.clamp_min(masked_mean(labels_f, mask), 1e-6),
        # Streaming ROC AUC: score histograms here, the scalar derived at
        # each pipeline's end (common/metrics.finalize_metrics).
        **auc_histograms(prob, labels, mask),
    }


def adam(parameters, learning_rate: float) -> torch.optim.Adam:
    """``optax.adam(learning_rate)``: b1 0.9, b2 0.999, eps 1e-8, every
    parameter dense (the tabular models' optimizer)."""
    return torch.optim.Adam(parameters, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)


def bce_loss(logits: torch.Tensor, labels: torch.Tensor, mask=None) -> torch.Tensor:
    """BCE over real examples only (padding carries zero loss, hence zero
    gradient)."""
    return masked_mean(_bce(logits, labels.float()), mask)
