"""Mask-aware metric helpers — the port of ``masked_mean``, ``AUC_BINS``
and ``auc_histograms`` from ``elasticdl_tpu/models/metrics.py``.

A padded batch carries a ``__mask__`` vector (1.0 = real example, 0.0 =
padding); means over per-example values then count real examples only.
"""

from __future__ import annotations

from typing import Optional

import torch


def masked_mean(values: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean of per-example ``values`` over real examples only.

    ``values`` may carry trailing per-example dims (e.g. per-token CE
    [b, s]); the [b] mask broadcasts across them, so every real example's
    elements weigh equally."""
    values = values.float()
    if mask is None:
        return values.mean()
    m = mask.float()
    m = m.reshape(m.shape + (1,) * (values.dim() - m.dim()))
    w = m.expand_as(values)
    return (values * w).sum() / w.sum().clamp_min(1e-12)


#: Score-histogram resolution for streaming AUC: 512 buckets bound the
#: binning bias at ~2e-3 (ties within a bucket count half).
AUC_BINS = 512


def auc_histograms(
    probs: torch.Tensor,
    labels: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    n_bins: int = AUC_BINS,
) -> dict:
    """Per-bucket positive/negative counts of ``probs`` in [0, 1], the
    device half of streaming AUC (``common.metrics.auc_from_histograms``).

    Histograms are linear, so they survive every aggregation (masked
    minibatch means, the worker's per-task weighting, the master's
    cross-worker mean), and the AUC derived at the end equals the AUC of
    the pooled predictions to ~1/n_bins.  Returns ``{AUC_POS: [n_bins],
    AUC_NEG: [n_bins]}``, divided by the real-example count so they
    weight-average like the scalar metrics around them.
    """
    from elasticdl_tpu_torch.common.metrics import AUC_NEG, AUC_POS

    probs = probs.float().reshape(-1)
    labels_f = labels.float().reshape(-1)
    m = torch.ones_like(probs) if mask is None else mask.float().reshape(-1)
    idx = (probs * n_bins).to(torch.int32).clamp(0, n_bins - 1).to(torch.int64)
    pos = probs.new_zeros(n_bins).index_add_(0, idx, m * labels_f)
    neg = probs.new_zeros(n_bins).index_add_(0, idx, m * (1.0 - labels_f))
    count = m.sum().clamp_min(1e-12)
    return {AUC_POS: pos / count, AUC_NEG: neg / count}
