"""Mask-aware metric helpers — the port of ``masked_mean`` from
``elasticdl_tpu/models/metrics.py``.

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
