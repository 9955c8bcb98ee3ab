"""Attention on one device: the plain oracle and the kernel routing.

Port of ``elasticdl_tpu/ops/ring_attention.py``'s single-device half:
``attention_reference`` (the numerics oracle) and ``_local_attention``'s
routing.  The sequence-parallel ring (K/V blocks rotating over a mesh axis)
is a later slice of the port; ``ring_attention`` with an axis raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from elasticdl_tpu_torch.ops.flash_attention import flash_attention, supports


def attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False
) -> torch.Tensor:
    """Plain full attention ([B, L, H, D] layout) — the numerics oracle."""
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        lq, lk = scores.shape[-2], scores.shape[-1]
        mask = torch.ones(lq, lk, dtype=torch.bool, device=q.device).tril(lk - lq)
        scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _local_attention(q, k, v, causal: bool) -> torch.Tensor:
    """Exact single-shard attention: the flash kernel for CUDA tensors
    inside its contract, the plain oracle otherwise (the CPU, and shapes
    the kernel does not take), as the reference routes between its Pallas
    kernel and its XLA path."""
    if q.is_cuda and supports(q, k, v):
        return flash_attention(q, k, v, causal)
    return attention_reference(q, k, v, causal=causal)


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    axis_name: Optional[str] = None,
    causal: bool = False,
) -> torch.Tensor:
    """Exact single-device attention (``axis_name=None``).  The
    sequence-parallel ring over a device axis is not ported yet."""
    if axis_name is not None:
        raise NotImplementedError(
            "ring attention over a device axis is not ported yet (ROADMAP, "
            "PyTorch port queue: ring and tensor-parallel attention)"
        )
    return _local_attention(q, k, v, causal)
