"""Ring attention: sequence parallelism over a mesh axis, and attention on
one device.

Port of ``elasticdl_tpu/ops/ring_attention.py``.  Each rank of the axis
holds ``[B, L/n]`` of every sequence; the queries stay put while the key
and value blocks travel around the ring, one rotation a step, and the
local queries accumulate them with the streaming softmax (running row max
``m``, normaliser ``l``, unnormalised output ``o``), exact to rounding in
any block order.  The causal mask uses global positions (``rank * L_local
+ offset``), so the sharded result equals the unsharded lower-triangular
mask.

As in the reference the ring (n > 1) is plain tensor algebra in f32, not
a kernel: the einsums, the mask and the rotation
(``Reducer.ring_shift``: ``isend``/``irecv`` over the axis's process
group, the reverse rotation in the backward).  A ring of one rank (and no
axis) is ``_local_attention``: the flash kernels for card tensors inside
their contract, the plain oracle otherwise.
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
    """Exact single-shard attention: the flash kernels for CUDA tensors
    inside their contract (the forward, and the dq and dkv kernels in the
    backward, whether or not a gradient is wanted), the plain oracle
    otherwise (the CPU, and shapes the kernels do not take), as the
    reference routes between its Pallas kernels and its XLA path."""
    if q.is_cuda and supports(q, k, v):
        return flash_attention(q, k, v, causal)
    return attention_reference(q, k, v, causal=causal)


class _Rotate(torch.autograd.Function):
    """One ring step for the key and value blocks: forward, send to the
    next position and receive from the previous one; backward, the
    gradients go the other way."""

    @staticmethod
    def forward(ctx, k, v, reducer, group):
        ctx.reducer, ctx.group = reducer, group
        return tuple(reducer.ring_shift([k, v], group, shift=1))

    @staticmethod
    def backward(ctx, gk, gv):
        gk = torch.zeros_like(gv) if gk is None else gk
        gv = torch.zeros_like(gk) if gv is None else gv
        gk, gv = ctx.reducer.ring_shift([gk, gv], ctx.group, shift=-1)
        return gk, gv, None, None


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    axis_name: Optional[str] = None,
    causal: bool = False,
    ctx=None,
) -> torch.Tensor:
    """Blockwise attention with K/V ring rotation over ``axis_name``.

    Inputs are this rank's sequence shards ``[B, L_local, H, D]``; the
    output is its shard of the full-attention result.  ``ctx`` (the
    trainer's ``ParallelContext``, whose ``axis_name`` must be the axis)
    gives the axis's size, this rank's position and the group.  With
    ``axis_name=None``, or an axis of one rank, it is exact single-device
    attention.  Every rank of the axis must call it at the same point: the
    rotations are collective, and none is skipped for a fully masked
    block."""
    if axis_name is None:
        return _local_attention(q, k, v, causal)
    if ctx is None or ctx.axis_name != axis_name:
        raise ValueError(f"ring attention over {axis_name!r} needs the ParallelContext of "
                         f"that axis, got {getattr(ctx, 'axis_name', None)!r}")
    n = ctx.axis_size
    if n == 1:
        return _local_attention(q, k, v, causal)
    my = ctx.axis_index
    b, lq, h, d = q.shape
    lk = k.shape[1]
    scale = d**-0.5
    qf = q.float()
    q_pos = my * lq + torch.arange(lq, device=q.device)  # global positions

    def accumulate(acc, src, k_blk, v_blk):
        o, m, l = acc
        scores = torch.einsum("bqhd,bkhd->bhqk", qf, k_blk) * scale
        if causal:
            kv_pos = src * lk + torch.arange(lk, device=q.device)
            mask = q_pos[:, None] >= kv_pos[None, :]  # [lq, lk]
            scores = scores.masked_fill(~mask, float("-inf"))
        m_new = torch.maximum(m, scores.amax(dim=-1))
        # Fully masked rows keep m=-inf; guard the exp against inf-inf.
        safe_m = torch.where(torch.isneginf(m_new), 0.0, m_new)
        p = torch.exp(scores - safe_m[..., None])
        corr = torch.where(torch.isneginf(m), 0.0, torch.exp(m - safe_m))
        l_new = l * corr + p.sum(dim=-1)
        o_new = o * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, v_blk)
        return o_new, m_new, l_new

    # Block 0 is the locally held K/V; then exactly n-1 rotations
    # (rotate-then-accumulate), so no transferred block is wasted.
    o0 = q.new_zeros((b, h, lq, d), dtype=torch.float32)
    m0 = q.new_full((b, h, lq), float("-inf"), dtype=torch.float32)
    l0 = q.new_zeros((b, h, lq), dtype=torch.float32)
    k_blk, v_blk = k.float(), v.float()
    acc = accumulate((o0, m0, l0), my, k_blk, v_blk)
    for i in range(1, n):
        k_blk, v_blk = _Rotate.apply(k_blk, v_blk, ctx.reducer, ctx.group)
        acc = accumulate(acc, (my - i) % n, k_blk, v_blk)
    o, m, l = acc
    out = o / l.clamp_min(1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)  # [B, Lq, H, D]
