"""Flash attention forward: the hand-written Hopper kernel and its plain
PyTorch version.

Port of ``elasticdl_tpu/ops/flash_attention.py``'s forward (the Pallas
``_fwd_kernel``).  The kernel lives in
``elasticdl_tpu_torch/csrc/flash_attention_fwd.cu``; its source note says
what bounds it on the card and how the design differs from the TPU kernel
(K/V streamed through shared memory with an online softmax instead of held
whole in VMEM).

Public layout is the model's ``[B, L, H, D]``, in and out; the logsumexp is
f32 ``[B*H, L]`` (row ``b*H + h``), kept for the training slice's backward.
The TPU kernel's 128-lane head padding and ``[BH, n_q, 8, 128]`` vector
tiles are TPU layout constraints and are gone.

Routing: a CUDA tensor launches the kernel or raises; a CPU tensor runs
:func:`flash_attention_plain`, the same arithmetic in plain PyTorch (the
tests hold it against the JAX kernel, and ``chip_smoke.py`` holds the
kernel against it on the card).  There is no silent fallback from one to
the other.  Forward only: the backward kernels come with the training
slice.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from elasticdl_tpu_torch.ops import kernels

KERNEL = "flash_attention_fwd"
SOURCE = "flash_attention_fwd.cu"

# The reference kernel's contract (elasticdl_tpu/ops/flash_attention.py):
# kept exactly, so the port routes exactly as the reference does.
_TQ = 128
_LANE = 128
_MAX_L = 8192

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def supports(q, k, v) -> bool:
    """True when these shapes are inside the kernel's contract (callers use
    this to fall back to the XLA path instead of tripping _check)."""
    b, lq, h, d = q.shape
    return bool(
        lq % _TQ == 0
        and lq <= _MAX_L
        and d <= _LANE
        and k.shape == q.shape
        and v.shape == q.shape
    )


def _check(q, k, v):
    if not supports(q, k, v):
        raise ValueError(
            f"flash_attention supports self-attention with L a multiple of "
            f"{_TQ}, L <= {_MAX_L}, head_dim <= {_LANE}; got q{tuple(q.shape)} "
            f"k{tuple(k.shape)} v{tuple(v.shape)} (use ops.ring_attention's XLA path)"
        )


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: (O ``[B, L, H, D]`` in the
    input dtype, lse f32 ``[B*H, L]``).  Scores and statistics in f32, p
    rounded to the input dtype before the PV product, the all-masked-row
    guard and the 1e-30 clamps, as in the TPU kernel."""
    b, l, h, d = q.shape
    scale = d**-0.5
    qf, kf, vf = (x.float().permute(0, 2, 1, 3) for x in (q, k, v))  # [B, H, L, D]
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if causal:
        mask = torch.ones(l, l, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(dim=-1)
    safe_m = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    p = torch.exp(s - safe_m[..., None])
    den = p.sum(dim=-1).clamp_min(1e-30)
    o = torch.matmul(p.to(q.dtype).float(), vf) / den[..., None]
    lse = safe_m + torch.log(den)
    return (
        o.to(q.dtype).permute(0, 2, 1, 3).contiguous(),
        lse.reshape(b * h, l),
    )


_ARGTYPES = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 4 + (
    ctypes.c_long, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
)


def _launch(q, k, v, causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    b, l, h, d = q.shape
    fn = kernels.bind(SOURCE, KERNEL, _ARGTYPES)
    o = torch.empty((b, l, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, l), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        b, l, h, d, q.stride(1), float(d**-0.5), int(bool(causal)),
        _DTYPE_CODES[q.dtype], stream,
    )
    kernels.count(KERNEL)
    kernels.check_launch(KERNEL, status)
    return o, lse


def _check_layout(q, k, v) -> None:
    """The kernel reads ``[B, L, H, D]`` with unit element stride, head
    stride D and one row stride: contiguous tensors, or views into a fused
    ``[B, L, 3*H*D]`` qkv projection (row stride 3*H*D)."""
    b, l, h, d = q.shape
    row = q.stride(1)
    want = (l * row, row, d, 1)
    if any(tuple(x.stride()) != want for x in (q, k, v)) or row < h * d:
        raise ValueError(
            f"flash_attention: q, k and v must be [B, L, H, D] with strides "
            f"(L*r, r, D, 1) for one row stride r >= H*D; got "
            f"{q.stride()}, {k.stride()}, {v.stride()}"
        )


def flash_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(O, lse) of exact self-attention over ``[B, L, H, D]`` inputs."""
    _check(q, k, v)
    devices = {q.device, k.device, v.device}
    if len(devices) != 1:
        raise ValueError(f"flash_attention: q, k, v on different devices {devices}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash_attention takes float32 or bfloat16 q/k/v of one dtype; "
            f"got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    device = q.device
    if device.type == "cpu":
        return flash_attention_plain(q, k, v, causal)
    if device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {device}")
    _check_layout(q, k, v)
    return _launch(q, k, v, causal)


def flash_attention(q, k, v, causal: bool = False) -> torch.Tensor:
    """Exact (non-ring) attention, [B, L, H, D] -> [B, L, H, D]."""
    return flash_attention_fwd(q, k, v, causal)[0]
