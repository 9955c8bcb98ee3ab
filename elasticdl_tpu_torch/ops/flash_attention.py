"""Flash attention: the hand-written Hopper kernels (forward, and the dq
and dkv backward), their plain PyTorch versions, and the autograd Function
that ties them together.

Port of ``elasticdl_tpu/ops/flash_attention.py`` (the Pallas
``_fwd_kernel``, ``_dq_kernel`` and ``_dkv_kernel`` and the ``custom_vjp``
around them).  The kernels live in ``elasticdl_tpu_torch/csrc/
flash_attention_fwd.cu`` and ``flash_attention_bwd.cu``; their source notes
say what bounds each on the card and how the design differs from the TPU
kernel (tiles streamed through shared memory instead of K/V held whole in
VMEM).

Public layout is the model's ``[B, L, H, D]``, in and out; the logsumexp
and the backward's delta are f32 ``[B*H, L]`` (row ``b*H + h``).  The TPU
kernel's 128-lane head padding and ``[BH, n_q, 8, 128]`` vector tiles are
TPU layout constraints and are gone.

Routing: a CUDA tensor launches the kernel or raises; a CPU tensor runs the
plain version, the same arithmetic in plain PyTorch (the tests hold it
against the JAX kernels, and ``chip_smoke.py`` holds each kernel against it
on the card).  There is no silent fallback from one to the other.  On the
card the bf16 kernels, forward and backward, load tiles by TMA, which
needs 16-byte rows: inputs with a head dim that is not a multiple of 8 (or
rows it cannot address) run the same kernels over copies padded to such a
head dim, a routing by layout that the wrappers state and the tests cover.

:func:`flash_attention` is differentiable.  When q, k and v are views into
one fused ``[B, L, 3*H*D]`` projection, as the model passes them, the
Function takes that tensor and returns its gradient whole: the backward
kernels write dq, dk and dv into it with its row stride, so autograd does
not concatenate three copies.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from elasticdl_tpu_torch.ops import kernels

KERNEL = "flash_attention_fwd"
SOURCE = "flash_attention_fwd.cu"
DQ_KERNEL = "flash_attention_bwd_dq"
DKV_KERNEL = "flash_attention_bwd_dkv"
BWD_SOURCE = "flash_attention_bwd.cu"

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
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False, scale=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: (O ``[B, L, H, D]`` in the
    input dtype, lse f32 ``[B*H, L]``).  Scores and statistics in f32, p
    rounded to the input dtype before the PV product, the all-masked-row
    guard and the 1e-30 clamps, as in the TPU kernel.  ``scale``: the
    score scale, D^-1/2 by default."""
    b, l, h, d = q.shape
    scale = d**-0.5 if scale is None else scale
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


def _launch(q, k, v, causal: bool, scale=None) -> Tuple[torch.Tensor, torch.Tensor]:
    b, l, h, d = q.shape
    fn = kernels.bind(SOURCE, KERNEL, _ARGTYPES)
    o = torch.empty((b, l, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, l), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        b, l, h, d, q.stride(1), float(d**-0.5 if scale is None else scale), int(bool(causal)),
        _DTYPE_CODES[q.dtype], stream,
    )
    kernels.count(KERNEL)
    kernels.check_launch(KERNEL, status)
    return o, lse


def _check_layout(*xs: torch.Tensor) -> None:
    """The kernels read and write ``[B, L, H, D]`` with unit element
    stride, head stride D and one row stride shared by all of ``xs``:
    contiguous tensors, or views into a fused ``[B, L, 3*H*D]`` qkv
    projection (row stride 3*H*D)."""
    b, l, h, d = xs[0].shape
    row = xs[0].stride(1)
    want = (l * row, row, d, 1)
    if any(tuple(x.stride()) != want for x in xs) or row < h * d:
        raise ValueError(
            f"flash_attention: q, k and v (and the gradient buffers) must be "
            f"[B, L, H, D] with strides (L*r, r, D, 1) for one row stride "
            f"r >= H*D; got {', '.join(str(x.stride()) for x in xs)}"
        )


def flash_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(O, lse) of exact self-attention over ``[B, L, H, D]`` inputs.

    Routing by layout on the card: bf16 inputs whose head dim is not a
    multiple of 8 (or whose rows the kernel's TMA loads cannot address:
    a row stride not a multiple of 8, data not 16-byte aligned) go to the
    same kernel over copies padded to such a head dim, and O is sliced
    back (``_fwd_padded``), as the TPU wrapper pads the head dim to its 128
    lanes; f32 inputs go to the FMA kernel as they are."""
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
    if q.dtype == torch.bfloat16 and not _tma_layout(q, k, v):
        return _fwd_padded(q, k, v, causal, _launch)
    return _launch(q, k, v, causal)


# ---------------------------------------------------------------- backward


def _heads_first(x: torch.Tensor) -> torch.Tensor:
    """[B, L, H, D] in any float dtype -> f32 [B, H, L, D]."""
    return x.float().permute(0, 2, 1, 3)


def _probs(q, k, lse, causal: bool, scale: float) -> torch.Tensor:
    """P = exp(S - lse) in f32 ``[B, H, L, L]`` from the forward's lse, zero
    past the diagonal under causal masking."""
    b, l, h, d = q.shape
    s = torch.matmul(_heads_first(q), _heads_first(k).transpose(-1, -2)) * scale
    if causal:
        mask = torch.ones(l, l, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
    return torch.exp(s - lse.reshape(b, h, l, 1))


def flash_attention_bwd_dq_plain(q, k, v, o, lse, do, causal: bool = False, scale=None):
    """The dq kernel's function in plain PyTorch: (dq ``[B, L, H, D]`` in
    the input dtype, delta f32 ``[B*H, L]``).  delta = rowsum(dO * O) and
    dS = P (dO V^T - delta) in f32; dS rounded to the input dtype before
    the product with K, as in the TPU kernel.  ``scale``: the score scale,
    D^-1/2 by default."""
    b, l, h, d = q.shape
    scale = d**-0.5 if scale is None else scale
    p = _probs(q, k, lse, causal, scale)
    dof = _heads_first(do)
    delta = (dof * _heads_first(o)).sum(dim=-1)  # [B, H, L]
    ds = p * (torch.matmul(dof, _heads_first(v).transpose(-1, -2)) - delta[..., None])
    dq = torch.matmul(ds.to(q.dtype).float(), _heads_first(k)) * scale
    return dq.to(q.dtype).permute(0, 2, 1, 3), delta.reshape(b * h, l)


def flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, causal: bool = False, scale=None):
    """The dkv kernel's function in plain PyTorch: (dk, dv) ``[B, L, H, D]``
    in the input dtype.  P^T and dS^T in f32, each rounded to the input
    dtype before its product (with dO, with Q), as in the TPU kernel."""
    b, l, h, d = q.shape
    scale = d**-0.5 if scale is None else scale
    p = _probs(q, k, lse, causal, scale)
    dof = _heads_first(do)
    ds = p * (torch.matmul(dof, _heads_first(v).transpose(-1, -2)) - delta.reshape(b, h, l, 1))
    dv = torch.matmul(p.to(q.dtype).float().transpose(-1, -2), dof)
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), _heads_first(q)) * scale
    return dk.to(q.dtype).permute(0, 2, 1, 3), dv.to(q.dtype).permute(0, 2, 1, 3)


def flash_attention_bwd_plain(q, k, v, o, lse, do, causal: bool = False):
    """The backward kernels' function in plain PyTorch: (dq, dk, dv)."""
    dq, delta = flash_attention_bwd_dq_plain(q, k, v, o, lse, do, causal)
    return (dq, *flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, causal))


_BWD_ARGTYPES = (ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 4 + (
    ctypes.c_long, ctypes.c_long, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
)


def _grad_buffers(q, bufs, n: int) -> Tuple[torch.Tensor, ...]:
    """``n`` gradient buffers shaped like q: the given ones (checked to
    share one row-strided layout the kernels can write), else fresh
    contiguous tensors."""
    if bufs is None:
        return tuple(torch.empty(q.shape, dtype=q.dtype, device=q.device) for _ in range(n))
    for x in bufs:
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(
                f"flash_attention backward: gradient buffer {tuple(x.shape)} {x.dtype} "
                f"{x.device} does not match q {tuple(q.shape)} {q.dtype} {q.device}"
            )
    _check_layout(*bufs)
    return tuple(bufs)


def _bwd_inputs(q, k, v, tensors, vectors) -> None:
    """Checks shared by the backward wrappers: the forward's contract (and,
    on the card, its layout) for q, k, v; contiguous ``[B, L, H, D]``
    ``tensors`` (o, dO) of q's dtype; contiguous f32 ``[B*H, L]``
    ``vectors`` (lse, delta); one device."""
    _check(q, k, v)
    if q.dtype not in _DTYPE_CODES or any(x.dtype != q.dtype for x in (k, v, *tensors)):
        raise TypeError("flash_attention backward: q, k, v, o and dO must share one dtype "
                        "(float32 or bfloat16)")
    b, l, h, _ = q.shape
    for x in tensors:
        if x.shape != q.shape or not x.is_contiguous():
            raise ValueError(f"flash_attention backward: o and dO must be contiguous "
                             f"{tuple(q.shape)}; got {tuple(x.shape)}")
    for x in vectors:
        if x.shape != (b * h, l) or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"flash_attention backward: lse and delta must be contiguous "
                             f"float32 ({b * h}, {l}); got {tuple(x.shape)} {x.dtype}")
    devices = {x.device for x in (q, k, v, *tensors, *vectors)}
    if len(devices) != 1:
        raise ValueError(f"flash_attention backward: tensors on different devices {devices}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if q.is_cuda:
        _check_layout(q, k, v)


def _tma_layout(*xs: torch.Tensor) -> bool:
    """True when the bf16 kernels' TMA loads and 16-byte stores can take
    ``xs`` ([B, L, H, D] tensors, as they are): rows of whole 16-byte
    chunks (D % 8 == 0), row strides a multiple of 8 elements, 16-byte
    aligned data."""
    d = xs[0].shape[-1]
    return d % 8 == 0 and all(x.stride(1) % 8 == 0 and x.data_ptr() % 16 == 0 for x in xs)


def _pad_head(x: torch.Tensor, dp: int) -> torch.Tensor:
    """A contiguous copy of [B, L, H, D] ``x`` with the head dim zero-padded
    to ``dp``."""
    out = x.new_zeros((*x.shape[:-1], dp))
    out[..., : x.shape[-1]] = x
    return out


def _fwd_padded(q, k, v, causal, fwd_fn):
    """(O, lse) by ``fwd_fn`` (the forward kernel's launch, or its plain
    version) over copies of q, k and v whose head dim is zero-padded to a
    multiple of 8, at the original D^-1/2 scale; O sliced back to D,
    contiguous.  Zero columns add nothing to a score, and the output
    columns past D are dropped."""
    d = q.shape[-1]
    dp = -(-d // 8) * 8
    o, lse = fwd_fn(*(_pad_head(x, dp) for x in (q, k, v)), causal, scale=d**-0.5)
    return o[..., :d].contiguous(), lse


def _bwd_dq_padded(q, k, v, o, lse, do, causal, dq_fn):
    """(dq, delta) by ``dq_fn`` (the dq kernel's launch, or its plain
    version) over copies of q, k, v, o and dO whose head dim is zero-padded
    to a multiple of 8, at the original D^-1/2 scale; dq sliced back to D.
    Zero columns add nothing to a score, to delta or to a gradient column
    that is kept."""
    d = q.shape[-1]
    dp = -(-d // 8) * 8
    dq, delta = dq_fn(*(_pad_head(x, dp) for x in (q, k, v, o)), lse, _pad_head(do, dp), causal,
                      scale=d**-0.5)
    return dq[..., :d], delta


def _bwd_dkv_padded(q, k, v, do, lse, delta, causal, dkv_fn):
    """(dk, dv) by ``dkv_fn`` over head-padded copies, as ``_bwd_dq_padded``."""
    d = q.shape[-1]
    dp = -(-d // 8) * 8
    dk, dv = dkv_fn(*(_pad_head(x, dp) for x in (q, k, v, do)), lse, delta, causal,
                    scale=d**-0.5)
    return dk[..., :d], dv[..., :d]


def _launch_dq(q, k, v, o, lse, do, causal, scale=None, dq=None):
    b, l, h, d = q.shape
    dq = torch.empty_like(o) if dq is None else dq
    delta = torch.empty_like(lse)
    fn = kernels.bind(BWD_SOURCE, DQ_KERNEL, _BWD_ARGTYPES)
    status = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), b, l, h, d, q.stride(1), dq.stride(1),
        float(d**-0.5 if scale is None else scale), int(bool(causal)), _DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    kernels.count(DQ_KERNEL)
    kernels.check_launch(DQ_KERNEL, status)
    return dq, delta


def _launch_dkv(q, k, v, do, lse, delta, causal, scale=None, dk=None, dv=None):
    b, l, h, d = q.shape
    if dk is None:
        dk, dv = torch.empty_like(do), torch.empty_like(do)
    fn = kernels.bind(BWD_SOURCE, DKV_KERNEL, _BWD_ARGTYPES)
    status = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, l, h, d, q.stride(1), dk.stride(1),
        float(d**-0.5 if scale is None else scale), int(bool(causal)), _DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    kernels.count(DKV_KERNEL)
    kernels.check_launch(DKV_KERNEL, status)
    return dk, dv


def flash_attention_bwd_dq(q, k, v, o, lse, do, causal: bool = False, dq=None):
    """(dq, delta) of attention's backward; ``dq``: a buffer to write into
    (a view into a fused qkv gradient, say).

    Routing by layout on the card: bf16 inputs whose head dim is not a
    multiple of 8 (or whose rows the kernel's TMA loads cannot address:
    row strides not a multiple of 8, data not 16-byte aligned) go to the
    same kernel over copies padded to such a head dim, and dq is sliced
    back, as the TPU wrapper pads the head dim to its 128 lanes."""
    _bwd_inputs(q, k, v, (o, do), (lse,))
    (dq,) = _grad_buffers(q, None if dq is None else (dq,), 1)
    if q.device.type == "cpu":
        ref, delta = flash_attention_bwd_dq_plain(q, k, v, o, lse, do, causal)
        return dq.copy_(ref), delta
    if q.dtype == torch.bfloat16 and not _tma_layout(q, k, v, o, do, dq):
        ref, delta = _bwd_dq_padded(q, k, v, o, lse, do, causal, _launch_dq)
        return dq.copy_(ref), delta
    return _launch_dq(q, k, v, o, lse, do, causal, dq=dq)


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal: bool = False, dk=None, dv=None):
    """(dk, dv) of attention's backward from the forward's lse and the dq
    step's delta; ``dk``, ``dv``: buffers to write into (both or
    neither).  Routed by layout as ``flash_attention_bwd_dq``."""
    _bwd_inputs(q, k, v, (do,), (lse, delta))
    dk, dv = _grad_buffers(q, None if dk is None else (dk, dv), 2)
    if q.device.type == "cpu":
        ref_k, ref_v = flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, causal)
        return dk.copy_(ref_k), dv.copy_(ref_v)
    if q.dtype == torch.bfloat16 and not _tma_layout(q, k, v, do, dk, dv):
        ref_k, ref_v = _bwd_dkv_padded(q, k, v, do, lse, delta, causal, _launch_dkv)
        return dk.copy_(ref_k), dv.copy_(ref_v)
    return _launch_dkv(q, k, v, do, lse, delta, causal, dk=dk, dv=dv)


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool = False, out=None):
    """(dq, dk, dv) of attention's backward: the dq kernel (which also
    writes delta), then the dkv kernel.  ``out``: (dq, dk, dv) buffers to
    write into, dk and dv with one row stride."""
    dq, dk, dv = (None,) * 3 if out is None else out
    dq, delta = flash_attention_bwd_dq(q, k, v, o, lse, do, causal, dq=dq)
    return (dq, *flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal, dk=dk, dv=dv))


def _split_qkv(qkv: torch.Tensor, n_heads: int):
    """q, k, v views ``[B, L, H, D]`` of a fused ``[B, L, 3*H*D]`` tensor
    split ``[all-q | all-k | all-v]``."""
    b, l, c = qkv.shape
    return qkv.view(b, l, 3 * n_heads, c // (3 * n_heads)).split(n_heads, dim=2)


def _fused_qkv(q, k, v):
    """The contiguous ``[B, L, 3*H*D]`` tensor whose consecutive column
    blocks q, k and v are (as ``_split_qkv`` makes them), or None."""
    base = q._base
    if base is None or k._base is not base or v._base is not base:
        return None
    b, l, h, d = q.shape
    if tuple(base.shape) != (b, l, 3 * h * d) or not base.is_contiguous():
        return None
    step = h * d * q.element_size()
    ptr = base.data_ptr()
    if (q.data_ptr(), k.data_ptr(), v.data_ptr()) != (ptr, ptr + step, ptr + 2 * step):
        return None
    want = (l * 3 * h * d, 3 * h * d, d, 1)
    return base if all(tuple(x.stride()) == want for x in (q, k, v)) else None


class _FlashAttention(torch.autograd.Function):
    """O = attention(q, k, v): the forward kernel; backward by the dq and
    dkv kernels from the saved O and lse (under remat, the recomputed
    ones)."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = flash_attention_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return (*flash_attention_bwd(q, k, v, o, lse, do.contiguous(), ctx.causal), None)


class _FlashAttentionQKV(torch.autograd.Function):
    """The same over a fused qkv tensor: its gradient is written whole, dq,
    dk and dv in place with the tensor's row stride."""

    @staticmethod
    def forward(ctx, qkv, n_heads, causal):
        o, lse = flash_attention_fwd(*_split_qkv(qkv, n_heads), causal)
        ctx.save_for_backward(qkv, o, lse)
        ctx.n_heads, ctx.causal = n_heads, causal
        return o

    @staticmethod
    def backward(ctx, do):
        qkv, o, lse = ctx.saved_tensors
        dqkv = torch.empty_like(qkv)
        flash_attention_bwd(*_split_qkv(qkv, ctx.n_heads), o, lse, do.contiguous(), ctx.causal,
                            out=_split_qkv(dqkv, ctx.n_heads))
        return dqkv, None, None


def flash_attention(q, k, v, causal: bool = False) -> torch.Tensor:
    """Exact (non-ring) attention, [B, L, H, D] -> [B, L, H, D]; its
    gradient runs the backward kernels (plain versions on the CPU)."""
    qkv = _fused_qkv(q, k, v)
    if qkv is not None:
        return _FlashAttentionQKV.apply(qkv, q.shape[2], causal)
    return _FlashAttention.apply(q, k, v, causal)
