"""The benchmark's fixed arithmetic: the card's published peaks, the bound
of a flash-attention kernel, the model FLOPs of a training step, and the
grouping of device kernels by name.

These are frozen copies: ``bound_ms``, ``attention_bound_ms`` and the
kernel groups come from ``chip_smoke.py`` (repo root) as it stood when the
benchmark was written. A later change to the program cannot move them.
"""

from __future__ import annotations

#: NVIDIA H100 SXM, published dense peaks (data sheet, 700 W).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
#: The peak every ``mfu`` metric divides by: bf16 tensor-core FLOP/s.
MFU_PEAK_FLOPS = PEAK_FLOPS["bfloat16"]

_ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


def bound_ms(nbytes: float, flops: float, dtype: str) -> tuple:
    """(bound ms, what bounds it): the larger of the bytes over the memory
    rate and the operations over the peak rate of ``dtype``."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attention_bound_ms(b, l, h, d, dtype, causal, kernel: str = "fwd") -> tuple:
    """(bound ms, what bounds it) for one attention kernel over the (query,
    key) pairs the inputs need (causal: the L(L+1)/2 on or below the
    diagonal), each input read once and each output written once:
    fwd reads q, k, v, writes o and the f32 lse, 4*D flops per pair; dq
    reads q, k, v, o, dO and lse, writes dq and the f32 delta, 6*D per
    pair; dkv reads q, k, v, dO, lse and delta, writes dk and dv, 8*D per
    pair."""
    tensor = b * l * h * d * _ITEMSIZE[dtype]
    vector = b * h * l * 4
    nbytes, per_pair = {
        "fwd": (4 * tensor + vector, 4),
        "dq": (6 * tensor + 2 * vector, 6),
        "dkv": (6 * tensor + 2 * vector, 8),
    }[kernel]
    pairs = b * h * (l * (l + 1) // 2 if causal else l * l)
    return bound_ms(nbytes, per_pair * d * pairs, dtype)


#: Device kernels by group: a kernel belongs to the first group one of
#: whose fragments its lower-cased name contains.
KERNEL_GROUPS = (
    ("flash_fwd", ("fwd_wgmma_kernel", "fwd_f32_kernel")),
    ("flash_dq", ("dq_wgmma_kernel", "dq_f32_kernel")),
    ("flash_dkv", ("dkv_wgmma_kernel", "dkv_f32_kernel")),
    ("matmul", ("nvjet", "gemm", "xmma", "cutlass", "matmul")),
)


def kernel_group(name: str) -> str:
    k = name.lower()
    return next((g for g, frags in KERNEL_GROUPS if any(f in k for f in frags)), "other")


def lm_step_flops(batch: int, seq: int, dim: int, n_layers: int, vocab: int,
                  n_heads: int) -> float:
    """Model FLOPs of one training step of a decoder-only transformer with a
    tied head: forward and backward (three times the forward), no
    recomputed FLOPs. Forward: two FLOPs a multiply-add of every matmul
    weight (``12 dim^2`` a layer: qkv, output, and a 4x MLP) and of the
    head (``vocab x dim``) for each token, and the attention's two
    products, ``4 * dim`` FLOPs a causal (query, key) pair a layer, each
    pair on or below the diagonal counted once. Norms, activations, the
    softmax and the loss are left out, as is usual."""
    del n_heads  # the attention's FLOPs depend on dim = heads x head size only
    tokens = batch * seq
    matmul = 2.0 * tokens * (12 * dim * dim * n_layers + vocab * dim)
    pairs = batch * seq * (seq + 1) / 2
    attention = 4.0 * dim * pairs * n_layers
    return 3.0 * (matmul + attention)


def deepfm_step_flops(batch: int, num_dense: int, num_cat: int, dim: int,
                      hidden: tuple) -> float:
    """Model FLOPs of one DeepFM training step: forward and backward (three
    times the forward). Forward a row: the MLP's matmuls (two FLOPs a
    multiply-add, bias adds included) over ``num_cat * dim + num_dense``
    inputs; the FM's sums of the vectors and of their squares and the
    square of the sum (``4 * num_cat * dim``); the first-order terms
    (``num_cat + 2 * num_dense``). The lookup and the optimizer are not
    model FLOPs."""
    widths = (num_cat * dim + num_dense,) + tuple(hidden) + (1,)
    mlp = sum(2 * a * b + b for a, b in zip(widths[:-1], widths[1:]))
    fm = 4 * num_cat * dim
    first = num_cat + 2 * num_dense
    return 3.0 * batch * (mlp + fm + first)
