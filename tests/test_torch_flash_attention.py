"""The PyTorch port's flash-attention forward against the JAX package.

The port's plain version (what its wrapper runs for CPU tensors) is held
against the JAX ``flash_attention`` Pallas kernel run in interpret mode on
the CPU, as tests/test_flash_attention.py runs it.  Inputs are made from a
seed with numpy and handed to both.  Tolerances are the reference's own
from tests/test_flash_attention.py: f32 2e-5, bf16 3e-2 (one bf16 ulp at
the outputs' magnitude, from the p rounding before the PV product and a
different summation order).  The CUDA kernel itself is compared with the
plain version on the card (``chip_smoke.py``, and tests/test_torch_cuda.py
on a machine with a card), with limits set from its readings there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import elasticdl_tpu.parallel.trainer  # noqa: F401  (resolves the ops <-> parallel import cycle)
from elasticdl_tpu.ops import flash_attention as jfa
from elasticdl_tpu_torch.ops import flash_attention as tfa
from elasticdl_tpu_torch.ops import kernels

_DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
           "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _qkv(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(shape) * 0.5).astype(np.float32) for _ in range(3)]


def _both(arrays, dtype):
    jdt, tdt, _ = _DTYPES[dtype]
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


@pytest.mark.parametrize("l", [128, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_matches_jax_kernel(causal, dtype, l):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv((2, l, 2, 64), seed=l), dtype)
    tol = _DTYPES[dtype][2]
    out, lse = tfa.flash_attention_fwd(tq, tk, tv, causal)
    ref, res = jfa._fwd_impl(jq, jk, jv, causal)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    np.testing.assert_allclose(
        out.float().numpy(), np.asarray(ref, np.float32), atol=tol, rtol=tol
    )
    # The reference keeps lse as [BH, n_q, 8, 128] tiles with the data in
    # row 0; the port keeps f32 [B*H, L] (row b*H + h, the same order).
    jlse = np.asarray(res[4])[:, :, 0, :].reshape(lse.shape)
    assert lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), jlse, atol=tol, rtol=tol)


def test_public_entry_matches_jax_flash_attention():
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv((1, 128, 2, 64), seed=7), "float32")
    out = tfa.flash_attention(tq, tk, tv, True)
    ref = jfa.flash_attention(jq, jk, jv, True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=2e-5)


def test_cpu_tensors_never_launch_the_kernel():
    kernels.reset_counts()
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 128, 1, 64)))
    tfa.flash_attention(q, k, v, causal=True)
    assert kernels.counts().get(tfa.KERNEL, 0) == 0


@pytest.mark.parametrize(
    "shape_q,shape_kv",
    [((2, 200, 2, 64), (2, 200, 2, 64)),   # L not a multiple of 128
     ((1, 128, 1, 192), (1, 128, 1, 192)),  # head dim over 128
     ((1, 128, 1, 64), (1, 256, 1, 64))],   # cross-length
)
def test_outside_contract_raises_the_reference_message(shape_q, shape_kv):
    q = np.zeros(shape_q, np.float32)
    kv = np.zeros(shape_kv, np.float32)
    with pytest.raises(ValueError) as jerr:
        jfa._check(jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv))
    with pytest.raises(ValueError) as terr:
        tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(kv), torch.from_numpy(kv))
    assert str(terr.value) == str(jerr.value)
    assert tfa.supports(q, kv, kv) == jfa.supports(q, kv, kv) is False


def test_rejects_other_dtypes():
    q = torch.zeros((1, 128, 1, 64), dtype=torch.float16)
    with pytest.raises(TypeError):
        tfa.flash_attention(q, q, q)


def _qkv_views(b, l, h, d, dtype, device="cpu", seed=0):
    """q, k, v as views into one fused [B, L, 3*H*D] projection, as the
    model hands them to the kernel."""
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy((rng.standard_normal((b, l, 3 * h * d)) * 0.5).astype(np.float32))
    return qkv.to(dtype).to(device).view(b, l, 3 * h, d).split(h, dim=2)


def test_layout_check_takes_contiguous_and_fused_qkv_views():
    q, k, v = _qkv_views(2, 128, 3, 64, torch.float32)
    assert q.stride() == (128 * 3 * 192, 3 * 192, 64, 1)
    tfa._check_layout(q, k, v)
    tfa._check_layout(*(x.contiguous() for x in (q, k, v)))
    t = q.contiguous().transpose(1, 2).contiguous().transpose(1, 2)  # [B, H, L, D] storage
    with pytest.raises(ValueError, match="strides"):
        tfa._check_layout(t, t, t)
    with pytest.raises(ValueError, match="strides"):
        tfa._check_layout(q, k.contiguous(), v)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_padded_head_route_matches_plain_and_jax_kernel(dtype):
    """D=36, which the bf16 kernel's TMA loads cannot read: the wrapper's
    route (q, k, v copied into a head dim zero-padded to 40, the D=36
    scale, O sliced back), run through the plain version, gives the
    unpadded plain version's O and lse, and both match the Pallas kernel
    in interpret mode at this file's tolerance."""
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv((2, 128, 2, 36), seed=36), dtype)
    tol = _DTYPES[dtype][2]
    out, lse = tfa._fwd_padded(tq, tk, tv, True, tfa.flash_attention_plain)
    plain, plain_lse = tfa.flash_attention_plain(tq, tk, tv, True)
    assert out.shape == tq.shape and out.dtype == tq.dtype and out.is_contiguous()
    assert lse.shape == (2 * 2, 128) and lse.dtype == torch.float32
    # The zero columns change only the f32 summation order.
    torch.testing.assert_close(lse, plain_lse, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(out.float(), plain.float(), atol=tol, rtol=tol)
    ref, res = jfa._fwd_impl(jq, jk, jv, True)
    jlse = np.asarray(res[4])[:, :, 0, :].reshape(lse.shape)
    ref = np.asarray(ref, np.float32)
    for o, ls in ((out, lse), (plain, plain_lse)):
        np.testing.assert_allclose(o.float().numpy(), ref, atol=tol, rtol=tol)
        np.testing.assert_allclose(ls.numpy(), jlse, atol=tol, rtol=tol)


def test_tma_layout_routes_the_forward_by_head_dim_strides_and_alignment():
    """Which bf16 inputs ``flash_attention_fwd`` hands the kernel as they
    are on the card (``_tma_layout`` true) and which go through
    ``_fwd_padded`` (false); the padded copies always qualify."""
    bf16 = torch.bfloat16
    kernel = [_qkv_views(1, 128, 2, 64, bf16),  # the model's fused qkv views
              *([torch.zeros((1, 128, 2, d), dtype=bf16)] * 3 for d in (64, 128))]
    # A row stride of 132 elements (264 bytes): rows TMA cannot step over.
    wide = torch.zeros((1, 128, 2 * 64 + 4), dtype=bf16)[..., :128].view(1, 128, 2, 64)
    shifted = torch.zeros(128 * 2 * 64 + 1, dtype=bf16)[1:].view(1, 128, 2, 64)
    padded = [_qkv_views(1, 128, 2, 36, bf16),  # 72-byte rows
              [torch.zeros((1, 128, 2, 36), dtype=bf16)] * 3,
              [wide] * 3,
              [torch.zeros((1, 128, 2, 64), dtype=bf16), shifted, shifted]]
    for qkv in kernel:
        tfa._check_layout(*qkv)
        assert tfa._tma_layout(*qkv)
    for qkv in padded:
        tfa._check_layout(*qkv)
        assert not tfa._tma_layout(*qkv)
        d = qkv[0].shape[-1]
        assert tfa._tma_layout(*(tfa._pad_head(x, -(-d // 8) * 8) for x in qkv))
