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
