"""The PyTorch port's flash-attention backward against the JAX package.

The port's autograd Function runs, on CPU tensors, the plain forward and
the plain backward (``flash_attention_bwd_plain``: the dq and dkv kernels'
function in plain PyTorch).  It is held against ``jax.vjp`` of the JAX
``flash_attention``, whose custom VJP runs the Pallas ``_dq_kernel`` and
``_dkv_kernel`` in interpret mode on the CPU, as tests/test_flash_attention.py
runs them.  Inputs and cotangents are made from a seed with numpy.

Tolerances: f32 5e-5, the reference's own VJP tolerance
(tests/test_flash_attention.py).  bf16: the largest error of each gradient
is at most one bf16 ulp of that gradient's largest element (2^-7 relative
at the bottom of its binade).  Measured: at most 1/8 of that ulp over
every case here; the two sides round P and dS to bf16 at the same places,
and differ by f32 summation order, by the port taking P from the forward's
lse where the TPU dq kernel renormalizes its own row, and by which
elements of dS land on the other side of a bf16 rounding boundary.

The CUDA kernels are held against the plain versions on the card
(``chip_smoke.py``, and tests/test_torch_cuda.py), with the limits set
from their readings there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import elasticdl_tpu.parallel.trainer  # noqa: F401  (resolves the ops <-> parallel import cycle)
from elasticdl_tpu.ops import flash_attention as jfa
from elasticdl_tpu_torch.ops import flash_attention as tfa
from elasticdl_tpu_torch.ops import kernels
from elasticdl_tpu_torch.ops.ring_attention import attention_reference

_DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _arrays(shape, seed, n=4):
    """q, k, v (scale 0.5) and a cotangent (scale 1), f32 numpy."""
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(shape) * s).astype(np.float32)
            for s in (0.5,) * (n - 1) + (1.0,)]


def _jax_grads(q, k, v, g, dtype, causal):
    jdt = _DTYPES[dtype][0]
    args = [jnp.asarray(a).astype(jdt) for a in (q, k, v)]
    _, vjp = jax.vjp(lambda a, b, c: jfa.flash_attention(a, b, c, causal), *args)
    return [np.asarray(x, np.float32) for x in vjp(jnp.asarray(g).astype(jdt))]


def _bf16_ulp(magnitude: float) -> float:
    """One bf16 ulp at ``magnitude`` (8 significant bits)."""
    return float(2.0 ** (np.floor(np.log2(magnitude)) - 7))


def _assert_grads_close(got, ref, dtype):
    for name, x, r in zip(("dq", "dk", "dv"), got, ref):
        x = x.float().numpy() if isinstance(x, torch.Tensor) else x
        if dtype == "float32":
            np.testing.assert_allclose(x, r, atol=5e-5, rtol=5e-5, err_msg=name)
        else:
            err = np.abs(x - r).max()
            assert err <= _bf16_ulp(np.abs(r).max()), (name, err, np.abs(r).max())


@pytest.mark.parametrize("l", [128, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_backward_matches_jax_vjp(causal, dtype, l):
    q, k, v, g = _arrays((2, l, 2, 64), seed=l + causal)
    tdt = _DTYPES[dtype][1]
    tq, tk, tv = (torch.from_numpy(a).to(tdt).requires_grad_() for a in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, causal)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g).to(tdt))
    assert all(x.dtype == tdt and x.shape == tq.shape for x in got)
    _assert_grads_close(got, _jax_grads(q, k, v, g, dtype, causal), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_qkv_views_differentiate_into_qkv(dtype):
    """q, k, v as views into one [B, L, 3*H*D] projection (the model's
    layout): the Function takes the fused tensor, so its gradient arrives
    whole, with no split backward concatenating three copies."""
    b, l, h, d = 2, 128, 2, 64
    q, k, v, g = _arrays((b, l, h, d), seed=11)
    tdt = _DTYPES[dtype][1]
    fused = np.concatenate([x.reshape(b, l, h * d) for x in (q, k, v)], axis=-1)
    qkv = torch.from_numpy(fused).to(tdt).requires_grad_()
    tq, tk, tv = qkv.view(b, l, 3 * h, d).split(h, dim=2)
    assert tfa._fused_qkv(tq, tk, tv) is qkv
    out = tfa.flash_attention(tq, tk, tv, True)
    assert type(out.grad_fn).__name__ == "_FlashAttentionQKVBackward"
    (dqkv,) = torch.autograd.grad(out, (qkv,), torch.from_numpy(g).to(tdt))
    got = [x.contiguous() for x in tfa._split_qkv(dqkv, h)]
    _assert_grads_close(got, _jax_grads(q, k, v, g, dtype, True), dtype)


def test_fused_qkv_detection_needs_the_exact_layout():
    b, l, h, d = 1, 128, 2, 64
    qkv = torch.zeros((b, l, 3 * h * d))
    q, k, v = tfa._split_qkv(qkv, h)
    assert tfa._fused_qkv(q, k, v) is qkv
    assert tfa._fused_qkv(q, v, k) is None  # not in [q | k | v] order
    assert tfa._fused_qkv(q.contiguous(), k, v) is None
    wider = torch.zeros((b, l, 4 * h * d))
    assert tfa._fused_qkv(*wider.view(b, l, 4 * h, d).split(h, dim=2)[:3]) is None


@pytest.mark.parametrize("causal", [False, True])
def test_plain_backward_matches_autograd_of_the_oracle(causal):
    """f32: the plain backward equals torch autograd through
    ``attention_reference`` (softmax attention written out) to f32
    summation order."""
    q, k, v, g = (torch.from_numpy(a) for a in _arrays((2, 256, 3, 64), seed=5))
    o, lse = tfa.flash_attention_plain(q, k, v, causal)
    got = tfa.flash_attention_bwd_plain(q, k, v, o, lse, g, causal)
    args = [x.clone().requires_grad_() for x in (q, k, v)]
    ref = torch.autograd.grad(attention_reference(*args, causal=causal), args, g)
    for x, r in zip(got, ref):
        torch.testing.assert_close(x, r, atol=2e-6, rtol=2e-5)


def test_cpu_tensors_never_launch_the_backward_kernels():
    kernels.reset_counts()
    q, k, v, g = (torch.from_numpy(a).requires_grad_() for a in _arrays((1, 128, 1, 64), 3))
    tfa.flash_attention(q, k, v, causal=True).backward(g.detach())
    assert q.grad is not None and k.grad is not None and v.grad is not None
    counts = kernels.counts()
    assert all(counts.get(name, 0) == 0 for name in (tfa.KERNEL, tfa.DQ_KERNEL, tfa.DKV_KERNEL))


def test_wrappers_write_into_given_buffers_and_return_delta():
    b, l, h, d = 1, 128, 2, 64
    q, k, v, g = (torch.from_numpy(a) for a in _arrays((b, l, h, d), 4))
    o, lse = tfa.flash_attention_fwd(q, k, v, True)
    dqkv = torch.zeros((b, l, 3 * h * d))
    dq, dk, dv = tfa._split_qkv(dqkv, h)
    out = tfa.flash_attention_bwd(q, k, v, o, lse, g, True, out=(dq, dk, dv))
    assert all(x.data_ptr() == y.data_ptr() for x, y in zip(out, (dq, dk, dv)))
    ref = tfa.flash_attention_bwd_plain(q, k, v, o, lse, g, True)
    for x, r in zip(out, ref):
        torch.testing.assert_close(x, r, atol=0, rtol=0)
    _, delta = tfa.flash_attention_bwd_dq(q, k, v, o, lse, g, True)
    assert delta.shape == (b * h, l) and delta.dtype == torch.float32
    want = (g * o).sum(-1).permute(0, 2, 1).reshape(b * h, l)
    torch.testing.assert_close(delta, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_padded_head_route_matches_plain_backward_and_jax_vjp(dtype):
    """D=36, which the bf16 kernels' TMA loads cannot read: the wrappers'
    route (q, k, v, o and dO copied into a head dim zero-padded to 40, the
    D=36 scale, gradients sliced back), run through the plain versions,
    gives the unpadded plain backward's dq, dk, dv and delta, and both match
    ``jax.vjp`` of the Pallas kernels at this file's tolerance."""
    b, l, h, d = 2, 128, 2, 36
    q, k, v, g = _arrays((b, l, h, d), seed=36)
    tdt = _DTYPES[dtype][1]
    tq, tk, tv, tg = (torch.from_numpy(a).to(tdt) for a in (q, k, v, g))
    o, lse = tfa.flash_attention_fwd(tq, tk, tv, True)
    dq, delta = tfa._bwd_dq_padded(tq, tk, tv, o, lse, tg, True, tfa.flash_attention_bwd_dq_plain)
    padded = (dq, *tfa._bwd_dkv_padded(tq, tk, tv, tg, lse, delta, True,
                                       tfa.flash_attention_bwd_dkv_plain))
    ref_dq, ref_delta = tfa.flash_attention_bwd_dq_plain(tq, tk, tv, o, lse, tg, True)
    plain = (ref_dq, *tfa.flash_attention_bwd_dkv_plain(tq, tk, tv, tg, lse, ref_delta, True))
    assert all(x.shape == tq.shape and x.dtype == tdt for x in padded)
    torch.testing.assert_close(delta, ref_delta, atol=1e-6, rtol=1e-5)
    # The zero columns change only the f32 summation order.
    _assert_grads_close(padded, [x.float().numpy() for x in plain], dtype)
    ref = _jax_grads(q, k, v, g, dtype, True)
    _assert_grads_close(padded, ref, dtype)
    _assert_grads_close(plain, ref, dtype)


def test_tma_layout_routes_by_head_dim_strides_and_alignment():
    bf16 = torch.bfloat16
    q, k, v = tfa._split_qkv(torch.zeros((1, 128, 3 * 2 * 64), dtype=bf16), 2)
    assert tfa._tma_layout(q, k, v)  # the model's fused qkv views at D=64
    q36, k36, v36 = tfa._split_qkv(torch.zeros((1, 128, 3 * 2 * 36), dtype=bf16), 2)
    assert not tfa._tma_layout(q36, k36, v36)  # 72-byte rows
    shifted = torch.zeros(128 * 2 * 64 + 1, dtype=bf16)[1:].view(1, 128, 2, 64)
    assert not tfa._tma_layout(shifted)  # data 2 bytes off 16-byte alignment
    x = torch.from_numpy(_arrays((1, 128, 2, 36), seed=2, n=1)[0])
    p = tfa._pad_head(x, 40)
    assert p.shape == (1, 128, 2, 40) and p.is_contiguous() and tfa._tma_layout(p)
    assert torch.equal(p[..., :36], x) and not p[..., 36:].any()


def test_backward_wrappers_refuse_bad_arguments():
    q, k, v, g = (torch.from_numpy(a) for a in _arrays((1, 128, 2, 64), 6))
    o, lse = tfa.flash_attention_fwd(q, k, v, True)
    with pytest.raises(ValueError, match="lse and delta"):
        tfa.flash_attention_bwd(q, k, v, o, lse[:, :64].contiguous(), g, True)
    with pytest.raises(ValueError, match="o and dO"):
        tfa.flash_attention_bwd(q, k, v, o, lse, g.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(TypeError, match="one dtype"):
        tfa.flash_attention_bwd(q, k, v, o, lse, g.to(torch.bfloat16), True)
    with pytest.raises(ValueError, match="strides"):
        # dk and dv buffers that do not share one row stride
        _, _, dv_view = tfa._split_qkv(torch.empty((1, 128, 3 * 128)), 2)
        tfa.flash_attention_bwd(q, k, v, o, lse, g, True,
                                out=(torch.empty_like(q), torch.empty_like(q), dv_view))
    with pytest.raises(ValueError, match="flash_attention supports"):
        z = torch.zeros((1, 200, 2, 64))
        tfa.flash_attention_bwd(z, z, z, z, torch.zeros((2, 200)), z, True)
