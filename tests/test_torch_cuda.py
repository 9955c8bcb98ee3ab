"""The port's CUDA kernels against their plain versions, on a card.

Every case here needs an NVIDIA card (the kernels have no CPU mode), is
marked ``cuda`` and skips without one.  The file imports neither JAX nor
the JAX package, so it also runs on a machine with the card and no JAX,
without the repo's conftest (which sets JAX up):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Limits are chip_smoke.py's, set from the kernels' readings on the card
(PERF.md): for the forward, O's error norm over O's norm, O's largest
error over O's largest element, lse's largest absolute error; for the
backward, each gradient's error norm over the reference's norm and its
largest error over the largest element, and delta's largest error over
its largest element.
"""

import numpy as np
import pytest
import torch

from elasticdl_tpu_torch.models import transformer_lm as tlm
from elasticdl_tpu_torch.ops import flash_attention as tfa
from elasticdl_tpu_torch.ops import kernels
from elasticdl_tpu_torch.parallel.trainer import Trainer

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_FWD_TOL = {torch.float32: (1e-5, 1e-4, 2e-5), torch.bfloat16: (1e-2, 2**-5, 1e-4)}
_BWD_TOL = {torch.float32: (1e-5, 1e-4, 1e-5), torch.bfloat16: (2e-3, 2**-5, 1e-5)}

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from elasticdl_tpu_torch.common.device import set_matmul_precision

    set_matmul_precision()


def _arrays(shape, seed, n=3):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(shape) * 0.5).astype(np.float32) for _ in range(n)]


def _qkv_views(b, l, h, d, dtype, seed=0):
    """q, k, v as views into one fused [B, L, 3*H*D] projection on the card,
    as the model hands them to the kernels."""
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy((rng.standard_normal((b, l, 3 * h * d)) * 0.5).astype(np.float32))
    return tfa._split_qkv(qkv.to(dtype).cuda(), h)


def _assert_fwd_close(out, lse, ref, ref_lse):
    o_rel, o_max, lse_abs = _FWD_TOL[ref.dtype]
    err = out.float() - ref.float()
    assert (err.norm() / ref.float().norm()).item() <= o_rel
    assert (err.abs().max() / ref.float().abs().max()).item() <= o_max
    assert (lse - ref_lse).abs().max().item() <= lse_abs


@pytest.mark.parametrize("d", [64, 128, 36])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain_version(card, dtype, causal, d):
    """Contiguous q, k, v; D=36 takes the bf16 kernel's padded route."""
    q, k, v = (torch.from_numpy(a).to(_DTYPES[dtype]).cuda() for a in _arrays((2, 256, 3, d), 0))
    out, lse = tfa.flash_attention_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    _assert_fwd_close(out, lse, *tfa.flash_attention_plain(q, k, v, causal))


@pytest.mark.parametrize("d", [64, 128, 36])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_reads_fused_qkv_views(card, dtype, causal, d):
    q, k, v = _qkv_views(2, 256, 3, d, _DTYPES[dtype])
    out, lse = tfa.flash_attention_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    _assert_fwd_close(out, lse, *tfa.flash_attention_plain(q, k, v, causal))


def test_cuda_kernel_long_sequence(card):
    """L=8192, the contract's longest: 128 key tiles through the ring."""
    q, k, v = _qkv_views(1, 8192, 2, 64, torch.bfloat16, seed=3)
    out, lse = tfa.flash_attention_fwd(q, k, v, True)
    torch.cuda.synchronize()
    _assert_fwd_close(out, lse, *tfa.flash_attention_plain(q, k, v, True))


@pytest.mark.parametrize("d", [64, 128, 36])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fused", [False, True])
def test_cuda_backward_kernels_match_plain_version(card, fused, dtype, causal, d):
    """Kernels against plain versions; D=36 takes the bf16 kernels' padded
    route."""
    b, l, h = 2, 256, 3
    tdt = _DTYPES[dtype]
    rng = np.random.default_rng(8)
    g = torch.from_numpy(rng.standard_normal((b, l, h, d)).astype(np.float32)).to(tdt).cuda()
    if fused:
        q, k, v = _qkv_views(b, l, h, d, tdt, seed=8)
        dq_buf, dk_buf, dv_buf = tfa._split_qkv(torch.empty((b, l, 3 * h * d), dtype=tdt,
                                                            device="cuda"), h)
    else:
        q, k, v = (torch.from_numpy(a).to(tdt).cuda() for a in _arrays((b, l, h, d), 8))
        dq_buf = dk_buf = dv_buf = None
    o, lse = tfa.flash_attention_fwd(q, k, v, causal)
    dq, delta = tfa.flash_attention_bwd_dq(q, k, v, o, lse, g, causal, dq=dq_buf)
    dk, dv = tfa.flash_attention_bwd_dkv(q, k, v, g, lse, delta, causal, dk=dk_buf, dv=dv_buf)
    torch.cuda.synchronize()
    ref_dq, ref_delta = tfa.flash_attention_bwd_dq_plain(q, k, v, o, lse, g, causal)
    ref = (ref_dq, *tfa.flash_attention_bwd_dkv_plain(q, k, v, g, lse, ref_delta, causal))
    rel, largest, delta_tol = _BWD_TOL[tdt]
    assert ((delta - ref_delta).abs().max() / ref_delta.abs().max()).item() <= delta_tol
    for x, r in zip((dq, dk, dv), ref):
        err = x.float() - r.float()
        assert (err.norm() / r.float().norm()).item() <= rel
        assert (err.abs().max() / r.float().abs().max()).item() <= largest


def test_cuda_training_step_launches_each_kernel_once_per_layer(card):
    qkv = torch.randn((2, 256, 3 * 2 * 64), device="cuda", dtype=torch.bfloat16,
                      requires_grad=True)
    kernels.reset_counts()
    tfa.flash_attention(*tfa._split_qkv(qkv, 2), True).float().square().sum().backward()
    counts = kernels.counts()
    assert [counts.get(n, 0) for n in (tfa.KERNEL, tfa.DQ_KERNEL, tfa.DKV_KERNEL)] == [1, 1, 1]
    assert qkv.grad is not None and torch.isfinite(qkv.grad).all()


@pytest.mark.parametrize("remat", [False, True])
def test_cuda_transformer_lm_trains_through_the_kernels(card, remat):
    layers = 2
    spec = tlm.model_spec(compute_dtype="bfloat16", vocab=512, dim=128, n_heads=2,
                          n_layers=layers, max_seq=256, seq_len=256, remat=remat)
    trainer = Trainer(spec, device="cuda")
    state = trainer.init_state(0)
    toks = np.random.default_rng(0).integers(0, 512, (4, 257)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    kernels.reset_counts()
    state, metrics = trainer.run_train_steps(state, [batch, batch])
    counts = kernels.counts()
    forwards = (2 if remat else 1) * layers * 2
    assert [counts.get(n, 0) for n in (tfa.KERNEL, tfa.DQ_KERNEL, tfa.DKV_KERNEL)] == [
        forwards, 2 * layers, 2 * layers]
    losses = [float(m["loss"]) for m in metrics]
    assert all(np.isfinite(losses)) and losses[1] < losses[0]
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in state.model.parameters())
