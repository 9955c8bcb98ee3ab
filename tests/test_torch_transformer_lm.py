"""The PyTorch port's transformer_lm forward against the JAX package.

JAX-initialised weights are carried into the port with
``transformer_lm.params_from_jax`` and both forwards run on the same
tokens (numpy, from a seed).  On the CPU both sides take their plain
attention path (the JAX reference's XLA oracle, the port's
``attention_reference``).  Tolerances: f32 compute 1e-4 (observed max
|diff| 3.2e-6, summation order only).  bf16 compute: max |diff| 8e-2 and
mean |diff| 1.5e-2 (observed 0.039 / 0.0058 at 2 layers and 0.0625 /
0.0089 at 12 layers, logits up to |4.5|): bf16 rounds at other places in
the two frameworks, and one bf16 ulp is 1.6e-2 on [2, 4) and 3.1e-2 on
[4, 8), so the bound is a few ulps at the largest logits and the mean
stays about one ulp.  The 12-layer case catches the reference's
``sorted()`` block order (b0, b1, b10, b11, b2, ...).
"""

import jax
import numpy as np
import pytest
import torch

import elasticdl_tpu.parallel.trainer  # noqa: F401  (resolves the ops <-> parallel import cycle)
from elasticdl_tpu.models import transformer_lm as jlm
from elasticdl_tpu_torch.models import transformer_lm as tlm

_CASES = {
    # name: (vocab, dim, n_heads, n_layers, seq_len)
    "zoo_narrow": (256, 64, 2, 2, 128),
    "twelve_layers": (512, 128, 2, 12, 128),
}


def _forward_both(case, compute_dtype, batch=2, seed=0):
    vocab, dim, n_heads, n_layers, seq_len = _CASES[case]
    spec = jlm.model_spec(
        compute_dtype=compute_dtype, vocab=vocab, dim=dim, n_heads=n_heads,
        n_layers=n_layers, max_seq=seq_len, seq_len=seq_len,
    )
    params = jax.device_get(spec.init(jax.random.key(seed)))
    tokens = np.random.default_rng(seed).integers(0, vocab, (batch, seq_len)).astype(np.int32)
    ref = np.asarray(spec.apply(params, {"tokens": tokens}, train=False))
    model = tlm.params_from_jax(params, n_heads, compute_dtype, device="cpu")
    with torch.inference_mode():
        out = model(torch.from_numpy(tokens))
    return out.numpy(), ref


@pytest.mark.parametrize("case", sorted(_CASES))
def test_f32_logits_match_jax(case):
    out, ref = _forward_both(case, "float32")
    assert out.dtype == np.float32 and out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("case", sorted(_CASES))
def test_bf16_logits_match_jax(case):
    out, ref = _forward_both(case, "bfloat16")
    assert out.shape == ref.shape and np.isfinite(out).all()
    diff = np.abs(out - ref)
    assert diff.max() <= 8e-2, diff.max()
    assert diff.mean() <= 1.5e-2, diff.mean()


def test_numeric_block_order_would_differ():
    """The sorted() order matters: applying the 12 blocks in numeric order
    gives other logits, so the f32 match above pins the reference's order."""
    vocab, dim, n_heads, n_layers, seq_len = _CASES["twelve_layers"]
    spec = jlm.model_spec(compute_dtype="float32", vocab=vocab, dim=dim, n_heads=n_heads,
                          n_layers=n_layers, max_seq=seq_len, seq_len=seq_len)
    params = jax.device_get(spec.init(jax.random.key(0)))
    model = tlm.params_from_jax(params, n_heads, "float32", device="cpu")
    tokens = torch.from_numpy(np.arange(seq_len, dtype=np.int32)[None] % vocab)
    with torch.inference_mode():
        sorted_order = model(tokens)
        renamed = {f"b{i}": model.blocks[f"b{i}"] for i in range(n_layers)}
        w = model._weights()
        x = (model.tok_emb[tokens.long()] + model.pos_emb[:seq_len][None]).float()
        for i in range(n_layers):
            x = renamed[f"b{i}"](x, w["blocks"][f"b{i}"], n_heads, tlm.ring_attention)
        numeric = (tlm._rms_norm(x, model.ln_f) @ w["head"].T).float()
    assert sorted(model.blocks)[:4] == ["b0", "b1", "b10", "b11"]
    assert not torch.allclose(sorted_order, numeric, atol=1e-3)


def test_over_long_sequence_raises_like_the_reference():
    model = tlm.model_spec(vocab=32, dim=16, n_heads=2, n_layers=1, max_seq=8).init(
        seed=0, device="cpu")
    with pytest.raises(ValueError, match="global sequence length 9 exceeds max_seq 8"):
        model(torch.zeros((1, 9), dtype=torch.int32))


def test_fresh_init_is_seeded_and_shaped():
    spec = tlm.model_spec(vocab=64, dim=32, n_heads=2, n_layers=3, max_seq=16, seq_len=16)
    a, b = spec.init(seed=1, device="cpu"), spec.init(seed=1, device="cpu")
    c = spec.init(seed=2, device="cpu")
    assert torch.equal(a.blocks["b2"].w1, b.blocks["b2"].w1)
    assert not torch.equal(a.tok_emb, c.tok_emb)
    assert a.blocks["b0"].wqkv.shape == (32, 96) and a.blocks["b0"].w2.shape == (128, 32)
    tokens = np.random.default_rng(0).integers(0, 64, (2, 16)).astype(np.int32)
    with torch.inference_mode():
        out = spec.apply(a, {"tokens": torch.from_numpy(tokens)})
    assert out.shape == (2, 16, 64) and out.dtype == torch.float32
    assert torch.isfinite(out).all()
    for bad in (64, -1):
        with pytest.raises(ValueError, match="token ids"):
            spec.check_batch(a, {"tokens": np.full((1, 4), bad, np.int32)})
    spec.check_batch(a, {"tokens": tokens})


# Padded against plain head: the error norm over the plain result's norm.
# f32: summation order only (observed 4.1e-7 on the gradient); bf16: a few
# ulps (2**-8) where the two products round apart.
_HEAD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.mark.parametrize("mode", ["train", "serve"])
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("vocab", [1001, 8192])
def test_padded_head_matches_the_plain_product(monkeypatch, vocab, compute_dtype, mode):
    """A vocabulary off a multiple of 64 runs the head over ``head_pad``
    zero rows (23 at 1001); the logits ``[B, L, vocab]``, the loss and
    ``tok_emb``'s gradient match the plain unpadded ``x @ tok_emb.T`` in the
    compute dtype, and ``tok_emb`` keeps its shape.  An aligned vocabulary
    (8192) runs the plain product itself, bit for bit."""
    spec = tlm.model_spec(compute_dtype=compute_dtype, vocab=vocab, dim=64, n_heads=2,
                          n_layers=2, max_seq=32, seq_len=32)
    toks = np.random.default_rng(3).integers(0, vocab, (4, 33)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(toks[:, :-1]), "labels": torch.from_numpy(toks[:, 1:])}

    def run():
        model = spec.init(seed=0, device="cpu")
        if mode == "serve":
            with torch.inference_mode():
                logits = spec.apply(model, batch)
            return model, logits, spec.loss(logits, batch), None
        logits = spec.apply(model, batch, train=True)
        loss = spec.loss(logits, batch)
        loss.backward()
        return model, logits, loss.detach(), model.tok_emb.grad

    model, logits, loss, grad = run()
    with monkeypatch.context() as patch:
        patch.setattr(tlm.TransformerLM, "head_pad", 0)
        plain, *want = run()
        assert plain.head_pad == 0
    pad = {1001: 23, 8192: 0}[vocab]
    assert model.head_pad == pad
    assert model.tok_emb.shape == (vocab, 64)
    assert logits.shape == (4, 32, vocab) and logits.dtype == torch.float32
    assert logits.is_contiguous()
    if mode == "serve":
        assert model._weights()["head"].shape == (vocab + pad, 64)
    else:
        padded = type(logits.grad_fn).__name__ == "_PaddedHeadBackward"
        assert padded == bool(pad)
    for got, ref in zip((logits.detach(), loss, grad), want):
        if ref is None:
            continue
        if not pad:
            assert torch.equal(got, ref)
        err = ((got - ref).norm() / ref.norm()).item()
        assert err <= _HEAD_TOL[compute_dtype], err
