"""The port's DeepFM (``elasticdl_tpu_torch/models/deepfm.py``) against the
JAX package's (``elasticdl_tpu/models/deepfm.py``).

Width: ``buckets_per_feature=512, embedding_dim=4, hidden=(16,)``.  The
JAX ``init`` makes the weights; ``params_from_jax`` carries them into the
port.  The same Criteo records (numpy-seeded) go through both packages'
feeds, raw and preprocessed, with a padded tail marked by ``__mask__``.

Tolerances:
- float32 compute: logits, loss, metrics (the AUC histograms included)
  and gradients rtol 1e-5 / atol 1e-5 (the CPU's f32 sums in another order);
- bfloat16 compute: logits and loss rtol/atol 2e-2, gradients
  max |diff| <= 2e-2 x max |reference| per array (bf16 keeps ~3 digits);
- one Adam step against ``optax.adam``: parameters rtol 1e-5 / atol 1e-6,
  moments rtol 1e-4 / atol 1e-9;
- raw against preprocessed batches (the f16 wire rounds log1p): rtol/atol
  2e-3, as ``tests/test_data.py:251``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import elasticdl_tpu.parallel  # noqa: F401  (the JAX package's own import order)
from elasticdl_tpu.common.metrics import AUC_POS
from elasticdl_tpu.models import deepfm as jdeepfm
from elasticdl_tpu.models import tabular as jtabular
from elasticdl_tpu.ops.embedding import ParallelContext as JaxParallelContext
from elasticdl_tpu_torch.data import codecs
from elasticdl_tpu_torch.models import deepfm
from elasticdl_tpu_torch.parallel.trainer import MASK_KEY, Trainer

WIDTH = dict(buckets_per_feature=512, embedding_dim=4, hidden=(16,))
N, REAL = 64, 53  # a batch whose last 11 rows are padding


def _records(n=N, seed=9):
    rng = np.random.default_rng(seed)
    return [
        codecs.encode_criteo_example(
            int(rng.integers(0, 2)),
            [None if rng.random() < 0.1 else int(rng.integers(0, 1000)) for _ in range(13)],
            [int(rng.integers(0, 1 << 32)) for _ in range(26)],
        )
        for _ in range(n)
    ]


def _specs(compute_dtype, pre=True):
    kw = dict(WIDTH, compute_dtype=compute_dtype, host_tier=False, pipeline_preprocess=pre)
    return jdeepfm.model_spec(**kw), deepfm.model_spec(**kw)


def _jax_params(jspec, seed=0):
    return jax.device_get(jspec.init(jax.random.key(seed)))


def _batches(spec):
    batch = dict(spec.feed(_records()))
    batch[MASK_KEY] = (np.arange(N) < REAL).astype(np.float32)
    return batch


def _torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def _jax_loss_and_grads(jspec, params, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items() if k != MASK_KEY}
    mask = jnp.asarray(batch[MASK_KEY])

    def loss_fn(p):
        logits = jspec.apply(p, jb, ctx=JaxParallelContext())
        return jspec.loss(logits, jb, mask), logits

    (loss, logits), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    metrics = jspec.metrics(logits, jb, mask)
    return np.asarray(logits), float(loss), jax.device_get(grads), jax.device_get(metrics)


def _port_loss_and_grads(spec, model, batch):
    tb = _torch(batch)
    mask = tb.pop(MASK_KEY)
    logits = spec.apply(model, tb, train=True)
    loss = spec.loss(logits, tb, mask=mask)
    model.zero_grad(set_to_none=True)
    loss.backward()
    with torch.no_grad():
        metrics = spec.metrics(logits.detach(), tb, mask=mask)
    return logits.detach(), float(loss.detach()), deepfm_grads(model), metrics


def deepfm_grads(model):
    return {
        "fm_table": model.fm_table.grad.numpy(),
        "dense_linear": {"w": model.dense_linear.w.grad.numpy(),
                         "b": model.dense_linear.b.grad.numpy()},
        "mlp": {name: {"w": layer.w.grad.numpy(), "b": layer.b.grad.numpy()}
                for name, layer in model.mlp.items()},
    }


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree, np.float32)}


@pytest.mark.parametrize("pre", [True, False], ids=["preprocessed", "raw"])
def test_f32_logits_loss_metrics_and_gradients_match_jax(pre):
    jspec, spec = _specs("float32", pre)
    params = _jax_params(jspec)
    batch = _batches(jspec)
    # Both packages' feeds decode the same bytes.
    ours = codecs.criteo_feed_pre(_records(), 512) if pre else codecs.criteo_feed(_records())
    for k, v in ours.items():
        assert v.dtype == batch[k].dtype and np.array_equal(v, batch[k]), k
    jlogits, jloss, jgrads, jmetrics = _jax_loss_and_grads(jspec, params, batch)
    model = deepfm.params_from_jax(params, device="cpu", compute_dtype="float32",
                                   buckets_per_feature=512, embedding_dim=4)
    logits, loss, grads, metrics = _port_loss_and_grads(spec, model, batch)

    np.testing.assert_allclose(logits.numpy(), jlogits, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5, atol=1e-5)
    assert sorted(metrics) == sorted(jmetrics)
    assert metrics[AUC_POS].shape == (512,)
    for k, v in jmetrics.items():
        np.testing.assert_allclose(metrics[k].numpy(), np.asarray(v), rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    jl, tl = _leaves(jgrads), _leaves(grads)
    assert sorted(jl) == sorted(tl)
    for k in jl:
        np.testing.assert_allclose(tl[k], jl[k], rtol=1e-5, atol=1e-5, err_msg=k)


def test_binary_metrics_on_the_same_logits_match_jax():
    """``binary_metrics`` alone, on shared logits that span the AUC bins."""
    rng = np.random.default_rng(4)
    logits = (rng.standard_normal(300) * 3).astype(np.float32)
    labels = rng.integers(0, 2, 300).astype(np.uint8)
    mask = (np.arange(300) < 250).astype(np.float32)
    from elasticdl_tpu_torch.models.tabular import binary_metrics

    ours = binary_metrics(torch.from_numpy(logits), torch.from_numpy(labels), torch.from_numpy(mask))
    theirs = jtabular.binary_metrics(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(mask))
    for k, v in theirs.items():
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(v), rtol=1e-5, atol=1e-6, err_msg=k)
    # The AUC from the histograms is the finalized metric both pipelines report.
    from elasticdl_tpu.common.metrics import finalize_metrics as jfinalize
    from elasticdl_tpu_torch.common.metrics import finalize_metrics

    ours_f = finalize_metrics({k: v.numpy() for k, v in ours.items()})
    theirs_f = jfinalize({k: np.asarray(v) for k, v in theirs.items()})
    np.testing.assert_allclose(ours_f["auc"], theirs_f["auc"], rtol=1e-6)


def test_bf16_logits_loss_and_gradients_match_jax():
    jspec, spec = _specs("bfloat16")
    params = _jax_params(jspec, seed=1)
    batch = _batches(jspec)
    jlogits, jloss, jgrads, _ = _jax_loss_and_grads(jspec, params, batch)
    model = deepfm.params_from_jax(params, device="cpu", buckets_per_feature=512,
                                   embedding_dim=4)
    logits, loss, grads, _ = _port_loss_and_grads(spec, model, batch)
    np.testing.assert_allclose(logits.numpy(), jlogits, rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(loss, jloss, rtol=2e-2, atol=2e-2)
    jl, tl = _leaves(jgrads), _leaves(grads)
    for k in jl:
        assert np.abs(tl[k] - jl[k]).max() <= 2e-2 * np.abs(jl[k]).max() + 1e-12, k


def test_raw_and_preprocessed_batches_agree():
    """tests/test_data.py:251 in the port: the same records through
    ``pipeline_preprocess`` on and off give the same predictions."""
    outs = {}
    for pre in (False, True):
        spec = deepfm.model_spec(**WIDTH, compute_dtype="float32", pipeline_preprocess=pre)
        batch = spec.feed(_records())
        assert batch["cat"].dtype == (np.uint16 if pre else np.int32)
        trainer = Trainer(spec, device="cpu")
        state = trainer.init_state(0)
        outs[pre] = trainer.run_predict_step(state.model, batch).numpy()
    np.testing.assert_allclose(outs[True], outs[False], rtol=2e-3, atol=2e-3)
    assert ((outs[True] >= 0) & (outs[True] <= 1)).all()


def test_one_adam_step_matches_optax():
    jspec, spec = _specs("float32")
    params = _jax_params(jspec, seed=2)
    batch = _batches(jspec)
    _, _, jgrads, _ = _jax_loss_and_grads(jspec, params, batch)
    opt = optax.adam(1e-3)
    opt_state = opt.init(params)
    updates, opt_state = opt.update(jgrads, opt_state, params)
    jnew = jax.device_get(optax.apply_updates(params, updates))
    adam = next(s for s in opt_state if hasattr(s, "mu"))

    trainer = Trainer(spec, device="cpu")
    state = trainer.init_state(None)
    state.model.load_jax_params(params)
    state, metrics = trainer.run_train_step(state, batch)
    assert sorted(metrics) == ["accuracy", "calibration", "loss"]  # no histograms
    host = trainer.host_state(state)
    for k, ref in _leaves(jnew).items():
        np.testing.assert_allclose(host["params" + k], ref, rtol=1e-5, atol=1e-6, err_msg=k)
    for k, ref in _leaves(jax.device_get(adam.mu)).items():
        np.testing.assert_allclose(host["opt_state/mu" + k], ref, rtol=1e-4, atol=1e-9, err_msg=k)
    for k, ref in _leaves(jax.device_get(adam.nu)).items():
        np.testing.assert_allclose(host["opt_state/nu" + k], ref, rtol=1e-4, atol=1e-9, err_msg=k)
    assert int(host["opt_state/count"]) == int(adam.count) == 1


def test_params_carry_across_and_back():
    jspec, spec = _specs("float32")
    params = _jax_params(jspec, seed=3)
    model = deepfm.params_from_jax(params, buckets_per_feature=512, embedding_dim=4,
                                   device="cpu")
    back = deepfm.params_to_jax(model)
    jl, tl = _leaves(params), _leaves(back)
    assert sorted(jl) == sorted(tl)
    for k in jl:
        assert np.array_equal(jl[k], tl[k]), k
    # The canonical state's parameter paths are the JAX tree's.
    host = Trainer(spec, device="cpu").host_state(Trainer(spec, device="cpu").init_state(0))
    assert sorted(k[len("params"):] for k in host if k.startswith("params/")) == sorted(jl)


def test_seeded_init_has_the_reference_statistics():
    """Not the same draws (another generator), the same distributions: FM
    columns normal x 0.01, the first-order column zero, truncated-normal
    Glorot MLP weights (none past two of its std), zero biases."""
    _, spec = _specs("float32")
    model = spec.init(seed=5, device="cpu")
    jmodel = jdeepfm.model_spec(**WIDTH, host_tier=False).init(jax.random.key(5))
    from elasticdl_tpu_torch.ops.embedding import unpack_table

    logical = unpack_table(model.fm_table.detach(), 5)[: 26 * 512]
    jlogical = np.asarray(jax.device_get(jmodel["fm_table"])).reshape(-1, 8)[: 26 * 512, :5]
    assert (logical[:, 4] == 0).all() and (jlogical[:, 4] == 0).all()
    assert abs(float(logical[:, :4].std()) - float(jlogical[:, :4].std())) < 5e-4
    assert float(unpack_table(model.fm_table.detach(), 5)[26 * 512:].abs().max()) == 0.0
    w = model.mlp["layer0"].w.detach()
    std = np.sqrt(2.0 / sum(w.shape)) / 0.87962566103423978
    assert float(w.abs().max()) <= 2 * std
    jw = np.asarray(jmodel["mlp"]["layer0"]["w"])
    assert abs(float(w.std()) - float(jw.std())) < 0.15 * float(jw.std())
    assert float(model.mlp["layer0"].b.abs().max()) == 0.0


def test_model_spec_resolution_matches_the_reference():
    # Bench width: the mesh tier, preprocessing on, the same wire dtypes.
    spec = deepfm.model_spec()
    jspec = jdeepfm.model_spec()
    assert jspec.host_io == {}
    for k, v in jspec.example_batch(4).items():
        assert spec.example_batch(4)[k].dtype == v.dtype, k
    assert spec.feed.func is codecs.criteo_feed_pre and spec.feed.keywords == {"buckets": 65536}
    raw = deepfm.model_spec(buckets_per_feature=70000)
    assert raw.feed is codecs.criteo_feed
    # The host tier: no device table, the FM rows in the host store, raw
    # batches (its host hash takes the raw ids), as the reference resolves.
    host, jhost = deepfm.model_spec(host_tier=True), jdeepfm.model_spec(host_tier=True)
    assert not host.embedding_tables and sorted(host.host_io) == sorted(jhost.host_io)
    assert host.feed is codecs.criteo_feed
    assert "fm_table" not in dict(host.init(0, "cpu").named_parameters())
    with pytest.raises(ValueError, match="pipeline_preprocess"):
        deepfm.model_spec(host_tier=True, pipeline_preprocess=True)
    with pytest.raises(ValueError, match="pipeline_preprocess"):
        deepfm.model_spec(buckets_per_feature=70000, pipeline_preprocess=True)
    assert deepfm.model_spec(hidden="32,8").init(0, "cpu").mlp["layer1"].w.shape == (32, 8)
    optimizer = spec.optimizer([torch.nn.Parameter(torch.zeros(2))])
    assert isinstance(optimizer, torch.optim.Adam)
    assert optimizer.defaults["betas"] == (0.9, 0.999) and optimizer.defaults["eps"] == 1e-8


def test_out_of_range_id_reads_nan_from_the_model_table():
    """Hashed ids always land in range; an id past DeepFM's packed table
    (or negative) reads NaN from it, never a wrong row."""
    _, spec = _specs("float32")
    model = spec.init(seed=0, device="cpu")
    from elasticdl_tpu_torch.ops.embedding import gather_rows

    rows = gather_rows(model.fm_table.detach(), torch.tensor([-1, 26 * 512 * 2, 3]), 5)
    assert torch.isnan(rows[:2]).all() and torch.isfinite(rows[2]).all()
