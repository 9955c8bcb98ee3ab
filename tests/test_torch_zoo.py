"""The port's model zoo (``elasticdl_tpu_torch/models/{mnist,cifar10_resnet,
wide_deep}.py``) against the JAX package's.

The JAX models make the weights (``init`` from ``jax.random.key(0)``) and
the port's modules take them (``load_jax_params``: HWIO kernels
transposed to OIHW).  Inputs are numpy-seeded, with a padded tail marked
by ``__mask__`` where a trainer runs.  Widths: MNIST at full width;
ResNet at depth 14, width 8 (the reference's test size) and one ResNet-50
forward at full width, batch 2; the ImageNet-stem variant at depth 14,
width 8, ``image_size=64``; Wide&Deep at ``buckets=32, hidden=(32,)``.
Everything runs in f32 on the CPU.

Tolerances:
- forwards, ``predict`` and the padding and norm helpers: rtol 1e-4 /
  atol 1e-5 (the CPU's f32 sums in another order);
- three optimizer steps through each package's ``Trainer``: losses and
  parameters rtol 1e-4 / atol 1e-5, the reference's
  ``tests/test_model_zoo.py:127-130``;
- Wide&Deep under the ParameterServer strategy (both tables row-sharded
  over two gloo ranks, the ``dense`` and ``ragged`` lookup routes)
  against AllReduce (replicated tables) on the same global batches: loss
  within 1e-5, parameters rtol 1e-4 / atol 1e-5, the reference's
  ``test_ps_matches_allreduce`` (measured: losses equal, parameters within
  7.5e-9);
- ids (Wide&Deep's hashed singles and crosses) and the synthetic files:
  exact.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import elasticdl_tpu.parallel  # noqa: F401  (the JAX package's own import order)
from elasticdl_tpu.common.config import JobConfig as JaxJobConfig
from elasticdl_tpu.data import synthetic as jsynthetic
from elasticdl_tpu.models import cifar10_resnet as jresnet
from elasticdl_tpu.models import mnist as jmnist
from elasticdl_tpu.models import wide_deep as jwide_deep
from elasticdl_tpu.ops.embedding import ParallelContext as JaxParallelContext
from elasticdl_tpu.parallel.mesh import create_mesh as jax_create_mesh
from elasticdl_tpu.parallel.trainer import Trainer as JaxTrainer
from elasticdl_tpu_torch.common.config import JobConfig
from elasticdl_tpu_torch.data import synthetic
from elasticdl_tpu_torch.data.recordio import RecordIOReader
from elasticdl_tpu_torch.models import cifar10_resnet, common, mnist, wide_deep
from elasticdl_tpu_torch.parallel.trainer import MASK_KEY, TRACE, Trainer

from _torch_gloo_ranks import run_ranks, wide_deep_steps

RTOL, ATOL = 1e-4, 1e-5
RESNET14 = dict(depth=14, width=8)
INET = dict(depth=14, width=8, image_size=64, num_classes=7, imagenet_stem=True)
WD = dict(buckets=32, hidden=(32,))

_JAX = {"mnist": jmnist, "resnet": jresnet, "wide_deep": jwide_deep}
_PORT = {"mnist": mnist, "resnet": cifar10_resnet, "wide_deep": wide_deep}


def _specs(name, **kw):
    kw = dict(kw, compute_dtype="float32")
    return _JAX[name].model_spec(**kw), _PORT[name].model_spec(**kw)


def _jax_params(jspec, seed=0):
    return jax.device_get(jspec.init(jax.random.key(seed)))


def _images(n, size, channels, seed, classes=10):
    rng = np.random.default_rng(seed)
    return {"images": rng.random((n, size, size, channels), dtype=np.float32),
            "labels": rng.integers(0, classes, n).astype(np.int32)}


def _census(n, seed):
    rng = np.random.default_rng(seed)
    return {"dense": rng.uniform(0, 100, (n, 5)).astype(np.float32),
            "cat": rng.integers(0, 1 << 31, (n, 9)).astype(np.int32),
            "labels": (rng.random(n) < 0.3).astype(np.int32)}


def _torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def _port_model(spec, params):
    return spec.init(seed=None, device="cpu").load_jax_params(params)


def _jax_forward(name, jspec, params, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    if name == "wide_deep":
        return np.asarray(jspec.apply(params, jb, ctx=JaxParallelContext()))
    return np.asarray(jspec.apply(params, jb))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: np.asarray(tree, np.float32)}


# ---- forwards ------------------------------------------------------------------


@pytest.mark.parametrize("name,kw,batch", [
    ("mnist", {}, lambda: _images(8, 28, 1, seed=1)),
    ("resnet", RESNET14, lambda: _images(4, 32, 3, seed=2)),
    ("resnet", INET, lambda: _images(4, 64, 3, seed=3, classes=7)),
    ("wide_deep", WD, lambda: _census(32, seed=4)),
], ids=["mnist", "resnet14", "resnet14-imagenet-stem", "wide_deep"])
def test_forward_matches_jax_with_carried_weights(name, kw, batch):
    jspec, spec = _specs(name, **kw)
    params = _jax_params(jspec)
    b = batch()
    want = _jax_forward(name, jspec, params, b)
    got = spec.apply(_port_model(spec, params), _torch(b)).detach().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_resnet50_forward_at_full_width_matches_jax():
    """ResNet-50 at the bench's width (64; stages 3-4-6-3; 23.5M
    parameters) on two images."""
    jspec, spec = _specs("resnet")
    params = _jax_params(jspec)
    b = _images(2, 32, 3, seed=5)
    want = _jax_forward("resnet", jspec, params, b)
    model = _port_model(spec, params)
    assert 23_000_000 < sum(p.numel() for p in model.parameters()) < 24_000_000
    got = spec.apply(model, _torch(b)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_mnist_flattens_in_the_references_hwc_order():
    """``dense1``'s 9216 rows are in (h, w, c) order; the forward permutes
    the pooled activation to NHWC before the flatten.  The same weights
    read in (c, h, w) order (a forward that flattened NCHW) miss the
    reference by far more than the tolerance, on a non-symmetric input."""
    jspec, spec = _specs("mnist")
    params = _jax_params(jspec)
    b = _images(8, 28, 1, seed=6)
    want = _jax_forward("mnist", jspec, params, b)
    chw = dict(params, dense1=dict(params["dense1"]))
    w = np.asarray(params["dense1"]["w"]).reshape(12, 12, 64, 128)
    chw["dense1"]["w"] = np.ascontiguousarray(w.transpose(2, 0, 1, 3)).reshape(9216, 128)
    wrong = spec.apply(_port_model(spec, chw), _torch(b)).detach().numpy()
    assert np.abs(wrong - want).max() > 100 * ATOL
    got = spec.apply(_port_model(spec, params), _torch(b)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name,kw", [("mnist", {}), ("resnet", RESNET14), ("wide_deep", WD)])
def test_params_round_trip_through_the_jax_tree(name, kw):
    jspec, spec = _specs(name, **kw)
    params = _jax_params(jspec)
    back = _PORT[name].params_to_jax(_port_model(spec, params))
    want, got = _leaves(params), _leaves(back)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_imagenet_variant_feed_refuses_records():
    _, spec = _specs("resnet", **INET)
    with pytest.raises(RuntimeError, match="no dataset codec"):
        spec.feed([b"\x00" * 10])


# ---- the padding rule, the norm, the crosses ------------------------------------


@pytest.mark.parametrize("size,k", [(32, 3), (16, 3), (64, 7), (15, 3)])
def test_stride2_same_padding_is_xlas_asymmetric_rule(size, k):
    """XLA pads ``total // 2`` before and the rest after: a 3x3/s2 conv at
    an even size pads 0 and 1, a 7x7/s2 one 2 and 3.  ``conv2d_same``
    matches ``lax.conv_general_dilated(..., "SAME")``.  The symmetric
    padding of ``nn.Conv2d(padding=k // 2)`` gives the same shape and
    other numbers at every even size."""
    rng = np.random.default_rng(size + k)
    x = rng.standard_normal((2, size, size, 3)).astype(np.float32)
    w = rng.standard_normal((k, k, 3, 5)).astype(np.float32)
    dn = jax.lax.conv_dimension_numbers(x.shape, w.shape, ("NHWC", "HWIO", "NHWC"))
    want = np.asarray(jax.lax.conv_general_dilated(x, w, (2, 2), "SAME", dimension_numbers=dn))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    wt = common.hwio_to_oihw(w)
    got = common.conv2d_same(xt, wt, 2).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-4)
    symmetric = F.conv2d(xt, wt, stride=2, padding=k // 2).permute(0, 2, 3, 1).numpy()
    assert symmetric.shape == want.shape
    if size % 2 == 0:
        assert np.abs(symmetric - want).max() > 0.1
    else:  # odd sizes pad symmetrically under both rules
        np.testing.assert_allclose(symmetric, want, rtol=RTOL, atol=1e-4)


def test_stride2_same_max_pool_pads_with_minus_infinity_after():
    """The ImageNet stem's 3x3/s2 SAME max-pool: -inf padding, 0 before and
    1 after at an even size; on all-negative input a zero padding would
    win windows, and a symmetric one shifts them."""
    rng = np.random.default_rng(7)
    x = -np.abs(rng.standard_normal((2, 16, 16, 4))).astype(np.float32) - 0.1
    want = np.asarray(jax.lax.reduce_window(
        x, -jnp.inf, jax.lax.max, (1, 3, 3, 1), (1, 2, 2, 1), "SAME"))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = common.max_pool_same(xt, 3, 2).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, want)
    zero_pad = F.max_pool2d(F.pad(xt, (0, 1, 0, 1)), 3, 2).permute(0, 2, 3, 1).numpy()
    symmetric = F.max_pool2d(xt, 3, 2, padding=1).permute(0, 2, 3, 1).numpy()
    assert (zero_pad != want).any() and (symmetric != want).any()


def test_group_norm_fold_matches_the_reference_and_torchs():
    """The folded one-pass GroupNorm against the reference's
    ``_group_norm`` (NHWC) and ``F.group_norm`` at f32; 8 groups of 4."""
    rng = np.random.default_rng(8)
    x = (rng.standard_normal((3, 6, 5, 32)) * 2 + 0.5).astype(np.float32)
    scale = rng.standard_normal(32).astype(np.float32)
    bias = rng.standard_normal(32).astype(np.float32)
    want = np.asarray(jresnet._group_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias)))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    st, bt = torch.from_numpy(scale), torch.from_numpy(bias)
    got = cifar10_resnet.group_norm(xt, st, bt)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), F.group_norm(xt, 8, st, bt, 1e-5).numpy(),
                               rtol=RTOL, atol=ATOL)


def test_wide_ids_wrap_like_the_references_uint32_crosses():
    """Singles and crosses over the whole int32 range (census ids reach
    2^31; a cross ``a * 1000003 + b`` wraps mod 2^32): equal ids."""
    rng = np.random.default_rng(9)
    cat = rng.integers(-(1 << 31), 1 << 31, (256, 9), dtype=np.int64).astype(np.int32)
    cat[:4] = [[(1 << 31) - 1] * 9, [-1] * 9, [0] * 9, [1 << 30] * 9]
    for buckets in (32, 65536):
        want = np.asarray(jwide_deep._wide_ids(jnp.asarray(cat), buckets))
        got = wide_deep.wide_ids(torch.from_numpy(cat), buckets).numpy()
        np.testing.assert_array_equal(got, want)
    assert wide_deep._CROSSES == tuple(itertools.combinations(range(9), 2))


# ---- optimizers and training steps ----------------------------------------------


@pytest.mark.parametrize("nesterov", [False, True], ids=["momentum", "nesterov"])
def test_sgd_matches_optax_over_two_steps(nesterov):
    """``optax.sgd(lr, momentum=0.9, nesterov)`` and ``torch.optim.SGD(lr,
    momentum=0.9, dampening=0, nesterov)``: both start the trace at the
    first gradient, so two steps with different gradients agree."""
    rng = np.random.default_rng(10)
    w0 = rng.standard_normal(17).astype(np.float32)
    grads = [rng.standard_normal(17).astype(np.float32) for _ in range(2)]
    tx = optax.sgd(0.1, momentum=0.9, nesterov=nesterov)
    w, st = jnp.asarray(w0), tx.init(jnp.asarray(w0))
    p = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt = common.sgd([p], learning_rate=0.1, nesterov=nesterov)
    for g in grads:
        upd, st = tx.update(jnp.asarray(g), st, w)
        w = optax.apply_updates(w, upd)
        p.grad = torch.from_numpy(g.copy())
        opt.step()
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(opt.state[p]["momentum_buffer"].numpy(), np.asarray(st[0].trace),
                               rtol=1e-6, atol=1e-7)


def _jax_steps(jspec, batches, strategy="AllReduce"):
    jtr = JaxTrainer(jspec, JaxJobConfig(distribution_strategy=strategy),
                     jax_create_mesh(jax.devices(), num_devices=1))
    jstate = jtr.init_state(jax.random.key(0))
    params = jax.device_get(jstate.params)
    losses = []
    for b in batches:
        jstate, m = jtr.train_step(jstate, jtr.shard_batch(b))
        losses.append(float(m["loss"]))
    return params, losses, jax.device_get(jstate.params)


def _port_steps(spec, params, batches, strategy="AllReduce"):
    tr = Trainer(spec, device="cpu", config=JobConfig(distribution_strategy=strategy))
    state = tr.init_state(None)
    state.model.load_jax_params(params)
    losses = []
    for b in batches:
        state, m = tr.run_train_step(state, b)
        losses.append(float(m["loss"]))
    return tr, state, losses


def _masked(batch, real):
    n = len(batch["labels"])
    return dict(batch, **{MASK_KEY: (np.arange(n) < real).astype(np.float32)})


@pytest.mark.parametrize("name,kw,batches,strategy", [
    ("mnist", {}, lambda: [_masked(_images(16, 28, 1, seed=20 + i), 13) for i in range(3)],
     "AllReduce"),
    ("resnet", RESNET14, lambda: [_masked(_images(8, 32, 3, seed=30 + i), 6) for i in range(3)],
     "AllReduce"),
    ("wide_deep", WD, lambda: [_masked(_census(64, seed=40 + i), 57) for i in range(3)],
     "ParameterServer"),
], ids=["mnist", "resnet14", "wide_deep-ps"])
def test_three_training_steps_match_the_jax_trainer(name, kw, batches, strategy):
    """Each package's ``Trainer`` (a world of one; Wide&Deep with its two
    tables row-sharded under the ParameterServer strategy) from the same
    weights over the same three masked batches: the spec's optimizer (SGD
    momentum, SGD nesterov, Adam)."""
    jspec, spec = _specs(name, **kw)
    bs = batches()
    params, jlosses, jafter = _jax_steps(jspec, bs, strategy)
    tr, state, losses = _port_steps(spec, params, bs, strategy)
    np.testing.assert_allclose(losses, jlosses, rtol=RTOL, atol=ATOL)
    want, got = _leaves(jafter), _leaves(_PORT[name].params_to_jax(state.model))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("name,kw", [("mnist", {}), ("resnet", RESNET14)])
def test_sgd_trace_checkpoints_and_restores(name, kw):
    """SGD's momentum buffer is the canonical ``opt_state/trace/<path>``
    (no count): a restored state takes the next step exactly as the live
    one."""
    jspec, spec = _specs(name, **kw)
    size, ch = (28, 1) if name == "mnist" else (32, 3)
    bs = [_images(4, size, ch, seed=50 + i) for i in range(3)]
    tr, state, _ = _port_steps(spec, _jax_params(jspec), bs[:2])
    host = tr.host_state(state)
    assert "opt_state/count" not in host and not any("/mu/" in k for k in host)
    traces = [k for k in host if k.startswith(TRACE)]
    assert len(traces) == len(list(state.model.parameters()))
    restored = tr.adopt_restored(host)
    a, _ = tr.run_train_step(state, bs[2])
    b, _ = tr.run_train_step(restored, bs[2])
    ha, hb = tr.host_state(a), tr.host_state(b)
    for k in ha:
        np.testing.assert_array_equal(hb[k], ha[k], err_msg=k)


@pytest.mark.parametrize("name,kw,batch", [
    ("mnist", {}, lambda: _images(8, 28, 1, seed=60)),
    ("resnet", RESNET14, lambda: _images(4, 32, 3, seed=61)),
    ("wide_deep", WD, lambda: _census(32, seed=62)),
], ids=["mnist", "resnet14", "wide_deep"])
def test_predict_matches_the_jax_predict(name, kw, batch):
    """``Trainer.run_predict_step`` (the serving path): MNIST's class
    probabilities, Wide&Deep's income probability, the ResNet's logits
    (it declares no predict), against the JAX trainer's."""
    jspec, spec = _specs(name, **kw)
    b = batch()
    jtr = JaxTrainer(jspec, JaxJobConfig(), jax_create_mesh(jax.devices(), num_devices=1))
    jstate = jtr.init_state(jax.random.key(0))
    want = np.asarray(jtr.run_predict_step(jstate, b))
    tr = Trainer(spec, device="cpu")
    model = _port_model(spec, jax.device_get(jstate.params))
    got = tr.run_predict_step(model, b).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    if name == "mnist":
        np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-6)
    if name == "wide_deep":
        assert ((got >= 0) & (got <= 1)).all()


def test_wide_deep_ps_matches_allreduce_on_two_gloo_ranks():
    """The reference's ``test_ps_matches_allreduce`` for Wide&Deep, in a
    world of two: each rank holds half the physical rows of both tables
    (the dim-1 ``wide`` table packs 128 rows to one), the lookups are
    collective, and two Adam steps from the carried weights land where the
    replicated tables do."""
    kw = dict(WD, compute_dtype="float32")
    params = _jax_params(jwide_deep.model_spec(**kw))
    batches = [_census(64, seed=70 + i) for i in range(2)]
    variants = [("AllReduce", "auto"), ("ParameterServer", "dense"),
                ("ParameterServer", "ragged")]
    ranks = run_ranks(wide_deep_steps, 2, variants, kw, params, batches)
    for out in ranks:
        ar = out[("AllReduce", "auto")]
        full = (ar["rows"][0], ar["rows"][1])
        for variant in variants[1:]:
            ps = out[variant]
            assert ps["impl"] == variant[1]
            assert ps["rows"] == (full[0] // 2, full[1] // 2)
            np.testing.assert_allclose(ps["losses"], ar["losses"], rtol=0, atol=1e-5)
            assert sorted(ps["params"]) == sorted(ar["params"])
            for k in ar["params"]:
                np.testing.assert_allclose(ps["params"][k], ar["params"][k], rtol=RTOL,
                                           atol=ATOL, err_msg=f"{variant} {k}")
    # Both ranks gathered the same canonical state.
    for k, v in ranks[0][variants[1]]["params"].items():
        np.testing.assert_array_equal(ranks[1][variants[1]]["params"][k], v)


# ---- the data -------------------------------------------------------------------


@pytest.mark.parametrize("family", ["mnist", "cifar10", "census"])
def test_synthetic_files_are_the_references_bytes(tmp_path, family):
    ours, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    synthetic.generate(family, ours, 40, seed=7)
    jsynthetic.generate(family, theirs, 40, seed=7)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("family,spec_fn", [
    ("mnist", lambda: mnist.model_spec()),
    ("cifar10", lambda: cifar10_resnet.model_spec()),
])
def test_image_feeds_decode_the_synthetic_records(tmp_path, family, spec_fn):
    path = str(tmp_path / f"{family}.rio")
    synthetic.generate(family, path, 12, seed=3)
    from elasticdl_tpu.data import codecs as jcodecs

    records = list(RecordIOReader(path).read_range(0, 12))
    got = spec_fn().feed(records)
    want = getattr(jcodecs, f"{family}_feed")(records)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["images"].dtype == np.float32 and got["images"].max() <= 1.0
