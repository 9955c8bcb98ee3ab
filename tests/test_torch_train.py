"""The PyTorch port's training slice against the JAX package.

The JAX ``Trainer`` on a 1-device mesh (AllReduce, as tests/
test_transformer_lm.py builds it) and the port's ``Trainer(device="cpu")``
start from the same weights (carried with ``params_from_jax``) and take
``run_train_step`` on the same numpy batches, one of them padded with a
``__mask__`` that zeroes a row.  Both sides run their plain attention on
the CPU (the reference's XLA oracle, the port's ``attention_reference``).

Tolerances, f32 compute: loss per step rtol 1e-5; parameters after one
step rtol 2e-4 / atol 2e-5 (tests/test_transformer_lm.py's), and the same
after three steps (measured: largest difference 5.6e-6 at every step; the
AdamW update is about lr * sign(g) at step 1, so gradients that differ in
their last bits move a parameter by at most the rounding of that update).
Accuracy is equal, padded rows included.  bf16 compute: loss within 2e-3
per step (measured at most 3.4e-4: the logits carry bf16 roundings taken
at other places by the two frameworks, a few ulps each, and the loss
averages them over every token).
"""

import inspect

import jax
import numpy as np
import optax
import pytest
import torch

from elasticdl_tpu.common.config import JobConfig
from elasticdl_tpu.data import codecs as jcodecs
from elasticdl_tpu.data.packed import PackedRecords as JPackedRecords
from elasticdl_tpu.models import metrics as jmetrics
from elasticdl_tpu.models.spec import load_model_spec
from elasticdl_tpu.parallel.mesh import create_mesh
from elasticdl_tpu.parallel.trainer import Trainer as JaxTrainer
from elasticdl_tpu_torch.data import codecs as tcodecs
from elasticdl_tpu_torch.data.packed import PackedRecords
from elasticdl_tpu_torch.models import metrics as tmetrics
from elasticdl_tpu_torch.models import transformer_lm as tlm
from elasticdl_tpu_torch.parallel.trainer import Trainer, TrainState
from elasticdl_tpu_torch.serving.server import ServingServer

SEQ, VOCAB = 64, 512
_MODEL = dict(vocab=VOCAB, dim=64, n_heads=4, n_layers=2, max_seq=SEQ, seq_len=SEQ)


def _batches(n=3, b=4, seed=0):
    """n host batches; the second carries a __mask__ zeroing row 2."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        toks = rng.integers(0, VOCAB, size=(b, SEQ + 1)).astype(np.int32)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if i == 1:
            batch["__mask__"] = np.array([1, 1, 0, 1], np.float32)
        out.append(batch)
    return out


def _both(compute_dtype):
    kw = dict(compute_dtype=compute_dtype, **_MODEL)
    jspec = load_model_spec("elasticdl_tpu.models", "transformer_lm.model_spec", **kw)
    jtrainer = JaxTrainer(jspec, JobConfig(distribution_strategy="AllReduce"),
                          create_mesh(jax.devices(), num_devices=1))
    jstate = jtrainer.init_state(jax.random.key(0))
    trainer = Trainer(tlm.model_spec(**kw), device="cpu")
    state = trainer.init_state(0)
    state.model.load_jax_params(jax.device_get(jstate.params))
    return jtrainer, jstate, trainer, state


def _assert_params_close(jparams, model, rtol=2e-4, atol=2e-5):
    ref = jax.tree.leaves(jax.device_get(jparams))
    got = jax.tree.leaves(tlm.params_to_jax(model))
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g, np.asarray(r), rtol=rtol, atol=atol)


def test_three_f32_steps_match_the_jax_trainer():
    jtrainer, jstate, trainer, state = _both("float32")
    for i, batch in enumerate(_batches()):
        jstate, jm = jtrainer.run_train_step(jstate, batch)
        state, m = trainer.run_train_step(state, batch)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
        assert float(m["accuracy"]) == float(jm["accuracy"])
        _assert_params_close(jstate.params, state.model)
        assert state.step == int(jstate.step) == i + 1


def test_bf16_losses_match_the_jax_trainer():
    jtrainer, jstate, trainer, state = _both("bfloat16")
    for batch in _batches():
        jstate, jm = jtrainer.run_train_step(jstate, batch)
        state, m = trainer.run_train_step(state, batch)
        assert abs(float(m["loss"]) - float(jm["loss"])) <= 2e-3


def test_mask_weighs_the_loss_but_not_the_accuracy():
    """The masked loss is the mean over real rows; accuracy counts every
    row (the reference's metrics take no mask); an all-padding batch
    trains on a zero loss."""
    trainer = Trainer(tlm.model_spec(compute_dtype="float32", **_MODEL), device="cpu")
    batch = _batches()[1]
    mask = batch["__mask__"]
    model = trainer.init_state(0).model
    with torch.no_grad():
        logits = model(torch.from_numpy(batch["tokens"]))
        labels = torch.from_numpy(batch["labels"])
        ce = torch.nn.functional.cross_entropy(
            logits.reshape(-1, VOCAB), labels.reshape(-1).long(), reduction="none"
        ).reshape(labels.shape)
        acc = (logits.argmax(-1) == labels).float().mean()
    _, m = trainer.run_train_step(trainer.init_state(0), batch)
    np.testing.assert_allclose(float(m["loss"]), float(ce[mask > 0].mean()), rtol=1e-6)
    np.testing.assert_allclose(float(m["accuracy"]), float(acc), rtol=1e-6)
    _, m = trainer.run_train_step(trainer.init_state(0), dict(batch, __mask__=np.zeros(4, np.float32)))
    assert float(m["loss"]) == 0.0


def test_remat_on_and_off_take_the_same_step():
    kw = dict(compute_dtype="float32", **_MODEL)
    batch = _batches(1, seed=3)[0]
    results = []
    for remat in (True, False):
        trainer = Trainer(tlm.model_spec(remat=remat, **kw), device="cpu")
        state, m = trainer.run_train_step(trainer.init_state(0), batch)
        results.append((float(m["loss"]), [p.detach().clone() for p in state.model.parameters()]))
    (loss_a, params_a), (loss_b, params_b) = results
    assert loss_a == loss_b
    assert all(torch.equal(a, b) for a, b in zip(params_a, params_b))


@pytest.mark.parametrize("remat", [True, False])
def test_every_parameter_gets_a_gradient_and_changes(remat):
    """bf16 compute, where the matmul weights are cast: every parameter,
    the four cast matmul weights of each block and the tied head included,
    receives a non-zero gradient and moves in one step."""
    trainer = Trainer(tlm.model_spec(compute_dtype="bfloat16", remat=remat, **_MODEL), device="cpu")
    state = trainer.init_state(0)
    before = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    state, _ = trainer.run_train_step(state, _batches(1)[0])
    names = dict(state.model.named_parameters())
    assert set(names) == set(before) and len(names) == 3 + 6 * _MODEL["n_layers"]
    for name, p in names.items():
        assert p.grad is not None and p.grad.abs().sum() > 0, name
        assert not torch.equal(p.detach(), before[name]), name


def test_a_served_model_that_is_then_trained_serves_the_new_weights():
    spec = tlm.model_spec(compute_dtype="bfloat16", **_MODEL)
    trainer = Trainer(spec, device="cpu")
    state = trainer.init_state(0)
    server = ServingServer(spec, max_batch=2, state=state.model, device="cpu")
    try:
        tokens = {"tokens": _batches(1, b=2, seed=5)[0]["tokens"]}
        before, _ = server._run_batch(tokens, 2)
        state, _ = trainer.run_train_step(state, _batches(1)[0])
        after, _ = server._run_batch(tokens, 2)
        fresh = tlm.params_from_jax(tlm.params_to_jax(state.model), _MODEL["n_heads"],
                                    "bfloat16", device="cpu")
        with torch.inference_mode():
            want = fresh(torch.from_numpy(tokens["tokens"])).numpy()
        assert not np.array_equal(before, after)
        np.testing.assert_array_equal(after, want)
    finally:
        server.stop()


def test_adamw_hyperparameters_equal_optax_defaults():
    defaults = {k: p.default for k, p in inspect.signature(optax.adamw).parameters.items()}
    optimizer = Trainer(tlm.model_spec(learning_rate=1e-3, **_MODEL), device="cpu").init_state(0).optimizer
    assert isinstance(optimizer, torch.optim.AdamW)
    (group,) = optimizer.param_groups
    assert group["lr"] == 1e-3
    assert group["betas"] == (defaults["b1"], defaults["b2"])
    assert group["eps"] == defaults["eps"]
    assert group["weight_decay"] == defaults["weight_decay"] == 1e-4
    assert defaults["eps_root"] == 0.0 and defaults["mask"] is None and not group["amsgrad"]
    # optax decays every leaf (mask=None): one group holds every parameter.
    assert len(group["params"]) == 3 + 6 * _MODEL["n_layers"]


def test_params_to_jax_round_trips_through_params_from_jax():
    model = tlm.model_spec(**_MODEL).init(seed=2, device="cpu")
    tree = tlm.params_to_jax(model)
    assert sorted(tree["blocks"]) == ["b0", "b1"] and tree["tok_emb"].shape == (VOCAB, 64)
    back = tlm.params_from_jax(tree, _MODEL["n_heads"], device="cpu")
    for a, b in zip(model.parameters(), back.parameters()):
        assert torch.equal(a, b)


def test_lm_feed_and_codec_match_the_reference():
    toks = np.random.default_rng(0).integers(0, VOCAB, (3, SEQ + 1)).astype(np.int32)
    records = [tcodecs.encode_lm_example(t) for t in toks]
    assert records == [jcodecs.encode_lm_example(t) for t in toks]
    for port_records, ref_records in ((records, records),
                                      (PackedRecords.from_records(records),
                                       JPackedRecords.from_records(records))):
        got, ref = tcodecs.lm_feed(port_records), jcodecs.lm_feed(ref_records)
        assert sorted(got) == sorted(ref) == ["labels", "tokens"]
        for key in got:
            np.testing.assert_array_equal(got[key], ref[key])
    assert tlm.model_spec().feed is tcodecs.lm_feed


@pytest.mark.parametrize("with_mask", [False, True])
def test_masked_mean_matches_the_reference(with_mask):
    rng = np.random.default_rng(1)
    values = rng.standard_normal((4, 6)).astype(np.float32)
    mask = np.array([1, 0, 1, 1], np.float32) if with_mask else None
    got = tmetrics.masked_mean(torch.from_numpy(values),
                               None if mask is None else torch.from_numpy(mask))
    ref = jmetrics.masked_mean(values, mask)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)
    zeros = torch.zeros(4)
    assert float(tmetrics.masked_mean(torch.from_numpy(values), zeros)) == 0.0


def test_run_train_steps_loops_over_host_or_placed_batches():
    trainer = Trainer(tlm.model_spec(compute_dtype="float32", **_MODEL), device="cpu")
    state = trainer.init_state(0)
    batches = _batches()
    state, metrics = trainer.run_train_steps(state, iter(batches))
    assert state.step == 3 and len(metrics) == 3
    state, metrics = trainer.run_train_steps(
        state, [trainer.shard_batch(batches[0])], pre_sharded=True)
    assert state.step == 4 and all(torch.isfinite(v) for v in metrics[0].values())


def test_a_spec_without_loss_or_optimizer_does_not_train():
    spec = tlm.model_spec(**_MODEL)
    spec.loss = None
    trainer = Trainer(spec, device="cpu")
    with pytest.raises(ValueError, match="cannot train"):
        trainer.run_train_step(TrainState(0, spec.init(seed=0, device="cpu"), None), _batches(1)[0])
