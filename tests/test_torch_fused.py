"""The port's fused task dispatch (``Trainer.shard_stacked_batch``,
``train_scan``, ``eval_scan``) against the JAX package's, against its own
per-step loop, and the worker's routing onto it.

Sizes: ``transformer_lm`` 2 layers of dim 32 (4 heads, 16 tokens, batch
4), MNIST at batch 8, DeepFM at 512 buckets a feature (dim 4, MLP 16,
batch 16), Wide&Deep at 32 buckets under ParameterServer (batch 16); T = 3
steps a scan.  Inputs are numpy-seeded; the JAX ``init`` makes the weights
and ``load_jax_params`` carries them into the port.  On the CPU the
port's scans run their steps eagerly (the card replays one CUDA graph:
``tests/test_torch_cuda.py``).

Tolerances, f32 compute: against the JAX ``train_scan``, ``transformer_lm``
as ``tests/test_torch_train.py`` (losses rtol 1e-5; parameters rtol 2e-4 /
atol 2e-5) and MNIST as ``tests/test_torch_zoo.py`` (rtol 1e-4 / atol
1e-5); DeepFM's ``eval_scan`` as ``tests/test_torch_deepfm.py`` (rtol 1e-5
/ atol 1e-5, the AUC histograms included).  Against the port's own
per-step loop: bit for bit (losses, parameters, optimizer slots, eval
metrics).
"""

import dataclasses
import sys

import jax
import numpy as np
import pytest
import torch

import elasticdl_tpu.parallel  # noqa: F401  (the JAX package's own import order)
from elasticdl_tpu.common.config import JobConfig as JaxJobConfig
from elasticdl_tpu.models import deepfm as jdeepfm
from elasticdl_tpu.models import mnist as jmnist
from elasticdl_tpu.models.spec import load_model_spec as jax_load_model_spec
from elasticdl_tpu.parallel.mesh import create_mesh
from elasticdl_tpu.parallel.trainer import Trainer as JaxTrainer
from elasticdl_tpu_torch.common.config import JobConfig
from elasticdl_tpu_torch.data import codecs
from elasticdl_tpu_torch.data.reader import Shard, create_data_reader
from elasticdl_tpu_torch.data.synthetic import generate
from elasticdl_tpu_torch.master.task_dispatcher import TASK_EVALUATION, Task
from elasticdl_tpu_torch.models import deepfm, mnist, wide_deep
from elasticdl_tpu_torch.models import transformer_lm as tlm
from elasticdl_tpu_torch.parallel.mesh import Mesh
from elasticdl_tpu_torch.parallel.trainer import (
    SCAN_BUDGETS,
    ScanBudgetError,
    ScanMetrics,
    Trainer,
    TrainLoopError,
    make_capturable,
)
from elasticdl_tpu_torch.worker.worker import Worker

T = 3
SEQ, VOCAB = 16, 512
_LM = dict(vocab=VOCAB, dim=32, n_heads=4, n_layers=2, max_seq=SEQ, seq_len=SEQ,
           compute_dtype="float32")
_DFM = dict(buckets_per_feature=512, embedding_dim=4, hidden=(16,), compute_dtype="float32",
            host_tier=False)
_WD = dict(buckets=32, hidden=(32,), compute_dtype="float32")


def _lm_stacked(t=T, b=4, seed=0):
    toks = np.random.default_rng(seed).integers(0, VOCAB, (t, b, SEQ + 1)).astype(np.int32)
    return {"tokens": toks[:, :, :-1], "labels": toks[:, :, 1:]}


def _mnist_stacked(t=T, b=8, seed=1):
    rng = np.random.default_rng(seed)
    return {"images": rng.random((t, b, 28, 28, 1), dtype=np.float32),
            "labels": rng.integers(0, 10, (t, b)).astype(np.int32)}


def _criteo_records(n, seed):
    rng = np.random.default_rng(seed)
    return [
        codecs.encode_criteo_example(
            int(rng.integers(0, 2)),
            [None if rng.random() < 0.1 else int(rng.integers(0, 1000)) for _ in range(13)],
            [int(rng.integers(0, 1 << 32)) for _ in range(26)],
        )
        for _ in range(n)
    ]


def _stack(batch, t):
    return {k: np.ascontiguousarray(v).reshape((t, -1) + np.shape(v)[1:]) for k, v in batch.items()}


def _dfm_stacked(spec, t=T, b=16, seed=9):
    return _stack(dict(spec.feed(_criteo_records(t * b, seed))), t)


def _census_stacked(t=T, b=16, seed=40):
    rng = np.random.default_rng(seed)
    n = t * b
    return _stack({"dense": rng.uniform(0, 100, (n, 5)).astype(np.float32),
                   "cat": rng.integers(0, 1 << 31, (n, 9)).astype(np.int32),
                   "labels": (rng.random(n) < 0.3).astype(np.int32)}, t)


def _steps(stacked):
    n = next(iter(stacked.values())).shape[0]
    return [{k: v[i] for k, v in stacked.items()} for i in range(n)]


# name -> (port spec, trainer config, stacked batch)
_CASES = {
    "transformer_lm": (lambda: tlm.model_spec(**_LM), "AllReduce", _lm_stacked),
    "mnist": (lambda: mnist.model_spec(compute_dtype="float32"), "AllReduce", _mnist_stacked),
    "deepfm": (lambda: deepfm.model_spec(**_DFM), "AllReduce",
               lambda: _dfm_stacked(deepfm.model_spec(**_DFM))),
    "wide_deep-ps": (lambda: wide_deep.model_spec(**_WD), "ParameterServer", _census_stacked),
}


def _trainer(name):
    spec_fn, strategy, _ = _CASES[name]
    return Trainer(spec_fn(), device="cpu", config=JobConfig(distribution_strategy=strategy))


def _jax_trainer(jspec):
    return JaxTrainer(jspec, JaxJobConfig(distribution_strategy="AllReduce"),
                      create_mesh(jax.devices(), num_devices=1))


def _arrays(trainer, state):
    return trainer.host_state(state)


# ---- against the JAX package ---------------------------------------------------


def _lm_pair():
    jspec = jax_load_model_spec("elasticdl_tpu.models", "transformer_lm.model_spec", **_LM)
    return jspec, tlm.model_spec(**_LM), tlm.params_to_jax, (2e-4, 2e-5), 1e-5, _lm_stacked()


def _mnist_pair():
    return (jmnist.model_spec(compute_dtype="float32"), mnist.model_spec(compute_dtype="float32"),
            mnist.params_to_jax, (1e-4, 1e-5), 1e-4, _mnist_stacked())


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: np.asarray(tree, np.float32)}


@pytest.mark.parametrize("pair", [_lm_pair, _mnist_pair], ids=["transformer_lm", "mnist"])
def test_train_scan_matches_the_jax_train_scan(pair):
    """One ``train_scan`` of T steps in each package from the same weights
    on the same stacked batch: the ``[T]`` losses and the final
    parameters."""
    jspec, spec, to_jax, (rtol, atol), loss_rtol, stacked = pair()
    jtr = _jax_trainer(jspec)
    jstate = jtr.init_state(jax.random.key(0))
    params = jax.device_get(jstate.params)
    tr = Trainer(spec, device="cpu")
    state = tr.init_state(None)
    state.model.load_jax_params(params)
    jstate, jm = jtr.train_scan(jstate, jtr.shard_stacked_batch(stacked))
    state, m = tr.train_scan(state, tr.shard_stacked_batch(stacked))
    assert isinstance(m, ScanMetrics) and m["loss"].shape == (T,)
    np.testing.assert_allclose(m["loss"].numpy(), np.asarray(jm["loss"]), rtol=loss_rtol)
    assert state.step == int(jstate.step) == T
    want, got = _leaves(jax.device_get(jstate.params)), _leaves(to_jax(state.model))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol, err_msg=k)


def test_eval_scan_matches_the_jax_eval_scan_for_deepfm():
    """DeepFM's ``eval_scan`` in both packages from the same weights: every
    metric of every step, the AUC score histograms included."""
    kw = dict(_DFM)
    jspec, spec = jdeepfm.model_spec(**kw), deepfm.model_spec(**kw)
    params = jax.device_get(jspec.init(jax.random.key(0)))
    jtr = _jax_trainer(jspec)
    jstate = jtr.init_state(jax.random.key(0))
    jstate = jstate.replace(params=jax.device_put(params))
    tr = Trainer(spec, device="cpu")
    state = tr.init_state(None)
    state.model.load_jax_params(params)
    stacked = _dfm_stacked(spec)
    jm = jax.device_get(jtr.eval_scan(jstate, jtr.shard_stacked_batch(stacked)))
    m = tr.eval_scan(state, tr.shard_stacked_batch(stacked))
    assert sorted(m) == sorted(jm)
    assert any(np.asarray(v).ndim == 2 for v in jm.values())  # the histograms: [T, bins]
    for k in jm:
        assert tuple(m[k].shape) == np.shape(jm[k]), k
        np.testing.assert_allclose(m[k].numpy(), np.asarray(jm[k]), rtol=1e-5, atol=1e-5,
                                   err_msg=k)


# ---- against the port's own per-step loop ---------------------------------------


@pytest.mark.parametrize("name", sorted(_CASES))
def test_train_scan_matches_the_per_step_loop_bit_for_bit(name):
    """``train_scan`` over T steps and ``run_train_steps`` over the same T
    batches from the same seeded state: equal losses, parameters and
    optimizer slots, bit for bit; the step advances by T once."""
    stacked = _CASES[name][2]()
    tr_a, tr_b = _trainer(name), _trainer(name)
    a, b = tr_a.init_state(0), tr_b.init_state(0)
    a, ma = tr_a.train_scan(a, tr_a.shard_stacked_batch(stacked))
    b, mb = tr_b.run_train_steps(b, _steps(stacked))
    assert a.step == b.step == T
    assert sorted(ma) == sorted(mb[0])
    for k in ma:
        assert torch.equal(ma[k], torch.stack([m[k] for m in mb])), k
    sa, sb = _arrays(tr_a, a), _arrays(tr_b, b)
    assert sorted(sa) == sorted(sb)
    for k in sa:
        np.testing.assert_array_equal(sa[k], sb[k], err_msg=k)


@pytest.mark.parametrize("name", sorted(_CASES))
def test_eval_scan_matches_per_step_eval_bit_for_bit(name):
    stacked = _CASES[name][2]()
    tr = _trainer(name)
    state = tr.init_state(0)
    m = tr.eval_scan(state, tr.shard_stacked_batch(stacked))
    per_step = [tr.eval_step(state, tr.shard_batch(b)) for b in _steps(stacked)]
    assert sorted(m) == sorted(per_step[0])
    for k in m:
        assert torch.equal(m[k], torch.stack([s[k] for s in per_step])), k


@pytest.mark.parametrize("name,key,shape", [
    ("transformer_lm", "tokens", (T, 4, SEQ // 2)),  # the sequence path: half of each sequence
    ("mnist", "images", (T, 4, 28, 28, 1)),  # data parallel: half of the examples
])
def test_shard_stacked_batch_places_each_step_as_shard_batch(name, key, shape):
    """On a mesh of two ranks (no process group needed to place), a rank's
    stacked batch is the stack of its ``shard_batch`` slices."""
    stacked = _lm_stacked(b=4) if name == "transformer_lm" else _mnist_stacked()
    for rank in (0, 1):
        tr = Trainer(_CASES[name][0](), device="cpu", mesh=Mesh({"dp": 2}, rank=rank))
        placed = tr.shard_stacked_batch(stacked)
        for i, step in enumerate(_steps(stacked)):
            one = tr.shard_batch(step)
            for k in one:
                assert torch.equal(placed[k][i], one[k]), (rank, i, k)
        assert placed[key].shape == shape


@pytest.mark.parametrize("kind", sorted(SCAN_BUDGETS))
def test_a_fifth_batch_variant_raises(kind):
    """The reference's budget of 4 variants a scan: four step counts run,
    a fifth raises before anything runs; a variant seen before still runs."""
    tr = Trainer(tlm.model_spec(**_LM), device="cpu")
    state = tr.init_state(0)

    def run(t):
        stacked = tr.shard_stacked_batch(_lm_stacked(t=t))
        if kind == "train_scan":
            return tr.train_scan(state, stacked)[0]
        tr.eval_scan(state, stacked)
        return state

    for t in (1, 2, 3, 4):
        state = run(t)
    step = state.step
    with pytest.raises(ScanBudgetError, match="past the budget of 4"):
        run(5)
    assert state.step == step
    state = run(2)


def test_host_tier_tables_refuse_the_scans():
    spec = deepfm.model_spec(**dict(_DFM, host_tier=True))
    tr = Trainer(spec, device="cpu")
    assert "host-tier" in tr.scan_unsupported()
    state = tr.init_state(0)
    with pytest.raises(NotImplementedError, match="host-tier"):
        tr.train_scan(state, {"labels": torch.zeros((2, 4))})


def test_a_failing_step_inside_the_scan_raises_train_loop_error():
    tr = Trainer(tlm.model_spec(**_LM), device="cpu")
    state = tr.init_state(0)
    stacked = tr.shard_stacked_batch(_lm_stacked())
    stacked["tokens"][1].fill_(VOCAB + 7)  # an id past the vocabulary
    with pytest.raises(TrainLoopError):
        tr.train_scan(state, stacked)


# ---- the worker's routing --------------------------------------------------------


MB = 8


def _lm_file(tmp_path, n):
    path = str(tmp_path / "train.rio")
    generate("lm", path, n, seed=0, seq_len=SEQ, vocab=VOCAB)
    return path


def _worker(path, spec=None, **cfg):
    cfg = dict(dict(model_def="transformer_lm.model_spec"), **cfg)
    config = JobConfig(training_data=path, minibatch_size=MB, task_pipelining=False, **cfg)
    worker = Worker(config, master=None, reader=create_data_reader(path),
                    spec=spec or tlm.model_spec(**_LM), device="cpu")
    worker.state = worker.trainer.init_state(0)
    return worker


def _spy(worker):
    """The worker's calls into its trainer, by method: each call's leading
    batch size (the steps of a scan, the examples of a step).  A scan runs
    its steps through the trainer's unwrapped step, so they are not seen
    here."""
    calls = {"train_scan": [], "train_step": [], "eval_scan": [], "eval_step": []}
    tr = worker.trainer
    for name in calls:
        orig = getattr(tr, name)

        def wrapped(*args, _orig=orig, _name=name):
            calls[_name].append(next(iter(args[1].values())).shape[0])
            return _orig(*args)

        setattr(tr, name, wrapped)
    return calls


def test_worker_runs_one_train_scan_a_task_and_one_step_for_the_tail(tmp_path):
    """A task of 2 full minibatches and a tail of 5 records: one
    ``train_scan`` of 2 steps and one (masked) ``train_step``; the reported
    metrics are the mean over the 3 steps, as the per-step path's."""
    path = _lm_file(tmp_path, 2 * MB + 5)
    task = Task(task_id=0, shard=Shard(name=path, start=0, end=2 * MB + 5))
    fused = _worker(path)
    calls = _spy(fused)
    got = fused._run_training_task(task)
    assert calls["train_scan"] == [2] and calls["train_step"] == [MB]
    assert fused.state.step == 3
    per_step = _worker(path, fused_task_scan=False)
    pcalls = _spy(per_step)
    want = per_step._run_training_task(task)
    assert pcalls["train_scan"] == [] and len(pcalls["train_step"]) == 3
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == want[k], k
    for a, b in zip(fused.state.model.parameters(), per_step.state.model.parameters()):
        assert torch.equal(a, b)


def test_worker_fused_eval_runs_one_eval_scan_and_a_masked_tail(tmp_path):
    path = _lm_file(tmp_path, 3 * MB + 3)
    task = Task(task_id=0, shard=Shard(name=path, start=0, end=3 * MB + 3),
                type=TASK_EVALUATION)
    fused = _worker(path)
    calls = _spy(fused)
    metrics, weight = fused._run_evaluation_task(task)
    assert calls["eval_scan"] == [3] and calls["eval_step"] == [MB]
    per_step = _worker(path, fused_task_scan=False)
    pcalls = _spy(per_step)
    want, want_weight = per_step._run_evaluation_task(task)
    assert pcalls["eval_scan"] == [] and len(pcalls["eval_step"]) == 4
    assert weight == want_weight == 3 * MB + 3
    assert sorted(metrics) == sorted(want)
    for k in want:
        np.testing.assert_allclose(metrics[k], want[k], rtol=1e-6, err_msg=k)


def test_worker_keeps_the_per_step_path_with_host_tier_tables(tmp_path):
    from elasticdl_tpu_torch.data.synthetic import synthetic_criteo

    path = str(tmp_path / "criteo.rio")
    synthetic_criteo(path, 2 * MB + 3, seed=11, container="recordio")
    spec = deepfm.model_spec(**dict(_DFM, host_tier=True))
    worker = _worker(path, spec=spec, model_def="deepfm.model_spec")
    assert "host-tier" in worker._fused_eligible()
    calls = _spy(worker)
    worker._run_training_task(Task(task_id=0, shard=Shard(name=path, start=0, end=2 * MB + 3)))
    assert calls["train_scan"] == [] and len(calls["train_step"]) == 3


def test_worker_takes_the_fused_path_in_gang_mode(tmp_path):
    """Gang mode scans as alone: the choice reads only the flag and the
    trainer (the gang's process tests run it: tests/test_torch_gang.py)."""
    path = _lm_file(tmp_path, MB)
    worker = _worker(path)
    assert worker._fused_eligible() is None and worker._fused_path()
    worker._group_mode = True
    assert worker._fused_eligible() is None and worker._fused_path()


def test_worker_keeps_the_per_step_path_without_the_flag(tmp_path):
    path = _lm_file(tmp_path, MB)
    for group_mode in (False, True):
        worker = _worker(path, fused_task_scan=False)
        worker._group_mode = group_mode
        assert worker._fused_eligible() == "--fused_task_scan=False"
        assert not worker._fused_path()


# ---- the optimizer a graph replays -----------------------------------------------


@pytest.mark.parametrize("make,capturable", [
    (lambda ps: torch.optim.Adam(ps, lr=1e-3), True),
    (lambda ps: torch.optim.AdamW(ps, lr=1e-3), True),
    (lambda ps: torch.optim.SGD(ps, lr=0.1, momentum=0.9), False),
], ids=["adam", "adamw", "sgd"])
def test_the_trainer_on_the_card_makes_the_models_own_optimizer_capturable(make, capturable):
    """A model's own plain ``torch.optim.Adam`` (the ``zoo init``
    template's) is made capturable in every group by the trainer that
    captures its update on the card; on the CPU it is left as made.  SGD
    has no such option and needs none."""
    spec = dataclasses.replace(mnist.model_spec(compute_dtype="float32"), optimizer=make)
    tr = Trainer(spec, device="cpu")
    model = tr.init_state(0).model
    assert not any(g.get("capturable") for g in tr._make_optimizer(model).param_groups)
    tr.device = torch.device("cuda")  # only the choice: nothing runs on a card
    opt = tr._make_optimizer(model)
    assert all(bool(g.get("capturable")) is capturable for g in opt.param_groups)
    assert bool(opt.defaults.get("capturable")) is capturable
    make_capturable(opt)  # twice is once
    assert all(bool(g.get("capturable")) is capturable for g in opt.param_groups)


def _zoo_template(tmp_path, monkeypatch):
    """The ``zoo init`` template's spec (its own plain ``torch.optim.Adam``)
    fed by the port's MNIST records."""
    from elasticdl_tpu_torch.client import zoo
    from elasticdl_tpu_torch.models.spec import load_model_spec

    zoo.zoo_init(str(tmp_path / "fused_zoo"))
    monkeypatch.syspath_prepend(str(tmp_path))
    try:
        spec = load_model_spec("fused_zoo", "template.model_spec")
    finally:
        for name in [m for m in sys.modules if m.split(".")[0] == "fused_zoo"]:
            del sys.modules[name]
    return dataclasses.replace(spec, feed=mnist.model_spec().feed)


def test_worker_trains_the_zoo_template_on_the_fused_path(tmp_path, monkeypatch):
    """The ``zoo init`` template through the worker's default path: one
    ``train_scan`` a task and the tail step, equal to the per-step path."""
    spec = _zoo_template(tmp_path, monkeypatch)
    path = str(tmp_path / "mnist.rio")
    generate("mnist", path, 2 * MB + 3, seed=3)
    task = Task(task_id=0, shard=Shard(name=path, start=0, end=2 * MB + 3))
    fused = _worker(path, spec=spec, model_def="template.model_spec")
    calls = _spy(fused)
    got = fused._run_training_task(task)
    assert calls["train_scan"] == [2] and calls["train_step"] == [MB]
    per_step = _worker(path, spec=spec, model_def="template.model_spec", fused_task_scan=False)
    want = per_step._run_training_task(task)
    assert got == want
    for a, b in zip(fused.state.model.parameters(), per_step.state.model.parameters()):
        assert torch.equal(a, b)
