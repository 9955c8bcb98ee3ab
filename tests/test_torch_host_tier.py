"""The PyTorch port's host tier against the JAX package's: the native
embedding store (``ps/host_store.py``), host-tier DeepFM
(``models/deepfm.py``, ``host_tier=True``) and the trainer's host half
(``parallel/trainer.py``: pull, inject, push, ``use_async``, the host-store
checkpoints), and the worker's torn-checkpoint walk.

Width: ``buckets_per_feature=512, embedding_dim=4, hidden=(16,)``, f32
compute, batches of 64 made from a seed with numpy.  The JAX side runs its
``Trainer`` on one CPU device, as its own tests do; the weights carry into
the port by ``params_from_jax`` and the rows by the native store's file.

Tolerances:
- the store: both packages run the same C++, so pulls and files are equal
  bit for bit;
- training: each step's loss rtol 1e-5; the touched rows after 4 steps
  atol 1e-6 at ``learning_rate=1e-4`` (measured: at most 2.4e-7).  At the
  model's default 1e-3 the rows agree to 5e-5 (measured: at most 1.1e-5):
  the store's adagrad (lr 10x the model's) moves a row by about
  lr * g / (|g| + eps), so an entry whose few gradients nearly cancel turns
  the f32 summation order of the two backwards (gradients equal to 1.2e-7
  of their largest) into a visible fraction of a step;
- the host-tier forward against the device-tier forward on the same rows:
  rtol 1e-6 / atol 1e-6.
"""

import os

import jax
import numpy as np
import pytest
import torch

import elasticdl_tpu.parallel  # noqa: F401  (the JAX package's own import order)
from elasticdl_tpu.common.config import JobConfig as JaxJobConfig
from elasticdl_tpu.models import deepfm as jdeepfm
from elasticdl_tpu.parallel.mesh import create_mesh
from elasticdl_tpu.parallel.trainer import Trainer as JaxTrainer
from elasticdl_tpu.ps import host_store as jhost_store
from elasticdl_tpu_torch.common.config import JobConfig
from elasticdl_tpu_torch.data import codecs
from elasticdl_tpu_torch.models import deepfm
from elasticdl_tpu_torch.parallel.trainer import Trainer, TrainLoopError
from elasticdl_tpu_torch.ps import host_store

from _torch_reference_native import reference_native  # noqa: F401  (a fixture)

WIDTH = dict(buckets_per_feature=512, embedding_dim=4, hidden=(16,), compute_dtype="float32")
KEY = deepfm.HOST_FM_KEY
B, STEPS = 64, 4
LOSS_RTOL = 1e-5
ROW_ATOL, ROW_ATOL_DEFAULT_LR = 1e-6, 5e-5


def _batches(n=STEPS, seed=0, b=B):
    rng = np.random.default_rng(seed)
    return [{
        "dense": rng.uniform(0, 100, (b, 13)).astype(np.float32),
        "cat": rng.integers(-(1 << 31), 1 << 31, (b, 26)).astype(np.int32),
        "labels": rng.integers(0, 2, (b,)).astype(np.int32),
    } for _ in range(n)]


def _specs(**kw):
    kw = dict(WIDTH, host_tier=True, **kw)
    return jdeepfm.model_spec(**kw), deepfm.model_spec(**kw)


def _jax_trainer(jspec, **cfg):
    return JaxTrainer(jspec, JaxJobConfig(**cfg), create_mesh(jax.devices()[:1]))


def _ids(spec, batches):
    return np.unique(np.concatenate([spec.host_io[KEY].ids_fn(b).ravel() for b in batches]))


# ---- the store ----

@pytest.mark.parametrize("optimizer", ["sgd", "momentum", "adam", "adagrad"])
@pytest.mark.usefixtures("reference_native")
def test_store_matches_the_reference_store_and_files_cross(tmp_path, optimizer):
    """The same pushes into both packages' stores give the same rows, bit for
    bit, and a file saved by either loads into the other."""
    rng = np.random.default_rng(1)
    kw = dict(dim=5, optimizer=optimizer, learning_rate=0.05, init_scale=0.02)
    ours, theirs = host_store.HostEmbeddingStore(**kw), jhost_store.HostEmbeddingStore(**kw)
    ids = rng.integers(-(1 << 40), 1 << 40, 300).astype(np.int64)
    assert np.array_equal(ours.pull(ids), theirs.pull(ids))
    for _ in range(3):
        push = np.concatenate([ids[:200], ids[:50]])  # duplicates accumulate
        grads = rng.standard_normal((push.size, 5)).astype(np.float32)
        ours.push_grad(push, grads)
        theirs.push_grad(push, grads)
    assert np.array_equal(ours.pull(ids), theirs.pull(ids))
    assert len(ours) == len(theirs) == np.unique(ids).size
    rows, missing = ours.try_pull(np.concatenate([ids[:4], [7, 8]]))
    assert missing == 2 and np.array_equal(rows[:4], theirs.pull(ids[:4]))
    for src, dst_cls, name in ((ours, jhost_store.HostEmbeddingStore, "port.bin"),
                               (theirs, host_store.HostEmbeddingStore, "jax.bin")):
        path = str(tmp_path / name)
        assert src.save(path) == len(src)
        dst = dst_cls(**kw)
        assert dst.load(path) == len(src)
        assert np.array_equal(dst.pull(ids), src.pull(ids))
    wrong = host_store.HostEmbeddingStore(**dict(kw, dim=4))
    with pytest.raises(ValueError, match="mismatch"):
        wrong.load(str(tmp_path / "jax.bin"))
    ours.close()
    with pytest.raises(RuntimeError, match="closed"):
        ours.pull(ids)


def test_store_without_the_native_library_raises(monkeypatch):
    """No fallback: a library that does not build makes the store raise."""
    monkeypatch.setattr(host_store, "_lib", None)
    monkeypatch.setattr(host_store, "_lib_error", "native lib unavailable: g++ failed")
    with pytest.raises(RuntimeError, match="native lib unavailable"):
        host_store.HostEmbeddingStore(dim=4)


# ---- the model ----

def test_pipeline_preprocess_auto_picks_the_raw_feed_for_the_host_tier():
    """The host tier's pulls hash the raw 32-bit ids, so ``"auto"`` must not
    hand it the preprocessed feed's uint16 bucket ids, at any bucket count;
    an explicit True is refused, as the reference's resolution does."""
    for buckets in (512, 65536):
        spec = deepfm.model_spec(buckets_per_feature=buckets, host_tier=True)
        jspec = jdeepfm.model_spec(buckets_per_feature=buckets, host_tier=True)
        assert spec.feed is codecs.criteo_feed
        assert spec.example_batch(2)["cat"].dtype == jspec.example_batch(2)["cat"].dtype
    with pytest.raises(ValueError, match="pipeline_preprocess"):
        deepfm.model_spec(host_tier=True, pipeline_preprocess=True)
    # "auto" promotes the full-width table (27,262,976 rows) to the host tier.
    auto = deepfm.model_spec(buckets_per_feature=1 << 20)
    assert sorted(auto.host_io) == [KEY] and not auto.embedding_tables
    assert auto.feed is codecs.criteo_feed
    io, jio = auto.host_io[KEY], jdeepfm.model_spec(buckets_per_feature=1 << 20,
                                                   host_tier=True).host_io[KEY]
    assert (io.dim, io.optimizer, io.learning_rate, io.init_scale) == (
        jio.dim, jio.optimizer, jio.learning_rate, jio.init_scale)


def test_host_ids_match_the_reference():
    jspec, spec = _specs()
    for batch in _batches(2, seed=3):
        assert np.array_equal(spec.host_io[KEY].ids_fn(batch), jspec.host_io[KEY].ids_fn(batch))


def test_params_carry_both_ways_for_the_host_tier():
    jspec, _ = _specs()
    tree = jax.device_get(jspec.init(jax.random.key(0)))
    assert "fm_table" not in tree
    model = deepfm.params_from_jax(tree, 512, 4, "float32", device="cpu")
    assert model.host_tier and not hasattr(model, "fm_table")
    back = deepfm.params_to_jax(model)
    assert sorted(back) == sorted(tree)
    np.testing.assert_array_equal(back["mlp"]["layer0"]["w"], tree["mlp"]["layer0"]["w"])
    device_tree = jax.device_get(jdeepfm.model_spec(**dict(WIDTH, host_tier=False))
                                 .init(jax.random.key(0)))
    with pytest.raises(ValueError, match="fm_table"):
        model.load_jax_params(device_tree)


def test_host_tier_forward_equals_the_device_tier_forward():
    """The same rows as a device table and as injected host rows give the
    same logits (the reference's host-vs-device forward check)."""
    from elasticdl_tpu_torch.ops.embedding import pack_table

    _, host_spec = _specs()
    dev_spec = deepfm.model_spec(**dict(WIDTH, host_tier=False, pipeline_preprocess=False))
    trainer = Trainer(host_spec, device="cpu")
    state = trainer.init_state(0)
    vocab = 26 * 512
    logical = trainer._host_stores[KEY].pull(np.arange(vocab, dtype=np.int64))
    dev_model = dev_spec.init(seed=None, device="cpu")
    tree = deepfm.params_to_jax(state.model)
    tree["fm_table"] = pack_table(torch.from_numpy(logical), 5).numpy()
    dev_model.load_jax_params(tree)
    batch = _batches(1, seed=4)[0]
    host_out = trainer.run_predict_step(state.model, batch)
    dev_out = Trainer(dev_spec, device="cpu").run_predict_step(dev_model, batch)
    assert host_out.shape == (B,)
    np.testing.assert_allclose(host_out.numpy(), dev_out.numpy(), rtol=1e-6, atol=1e-6)
    metrics = trainer.run_eval_step(state, batch)
    assert np.isfinite(float(metrics["loss"]))


# ---- training against the JAX trainer ----

def _run_both(tmp_path, use_async, depth, learning_rate, batches):
    """JAX then the port over ``batches`` from the same weights and rows:
    the JAX init carried by ``params_from_jax``, its store's rows of the
    batches' ids by the native file (``save_host_stores`` ->
    ``restore_host_stores``)."""
    jspec, spec = _specs(learning_rate=learning_rate)
    jt = _jax_trainer(jspec, async_staleness=depth)
    jstate = jt.init_state(jax.random.key(0))
    params = jax.device_get(jstate.params)
    ids = _ids(spec, batches)
    jt._host_stores[KEY].pull(ids)
    jt.save_host_stores(str(tmp_path), 0)
    jstate, jmetrics = jt.run_train_steps(jstate, batches, use_async=use_async)

    trainer = Trainer(spec, device="cpu", config=JobConfig(async_staleness=depth))
    state = trainer.init_state(None)
    state.model.load_jax_params(params)
    assert trainer.restore_host_stores(str(tmp_path), 0)
    assert len(trainer._host_stores[KEY]) == ids.size
    state, metrics = trainer.run_train_steps(state, batches, use_async=use_async)
    return ([float(m["loss"]) for m in jmetrics], [float(m["loss"]) for m in metrics],
            jt._host_stores[KEY].pull(ids), trainer._host_stores[KEY].pull(ids), state)


@pytest.mark.parametrize("use_async,depth", [(False, 1), (True, 1), (True, 2)],
                         ids=["sync", "async1", "async2"])
@pytest.mark.usefixtures("reference_native")
def test_host_tier_training_matches_jax(tmp_path, use_async, depth):
    jl, tl, jrows, rows, state = _run_both(tmp_path, use_async, depth, 1e-4, _batches())
    assert state.step == STEPS
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    np.testing.assert_allclose(rows, jrows, rtol=0, atol=ROW_ATOL)


@pytest.mark.usefixtures("reference_native")
def test_host_tier_training_matches_jax_at_the_default_learning_rate(tmp_path):
    jl, tl, jrows, rows, _ = _run_both(tmp_path, True, 2, 1e-3, _batches())
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    np.testing.assert_allclose(rows, jrows, rtol=0, atol=ROW_ATOL_DEFAULT_LR)
    assert np.abs(rows - jrows).max() > 0  # the two backwards do differ


def test_single_batch_async_equals_sync():
    """One batch leaves nothing to overlap: async is the sync order, bit for
    bit (losses and rows)."""
    _, spec = _specs()
    out = []
    for use_async in (False, True):
        trainer = Trainer(spec, device="cpu", config=JobConfig())
        state, metrics = trainer.run_train_steps(trainer.init_state(0), _batches(1),
                                                 use_async=use_async)
        out.append((float(metrics[0]["loss"]),
                    trainer._host_stores[KEY].pull(_ids(spec, _batches(1)))))
    assert out[0][0] == out[1][0]
    assert np.array_equal(out[0][1], out[1][1])


def test_async_pulls_read_rows_one_push_stale(monkeypatch):
    """The order of pulls and pushes: at depth D the pull of step n sees the
    pushes of steps up to n - D - 1; in sync mode every earlier one."""
    _, spec = _specs()
    for use_async, depth, want in ((False, 1, [0, 1, 2, 3]), (True, 1, [0, 0, 1, 2]),
                                   (True, 2, [0, 0, 0, 1])):
        trainer = Trainer(spec, device="cpu", config=JobConfig(async_staleness=depth))
        store = trainer._host_stores[KEY]
        pushes, seen = [], []
        orig_pull, orig_push = store.pull, store.push_grad
        monkeypatch.setattr(store, "pull", lambda ids, f=orig_pull: (seen.append(len(pushes)), f(ids))[1])
        monkeypatch.setattr(store, "push_grad",
                            lambda ids, g, f=orig_push: (pushes.append(1), f(ids, g))[1])
        trainer.run_train_steps(trainer.init_state(0), _batches(), use_async=use_async)
        assert seen == want and len(pushes) == STEPS, (use_async, depth, seen)


def test_failed_pull_and_push_fail_the_loop(monkeypatch):
    """A failed pull or push is never skipped: it raises ``TrainLoopError``.
    A pull that fails before its step leaves the last completed step's
    state (the outstanding pushes landed first); a failed push leaves none."""
    _, spec = _specs()
    trainer = Trainer(spec, device="cpu", config=JobConfig())
    store = trainer._host_stores[KEY]
    calls = {"pull": 0}
    orig = store.pull

    def flaky_pull(ids):
        calls["pull"] += 1
        if calls["pull"] == 3:
            raise ConnectionError("PS shard lost")
        return orig(ids)

    monkeypatch.setattr(store, "pull", flaky_pull)
    pushed = []
    orig_push = store.push_grad
    monkeypatch.setattr(store, "push_grad", lambda ids, g: (pushed.append(1), orig_push(ids, g))[1])
    with pytest.raises(TrainLoopError) as err:
        trainer.run_train_steps(trainer.init_state(0), _batches(), use_async=True)
    assert err.value.state is not None and err.value.state.step == 2 and len(pushed) == 2
    monkeypatch.setattr(store, "pull", orig)
    monkeypatch.setattr(store, "push_grad", lambda ids, g: (_ for _ in ()).throw(IOError("disk")))
    with pytest.raises(TrainLoopError) as err:
        trainer.run_train_steps(trainer.init_state(0), _batches(2))
    assert err.value.state is None and isinstance(err.value.cause, IOError)


# ---- checkpoints ----

@pytest.mark.usefixtures("reference_native")
def test_host_store_checkpoint_roundtrip_retention_and_torn_steps(tmp_path):
    _, spec = _specs()
    trainer = Trainer(spec, device="cpu", config=JobConfig())
    state = trainer.init_state(0)
    batches = _batches(3)
    state, _ = trainer.run_train_steps(state, batches)
    ids = _ids(spec, batches)
    before = trainer._host_stores[KEY].pull(ids)
    for step in (1, 2, 3, 4, 5):
        trainer.save_host_stores(str(tmp_path), step, keep_max=3)
    assert sorted(os.listdir(tmp_path / "host_stores")) == ["3", "4", "5"]
    assert os.listdir(tmp_path / "host_stores" / "5") == [f"{KEY}.bin"]
    # The port's file restores into the JAX trainer and back.
    jspec, _ = _specs()
    jt = _jax_trainer(jspec)
    assert jt.restore_host_stores(str(tmp_path), 5)
    np.testing.assert_array_equal(jt._host_stores[KEY].pull(ids), before)
    jt.save_host_stores(str(tmp_path / "jax"), 7)
    fresh = Trainer(spec, device="cpu", config=JobConfig())
    assert fresh.restore_host_stores(str(tmp_path / "jax"), 7)
    np.testing.assert_array_equal(fresh._host_stores[KEY].pull(ids), before)
    # A missing snapshot is a torn checkpoint and raises; an unreadable
    # file re-initialises the stores.
    with pytest.raises(FileNotFoundError, match="torn"):
        fresh.restore_host_stores(str(tmp_path), 99)
    with open(tmp_path / "host_stores" / "4" / f"{KEY}.bin", "r+b") as f:
        f.truncate(40)
    with pytest.raises(FileNotFoundError, match="unreadable"):
        fresh.restore_host_stores(str(tmp_path), 4)
    assert len(fresh._host_stores[KEY]) == 0


def test_torn_checkpoint_falls_back_to_the_older_step(tmp_path):
    """A crash can commit the dense half of step N without its host-store
    snapshot: the worker's join walks back to the newest intact pair."""
    import shutil

    from elasticdl_tpu_torch.common.checkpoint import CheckpointManager
    from elasticdl_tpu_torch.master.servicer import MasterServicer
    from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
    from elasticdl_tpu_torch.worker.worker import DirectMasterProxy, Worker

    _, spec = _specs()
    ckpt_dir = str(tmp_path / "ckpt")
    trainer = Trainer(spec, device="cpu", config=JobConfig())
    state = trainer.init_state(0)
    ckpt = CheckpointManager(ckpt_dir)
    batch = _batches(1)[0]
    for step in (1, 2):
        state, _ = trainer.run_train_step(state, batch)
        ckpt.save(step, trainer.host_state(state), wait=True)
        trainer.save_host_stores(ckpt_dir, step)
    shutil.rmtree(tmp_path / "ckpt" / "host_stores" / "2")
    fallback = Trainer(spec, device="cpu", config=JobConfig())
    assert fallback.restore_host_stores(ckpt_dir, 1)
    rows1 = fallback._host_stores[KEY].pull(_ids(spec, [batch]))

    servicer = MasterServicer(TaskDispatcher([]))  # no tasks: join, then exit
    worker = Worker(JobConfig(checkpoint_dir=ckpt_dir), DirectMasterProxy(servicer),
                    reader=None, worker_id="w0", spec=spec, device="cpu")
    result = worker.run()
    assert result["step"] == 1  # the intact step, not 2, not 0
    np.testing.assert_array_equal(
        worker.trainer._host_stores[KEY].pull(_ids(spec, [batch])), rows1)
