"""The PyTorch port's checkpoints: the canonical state on disk, the
published manifest both packages read, and the serving replica's hot
reload.

Round trips are bit-exact (``np.array_equal``): a checkpoint stores f32
arrays and restores them unchanged, and a step taken after a restore
equals the same step taken without one.  The served logits after a hot
reload equal the restored module's own forward exactly (same module
arithmetic on the same weights, f32 on the CPU).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from elasticdl_tpu.common import checkpoint as jax_checkpoint
from elasticdl_tpu_torch.common import checkpoint as ckpt
from elasticdl_tpu_torch.common.checkpoint import CheckpointManager, publish_manifest, read_manifest
from elasticdl_tpu_torch.models import transformer_lm as tlm
from elasticdl_tpu_torch.parallel.trainer import Trainer, TrainState, outputs_to_numpy
from elasticdl_tpu_torch.serving.client import ServingClient
from elasticdl_tpu_torch.serving.server import ServingServer

SEQ, VOCAB = 64, 512
_MODEL = dict(vocab=VOCAB, dim=64, n_heads=4, n_layers=2, max_seq=SEQ, seq_len=SEQ,
              compute_dtype="float32")


def _batch(seed, b=4):
    toks = np.random.default_rng(seed).integers(0, VOCAB, (b, SEQ + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _trained(steps=2, seed=0):
    trainer = Trainer(tlm.model_spec(**_MODEL), device="cpu")
    state = trainer.init_state(seed)
    for i in range(steps):
        state, _ = trainer.run_train_step(state, _batch(i))
    return trainer, state


def _assert_equal(a, b):
    assert sorted(a) == sorted(b)
    for key in a:
        assert a[key].dtype == b[key].dtype, key
        assert np.array_equal(a[key], b[key]), key


def test_save_restore_round_trip_is_bit_exact(tmp_path):
    trainer, state = _trained()
    saved = trainer.host_state(state)
    names = {k for k in saved if k.startswith("params/")}
    assert names == {"params/" + k for k in ("tok_emb", "pos_emb", "ln_f")} | {
        f"params/blocks/b{i}/{w}" for i in range(2)
        for w in ("ln1", "ln2", "wqkv", "wo", "w1", "w2")}
    assert int(saved["step"]) == 2 and int(saved["opt_state/count"]) == 2
    mgr = CheckpointManager(str(tmp_path), keep_max=3)
    mgr.save(2, saved, wait=True)
    restored = trainer.adopt_restored(mgr.restore(2))
    assert restored.step == 2
    _assert_equal(trainer.host_state(restored), saved)
    # The optimizer state came back too: one more step from each is equal.
    a, _ = trainer.run_train_step(state, _batch(9))
    b, _ = trainer.run_train_step(restored, _batch(9))
    _assert_equal(trainer.host_state(a), trainer.host_state(b))


def test_fresh_state_round_trips_with_zero_moments(tmp_path):
    trainer = Trainer(tlm.model_spec(**_MODEL), device="cpu")
    fresh = trainer.host_state(trainer.init_state(0))
    assert int(fresh["opt_state/count"]) == 0
    assert not any(fresh[k].any() for k in fresh if k.startswith("opt_state/mu/"))
    restored = trainer.adopt_restored(fresh, trainer.init_state(1))
    _assert_equal(trainer.host_state(restored), fresh)
    assert not restored.optimizer.state  # count 0: torch's own empty state


def test_adopt_rejects_a_state_of_another_model():
    trainer, state = _trained(steps=1)
    arrays = trainer.host_state(state)
    other = Trainer(tlm.model_spec(**dict(_MODEL, n_layers=1)), device="cpu")
    with pytest.raises(ValueError, match="does not match the model"):
        other.adopt_restored(arrays)
    bad = dict(arrays, **{"params/tok_emb": arrays["params/tok_emb"][:, :8]})
    with pytest.raises(ValueError, match="shape"):
        trainer.adopt_restored(bad)


def test_keep_max_prunes_the_oldest_steps(tmp_path):
    trainer, state = _trained(steps=1)
    arrays = trainer.host_state(state)
    mgr = CheckpointManager(str(tmp_path), keep_max=2)
    for step in (1, 2, 3, 4):
        mgr.save(step, arrays)  # background writes, serialized
    mgr.wait()
    assert mgr.all_steps() == [4, 3]
    assert mgr.latest_step() == 4
    assert sorted(os.listdir(tmp_path)) == ["3", "4"]


def test_a_torn_step_directory_is_never_listed(tmp_path):
    trainer, state = _trained(steps=1)
    arrays = trainer.host_state(state)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(5, arrays, wait=True)
    # A write cut by a crash: its temporary directory, half written.
    torn = tmp_path / ".tmp-7-123-456"
    torn.mkdir()
    (torn / "params.tok_emb.npy").write_bytes(b"\x93NUMPY half an array")
    # A step directory without its index (arrays copied in by hand).
    (tmp_path / "9").mkdir()
    (tmp_path / "9" / "params.tok_emb.npy").write_bytes(b"\x93NUMPY")
    assert mgr.all_steps() == [5]
    with pytest.raises(FileNotFoundError):
        mgr.restore(9)
    with pytest.raises(FileNotFoundError):
        mgr.publish(7)
    _assert_equal(mgr.restore(), arrays)


def test_a_failed_background_save_surfaces_at_wait(tmp_path, monkeypatch):
    trainer, state = _trained(steps=1)
    mgr = CheckpointManager(str(tmp_path))

    def boom(f, array, allow_pickle=False):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt.np, "save", boom)
    mgr.save(3, trainer.host_state(state))
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    assert mgr.all_steps() == []
    assert os.listdir(tmp_path) == []  # the failed write's temporary directory is gone
    mgr.wait()  # the error is raised once


def test_publish_waits_for_the_write_in_flight(tmp_path, monkeypatch):
    trainer, state = _trained(steps=1)
    arrays = trainer.host_state(state)
    mgr = CheckpointManager(str(tmp_path))
    orig = mgr._write

    def slow(step, arrays):
        import time

        time.sleep(0.3)
        orig(step, arrays)

    monkeypatch.setattr(mgr, "_write", slow)
    mgr.save(4, arrays)
    assert read_manifest(str(tmp_path)) is None
    mgr.publish(4)  # waits out the write before naming the step
    assert read_manifest(str(tmp_path))["step"] == 4
    assert mgr.all_steps() == [4]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_reads_the_others_manifest(tmp_path, writer):
    publish = publish_manifest if writer == "port" else jax_checkpoint.publish_manifest
    read = jax_checkpoint.read_manifest if writer == "port" else read_manifest
    publish(str(tmp_path), 12, code_rev="abc", extra={"job": "lm"})
    m = read(str(tmp_path))
    assert m["step"] == 12 and m["code_rev"] == "abc" and m["job"] == "lm"
    assert sorted(m) == ["code_rev", "job", "published_utc", "step"]
    assert ckpt.MANIFEST_NAME == jax_checkpoint.MANIFEST_NAME


def test_replica_restores_and_hot_reloads_a_published_step(tmp_path):
    """A replica over a checkpoint directory serves the published step at
    start; a newer publish hot-reloads (and an older one too: the trainer
    is the source of truth), and Predict then equals the restored module's
    own forward exactly.  No restore draws fresh weights first."""
    base = tlm.model_spec(**_MODEL)
    seeds = []

    def init(seed, device=None):
        seeds.append(seed)
        return base.init(seed=seed, device=device)

    spec = dataclasses.replace(base, init=init)
    trainer, state = _trained(steps=1)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, trainer.host_state(state), wait=True)
    mgr.publish(1)
    state, _ = trainer.run_train_step(state, _batch(5))
    state, _ = trainer.run_train_step(state, _batch(6))
    server = ServingServer(spec, checkpoint_dir=str(tmp_path), max_batch=2,
                           batch_buckets=[1, 2], max_delay_ms=1, poll_interval_s=60.0,
                           device="cpu").start()
    client = ServingClient(server.address)
    try:
        client.wait_ready(10.0)
        assert server.live_step == 1
        tokens = _batch(11, b=2)["tokens"]

        def served():
            return client.predict_outputs({"tokens": tokens}, timeout_s=60.0)

        def forward(step):
            model = trainer.adopt_restored(
                mgr.restore(step), TrainState(0, base.init(seed=7, device="cpu"), None)
            ).model.eval()
            return outputs_to_numpy(trainer.run_predict_step(model, {"tokens": tokens}))

        before = served()
        assert np.array_equal(before, forward(1))
        # Step 3 published: the watcher's poll swaps it in.
        mgr.save(3, trainer.host_state(state), wait=True)
        mgr.publish(3)
        assert server._watcher.poke() is True
        assert server.live_step == 3 and server._watcher.applied_step() == 3
        after = served()
        assert np.array_equal(after, forward(3))
        assert not np.array_equal(after, before)
        info = client.model_info()
        assert info["step"] == 3 and info["reloads"] == 2  # startup + hot reload
        # Republishing the same step is no change; an older step is.
        mgr.publish(3)
        assert server._watcher.poke() is False
        mgr.publish(1)
        assert server._watcher.poke() is True and server.live_step == 1
        assert np.array_equal(served(), before)
        assert [r[0] for r in server.reload_log] == [1, 3, 1]
        assert seeds == [None, None, None]
    finally:
        client.close()
        server.stop(grace=0.5)


def test_replica_without_a_manifest_serves_the_newest_step(tmp_path):
    trainer, state = _trained(steps=2)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, trainer.host_state(state), wait=True)
    server = ServingServer(tlm.model_spec(**_MODEL), checkpoint_dir=str(tmp_path),
                           max_batch=2, device="cpu")
    try:
        assert server.live_step == 2
        live = server._live.state
        for name, p in state.model.named_parameters():
            assert torch.equal(dict(live.named_parameters())[name], p), name
    finally:
        server.stop(grace=0)
