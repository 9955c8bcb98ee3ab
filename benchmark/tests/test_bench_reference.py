"""The plain references against the port's models at a tiny size in
float32: one training step from the same weights on the same rows, the
rows decoded by the port from the files the benchmark writes."""


import numpy as np
import pytest
import torch

import generators
import harness
import records
from conftest import tiny_cell, tiny_deepfm_cell
from elasticdl_tpu_torch.common.config import JobConfig
from elasticdl_tpu_torch.data.recordio import RecordIOReader
from elasticdl_tpu_torch.models.spec import load_model_spec_for_job
from elasticdl_tpu_torch.parallel.trainer import Trainer


def _port(cfg, family, seed):
    job = JobConfig(model_def=cfg["model_def"], model_params=family.model_params(cfg),
                    learning_rate=cfg["learning_rate"], compute_dtype=cfg["compute_dtype"])
    trainer = Trainer(load_model_spec_for_job(job), device="cpu")
    state = trainer.init_state(None)
    family.load_into(state.model, family.make_weights(cfg, seed, trainer.device))
    return trainer, state


def _close(prog, ref):
    for group in ("params", "exp_avg"):
        for k, v in ref[group].items():
            assert torch.allclose(prog[group][k], v, rtol=1e-4, atol=1e-6), (group, k)


def test_lm_reference_matches_the_port(tmp_path):
    cell = tiny_cell("gpt2s-train")
    cfg, family = cell["cfg"], harness.family_of(cell["cfg"])
    rows = generators.lm_tokens(generators.rng_for(5, "t"), 4, cfg["seq_len"], cfg["vocab"], 0.1)
    path = str(tmp_path / "lm.rio")
    records.write_fixed(path, rows)
    trainer, state = _port(cfg, family, 5)
    batch = trainer.spec.feed(list(RecordIOReader(path).read_range(0, 4)))
    state, metrics, _ = trainer.train_step(state, trainer.shard_batch(batch))
    ref = family.reference(cfg, family.make_weights(cfg, 5, trainer.device), "fp32")
    loss = ref.step(torch.from_numpy(rows).long())
    assert float(metrics["loss"]) == pytest.approx(loss, rel=1e-6)
    _close(family.read_state(cfg, state.model, state.optimizer), ref.state())


def test_deepfm_reference_matches_the_port(tmp_path):
    cell = tiny_deepfm_cell()
    cfg, traffic = cell["cfg"], cell["traffic"]
    family = harness.family_of(cfg)
    data = family.make_data(cfg, dict(traffic, rows=512), 9, str(tmp_path), None)
    trainer, state = _port(cfg, family, 9)
    batch = trainer.spec.feed(RecordIOReader(data["train_path"]).read_range_packed(0, 512))
    state, metrics, _ = trainer.train_step(state, trainer.shard_batch(batch))
    ref = family.reference(cfg, family.make_weights(cfg, 9, trainer.device), "fp32")
    rows = family.device_rows(data, trainer.device)
    loss = family.run_reference(ref, rows, [(0, 512)], trainer.device)[0]
    assert float(metrics["loss"]) == pytest.approx(loss, rel=1e-6)
    _close(family.read_state(cfg, state.model, state.optimizer), ref.state())


def test_the_criteo_records_decode_to_the_generated_rows(tmp_path):
    cell = tiny_deepfm_cell()
    rows = generators.criteo_rows(11, "t", 3000, dict(cell["traffic"]["generator"], num_dense=13))
    path = str(tmp_path / "c.rio")
    records.write_criteo(path, **rows)
    from elasticdl_tpu_torch.data.codecs import criteo_feed_plain

    plain = criteo_feed_plain(list(RecordIOReader(path).read_range(0, 3000)))
    assert (plain["labels"] == rows["labels"]).all()
    assert (plain["dense"] == np.maximum(rows["dense"], 0)).all()
    assert (plain["cat"].view(np.uint32) == rows["cats"]).all()
    assert 0.15 < rows["labels"].mean() < 0.35


def test_the_same_seed_gives_the_same_rows_and_weights():
    cell = tiny_deepfm_cell()
    p = dict(cell["traffic"]["generator"], num_dense=13)
    a, b = (generators.criteo_rows(2**33 + 1, "train", 100, p) for _ in range(2))
    assert all((a[k] == b[k]).all() for k in a)
    family = harness.family_of(cell["cfg"])
    wa, wb = (family.make_weights(cell["cfg"], 2**33 + 1, "cpu") for _ in range(2))
    assert all(torch.equal(wa[k], wb[k]) for k in wa)
