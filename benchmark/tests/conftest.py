"""The benchmark's CPU tests: ``python -m pytest benchmark/tests`` from the
repo root. Tests that need the card carry the ``cuda`` marker and decide
inside the test whether there is one."""

import json
import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for path in (ROOT, BENCH):
    if path not in sys.path:
        sys.path.insert(0, path)


def tiny_cell(name: str, compute_dtype: str = "float32") -> dict:
    """A cell of ``BENCHMARK.json`` at a size a CPU test holds: the same
    family, traffic and limits, the widths cut."""
    import harness

    cell = harness.load_cell(name)
    cfg, traffic = dict(cell["cfg"]), dict(cell["traffic"])
    cfg.update(vocab=512, dim=64, n_heads=4, n_layers=2, seq_len=64, compute_dtype=compute_dtype)
    traffic.update(rows=256, minibatch_size=4, num_minibatches_per_task=2)
    return dict(cell, cfg=cfg, traffic=traffic)


def tiny_deepfm_cell(checkpointed: bool = False, compute_dtype: str = "float32") -> dict:
    """A ``deepfm`` cell at a size a CPU test holds: the family, its
    reference and the harness's evaluation and checkpoint checks, which no
    cell of ``BENCHMARK.json`` runs yet. ``checkpointed`` adds evaluation
    rounds and a checked checkpoint."""
    cfg = {"name": "deepfm-tiny", "family": "deepfm", "model_def": "deepfm.model_spec",
           "num_dense": 13, "num_categorical": 26, "embedding_dim": 4, "hidden": [16, 16],
           "buckets_per_feature": 512, "learning_rate": 0.001, "compute_dtype": compute_dtype,
           "limits": {"first_loss_gap": 0.0003, "loss_gap": 0.002, "grad_gap": 0.08,
                      "update_gap": 0.03, "eval_gap": 0.0006, "ckpt_update_gap": 0.15}}
    generator = {"cardinalities": [3, 10, 1000, 100000] * 6 + [50, 500], "id_law": "zipf",
                 "zipf_exponent": 1.1, "dense_log_mu": 1.0, "dense_log_sigma": 1.6,
                 "dense_missing": 0.2, "positive_rate": 0.25}
    traffic = {"rows": 8192, "val_rows": 0, "minibatch_size": 256, "num_minibatches_per_task": 2,
               "prep_depth": 2, "ingest_threads": 0, "generator": generator}
    if checkpointed:
        traffic.update(val_rows=512, checkpoint_steps=20, keep_checkpoint_max=2,
                       evaluation_steps=20, check_checkpoint=True)
    metrics = [{"name": "setup_s", "unit": "s"}]
    return {"name": cfg["name"], "chips": 1, "cfg": cfg, "traffic": traffic,
            "end_to_end": metrics, "per_layer": []}


@pytest.fixture
def bench_json():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)
