"""The ``(dp, tp)`` mesh of the port and the tensor-parallel job.

1. ``create_mesh(tensor_parallelism=)`` lays ranks out as the reference's
   ``reshape(-1, tp)`` lays devices out (``tp`` consecutive ranks a row);
   ``mesh_shape`` reads ``(dp, tp)``.
2. The leftover-rank rule: ``resolve_world_shape`` is the reference's
   ``resolve_2d_shape`` whenever that fills the world; otherwise ``tp``
   degrades along its divisors to one that divides the world (a port rank
   cannot sit out of its world).  A spawned world of 3 at
   ``tensor_parallelism=2`` trains on ``{dp: 3}`` and matches one process.
3. The CLI's local mode with ``--multihost --num_workers=2
   --tensor_parallelism=2`` on the CPU: both ranks on ``(dp 1, tp 2)``,
   every task done once, an eval round, equal state digests at each
   checkpoint, the epoch's step count at the end, the worker publishing
   ``edl_mesh_shape``.
"""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from elasticdl_tpu.parallel.mesh import resolve_2d_shape as jax_resolve_2d_shape
from elasticdl_tpu_torch.common import gauge
from elasticdl_tpu_torch.common.checkpoint import CheckpointManager, read_manifest
from elasticdl_tpu_torch.common.config import JobConfig
from elasticdl_tpu_torch.data.synthetic import generate
from elasticdl_tpu_torch.models import transformer_lm as tlm
from elasticdl_tpu_torch.parallel import mesh as tmesh
from elasticdl_tpu_torch.parallel.trainer import Trainer
from elasticdl_tpu_torch.worker.worker import Worker

from _torch_gloo_ranks import free_port, lm_mesh_runs, run_ranks

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT_S = 120.0
LM = dict(vocab=128, dim=32, n_heads=4, n_layers=2, max_seq=32, seq_len=32,
          compute_dtype="float32", parallelism="tensor")


def test_tp_mesh_lays_ranks_out_as_the_reference():
    shape = {"dp": 2, "tp": 2}
    for rank in range(4):
        m = tmesh.Mesh(shape, rank=rank)
        assert (m.position("dp"), m.position("tp")) == divmod(rank, 2)
        assert m.line(("tp",)) == [2 * (rank // 2), 2 * (rank // 2) + 1]
        assert m.line(("dp",)) == [rank % 2, rank % 2 + 2]
    assert tmesh.mesh_shape(tmesh.Mesh(shape)) == (2, 2)
    assert tmesh.mesh_shape(tmesh.Mesh({"dp": 4})) == (4, 1)
    assert tmesh.mesh_shape(tmesh.Mesh({"dp": 2, "ep": 2})) == (4, 1)
    one = tmesh.create_mesh(tensor_parallelism=1, world=(1, 0, None))
    assert one.shape == {"dp": 1}
    with pytest.raises(ValueError, match="does not divide"):
        tmesh.create_mesh(tensor_parallelism=3, world=(4, 0, None))
    with pytest.raises(ValueError, match="mutually exclusive"):
        tmesh.create_mesh(dcn_parallelism=2, tensor_parallelism=2, world=(4, 0, None))


def test_resolve_world_shape_keeps_the_reference_shape_when_it_fills_the_world():
    for n in range(1, 13):
        for tp in range(1, 9):
            dp, got_tp = tmesh.resolve_world_shape(n, tp)
            assert dp * got_tp == n and tp % got_tp == 0, (n, tp)
            ref = jax_resolve_2d_shape(n, tp)
            if ref[0] * ref[1] == n:
                assert (dp, got_tp) == ref, (n, tp)
            else:
                # The largest divisor of the configured degree that divides n.
                assert got_tp == max(d for d in range(1, tp + 1) if tp % d == 0 and n % d == 0)
    assert tmesh.resolve_world_shape(3, 2) == (3, 1)
    assert tmesh.resolve_world_shape(6, 4) == (3, 2)
    assert tmesh.resolve_world_shape(8, 4) == (2, 4)


def _batches(n=2, size=6):
    rng = np.random.default_rng(7)
    out = []
    for _ in range(n):
        toks = rng.integers(0, LM["vocab"], size=(size, LM["seq_len"] + 1)).astype(np.int32)
        out.append({"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    return out


def test_a_world_of_3_at_tp_2_trains_on_dp_3():
    single = Trainer(tlm.model_spec(**LM), device="cpu")
    state = single.init_state(0)
    params = {k: {b: {n: np.array(a) for n, a in blk.items()} for b, blk in v.items()}
              if k == "blocks" else np.array(v) for k, v in tlm.params_to_jax(state.model).items()}
    losses = []
    for batch in _batches():
        state, m = single.run_train_step(state, batch)
        losses.append(float(m["loss"]))
    ranks = run_ranks(lm_mesh_runs, 3, [dict(model=LM, manager=dict(tensor_parallelism=2),
                                             params=params, batches=_batches())])
    for r in ranks:
        out = r[0]
        assert out["shape"] == {"dp": 3}
        np.testing.assert_allclose([float(m["loss"]) for m in out["metrics"]], losses,
                                   rtol=1e-5, atol=1e-6)
        for key, value in ranks[0][0]["host"].items():
            assert np.array_equal(out["host"][key], value), key


def test_worker_publishes_the_mesh_shape(tmp_path):
    config = JobConfig(model_def="transformer_lm.model_spec", checkpoint_dir=str(tmp_path))
    worker = Worker(config, master=None, reader=None, spec=tlm.model_spec(**LM), device="cpu",
                    gauges=gauge.Registry(enabled=True),
                    mesh=tmesh.Mesh({"dp": 1, "tp": 2}, rank=1))
    worker._collect_gauges()
    snap = worker.gauges.snapshot()
    shape = {s["labels"]["axis"]: s["value"] for s in snap["edl_mesh_shape"]["samples"]}
    assert shape == {"dp": 1.0, "tp": 2.0}
    assert worker.trainer.tp_size == 2


# ---- the CLI job ----------------------------------------------------------------------

MODEL_PARAMS = ("vocab=512;dim=64;n_heads=4;n_layers=2;max_seq=64;seq_len=64;"
                "compute_dtype=float32;parallelism=tensor")


def _events(text, kind):
    return [json.loads(line[len("[worker-event] "):]) for line in text.splitlines()
            if line.startswith("[worker-event] ")
            and json.loads(line[len("[worker-event] "):])["event"] == kind]


@pytest.fixture
def cpu_gang(monkeypatch):
    monkeypatch.setenv("ELASTICDL_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("ELASTICDL_STATE_DIGEST", "1")
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [_REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    monkeypatch.delenv("GRAFT_CHAOS", raising=False)
    monkeypatch.delenv("ELASTICDL_TORCH_DIST_BACKEND", raising=False)


def test_cli_job_with_tensor_parallelism(tmp_path, cpu_gang):
    train, val = str(tmp_path / "train.rio"), str(tmp_path / "val.rio")
    generate("lm", train, 128, seed=0, seq_len=64, vocab=512)
    generate("lm", val, 20, seed=1, seq_len=64, vocab=512)
    ckpt, pods = str(tmp_path / "ckpt"), str(tmp_path / "pods")
    job = "tpgang"
    cmd = [sys.executable, "-m", "elasticdl_tpu_torch.client.main", "train", "--local",
           f"--job_name={job}", "--model_def=transformer_lm.model_spec",
           f"--model_params={MODEL_PARAMS}", f"--training_data={train}",
           f"--validation_data={val}", "--minibatch_size=8", "--num_minibatches_per_task=2",
           "--evaluation_steps=8", f"--checkpoint_dir={ckpt}", "--checkpoint_steps=4",
           f"--pod_log_dir={pods}", "--num_workers=2", "--multihost=true",
           "--tensor_parallelism=2", f"--coordinator_port={free_port()}"]
    proc = subprocess.run(cmd, cwd=_REPO, capture_output=True, text=True, timeout=WAIT_S)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = next(x for x in proc.stderr.splitlines() if "job finished: " in x)
    status = ast.literal_eval(line.split("job finished: ", 1)[1])
    assert status["finished"] and status["done"] == 8, status
    assert status["duplicate_done"] == 0 and status["abandoned"] == 0, status
    assert status["eval_rounds"] >= 1 and np.isfinite(status["eval_metrics"]["loss"])
    logs = {r: open(os.path.join(pods, f"{job}-worker-{r}.log")).read() for r in (0, 1)}
    gang = {r: _events(logs[r], "gang")[0] for r in logs}
    assert sorted(g["rank"] for g in gang.values()) == [0, 1]
    assert all(g["mesh"] == {"dp": 1, "tp": 2} for g in gang.values())
    assert all("-> mesh of 2 ranks (none -> dp1xtp2)" in text for text in logs.values())
    summaries = {r: _events(logs[r], "summary")[0] for r in logs}
    assert summaries[0]["tasks"] == summaries[1]["tasks"]
    assert all(s["state_bytes"]["sharded_state"] for s in summaries.values())
    assert all("tp:all_reduce" in s["collective_by_op"] for s in summaries.values())
    # One state: equal digests of the gathered state at every checkpoint.
    digests = {r: {e["step"]: e["digest"] for e in _events(logs[r], "checkpoint")} for r in logs}
    assert digests[0] == digests[1] and sorted(digests[0]) == [4, 8, 12, 16]
    # The epoch's steps, each trained once; the whole state restores into
    # a world of one.
    assert read_manifest(ckpt)["step"] == summaries[0]["step"] == 16
    params = dict(kv.split("=") for kv in MODEL_PARAMS.split(";"))
    one = Trainer(tlm.model_spec(**{k: (v if k in ("compute_dtype", "parallelism") else int(v))
                                    for k, v in params.items()}), device="cpu")
    assert one.adopt_restored(CheckpointManager(ckpt).restore()).step == 16
