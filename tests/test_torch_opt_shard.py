"""The sharded state of the port's trainer (``elasticdl_tpu_torch/parallel/trainer.py``)
against the JAX package's: the ParameterServer strategy's row-sharded
tables and the sharded (ZeRO-style) optimizer, with canonical checkpoints.

1. The flags take effect, without a process group: DeepFM under
   ``ParameterServer`` on ``{dp: 2}`` holds half the padded table rows a
   rank, ``--optimizer_sharding=sharded`` holds ``padded / 2`` flat moments
   a dense leaf, ``auto`` follows the size threshold as the reference's
   ``_resolve_opt_sharding`` counts it (sharded for ``transformer_lm`` at
   the GPT-2-small width, replicated for DeepFM under ParameterServer at the
   bench width, shapes from meta tensors), and values the port cannot
   honour raise.
2. The sharded optimizer matches the replicated one on 2- and 4-rank gloo
   worlds (tests/_torch_gloo_ranks.py), ``transformer_lm`` (2 layers, dim
   64) over ``(dp, ep=1)``, 3 steps: losses within 1e-6 and parameters at
   rtol 2e-6, atol 1e-7 (tests/test_trainer_allreduce.py's
   ``test_sharded_optimizer_matches_replicated``), optimizer bytes a rank
   at most ``1/n`` of the replicated ones plus padding.
3. A checkpoint of the 2-rank sharded world restores into a world of one
   and back into two, its moments carried bit for bit, never
   re-initialised (tests/test_elastic.py's
   ``test_sharded_moments_survive_2_4_2_reform`` and
   ``test_sharded_checkpoint_restores_across_world_sizes``).
4. DeepFM under ParameterServer on ``{dp: 2}`` (both routes, and with the
   sharded optimizer) and on ``(dp=2, ep=2)`` (both routes) against the
   JAX trainer on the 2- and 4-device meshes from the same weights, in the
   style of tests/test_torch_gang.py: metrics, parameters and an eval step
   after 3 steps at rtol 2e-4, atol 2e-5.
5. A CPU gang of two worker processes with sharded state, one SIGKILLed:
   no survivor's snapshot, both relaunches resume from the periodic
   checkpoint, and the job ends at that checkpoint's step plus the steps
   of the tasks the master had not counted (no task trained twice).
"""

import json
import os
import signal
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

import elasticdl_tpu.parallel  # noqa: F401  (the JAX package's own import order)
from elasticdl_tpu.common.config import JobConfig as JaxJobConfig
from elasticdl_tpu.models import deepfm as jdeepfm
from elasticdl_tpu.parallel.mesh import create_mesh as jax_create_mesh
from elasticdl_tpu.parallel.trainer import Trainer as JaxTrainer
from elasticdl_tpu_torch.common.checkpoint import CheckpointManager, read_manifest
from elasticdl_tpu_torch.common.config import JobConfig
from elasticdl_tpu_torch.data import codecs
from elasticdl_tpu_torch.data.synthetic import synthetic_criteo
from elasticdl_tpu_torch.models import deepfm, transformer_lm as tlm
from elasticdl_tpu_torch.ops.embedding import table_shape
from elasticdl_tpu_torch.parallel.mesh import Mesh
from elasticdl_tpu_torch.parallel.trainer import MASK_KEY, MU, NU, Trainer, opt_shard_plan

from _torch_gloo_ranks import free_port, opt_shard_steps, ps_steps, run_ranks

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT_S = 120.0

DFM = dict(buckets_per_feature=512, embedding_dim=4, hidden=(16,), compute_dtype="float32",
           host_tier=False)
LM = dict(vocab=512, dim=64, n_heads=4, n_layers=2, max_seq=64, seq_len=64,
          compute_dtype="float32")
PS = "ParameterServer"


# ---- 1. the flags, without a process group --------------------------------------------

def test_parameter_server_holds_half_the_table_rows_a_rank():
    spec = deepfm.model_spec(**DFM)
    rows, width = table_shape(26 * DFM["buckets_per_feature"], DFM["embedding_dim"] + 1)
    for rank in (0, 1):
        tr = Trainer(spec, device="cpu", mesh=Mesh({"dp": 2}, rank=rank),
                     config=JobConfig(distribution_strategy=PS))
        assert tr.sharded_embeddings and tr.ctx.axis_size == 2 and tr.ctx.axis_index == rank
        state = tr.init_state(0)
        assert tuple(state.model.fm_table.shape) == (rows // 2, width)
        # Its rows of the table a world of one draws from the same seed.
        whole = deepfm.model_spec(**DFM).init(seed=0, device="cpu").fm_table.detach()
        assert torch.equal(state.model.fm_table.detach(), whole[rank * rows // 2:(rank + 1) * rows // 2])
        assert tr.sharded_state() and tr._opt_plan is None  # the replicated optimizer
        assert tr.restore_template(state)["params/fm_table"] == (rows, width)
    # AllReduce, or no tables: the table stays whole.
    tr = Trainer(spec, device="cpu", mesh=Mesh({"dp": 2}), config=JobConfig())
    assert not tr.sharded_embeddings and not tr.sharded_state()
    assert tuple(tr.init_state(0).model.fm_table.shape) == (rows, width)


def test_sharded_optimizer_holds_a_flat_shard_of_each_dense_leaf():
    spec = tlm.model_spec(**LM)
    tr = Trainer(spec, device="cpu", mesh=Mesh({"dp": 2, "ep": 1}, rank=1),
                 config=JobConfig(optimizer_sharding="sharded"))
    state = tr.init_state(0)
    zero = state.optimizer._zero_shards
    paths = tr._param_paths(state.model)
    assert tr.sharded_state() and len(zero.params) == len(paths)
    for (path, p), shard in zip(paths, zero.params):
        e = tr._opt_plan[path]
        assert e.size == p.numel() and e.padded % 2 == 0 and e.padded - e.size < 2
        assert tuple(shard.shape) == (e.padded // 2,)
        # Rank 1's half of the flat, zero-padded leaf.
        flat = torch.nn.functional.pad(p.detach().reshape(-1), (0, e.padded - e.size))
        assert torch.equal(shard.detach(), flat[e.padded // 2:])
    assert [g["params"] for g in state.optimizer.param_groups][0] == zero.params


def test_auto_follows_the_size_threshold(monkeypatch):
    spec = tlm.model_spec(**LM)
    mesh = Mesh({"dp": 4, "ep": 1})

    def plan(mode, mb=64.0, m=mesh):
        tr = Trainer(spec, device="cpu", mesh=m, config=JobConfig(
            optimizer_sharding=mode, optimizer_sharding_auto_mb=mb))
        tr.init_state(0)
        return tr._opt_plan is not None

    assert plan("auto", 1e-3) and not plan("auto", 1e6) and plan("sharded")
    assert not plan("replicated") and not plan("sharded", m=Mesh({"dp": 1}))
    # At full width, the shapes on meta tensors: transformer_lm at the
    # GPT-2-small width (887 MB of moments) shards, DeepFM under
    # ParameterServer at the bench width (the table kept, ~2 MB of MLP
    # moments) does not.
    meta = torch.device("meta")
    monkeypatch.setattr(tlm, "resolve_device", lambda device=None: meta)
    lm = tlm.TransformerLM(32768, 768, 12, 12, 1024, torch.bfloat16, meta)
    dfm = deepfm.DeepFM(65536, 8, (400, 400), torch.bfloat16, meta)
    for model, spec_, strategy, want, mb_want in (
            (lm, tlm.model_spec(**LM), "AllReduce", True, (887, 888)),
            (dfm, deepfm.model_spec(**DFM), PS, False, (1, 3))):
        tr = Trainer(spec_, device="cpu", mesh=Mesh({"dp": 2, "ep": 1}),
                     config=JobConfig(distribution_strategy=strategy, optimizer_sharding="auto"))
        paths = tr._param_paths(model)
        tables = [type(t)(t.path, 26 * 65536, 9) for t in spec_.embedding_tables]
        p = opt_shard_plan(paths, tables, tr.sharded_embeddings, 2)
        moments = sum(2 * 4 * e.size for e in p.values() if e != "keep")
        assert mb_want[0] <= moments / 1e6 <= mb_want[1], moments
        assert tr._resolve_opt_sharding(p, paths) is want


@pytest.mark.parametrize("strategy", ["AllReduce", PS])
def test_collective_bytes_leave_out_the_sharded_table(strategy):
    """The analytic gradient bytes a step, as the reference counts them: the
    row-sharded table's gradient never crosses the table axis."""
    tr = Trainer(deepfm.model_spec(**DFM), device="cpu", mesh=Mesh({"dp": 2}),
                 config=JobConfig(distribution_strategy=strategy))
    jtr = JaxTrainer(jdeepfm.model_spec(**DFM), JaxJobConfig(distribution_strategy=strategy),
                     jax_create_mesh(jax.devices(), num_devices=2))
    got = tr.collective_bytes_per_step(tr.init_state(0))
    assert got == jtr.collective_bytes_per_step(jtr.init_state(jax.random.key(0)))
    table = 4 * table_shape(26 * DFM["buckets_per_feature"], DFM["embedding_dim"] + 1)[0] * 128
    assert (got["flat"] < table) == (strategy == PS)


def test_pad_embedding_tables_packs_a_plain_table():
    """A model whose declared table is a plain ``[V, dim]`` array is brought
    into the padded packed layout, its rows kept (the reference's
    ``pad_embedding_tables``)."""
    from elasticdl_tpu_torch.models.spec import EmbeddingTableSpec
    from elasticdl_tpu_torch.ops.embedding import unpack_table
    from elasticdl_tpu_torch.parallel.trainer import pad_embedding_tables

    model = torch.nn.Module()
    model.emb = torch.nn.Module()
    plain = torch.randn(100, 9, generator=torch.Generator().manual_seed(0))
    model.emb.table = torch.nn.Parameter(plain.clone())
    pad_embedding_tables(model, [EmbeddingTableSpec(("emb", "table"), 100, 9)])
    assert tuple(model.emb.table.shape) == table_shape(100, 9)
    logical = unpack_table(model.emb.table.detach(), 9)
    assert torch.equal(logical[:100], plain) and not logical[100:].any()
    model.emb.table = torch.nn.Parameter(torch.zeros(5000, 9))  # more rows than declared
    with pytest.raises(ValueError, match="incompatible"):
        pad_embedding_tables(model, [EmbeddingTableSpec(("emb", "table"), 100, 9)])


def test_values_the_port_cannot_honour_raise():
    spec = deepfm.model_spec(**DFM)
    with pytest.raises(ValueError, match="distribution_strategy"):
        Trainer(spec, device="cpu", config=JobConfig(distribution_strategy="Parameterserver"))
    with pytest.raises(ValueError, match="optimizer_sharding"):
        Trainer(spec, device="cpu", config=JobConfig(optimizer_sharding="zero"))
    with pytest.raises(ValueError, match="unknown embedding lookup impl"):
        Trainer(spec, device="cpu", config=JobConfig(embedding_lookup_impl="bogus"))
    # Padded physical rows come in multiples of 256: three ranks cannot
    # split them evenly.
    with pytest.raises(ValueError, match="do not divide"):
        Trainer(spec, device="cpu", mesh=Mesh({"dp": 3}), config=JobConfig(distribution_strategy=PS))


# ---- 2. and 3. the sharded optimizer across ranks, and its checkpoints ---------------------


def _lm_batches(n: int = 3, size: int = 8):
    rng = np.random.default_rng(0)
    out = []
    for i in range(n):
        toks = rng.integers(0, LM["vocab"], size=(size, LM["seq_len"] + 1)).astype(np.int32)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if i == 1:  # a masked tail
            batch[MASK_KEY] = (np.arange(size) < 5).astype(np.float32)
        out.append(batch)
    return out


@pytest.fixture(scope="module")
def opt_worlds():
    return {world: run_ranks(opt_shard_steps, world, LM, _lm_batches()) for world in (2, 4)}


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_optimizer_matches_replicated(opt_worlds, world):
    ranks = opt_worlds[world]
    rep, sh = ranks[0]["replicated"], ranks[0]["sharded"]
    assert sh["plan"] and not rep["plan"]
    assert max(abs(a - b) for a, b in zip(rep["losses"], sh["losses"])) < 1e-6
    for key in rep["state"]:
        np.testing.assert_allclose(sh["state"][key], rep["state"][key], rtol=2e-6, atol=1e-7,
                                   err_msg=key)
    for r in ranks:
        # Every rank gathers the same canonical state; 1/n of the moments.
        for key in sh["state"]:
            assert np.array_equal(r["sharded"]["state"][key], sh["state"][key]), key
        n_leaves = sum(1 for k in rep["state"] if k.startswith(MU))
        assert r["sharded"]["opt_bytes"] <= r["replicated"]["opt_bytes"] / world + 8 * n_leaves * world
        assert set(r["sharded"]["by_op"]) >= {"zero:reduce_scatter", "zero:all_gather"}


def test_a_two_rank_sharded_checkpoint_restores_into_one_rank_and_back(opt_worlds, tmp_path):
    canonical = opt_worlds[2][0]["sharded"]["state"]
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    ckpt.save(3, canonical, wait=True)  # the worker's save layout
    # A world of one, replicated: the moments land as they were.
    one = Trainer(tlm.model_spec(**LM), device="cpu")
    state = one.adopt_restored(ckpt.restore(3), one.init_state(1))
    assert state.step == 3
    got = {k: np.asarray(v) for k, v in one.host_state(state).items()}
    for key in canonical:
        assert np.array_equal(got[key], canonical[key]), key
    assert any(np.abs(canonical[k]).max() > 0 for k in canonical if k.startswith(NU))
    state, _ = one.run_train_step(state, _lm_batches()[0])
    after_one = {k: np.asarray(v) for k, v in one.host_state(state).items()}
    ckpt.save(4, after_one, wait=True)
    # Back into two sharded ranks: each restores its shards, gathers them
    # back bit for bit, and steps on.
    back = run_ranks(opt_shard_steps, 2, LM, _lm_batches(1), ckpt.restore(4))
    for r in back:
        for key in after_one:
            assert np.array_equal(r["restored"][key], after_one[key]), key
        assert r["after"]["step"] == 5 and np.isfinite(r["loss"])
    for key in back[0]["after"]:
        assert np.array_equal(back[0]["after"][key], back[1]["after"][key]), key
    ckpt.close()


# ---- 4. DeepFM under ParameterServer against the JAX meshes --------------------------------


def _dfm_batches(spec):
    rng = np.random.default_rng(9)
    out = []
    for i in range(3):
        records = [
            codecs.encode_criteo_example(
                int(rng.integers(0, 2)),
                [None if rng.random() < 0.1 else int(rng.integers(0, 1000)) for _ in range(13)],
                [int(rng.integers(0, 1 << 32)) for _ in range(26)],
            )
            for _ in range(64)
        ]
        batch = dict(spec.feed(records))
        if i == 1:
            batch[MASK_KEY] = (np.arange(64) < 41).astype(np.float32)
        out.append(batch)
    return out


MESHES = {"dp2": (2, 1), "dp2_ep2": (4, 2)}  # name: (world, dcn_data_parallelism)
VARIANTS = {"dp2": [("dense", "replicated"), ("ragged", "replicated"), ("ragged", "sharded")],
            "dp2_ep2": [("dense", "replicated"), ("ragged", "replicated")]}


@pytest.fixture(scope="module")
def ps_worlds():
    jspec = jdeepfm.model_spec(**DFM)
    batches = _dfm_batches(deepfm.model_spec(**DFM))
    out = {}
    for name, (world, dcn) in MESHES.items():
        config = JaxJobConfig(distribution_strategy=PS, dcn_data_parallelism=dcn)
        jtrainer = JaxTrainer(jspec, config, jax_create_mesh(jax.devices(), num_devices=world,
                                                            dcn_parallelism=dcn))
        jstate = jtrainer.init_state(jax.random.key(0))
        params = jax.device_get(jstate.params)
        ref = []
        for batch in batches:
            jstate, m = jtrainer.run_train_step(jstate, dict(batch))
            ref.append({k: np.asarray(v) for k, v in jax.device_get(m).items()})
        jeval = {k: np.asarray(v) for k, v in
                 jax.device_get(jtrainer.run_eval_step(jstate, dict(batches[0]))).items()}
        jparams = jax.device_get(jtrainer.host_state(jstate).params)
        ranks = run_ranks(ps_steps, world, dcn, VARIANTS[name], DFM, params, batches)
        out[name] = {"ref": ref, "eval": jeval, "params": jparams, "ranks": ranks,
                     "mesh": dict(jtrainer.mesh.shape)}
    return out


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + k + "/")
        else:
            yield prefix + k, np.asarray(v)


@pytest.mark.parametrize("name,impl,opt", [(n, i, o) for n in MESHES for i, o in VARIANTS[n]])
def test_parameter_server_matches_the_jax_mesh(ps_worlds, name, impl, opt):
    world = ps_worlds[name]
    rows = table_shape(26 * DFM["buckets_per_feature"], DFM["embedding_dim"] + 1)[0]
    n_table = world["mesh"]["ep"] if name == "dp2_ep2" else 2
    want_params = dict(_flat(world["params"]))
    for rank, out in enumerate(world["ranks"]):
        got = out[(impl, opt)]
        assert got["impl"] == impl and got["sharded_opt"] == (opt == "sharded")
        assert got["table_rows"] == rows // n_table
        for step, (g, w) in enumerate(zip(got["metrics"], world["ref"])):
            assert sorted(g) == sorted(w), (rank, step)
            for k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=2e-4, atol=2e-5,
                                           err_msg=f"rank {rank} step {step} {k}")
        assert sorted(got["params"]) == sorted(want_params)
        for k, w in want_params.items():
            np.testing.assert_allclose(got["params"][k], w, rtol=2e-4, atol=2e-5, err_msg=k)
        for k in world["eval"]:
            np.testing.assert_allclose(got["eval"][k], world["eval"][k], rtol=2e-4, atol=2e-5)
        assert any(k.startswith("lookup:") for k in got["by_op"])
    # The ranks gather one state, bit for bit.
    first = world["ranks"][0][(impl, opt)]["params"]
    for out in world["ranks"][1:]:
        for k, v in out[(impl, opt)]["params"].items():
            assert np.array_equal(v, first[k]), k


# ---- 5. a SIGKILL in a sharded gang ---------------------------------------------------


def _events(text, kind):
    out = []
    for line in text.splitlines():
        if line.startswith("[worker-event] "):
            e = json.loads(line[len("[worker-event] "):])
            if e["event"] == kind:
                out.append(e)
    return out


@pytest.fixture
def cpu_gang(monkeypatch):
    monkeypatch.setenv("ELASTICDL_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("ELASTICDL_STATE_DIGEST", "1")
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [_REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    monkeypatch.delenv("GRAFT_CHAOS", raising=False)
    monkeypatch.delenv("ELASTICDL_TORCH_DIST_BACKEND", raising=False)


def test_sigkill_in_a_sharded_gang_resumes_from_the_periodic_checkpoint(tmp_path, cpu_gang):
    train = str(tmp_path / "train.rio")
    synthetic_criteo(train, 1024, seed=3, container="recordio")
    ckpt, pods = str(tmp_path / "ckpt"), str(tmp_path / "pods")
    job, mb, per_task, n_tasks = "psgang", 32, 2, 16
    w0, w1 = f"{job}-worker-0", f"{job}-worker-1"
    params = "buckets_per_feature=512;embedding_dim=4;hidden=16;compute_dtype=float32"
    cmd = [sys.executable, "-m", "elasticdl_tpu_torch.client.main", "train", "--local",
           f"--job_name={job}", "--model_def=deepfm.model_spec", f"--model_params={params}",
           f"--training_data={train}", f"--minibatch_size={mb}",
           f"--num_minibatches_per_task={per_task}", f"--checkpoint_dir={ckpt}",
           "--checkpoint_steps=4", f"--pod_log_dir={pods}", "--num_workers=2",
           "--multihost=true", "--dcn_data_parallelism=1", f"--distribution_strategy={PS}",
           "--optimizer_sharding=sharded", "--max_worker_relaunch=2",
           f"--coordinator_port={free_port()}",
           # Rank 1 stalls at its first task boundary past step 10; rank 0
           # blocks in that step's lookup, where the SIGKILL finds it.
           f"--chaos=stall:worker={w1},point=task,step=10,ms=600000"]
    cli_log = str(tmp_path / "cli.log")
    proc = subprocess.Popen(cmd, cwd=_REPO, stdout=open(cli_log, "w"), stderr=subprocess.STDOUT,
                            start_new_session=True)
    try:
        deadline = time.monotonic() + WAIT_S
        path = os.path.join(pods, f"{w1}.log")
        while "[graftchaos] stall" not in (open(path).read() if os.path.exists(path) else ""):
            assert proc.poll() is None and time.monotonic() < deadline, open(cli_log).read()
            time.sleep(0.05)
        time.sleep(0.5)
        os.kill(_events(open(path).read(), "ready")[0]["pid"], signal.SIGKILL)
        rc = proc.wait(timeout=WAIT_S)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    cli = open(cli_log).read()
    assert rc == 0, cli
    logs = {n: open(os.path.join(pods, f"{n}.log")).read()
            for n in (w0, w1, f"{w0}-r1", f"{w1}-r1")}
    for needle in (f"pod {w1} exited rc=-9 -> Failed", f"pod {w0} exited rc=3 -> Restart",
                   f"pod {w0}-r1 exited rc=0 -> Succeeded",
                   f"pod {w1}-r1 exited rc=0 -> Succeeded"):
        assert needle in cli, needle
    gang = _events(logs[w0], "gang")[0]
    assert gang["rank"] == 0 and gang["mesh"] == {"dp": 2}
    assert gang["distribution_strategy"] == PS and gang["sharded_embeddings"]
    assert gang["embedding_lookup_impl"] == "dense"  # auto on the CPU
    # No survivor's snapshot: both relaunches join from the periodic one.
    assert "pre-restart snapshot at step" not in logs[w0]
    assert "no pre-restart snapshot: the state is sharded" in logs[w0]
    joined = {_events(logs[n], "ready")[0]["joined_step"] for n in (f"{w0}-r1", f"{w1}-r1")}
    assert len(joined) == 1
    resumed = joined.pop()
    assert resumed >= 8 and resumed % 4 == 0
    # The tasks the old world's rank 0 reported and the master counted.
    counted = logs[w0].count("accepted=True")
    assert counted * per_task >= resumed
    status = eval(cli.split("job finished: ", 1)[1].splitlines()[0])  # a dict literal
    assert status["finished"] and status["done"] == n_tasks, status
    assert status["duplicate_done"] == 0 and status["abandoned"] == 0, status
    # The final step: the restored checkpoint's plus the steps of the
    # tasks dispatched after the re-form, which are exactly the ones the
    # master had not counted; a task trained twice would add its steps.
    final = _events(logs[f"{w0}-r1"], "summary")[0]
    assert final["steps"] == (n_tasks - counted) * per_task, (final["steps"], counted)
    assert read_manifest(ckpt)["step"] == final["step"] == resumed + final["steps"]
    # One state in each world: equal digests of the gathered state.
    for a, b in ((w0, w1), (f"{w0}-r1", f"{w1}-r1")):
        da = {e["step"]: e["digest"] for e in _events(logs[a], "checkpoint")}
        db = {e["step"]: e["digest"] for e in _events(logs[b], "checkpoint")}
        shared = set(da) & set(db)
        assert shared and all(da[s] == db[s] for s in shared), (da, db)
    assert final["state_bytes"]["sharded_state"]
    # The relaunched world restored a checkpoint of the whole state: a world
    # of one restores the final one and steps on.
    one = Trainer(deepfm.model_spec(**dict(DFM, hidden=(16,))), device="cpu")
    state = one.adopt_restored(CheckpointManager(ckpt).restore())
    assert state.step == final["step"]
