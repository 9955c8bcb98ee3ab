"""The PyTorch port's elastic training job against the JAX package's.

Both jobs read the same RecordIO files (the two ``synthetic_lm`` copies
write identical bytes), start from the same weights (JAX
``init_state(jax.random.key(0))``, carried into the port's
``Trainer.init_state`` by a monkeypatch with ``params_from_jax``'s
``load_jax_params``), and run one worker over ``DirectMasterProxy`` with
periodic checkpoints and eval rounds over a validation file whose last
minibatch is ragged (36 records, minibatch 8: a masked tail of 4).  Both
workers run synchronously (``task_pipelining=False``), so reports, eval
rounds and checkpoints land in the same order.  The width is
tests/test_torch_train.py's: SEQ 64, dim 64, 2 layers, vocab 512, f32
compute; both sides run their plain attention on the CPU.

Tolerances (f32): each reported training loss and each eval task's
metrics rtol 1e-5 (measured: at most 4.3e-7 and 3.6e-7 relative); the
final canonical arrays (parameters, AdamW moments, count, step) against
JAX ``Trainer.host_state`` rtol 2e-4 / atol 2e-5, test_torch_train's
(measured: largest parameter difference 2.6e-6, mu 5.2e-8, nu 3.5e-11).  Task counts, steps,
checkpoint steps and the manifest step are equal.
"""

import os
import time

import jax
import numpy as np
import pytest
import torch

from elasticdl_tpu.common.checkpoint import read_manifest as jax_read_manifest
from elasticdl_tpu.common.config import JobConfig as JaxJobConfig
from elasticdl_tpu.data.reader import create_data_reader as jax_create_data_reader
from elasticdl_tpu.data.synthetic import generate as jax_generate
from elasticdl_tpu.master.evaluation_service import EvaluationService as JaxEvaluationService
from elasticdl_tpu.master.servicer import MasterServicer as JaxMasterServicer
from elasticdl_tpu.master.task_dispatcher import TaskDispatcher as JaxTaskDispatcher
from elasticdl_tpu.models.spec import load_model_spec as jax_load_model_spec
from elasticdl_tpu.parallel.mesh import create_mesh
from elasticdl_tpu.parallel.trainer import Trainer as JaxTrainer
from elasticdl_tpu.worker.worker import DirectMasterProxy as JaxDirectMasterProxy
from elasticdl_tpu.worker.worker import Worker as JaxWorker
from elasticdl_tpu_torch.common.checkpoint import CheckpointManager, read_manifest
from elasticdl_tpu_torch.common.config import JobConfig
from elasticdl_tpu_torch.data.reader import create_data_reader
from elasticdl_tpu_torch.data.synthetic import generate
from elasticdl_tpu_torch.master.evaluation_service import EvaluationService
from elasticdl_tpu_torch.master.servicer import MasterServicer
from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
from elasticdl_tpu_torch.models import transformer_lm as tlm
from elasticdl_tpu_torch.parallel import trainer as ttrainer
from elasticdl_tpu_torch.worker.worker import DirectMasterProxy, Worker

SEQ, VOCAB = 64, 512
_MODEL = dict(vocab=VOCAB, dim=64, n_heads=4, n_layers=2, max_seq=SEQ, seq_len=SEQ,
              compute_dtype="float32")
N_TRAIN, N_VAL, MB, PER_TASK = 96, 36, 8, 2
_JOB = dict(
    model_def="transformer_lm.model_spec", minibatch_size=MB,
    num_minibatches_per_task=PER_TASK, evaluation_steps=4, checkpoint_steps=4,
    keep_checkpoint_max=2, task_pipelining=False,
)
LOSS_RTOL = 1e-5
STATE_RTOL, STATE_ATOL = 2e-4, 2e-5


def _data(tmp_path):
    train, val = str(tmp_path / "train.rio"), str(tmp_path / "val.rio")
    generate("lm", train, N_TRAIN, seed=0, seq_len=SEQ, vocab=VOCAB)
    generate("lm", val, N_VAL, seed=1, seq_len=SEQ, vocab=VOCAB)
    return train, val


class _Recording:
    """A master proxy that keeps every request of the methods that carry
    results (task reports and checkpoint reports)."""

    def __init__(self, proxy):
        self._proxy = proxy
        self.calls = []
        self.worker = None
        self.failed_at_step = []  # the worker's step at each failed report

    def call(self, method, request):
        if method in ("ReportTaskResult", "ReportCheckpoint"):
            self.calls.append((method, dict(request)))
        if method == "ReportTaskResult" and not request["success"] and not request.get("requeue"):
            self.failed_at_step.append(int(self.worker.state.step))
        return self._proxy.call(method, request)

    def training_losses(self):
        return [r["metrics"]["loss"] for m, r in self.calls
                if m == "ReportTaskResult" and r["success"] and r.get("task_type") == "training"]

    def eval_metrics(self):
        return [(r["metrics"], r["weight"]) for m, r in self.calls
                if m == "ReportTaskResult" and r["success"] and r.get("task_type") == "evaluation"]

    def checkpoint_steps(self):
        return [r["step"] for m, r in self.calls if m == "ReportCheckpoint"]


class _Mux:
    """Routes read_records by shard file name (train vs val)."""

    def __init__(self, train, val):
        self._train, self._val = train, val

    def read_records(self, shard):
        r = self._train if os.path.basename(shard.name).startswith("train") else self._val
        return r.read_records(shard)


def _jax_spec():
    return jax_load_model_spec("elasticdl_tpu.models", "transformer_lm.model_spec", **_MODEL)


def _jax_init_params():
    jtrainer = JaxTrainer(_jax_spec(), JaxJobConfig(distribution_strategy="AllReduce"),
                          create_mesh(jax.devices(), num_devices=1))
    return jax.device_get(jtrainer.init_state(jax.random.key(0)).params)


@pytest.fixture
def carried_init(monkeypatch):
    """The port's ``Trainer.init_state`` starts from the JAX init weights."""
    params = _jax_init_params()
    orig = ttrainer.Trainer.init_state

    def init_state(self, seed):
        state = orig(self, seed)
        state.model.load_jax_params(params)
        return state

    monkeypatch.setattr(ttrainer.Trainer, "init_state", init_state)
    return params


def _run_jax_job(tmp_path, train, val, ckpt_dir, spec=None, **overrides):
    config = JaxJobConfig(training_data=train, validation_data=val,
                          checkpoint_dir=ckpt_dir, **dict(_JOB, **overrides))
    reader, eval_reader = jax_create_data_reader(train), jax_create_data_reader(val)
    per_task = config.minibatch_size * config.num_minibatches_per_task
    servicer = JaxMasterServicer(
        JaxTaskDispatcher(reader.create_shards(per_task), num_epochs=1),
        evaluation=JaxEvaluationService(eval_reader.create_shards(per_task),
                                        evaluation_steps=config.evaluation_steps),
    )
    master = _Recording(JaxDirectMasterProxy(servicer))
    worker = JaxWorker(config, master, _Mux(reader, eval_reader), worker_id="w0",
                       spec=spec or _jax_spec(), devices=jax.devices()[:1])
    master.worker = worker
    result = worker.run()
    return result, servicer, master, worker


def _run_port_job(train, val, ckpt_dir, spec=None, **overrides):
    config = JobConfig(training_data=train, validation_data=val,
                       checkpoint_dir=ckpt_dir, **dict(_JOB, **overrides))
    reader, eval_reader = create_data_reader(train), create_data_reader(val)
    per_task = config.minibatch_size * config.num_minibatches_per_task
    servicer = MasterServicer(
        TaskDispatcher(reader.create_shards(per_task), num_epochs=1),
        evaluation=EvaluationService(eval_reader.create_shards(per_task),
                                     evaluation_steps=config.evaluation_steps),
    )
    master = _Recording(DirectMasterProxy(servicer))
    worker = Worker(config, master, _Mux(reader, eval_reader), worker_id="w0",
                    spec=spec or tlm.model_spec(**_MODEL), device="cpu")
    master.worker = worker
    result = worker.run()
    return result, servicer, master, worker


def _flat(tree, prefix):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


def _jax_canonical(jworker):
    """JAX ``Trainer.host_state`` in the port's canonical paths."""
    host = jworker.trainer.host_state(jworker.state)
    adam = next(s for s in host.opt_state if hasattr(s, "mu"))
    out = _flat(host.params, "params")
    out.update(_flat(adam.mu, "opt_state/mu"))
    out.update(_flat(adam.nu, "opt_state/nu"))
    out["opt_state/count"] = np.asarray(adam.count)
    out["step"] = np.asarray(host.step)
    return out


def test_synthetic_lm_copies_write_identical_bytes(tmp_path):
    ours, theirs = str(tmp_path / "port.rio"), str(tmp_path / "jax.rio")
    generate("lm", ours, 20, seed=3, seq_len=SEQ, vocab=VOCAB)
    jax_generate("lm", theirs, 20, seed=3, seq_len=SEQ, vocab=VOCAB)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("mode", [
    dict(),
    dict(task_pipelining=True, prep_depth=2),
], ids=["synchronous", "prep_ahead"])
def test_port_job_matches_the_jax_job(tmp_path, carried_init, mode):
    train, val = _data(tmp_path)
    jax_dir, port_dir = str(tmp_path / "jax_ckpt"), str(tmp_path / "port_ckpt")
    jres, jserv, jmaster, jworker = _run_jax_job(tmp_path, train, val, jax_dir, **mode)
    res, serv, master, worker = _run_port_job(train, val, port_dir, **mode)

    # Tasks, steps, eval rounds: equal.
    n_tasks = N_TRAIN // (MB * PER_TASK)
    jstatus, status = jserv.JobStatus({}), serv.JobStatus({})
    assert status["done"] == jstatus["done"] == n_tasks
    assert status["duplicate_done"] == jstatus["duplicate_done"] == 0
    assert res["tasks_done"] == jres["tasks_done"]
    assert res["step"] == jres["step"] == N_TRAIN // MB
    assert status["eval_rounds"] == jstatus["eval_rounds"] >= 2
    # Each reported training loss.
    losses, jlosses = master.training_losses(), jmaster.training_losses()
    assert len(losses) == len(jlosses) == n_tasks
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL)
    # Each eval task's metrics (count-weighted means over the ragged tail)
    # and the rounds' aggregates.
    evals, jevals = master.eval_metrics(), jmaster.eval_metrics()
    assert len(evals) == len(jevals) > 0
    for (m, w), (jm, jw) in zip(evals, jevals):
        assert w == jw and sorted(m) == sorted(jm)
        for k in m:
            np.testing.assert_allclose(m[k], jm[k], rtol=LOSS_RTOL)
    for k, v in jstatus["eval_metrics"].items():
        np.testing.assert_allclose(status["eval_metrics"][k], v, rtol=LOSS_RTOL)
    # Checkpoint steps, retained steps and the manifest step.
    assert master.checkpoint_steps() == jmaster.checkpoint_steps()
    assert read_manifest(port_dir)["step"] == jax_read_manifest(jax_dir)["step"] == res["step"]
    assert CheckpointManager(port_dir).all_steps() == sorted(
        jworker._ckpt.all_steps(), reverse=True)
    # The final canonical arrays against JAX Trainer.host_state.
    ours = worker.trainer.host_state(worker.state)
    theirs = _jax_canonical(jworker)
    assert sorted(ours) == sorted(theirs)
    for key, ref in theirs.items():
        np.testing.assert_allclose(ours[key], ref, rtol=STATE_RTOL, atol=STATE_ATOL,
                                   err_msg=key)
    # The checkpoint on disk holds that state.
    saved = CheckpointManager(port_dir).restore(res["step"])
    for key, value in ours.items():
        assert np.array_equal(saved[key], value), key


@pytest.mark.parametrize("masked_metrics", [False, True], ids=["model_metrics", "mask_metrics"])
def test_eval_step_matches_jax_run_eval_step(masked_metrics):
    """``run_eval_step`` on a batch with a ``__mask__``: transformer_lm's
    own metrics take no mask (both sides then mean over the padded batch);
    a metrics function that takes one makes both sides mean over real rows.
    f32, rtol 1e-5 (measured: loss 7.2e-8 relative, accuracy equal)."""
    from elasticdl_tpu.models import metrics as jmetrics
    from elasticdl_tpu.models import transformer_lm as jlm
    from elasticdl_tpu_torch.models import metrics as tmetrics

    jspec = _jax_spec()
    spec = tlm.model_spec(**_MODEL)
    if masked_metrics:
        def jmasked(logits, batch, mask=None):
            hit = (jax.numpy.argmax(logits, -1) == batch["labels"]).astype(jax.numpy.float32)
            return {"loss": jlm._loss(logits, batch, mask=mask),
                    "accuracy": jmetrics.masked_mean(hit, mask)}

        def masked(logits, batch, mask=None):
            hit = (logits.argmax(-1) == batch["labels"].long()).float()
            return {"loss": tlm._loss(logits, batch, mask=mask),
                    "accuracy": tmetrics.masked_mean(hit, mask)}

        jspec.metrics, spec.metrics = jmasked, masked
    jtrainer = JaxTrainer(jspec, JaxJobConfig(distribution_strategy="AllReduce"),
                          create_mesh(jax.devices(), num_devices=1))
    jstate = jtrainer.init_state(jax.random.key(0))
    trainer = ttrainer.Trainer(spec, device="cpu")
    state = trainer.init_state(0)
    state.model.load_jax_params(jax.device_get(jstate.params))

    rng = np.random.default_rng(5)
    toks = rng.integers(0, VOCAB, size=(4, SEQ + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "__mask__": np.array([1, 1, 1, 0], np.float32)}
    ref = jax.device_get(jtrainer.run_eval_step(jstate, dict(batch)))
    got = trainer.run_eval_step(state, dict(batch))
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-5, err_msg=k)
    # The step ran without gradients and left the module as it found it.
    assert all(p.grad is None for p in state.model.parameters())
    assert state.model.training
    if masked_metrics:
        unmasked = trainer.run_eval_step(state, {k: v for k, v in batch.items()
                                                 if k != "__mask__"})
        assert float(unmasked["loss"]) != pytest.approx(float(got["loss"]), rel=1e-6)


def test_resume_continues_from_the_checkpoint(tmp_path):
    """tests/test_worker.py's resume case: a job of 6 steps, then a fresh
    servicer over the same checkpoint directory resumes at step 6 and ends
    at 12; the restored arrays equal the saved ones exactly."""
    train, val = _data(tmp_path)
    ckpt = str(tmp_path / "ckpt")
    half = str(tmp_path / "train_half.rio")
    generate("lm", half, 48, seed=0, seq_len=SEQ, vocab=VOCAB)
    res, serv, _, worker = _run_port_job(half, val, ckpt, evaluation_steps=0)
    assert res["step"] == 6
    assert serv.GetCheckpoint({})["step"] == 6
    assert read_manifest(ckpt)["step"] == 6
    saved = CheckpointManager(ckpt).restore(6)

    restored = {}
    orig = Worker._restore_at_start

    def spy(self):
        orig(self)
        restored.update(self.trainer.host_state(self.state))

    Worker._restore_at_start = spy
    try:
        res2, serv2, _, _ = _run_port_job(half, val, ckpt, evaluation_steps=0)
    finally:
        Worker._restore_at_start = orig
    assert res2["step"] == 12  # resumed at 6, ran 6 more
    assert sorted(restored) == sorted(saved)
    for key, value in saved.items():
        assert np.array_equal(restored[key], value), key
    assert read_manifest(ckpt)["step"] == 12


def test_failed_step_recovers_from_the_newest_checkpoint(tmp_path, monkeypatch):
    """A step that fails part-way leaves an in-place state no one can vouch
    for: the worker rebuilds it from the newest checkpoint, the task is
    reported failed and requeued, and the job completes."""
    train, val = _data(tmp_path)
    ckpt = str(tmp_path / "ckpt")
    # The step every path runs (``train_step`` and the fused scans alike).
    orig = ttrainer.Trainer._train_step
    calls = {"n": 0}

    def flaky(self, state, batch):
        calls["n"] += 1
        result = orig(self, state, batch)
        if calls["n"] == 7:  # after the step-4 checkpoint, mid-task
            raise RuntimeError("injected step failure")
        return result

    monkeypatch.setattr(ttrainer.Trainer, "_train_step", flaky)
    recovered = []
    orig_recover = Worker._recover_state

    def spy(self):
        newest = self._ckpt.latest_step()
        orig_recover(self)
        recovered.append((newest, self.state.step))

    monkeypatch.setattr(Worker, "_recover_state", spy)
    res, serv, master, worker = _run_port_job(train, val, ckpt, evaluation_steps=0)
    assert worker.recoveries == 1
    newest, step = recovered[0]
    assert newest == step == 4
    status = serv.JobStatus({})
    assert status["done"] == N_TRAIN // (MB * PER_TASK) and status["todo"] == 0
    failed = [r for m, r in master.calls if m == "ReportTaskResult" and not r["success"]]
    assert len(failed) == 1
    # Steps after the recovery: 4 + every task trained since (2 steps each).
    trained_after = sum(
        1 for m, r in master.calls[master.calls.index(("ReportTaskResult", failed[0])):]
        if m == "ReportTaskResult" and r["success"] and r["task_type"] == "training")
    assert res["step"] == 4 + 2 * trained_after


def test_checkpoint_steps_match_at_the_chip_smoke_schedule(tmp_path):
    """``chip_smoke.py``'s job schedule (8 tasks of 4 minibatches of 16, eval
    and checkpoint every 16 steps, prep-ahead, the defaults) on both
    packages at a tiny width: the same checkpoint steps (16 and 32, and the
    final report of 32), eval rounds and tasks."""
    model = dict(vocab=VOCAB, dim=32, n_heads=2, n_layers=1, max_seq=16, seq_len=16,
                 compute_dtype="float32")
    train, val = str(tmp_path / "train.rio"), str(tmp_path / "val.rio")
    generate("lm", train, 512, seed=0, seq_len=16, vocab=VOCAB)
    generate("lm", val, 72, seed=1, seq_len=16, vocab=VOCAB)
    mode = dict(minibatch_size=16, num_minibatches_per_task=4, evaluation_steps=16,
                checkpoint_steps=16)
    jspec = jax_load_model_spec("elasticdl_tpu.models", "transformer_lm.model_spec", **model)
    jres, jserv, jmaster, _ = _run_jax_job(tmp_path, train, val, str(tmp_path / "j"),
                                           spec=jspec, **mode)
    res, serv, master, _ = _run_port_job(train, val, str(tmp_path / "p"),
                                         spec=tlm.model_spec(**model), **mode)
    assert master.checkpoint_steps() == jmaster.checkpoint_steps() == [16, 32, 32]
    assert serv.JobStatus({})["eval_rounds"] == jserv.JobStatus({})["eval_rounds"]
    assert res["tasks_done"] == jres["tasks_done"] and res["step"] == jres["step"] == 32


def _fail_feed_once(spec, record):
    """``spec.feed`` raising once, on the first call that holds ``record``."""
    feed, armed = spec.feed, [True]

    def flaky(records):
        if armed[0] and any(bytes(r) == record for r in records):
            armed[0] = False
            raise RuntimeError("injected feed failure")
        return feed(records)

    spec.feed = flaky
    return spec


@pytest.mark.parametrize("mode", [
    dict(task_pipelining=False, fused_task_scan=False),
    dict(task_pipelining=False),
    dict(task_pipelining=True, prep_depth=2),
], ids=["per_minibatch_feed", "fused_feed", "prep_ahead"])
def test_feed_failure_recovers_like_the_jax_job(tmp_path, carried_init, mode):
    """A ``spec.feed`` failure on the first record of minibatch 2 of the
    fourth task (steps 6 -> 8; the newest checkpoint holds step 4).  Fed
    one minibatch at a time, the step of minibatch 1 has run: both packages
    go on from it (``TrainLoopError.state``, step 7).  Fed in one call per
    task (inline or on the prep thread), no step has run: both keep step
    6.  The task is requeued and trained again; the final steps, the task
    counts and each reported loss (rtol 1e-5) are equal."""
    from elasticdl_tpu.data.reader import Shard as JaxShard

    train, val = _data(tmp_path)
    reader = jax_create_data_reader(train)
    trigger = list(reader.read_records(JaxShard(train, 56, 57)))[0]
    mode = dict(mode, evaluation_steps=0)
    _, jserv, jmaster, jworker = _run_jax_job(
        tmp_path, train, val, str(tmp_path / "jax_ckpt"),
        spec=_fail_feed_once(_jax_spec(), trigger), **mode)
    res, serv, master, worker = _run_port_job(
        train, val, str(tmp_path / "port_ckpt"),
        spec=_fail_feed_once(tlm.model_spec(**_MODEL), trigger), **mode)
    ran_one = not mode.get("fused_task_scan", True)
    assert master.failed_at_step == jmaster.failed_at_step == [7 if ran_one else 6]
    assert worker.recoveries == 0
    assert res["step"] == int(jworker.state.step) == N_TRAIN // MB + ran_one
    status, jstatus = serv.JobStatus({}), jserv.JobStatus({})
    assert status["done"] == jstatus["done"] == N_TRAIN // (MB * PER_TASK)
    np.testing.assert_allclose(master.training_losses(), jmaster.training_losses(),
                               rtol=LOSS_RTOL)


def test_pipelined_job_trains_the_same_state(tmp_path):
    """Task-level pipelining (the default) defers each task's metrics fetch
    and report past the next task's dispatch; it trains the same tasks in
    the same order, so losses and the final state equal the synchronous
    job's up to the CPU's own run-to-run rounding (the background save
    thread shares the CPU's intra-op threads, which moves the blocking of
    a reduction): losses rtol 1e-6, state rtol 1e-5 / atol 1e-7
    (measured over two runs: losses at most 7.3e-8 relative, state at most
    6.0e-8 absolute)."""
    train, val = _data(tmp_path)
    sync = _run_port_job(train, val, str(tmp_path / "a"), evaluation_steps=0)
    piped = _run_port_job(train, val, str(tmp_path / "b"), evaluation_steps=0,
                          task_pipelining=True)
    assert piped[0]["step"] == sync[0]["step"] == N_TRAIN // MB
    np.testing.assert_allclose(piped[2].training_losses(), sync[2].training_losses(),
                               rtol=1e-6)
    a = sync[3].trainer.host_state(sync[3].state)
    b = piped[3].trainer.host_state(piped[3].state)
    assert sorted(a) == sorted(b)
    for key in a:
        np.testing.assert_allclose(b[key], a[key], rtol=1e-5, atol=1e-7, err_msg=key)


def test_prediction_job_matches_the_jax_prediction_job(tmp_path, carried_init):
    """Prediction tasks: every record's logits, the wrap-padded tail's
    duplicates dropped, written per task; the same as the JAX worker's on
    the same weights (f32, rtol 1e-4 / atol 1e-5 on the logits, the serving
    test's bound; measured 3.9e-6 absolute at most)."""
    data = str(tmp_path / "pred.rio")
    generate("lm", data, 20, seed=4, seq_len=SEQ, vocab=VOCAB)
    outputs = {}
    for side in ("jax", "port"):
        out_dir = str(tmp_path / side)
        kw = dict(model_def="transformer_lm.model_spec", job_type="prediction",
                  minibatch_size=MB, prediction_outputs=out_dir)
        if side == "jax":
            reader = jax_create_data_reader(data)
            servicer = JaxMasterServicer(JaxTaskDispatcher(
                reader.create_shards(12), task_type="prediction"))
            JaxWorker(JaxJobConfig(**kw), JaxDirectMasterProxy(servicer), reader,
                      spec=_jax_spec(), devices=jax.devices()[:1]).run()
        else:
            reader = create_data_reader(data)
            servicer = MasterServicer(TaskDispatcher(
                reader.create_shards(12), task_type="prediction"))
            Worker(JobConfig(**kw), DirectMasterProxy(servicer), reader,
                   spec=tlm.model_spec(**_MODEL), device="cpu").run()
        assert servicer.JobStatus({})["done"] == 2
        files = sorted(os.listdir(out_dir))
        assert files == ["task-0.npy", "task-1.npy"]
        outputs[side] = np.concatenate([np.load(os.path.join(out_dir, f)) for f in files])
    assert outputs["port"].shape == (20, SEQ, VOCAB)  # every record, none twice
    np.testing.assert_allclose(outputs["port"], outputs["jax"], rtol=1e-4, atol=1e-5)


def test_worker_left_out_modes_raise(tmp_path):
    """Host-tier I/O (``use_async``, PS addresses), gang mode
    (``multihost``) and the collective gate (``collective_deadline_ms``) are
    ported: a worker takes them (a worker without a process group is a
    world of one).  The one host-tier layout left out raises, as in the
    reference: host-tier tables on a world of several ranks without a PS
    fleet."""
    from elasticdl_tpu_torch.models import deepfm
    from elasticdl_tpu_torch.parallel.mesh import Mesh

    spec = tlm.model_spec(**_MODEL)
    host = deepfm.model_spec(**dict(_DFM, host_tier=True))
    with pytest.raises(NotImplementedError, match="num_ps_pods"):
        Worker(JobConfig(), master=None, reader=None, spec=host, device="cpu",
               mesh=Mesh({"dp": 2}, rank=0))
    worker = Worker(JobConfig(use_async=True), master=None, reader=None, spec=host, device="cpu")
    assert worker.trainer.has_local_host_stores()
    for kwargs in (dict(multihost=True), dict(collective_deadline_ms=100.0), {},
                   dict(use_async=True, ps_addresses="localhost:1")):
        worker = Worker(JobConfig(**kwargs), master=None, reader=None, spec=spec, device="cpu")
        assert isinstance(worker.trainer.device, torch.device)
        assert worker.trainer.num_contributors() == 1 and not worker._group_mode


def test_profiled_task_writes_a_trace_and_runs_synchronously(tmp_path):
    """``profile_dir``: the second training task runs synchronously (its
    report, with its metrics, comes before the first task's deferred one)
    under ``torch.profiler`` and leaves a Chrome trace of its steps."""
    train, val = _data(tmp_path)
    prof_dir = tmp_path / "prof"
    res, _, master, _ = _run_port_job(train, val, str(tmp_path / "ckpt"), evaluation_steps=0,
                                      task_pipelining=True, profile_dir=str(prof_dir))
    assert res["step"] == N_TRAIN // MB
    assert sorted(os.listdir(prof_dir)) == ["w0-task-1.pt.trace.json"]
    import json

    with open(prof_dir / "w0-task-1.pt.trace.json") as f:
        events = json.load(f)["traceEvents"]
    names = {str(e.get("name", "")) for e in events}
    assert any(n.startswith("aten::") for n in names)  # the steps' operators
    assert any("Backward" in n for n in names)  # and their backward
    order = [r["task_id"] for m, r in master.calls if m == "ReportTaskResult"]
    assert order[:2] == [1, 0]


def test_preemption_snapshot_saves_and_publishes_the_parked_state(tmp_path, monkeypatch):
    """``preemption_snapshot`` (the SIGTERM path of ``worker/main.py``, run
    here in-process): the task loop parks at its next boundary, the
    undispatched preps and leases go back to the master requeued and the
    pipelined task's report lands (all from the preemption thread, in
    sequence order), and the live state is saved and published at its
    step."""
    import threading

    from elasticdl_tpu_torch.worker import worker as wmod

    train, val = _data(tmp_path)
    ckpt = str(tmp_path / "ckpt")
    config = JobConfig(training_data=train, validation_data=val, checkpoint_dir=ckpt,
                       **dict(_JOB, evaluation_steps=0, checkpoint_steps=0,
                              task_pipelining=True))
    reader = create_data_reader(train)
    servicer = MasterServicer(TaskDispatcher(reader.create_shards(MB * PER_TASK), num_epochs=1))
    master = _Recording(DirectMasterProxy(servicer))
    worker = Worker(config, master, reader, worker_id="w0", spec=tlm.model_spec(**_MODEL),
                    device="cpu")
    master.worker = worker
    result = {}

    class _Stop(Exception):
        pass

    orig_report = master.call

    def call(method, request):
        resp = orig_report(method, request)
        if (method == "ReportTaskResult" and request.get("task_id") == 1
                and "thread" not in result):
            result["thread"] = threading.Thread(
                target=lambda: result.setdefault("saved", worker.preemption_snapshot()))
            result["thread"].start()
        return resp

    master.call = call

    class _Clock:
        """The worker module's clock, with a sleep that can end the loop."""
        stop = False

        def __getattr__(self, name):
            return getattr(time, name)

        def sleep(self, s):
            if self.stop:
                raise _Stop()
            time.sleep(s)

    clock = _Clock()
    monkeypatch.setattr(wmod, "time", clock)
    loop = threading.Thread(target=lambda: pytest.raises(_Stop, worker.run), daemon=True)
    loop.start()
    deadline = time.monotonic() + 60
    while "saved" not in result and time.monotonic() < deadline:
        time.sleep(0.05)
    assert result.get("saved") is True
    step = worker.state.step
    assert worker._parked and read_manifest(ckpt)["step"] == step
    saved = CheckpointManager(ckpt).restore(step)
    for key, value in worker.trainer.host_state(worker.state).items():
        assert np.array_equal(saved[key], value), key
    status = servicer.JobStatus({})
    # Every task is done (its steps are in the snapshot) or back in todo.
    assert status["done"] == step // PER_TASK
    assert status["doing"] == 0 and status["done"] + status["todo"] == N_TRAIN // (MB * PER_TASK)

    clock.stop = True  # the parked loop's next sleep ends it
    loop.join(timeout=10)
    assert not loop.is_alive()


# ---- DeepFM: vector (AUC histogram) metrics through the job ----

_DFM = dict(buckets_per_feature=512, embedding_dim=4, hidden=(16,), compute_dtype="float32",
            host_tier=False)
DFM_TRAIN, DFM_VAL = 96, 36  # 6 tasks of 2 minibatches of 8; a masked eval tail of 4
#: DeepFM job tolerances (f32): each training loss and eval metric (the AUC
#: histograms included) rtol 1e-5 / atol 1e-7.  The final arrays, rtol 1e-4
#: and an atol per array: the Adam moments 1e-5 x the array's largest
#: magnitude (measured: at most 1.2e-6 of it); the parameters 1e-4, a tenth
#: of one Adam step at lr 1e-3 (measured: at most 6.5e-5, in the table).
#: Adam moves a parameter by about lr * g / (|g| + eps), so a table entry
#: whose few gradients nearly cancel (|g| near eps) turns their f32
#: rounding into a visible fraction of a step.
DFM_RTOL, DFM_ATOL = 1e-5, 1e-7
DFM_STATE_RTOL, DFM_MOMENT_REL, DFM_PARAM_ATOL = 1e-4, 1e-5, 1e-4


def _dfm_data(tmp_path):
    from elasticdl_tpu_torch.data.synthetic import synthetic_criteo

    train, val = str(tmp_path / "train.rio"), str(tmp_path / "val.rio")
    synthetic_criteo(train, DFM_TRAIN, seed=11, container="recordio")
    synthetic_criteo(val, DFM_VAL, seed=12, container="recordio")
    return train, val


@pytest.fixture
def carried_deepfm(monkeypatch):
    """The port's ``Trainer.init_state`` starts from the JAX DeepFM init."""
    from elasticdl_tpu.models import deepfm as jdeepfm

    params = jax.device_get(jdeepfm.model_spec(**_DFM).init(jax.random.key(0)))
    orig = ttrainer.Trainer.init_state

    def init_state(self, seed):
        state = orig(self, seed)
        state.model.load_jax_params(params)
        return state

    monkeypatch.setattr(ttrainer.Trainer, "init_state", init_state)
    return params


@pytest.mark.parametrize("mode", [
    dict(),
    dict(task_pipelining=True, prep_depth=2, ingest_threads=2),
], ids=["synchronous", "prep_ahead_ingest_pool"])
def test_deepfm_job_matches_the_jax_job(tmp_path, carried_deepfm, mode):
    """Both packages run DeepFM over the same Criteo RecordIO files from
    the same weights: the same tasks and eval rounds, each training loss,
    each eval task's metrics with the AUC histograms (lists), the rounds'
    ``auc``, and the final arrays (parameters, Adam moments, count)."""
    from elasticdl_tpu.models import deepfm as jdeepfm
    from elasticdl_tpu_torch.common.metrics import AUC_NEG, AUC_POS
    from elasticdl_tpu_torch.models import deepfm

    train, val = _dfm_data(tmp_path)
    overrides = dict(model_def="deepfm.model_spec", **mode)
    jres, jserv, jmaster, jworker = _run_jax_job(
        tmp_path, train, val, str(tmp_path / "jax_ckpt"), spec=jdeepfm.model_spec(**_DFM),
        **overrides)
    res, serv, master, worker = _run_port_job(
        train, val, str(tmp_path / "port_ckpt"), spec=deepfm.model_spec(**_DFM), **overrides)

    n_tasks = DFM_TRAIN // (MB * PER_TASK)
    jstatus, status = jserv.JobStatus({}), serv.JobStatus({})
    assert status["done"] == jstatus["done"] == n_tasks
    assert res["tasks_done"] == jres["tasks_done"]
    assert res["step"] == jres["step"] == DFM_TRAIN // MB
    assert status["eval_rounds"] == jstatus["eval_rounds"] >= 2
    losses, jlosses = master.training_losses(), jmaster.training_losses()
    assert len(losses) == len(jlosses) == n_tasks
    np.testing.assert_allclose(losses, jlosses, rtol=DFM_RTOL, atol=DFM_ATOL)
    # Training reports carry no histograms, as the reference's.
    for m, r in master.calls:
        if m == "ReportTaskResult" and r.get("task_type") == "training" and r["success"]:
            assert sorted(r["metrics"]) == ["accuracy", "calibration", "loss"]
    evals, jevals = master.eval_metrics(), jmaster.eval_metrics()
    assert len(evals) == len(jevals) > 0
    for (m, w), (jm, jw) in zip(evals, jevals):
        assert w == jw and sorted(m) == sorted(jm)
        assert isinstance(m[AUC_POS], list) and len(m[AUC_POS]) == 512
        # Histogram means over real rows: positives and negatives sum to 1.
        assert sum(m[AUC_POS]) + sum(m[AUC_NEG]) == pytest.approx(1.0, rel=1e-6)
        for k in m:
            np.testing.assert_allclose(m[k], jm[k], rtol=DFM_RTOL, atol=DFM_ATOL, err_msg=k)
    assert "auc" in status["eval_metrics"] and AUC_POS not in status["eval_metrics"]
    assert sorted(status["eval_metrics"]) == sorted(jstatus["eval_metrics"])
    for k, v in jstatus["eval_metrics"].items():
        np.testing.assert_allclose(status["eval_metrics"][k], v, rtol=DFM_RTOL, atol=DFM_ATOL,
                                   err_msg=k)
    ours, theirs = worker.trainer.host_state(worker.state), _jax_canonical(jworker)
    assert sorted(ours) == sorted(theirs)
    for key, ref in theirs.items():
        atol = (DFM_PARAM_ATOL if key.startswith("params/")
                else DFM_MOMENT_REL * float(np.abs(ref).max()))
        np.testing.assert_allclose(ours[key], ref, rtol=DFM_STATE_RTOL, atol=atol, err_msg=key)


def _histogram_metrics(logits, batch, mask=None):
    """A small spec's metrics with a vector pair (16-bin AUC histograms of a
    per-sequence score against a per-sequence label), beside its loss."""
    from elasticdl_tpu_torch.common.metrics import AUC_NEG, AUC_POS

    score = torch.softmax(logits.float(), dim=-1)[..., 0].mean(dim=-1).clamp(0, 1)
    label = (batch["labels"][:, 0] % 2).float()
    m = torch.ones_like(score) if mask is None else mask.float()
    idx = (score * 16).long().clamp(0, 15)
    count = m.sum().clamp_min(1e-12)
    pos = torch.zeros(16, device=score.device).index_add_(0, idx, m * label) / count
    neg = torch.zeros(16, device=score.device).index_add_(0, idx, m * (1 - label)) / count
    return {"loss": tlm._loss(logits, batch, mask=mask), AUC_POS: pos, AUC_NEG: neg}


def test_vector_metrics_pass_through_training_and_eval_tasks(tmp_path):
    """Metrics that are vectors (the AUC histogram pair) through a training
    task and an eval task of the port's worker: training drops them before
    the fetch and reports scalars; eval accumulates them in float64 and
    reports lists; the master's round finalizes them into ``auc``.  Before
    vector metrics were supported, the training task raised in
    ``_start_metrics_fetch`` (``torch.stack`` of unequal shapes) and the
    eval task in ``float(v)``."""
    from elasticdl_tpu_torch.common.metrics import AUC_NEG, AUC_POS

    train, val = _data(tmp_path)
    spec = tlm.model_spec(**_MODEL)
    spec.metrics = _histogram_metrics
    res, serv, master, worker = _run_port_job(train, val, str(tmp_path / "ckpt"), spec=spec)
    assert worker.recoveries == 0
    status = serv.JobStatus({})
    assert status["done"] == N_TRAIN // (MB * PER_TASK) and status["eval_rounds"] >= 2
    trains = [r for m, r in master.calls if m == "ReportTaskResult"
              and r.get("task_type") == "training" and not r.get("requeue")]
    assert trains and all(r["success"] and sorted(r["metrics"]) == ["loss"] for r in trains)
    evals = master.eval_metrics()
    assert evals
    for m, weight in evals:
        assert isinstance(m[AUC_POS], list) and len(m[AUC_POS]) == 16
        assert sum(m[AUC_POS]) + sum(m[AUC_NEG]) == pytest.approx(1.0, rel=1e-9)
    assert 0.0 <= status["eval_metrics"]["auc"] <= 1.0
    assert AUC_POS not in status["eval_metrics"]
    # An evaluation job alone (its tasks are the eval step's only path).
    from elasticdl_tpu_torch.master.task_dispatcher import TASK_EVALUATION

    reader = create_data_reader(val)
    eval_master = _Recording(DirectMasterProxy(MasterServicer(TaskDispatcher(
        reader.create_shards(MB * PER_TASK), task_type=TASK_EVALUATION))))
    eval_worker = Worker(JobConfig(model_def="transformer_lm.model_spec", job_type="evaluation",
                                   minibatch_size=MB), eval_master, reader, spec=spec,
                         device="cpu")
    eval_master.worker = eval_worker
    eval_worker.run()
    reports = [r for m, r in eval_master.calls if m == "ReportTaskResult"]
    assert len(reports) == -(-N_VAL // (MB * PER_TASK)) and all(r["success"] for r in reports)
    assert all(len(r["metrics"][AUC_NEG]) == 16 for r in reports)


def test_training_metrics_fetch_reduces_vectors_like_the_reference():
    """``_start_metrics_fetch`` + ``_finalize_training_metrics`` on
    per-step metrics holding vectors: one copy of one flattened row per
    step, vector entries summed over the steps and divided like the
    scalars, then finalized (the reference's ``_finalize_training_metrics``,
    run here on the same numbers)."""
    from elasticdl_tpu.common.metrics import finalize_metrics as jfinalize
    from elasticdl_tpu_torch.common.metrics import AUC_NEG, AUC_POS

    rng = np.random.default_rng(0)
    steps = [{"loss": rng.random(), AUC_POS: rng.random(8), AUC_NEG: rng.random(8)}
             for _ in range(3)]
    worker = Worker(JobConfig(), master=None, reader=None, spec=tlm.model_spec(**_MODEL),
                    device="cpu")
    fetch = worker._start_metrics_fetch(
        [{k: torch.tensor(v, dtype=torch.float32) for k, v in s.items()} for s in steps])
    keys, shapes, host, event = fetch
    assert host.shape == (3, 1 + 8 + 8) and event is None
    ours = worker._finalize_training_metrics(fetch)
    f32 = [{k: np.asarray(v, np.float32) for k, v in s.items()} for s in steps]
    want = jfinalize({k: sum(np.asarray(s[k], np.float64) for s in f32) / 3 for k in f32[0]})
    assert sorted(ours) == sorted(want) == ["auc", "loss"]
    for k, v in want.items():
        assert ours[k] == pytest.approx(v, rel=1e-12)


class _SlowCountingReader(_Mux):
    """``_Mux`` with a 0.3 s read that counts the ``read_records`` calls in
    flight at once; ``thread_safe_ranges`` is the class's own declaration
    (the base ``_Mux`` leaves it unset, like a shared-connection reader)."""

    def __init__(self, train, val, thread_safe_ranges):
        super().__init__(train, val)
        self.thread_safe_ranges = thread_safe_ranges
        self._lock = __import__("threading").Lock()
        self.active = self.peak = 0

    def read_records(self, shard):
        with self._lock:
            self.active += 1
            self.peak = max(self.peak, self.active)
        try:
            time.sleep(0.3)
            return list(super().read_records(shard))
        finally:
            with self._lock:
                self.active -= 1


@pytest.mark.parametrize("thread_safe", [False, True], ids=["shared-connection", "thread-safe"])
def test_prep_pool_is_one_thread_for_a_reader_without_thread_safe_ranges(tmp_path, thread_safe):
    """The reference's width rule for the prep-ahead pool: ``prep_depth``
    threads only for a reader that declares ``thread_safe_ranges``, else
    one, so a reader that holds one connection never sees two
    ``read_records`` calls at once.  With ``prep_depth=2`` the worker
    leases two tasks back to back and preps both: the thread-safe reader
    reads them together, its ranges also split over the ingest pool (peak
    at least 2), the other one one call at a time (peak 1)."""
    train, val = _data(tmp_path)
    config = JobConfig(training_data=train, validation_data=val,
                       checkpoint_dir=str(tmp_path / "ckpt"),
                       **dict(_JOB, task_pipelining=True, prep_depth=2,
                              evaluation_steps=0, checkpoint_steps=0))
    reader, eval_reader = create_data_reader(train), create_data_reader(val)
    per_task = config.minibatch_size * config.num_minibatches_per_task
    servicer = MasterServicer(TaskDispatcher(reader.create_shards(per_task), num_epochs=1))
    counting = _SlowCountingReader(reader, eval_reader, thread_safe)
    worker = Worker(config, DirectMasterProxy(servicer), counting, worker_id="w0",
                    spec=tlm.model_spec(**_MODEL), device="cpu")
    result = worker.run()
    assert result["step"] == N_TRAIN // MB
    assert counting.peak >= 2 if thread_safe else counting.peak == 1
