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

    def call(self, method, request):
        if method in ("ReportTaskResult", "ReportCheckpoint"):
            self.calls.append((method, dict(request)))
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


def _run_jax_job(tmp_path, train, val, ckpt_dir):
    config = JaxJobConfig(training_data=train, validation_data=val,
                          checkpoint_dir=ckpt_dir, **_JOB)
    reader, eval_reader = jax_create_data_reader(train), jax_create_data_reader(val)
    per_task = MB * PER_TASK
    servicer = JaxMasterServicer(
        JaxTaskDispatcher(reader.create_shards(per_task), num_epochs=1),
        evaluation=JaxEvaluationService(eval_reader.create_shards(per_task),
                                        evaluation_steps=config.evaluation_steps),
    )
    master = _Recording(JaxDirectMasterProxy(servicer))
    worker = JaxWorker(config, master, _Mux(reader, eval_reader), worker_id="w0",
                       spec=_jax_spec(), devices=jax.devices()[:1])
    result = worker.run()
    return result, servicer, master, worker


def _run_port_job(train, val, ckpt_dir, **overrides):
    config = JobConfig(training_data=train, validation_data=val,
                       checkpoint_dir=ckpt_dir, **dict(_JOB, **overrides))
    reader, eval_reader = create_data_reader(train), create_data_reader(val)
    per_task = MB * PER_TASK
    servicer = MasterServicer(
        TaskDispatcher(reader.create_shards(per_task), num_epochs=1),
        evaluation=EvaluationService(eval_reader.create_shards(per_task),
                                     evaluation_steps=config.evaluation_steps),
    )
    master = _Recording(DirectMasterProxy(servicer))
    worker = Worker(config, master, _Mux(reader, eval_reader), worker_id="w0",
                    spec=tlm.model_spec(**_MODEL), device="cpu")
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


def test_port_job_matches_the_jax_job(tmp_path, carried_init):
    train, val = _data(tmp_path)
    jax_dir, port_dir = str(tmp_path / "jax_ckpt"), str(tmp_path / "port_ckpt")
    jres, jserv, jmaster, jworker = _run_jax_job(tmp_path, train, val, jax_dir)
    res, serv, master, worker = _run_port_job(train, val, port_dir)

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
    orig = ttrainer.Trainer.train_step
    calls = {"n": 0}

    def flaky(self, state, batch):
        calls["n"] += 1
        state, metrics = orig(self, state, batch)
        if calls["n"] == 7:  # after the step-4 checkpoint, mid-task
            raise RuntimeError("injected step failure")
        return state, metrics

    monkeypatch.setattr(ttrainer.Trainer, "train_step", flaky)
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
    spec = tlm.model_spec(**_MODEL)
    for kwargs, what in (
        (dict(multihost=True), "gang mode"),
        (dict(collective_deadline_ms=100.0), "collective gate"),
        (dict(use_async=True), "host-tier I/O"),
    ):
        with pytest.raises(NotImplementedError, match=what):
            Worker(JobConfig(**kwargs), master=None, reader=None, spec=spec, device="cpu")
    worker = Worker(JobConfig(), master=None, reader=None, spec=spec, device="cpu")
    with pytest.raises(NotImplementedError, match="preemption"):
        worker.preemption_snapshot()
    assert isinstance(worker.trainer.device, torch.device)
