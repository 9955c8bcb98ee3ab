"""The PyTorch port's master: its wire tables, its copies of the
dispatcher, evaluation service and servicer against the reference's, and
jobs that cross the two packages over real localhost gRPC.

The master modules are copies (imports rewritten), so each dispatcher and
servicer scenario runs on both packages and the two transcripts must be
equal, beside the scenario's own assertions.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest

from elasticdl_tpu.common import rpc as jrpc
from elasticdl_tpu.common.config import JobConfig as JaxJobConfig
from elasticdl_tpu.data import reader as jreader
from elasticdl_tpu.master import evaluation_service as jeval
from elasticdl_tpu.master import rendezvous as jrdv
from elasticdl_tpu.master import servicer as jserv
from elasticdl_tpu.master import task_dispatcher as jdisp
from elasticdl_tpu.models.spec import load_model_spec as jax_load_model_spec
from elasticdl_tpu.worker.worker import RpcMasterProxy as JaxRpcMasterProxy
from elasticdl_tpu.worker.worker import Worker as JaxWorker
from elasticdl_tpu_torch.common import rpc as trpc
from elasticdl_tpu_torch.common.checkpoint import read_manifest
from elasticdl_tpu_torch.common.config import JobConfig
from elasticdl_tpu_torch.data import reader as treader
from elasticdl_tpu_torch.data.synthetic import generate
from elasticdl_tpu_torch.master import evaluation_service as teval
from elasticdl_tpu_torch.master import rendezvous as trdv
from elasticdl_tpu_torch.master import servicer as tserv
from elasticdl_tpu_torch.master import task_dispatcher as tdisp
from elasticdl_tpu_torch.models import transformer_lm as tlm
from elasticdl_tpu_torch.worker.worker import RpcMasterProxy, Worker

_PACKAGES = {
    "port": dict(Shard=treader.Shard, TaskDispatcher=tdisp.TaskDispatcher,
                 EvaluationService=teval.EvaluationService,
                 RendezvousServer=trdv.RendezvousServer,
                 MasterServicer=tserv.MasterServicer),
    "jax": dict(Shard=jreader.Shard, TaskDispatcher=jdisp.TaskDispatcher,
                EvaluationService=jeval.EvaluationService,
                RendezvousServer=jrdv.RendezvousServer,
                MasterServicer=jserv.MasterServicer),
}


def _fields(schema):
    return {
        "required": {k: tuple(t.__name__ for t in v) for k, v in schema.required.items()},
        "optional": {k: tuple(t.__name__ for t in v) for k, v in schema.optional.items()},
        "since": dict(schema.since),
    }


@pytest.mark.parametrize("table", [
    "MASTER_SCHEMAS", "MASTER_RESPONSE_SCHEMAS", "SERVING_SCHEMAS", "SERVING_RESPONSE_SCHEMAS",
])
def test_wire_tables_equal_the_reference_field_for_field(table):
    ours, theirs = getattr(trpc, table), getattr(jrpc, table)
    assert sorted(ours) == sorted(theirs)
    for method in theirs:
        assert dataclasses.is_dataclass(ours[method])
        assert _fields(ours[method]) == _fields(theirs[method]), method
    assert trpc.PROTOCOL_VERSION == jrpc.PROTOCOL_VERSION
    assert trpc.SERVICE_NAME == jrpc.SERVICE_NAME
    assert trpc.SERVING_SERVICE_NAME == jrpc.SERVING_SERVICE_NAME
    assert sorted(tserv.MasterServicer(tdisp.TaskDispatcher([])).method_table()) == sorted(
        trpc.MASTER_SCHEMAS)


# ---- dispatcher and servicer scenarios, run on both packages ----


def _shards(p, n, size=10):
    return [p["Shard"]("f", i * size, (i + 1) * size) for i in range(n)]


def _handout_and_done(p):
    d = p["TaskDispatcher"](_shards(p, 3))
    tasks = [d.get_task("w0") for _ in range(3)]
    assert d.get_task("w0") is None and not d.finished()
    ok = [d.report(t.task_id, True) for t in tasks]
    assert d.finished() and all(ok)
    return [t.to_dict() for t in tasks], d.counts()


def _failure_requeues(p):
    d = p["TaskDispatcher"](_shards(p, 2))
    t = d.get_task("w0")
    d.report(t.task_id, False)
    t2 = d.get_task("w1")
    assert t2.shard == t.shard
    d.report(t2.task_id, True)
    t3 = d.get_task("w1")
    d.report(t3.task_id, True)
    assert d.finished()
    return [t.to_dict(), t2.to_dict(), t3.to_dict()], d.counts()


def _requeue_flag_is_free(p):
    d = p["TaskDispatcher"](_shards(p, 1), max_task_retries=1)
    for _ in range(3):  # returned unstarted three times: no retry charged
        t = d.get_task("w0")
        d.report(t.task_id, False, requeue_only=True)
    t = d.get_task("w0")
    d.report(t.task_id, True)
    assert d.finished() and d.counts()["abandoned"] == 0
    return d.counts()


def _poison_task_abandoned(p):
    d = p["TaskDispatcher"](_shards(p, 1), max_task_retries=2)
    for _ in range(3):
        t = d.get_task("w0")
        d.report(t.task_id, False)
    assert d.get_task("w0") is None and d.finished()
    assert d.counts()["abandoned"] == 1
    return d.counts()


def _dead_worker_requeued_exactly_once(p):
    servicer = p["MasterServicer"](p["TaskDispatcher"](_shards(p, 4)),
                                   rendezvous=p["RendezvousServer"]())
    servicer.RegisterWorker({"worker_id": "w0"})
    resp = servicer.GetTask({"worker_id": "w0", "lease": 4})
    ids = [t["task_id"] for t in resp["tasks"]]
    servicer.ReportTaskResult({"worker_id": "w0", "task_id": ids[0], "success": True})
    servicer.DeregisterWorker({"worker_id": "w0"})
    d = servicer.dispatcher
    assert d.counts()["todo"] == 3 and d.recover_tasks("w0") == []
    # A late success from the lost worker is rejected and counted.
    late = servicer.ReportTaskResult({"worker_id": "w0", "task_id": ids[1], "success": True})
    servicer.RegisterWorker({"worker_id": "w1"})
    resp = servicer.GetTask({"worker_id": "w1", "lease": 8})
    assert sorted(t["task_id"] for t in resp["tasks"]) == sorted(ids[1:])
    for t in resp["tasks"]:
        servicer.ReportTaskResult({"worker_id": "w1", "task_id": t["task_id"], "success": True})
    status = servicer.JobStatus({})
    assert status["finished"] and status["done"] == 4
    return late, {k: status[k] for k in ("todo", "doing", "done", "duplicate_done")}


def _eval_interleaving(p):
    s = p["MasterServicer"](p["TaskDispatcher"](_shards(p, 2)),
                            evaluation=p["EvaluationService"](_shards(p, 2), 1))
    s.ReportVersion({"worker_id": "w0", "model_version": 5})
    types = []
    for weight, acc in ((10, 0.9), (30, 0.5)):
        resp = s.GetTask({"worker_id": "w0"})
        types.append(resp["task"]["type"])
        s.ReportTaskResult({"worker_id": "w0", "task_id": resp["task"]["task_id"],
                            "success": True, "task_type": "evaluation",
                            "metrics": {"accuracy": acc}, "weight": weight})
    types.append(s.GetTask({"worker_id": "w0"})["task"]["type"])
    status = s.JobStatus({})
    assert types == ["evaluation", "evaluation", "training"]
    assert status["eval_metrics"]["accuracy"] == pytest.approx(0.6)  # (9 + 15) / 40
    return types, status["eval_metrics"], status["eval_rounds"]


def _timeout_requeue(p):
    now = [0.0]
    d = p["TaskDispatcher"](_shards(p, 1), task_timeout_s=5.0, clock=lambda: now[0])
    t = d.get_task("w0")
    now[0] = 10.0
    t2 = d.get_task("w1")
    assert t2.shard == t.shard
    first, second = d.report(t.task_id, True), d.report(t2.task_id, True)
    assert first and not second and d.finished()
    return first, second, d.counts()


_CASES = {f.__name__.lstrip("_"): f for f in (
    _handout_and_done, _failure_requeues, _requeue_flag_is_free, _poison_task_abandoned,
    _dead_worker_requeued_exactly_once, _eval_interleaving, _timeout_requeue,
)}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_master_copies_behave_as_the_reference(case):
    port = _CASES[case](_PACKAGES["port"])
    ref = _CASES[case](_PACKAGES["jax"])
    assert port == ref


# ---- jobs across the two packages over localhost gRPC ----

SEQ, VOCAB, MB = 32, 128, 4
_MODEL = dict(vocab=VOCAB, dim=32, n_heads=2, n_layers=1, max_seq=SEQ, seq_len=SEQ,
              compute_dtype="float32")
_JOB = dict(model_def="transformer_lm.model_spec", minibatch_size=MB,
            num_minibatches_per_task=2, evaluation_steps=4, checkpoint_steps=4,
            keep_checkpoint_max=2)


class _Mux:
    def __init__(self, train, val):
        self._train, self._val = train, val

    def read_records(self, shard):
        r = self._train if os.path.basename(shard.name).startswith("train") else self._val
        return r.read_records(shard)


def _master(p, train, val, evaluation_steps):
    reader, eval_reader = treader.create_data_reader(train), treader.create_data_reader(val)
    servicer = p["MasterServicer"](
        p["TaskDispatcher"]([p["Shard"](s.name, s.start, s.end)
                             for s in reader.create_shards(2 * MB)]),
        evaluation=p["EvaluationService"](
            [p["Shard"](s.name, s.start, s.end) for s in eval_reader.create_shards(2 * MB)],
            evaluation_steps),
    )
    return servicer, _Mux(reader, eval_reader)


def _files(tmp_path):
    train, val = str(tmp_path / "train.rio"), str(tmp_path / "val.rio")
    generate("lm", train, 32, seed=0, seq_len=SEQ, vocab=VOCAB)
    generate("lm", val, 10, seed=1, seq_len=SEQ, vocab=VOCAB)
    return train, val


def test_port_worker_completes_a_job_against_the_jax_master(tmp_path):
    train, val = _files(tmp_path)
    servicer, mux = _master(_PACKAGES["jax"], train, val, _JOB["evaluation_steps"])
    server = jserv.MasterServer(servicer, port=0).start()
    ckpt = str(tmp_path / "ckpt")
    try:
        proxy = RpcMasterProxy(server.address, timeout_s=10.0)
        config = JobConfig(training_data=train, validation_data=val, checkpoint_dir=ckpt, **_JOB)
        result = Worker(config, proxy, mux, worker_id="torch-w0",
                        spec=tlm.model_spec(**_MODEL), device="cpu").run()
        proxy.close()
    finally:
        server.stop()
    status = servicer.JobStatus({})
    assert status["finished"] and status["done"] == 4 and status["duplicate_done"] == 0
    assert result["step"] == 8 and status["model_version"] == 8
    # With prep-ahead (the default) the port worker runs the reference's
    # dispatch order: this 4-task job gets one eval round, as the JAX
    # worker's does (the next test; tests/test_torch_job.py holds the
    # rounds equal across packages).
    assert status["eval_rounds"] == 1 and np.isfinite(status["eval_metrics"]["loss"])
    assert servicer.GetCheckpoint({})["step"] == 8 and read_manifest(ckpt)["step"] == 8
    assert set(status["phase_times"]["torch-w0"]) >= {"dispatch", "step_wait", "lease_wait"}


def test_jax_worker_completes_a_job_against_the_port_master(tmp_path):
    train, val = _files(tmp_path)
    servicer, mux = _master(_PACKAGES["port"], train, val, _JOB["evaluation_steps"])
    server = tserv.MasterServer(servicer, port=0).start()
    try:
        proxy = JaxRpcMasterProxy(server.address, timeout_s=10.0)
        config = JaxJobConfig(training_data=train, validation_data=val, **_JOB)
        spec = jax_load_model_spec("elasticdl_tpu.models", "transformer_lm.model_spec", **_MODEL)
        result = JaxWorker(config, proxy, mux, worker_id="jax-w0", spec=spec,
                           devices=jax.devices()[:1]).run()
    finally:
        server.stop()
    status = servicer.JobStatus({})
    assert status["finished"] and status["done"] == 4 and status["duplicate_done"] == 0
    assert result["step"] == 8 and status["eval_rounds"] >= 1
