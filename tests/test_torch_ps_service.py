"""The PyTorch port's PS service tier (``ps/service.py``, ``ps/reshard.py``,
``ps/main.py``) against the JAX package's, and the host tier through the
port's entry points: the trainer on a fleet, the in-process job against
the JAX job, the CLI job with ``--num_ps_pods=2`` whose PS pod is
SIGKILLed, and two gloo ranks against one fleet.

The wire is the reference's byte for byte, so the checks cross the
packages in both directions: a port client against reference shards and a
reference client against port shards give the rows a local store gives,
bit for bit (every side runs the same C++ store).  Snapshots one package's
shards write are read, resharded and restored by the other; resharded
files are equal byte for byte.

Tolerances: pulls, pushes, snapshots and reshards are exact.  The job: each
training loss and eval metric rtol 1e-5; the final dense arrays as
tests/test_torch_job.py holds DeepFM's (parameters atol 1e-4, moments 1e-5 of
their largest); the fleet's touched rows atol 1e-6 at ``learning_rate=1e-4``
(tests/test_torch_host_tier.py says why the rate).  The gang's first loss
against one process on the same global batch: 5e-5.
"""

import ast
import json
import os
import shutil
import signal
import subprocess
import sys
import time

import grpc
import jax
import numpy as np
import pytest

import elasticdl_tpu.parallel  # noqa: F401  (the JAX package's own import order)
from _torch_gloo_ranks import host_tier_steps, run_ranks
from _torch_reference_native import reference_native  # noqa: F401  (a fixture)
from elasticdl_tpu.ps import host_store as jhost_store
from elasticdl_tpu.ps import reshard as jreshard
from elasticdl_tpu.ps import service as jservice
from elasticdl_tpu_torch.common import gauge as gaugelib
from elasticdl_tpu_torch.common.config import JobConfig
from elasticdl_tpu_torch.models import deepfm
from elasticdl_tpu_torch.models.spec import HostTableIO
from elasticdl_tpu_torch.parallel.mesh import Mesh
from elasticdl_tpu_torch.parallel.trainer import Trainer
from elasticdl_tpu_torch.ps import reshard, service

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IO = HostTableIO(ids_fn=None, dim=5, optimizer="adagrad", learning_rate=0.05, init_scale=0.02)
IO_ADAM = HostTableIO(ids_fn=None, dim=3, optimizer="adam", learning_rate=0.01, init_scale=0.05)
KEY = deepfm.HOST_FM_KEY
DFM = dict(buckets_per_feature=512, embedding_dim=4, hidden=(16,), compute_dtype="float32",
           host_tier=True, learning_rate=1e-4)
PKG = {"port": service, "jax": jservice}


def _fleet(pkg, tables, n):
    return [PKG[pkg].PSServer(tables, shard=s, num_shards=n,
                              gauges=(gaugelib.Registry() if pkg == "port" else None)).start()
            for s in range(n)]


def _stop(servers):
    for s in servers:
        s.stop(grace=0)


# ---- the frame ----

def test_frames_are_the_reference_frames_byte_for_byte():
    meta = {"table": "t", "step": 3, "nested": {"a": [1, 2]}}
    arrays = {"ids": np.arange(-5, 7, dtype=np.int64).reshape(3, 4),
              "grads": np.linspace(-1, 1, 30, dtype=np.float32).reshape(6, 5),
              "empty": np.zeros((0, 5), np.float32)}
    ours = service.encode_frame(meta, arrays)
    assert ours == jservice.encode_frame(meta, arrays)
    for decode in (service.decode_frame, jservice.decode_frame):
        m, a = decode(ours)
        assert m == meta and sorted(a) == sorted(arrays)
        for k in arrays:
            assert a[k].dtype == arrays[k].dtype and np.array_equal(a[k], arrays[k])
    assert np.array_equal(service.shard_of(np.array([-7, -1, 0, 5]), 3),
                          jservice.shard_of(np.array([-7, -1, 0, 5]), 3))
    assert service.snapshot_filename("k", 1, 3) == jservice.snapshot_filename("k", 1, 3)
    assert service.PS_METHODS == jservice.PS_METHODS
    assert service.parse_ps_addresses("a:1, b:2 ,,c:3") == ["a:1", "b:2", "c:3"]


@pytest.mark.parametrize("payload", [
    b"", b"\x01\x00", b"\xff\x00\x00\x00{}", b"\x02\x00\x00\x00{x",
    b"\x02\x00\x00\x00[]", service.encode_frame({}, {})[:4] + b'{"meta": {}}',
    b'\x3b\x00\x00\x00{"meta": {}, "arrays": [{"name": "x", "dtype": "<f4"}]}  ',
    service.encode_frame({}, {"x": np.ones(4, np.float32)})[:-1],
], ids=["empty", "short", "header_past_payload", "bad_json", "not_a_dict", "no_arrays",
        "bad_descriptor", "array_past_frame"])
def test_malformed_frames_fail_as_the_reference_fails(payload):
    errors = []
    for pkg in (service, jservice):
        with pytest.raises(pkg.PSFrameError) as err:
            pkg.decode_frame(payload)
        errors.append(str(err.value))
    assert errors[0] == errors[1]


@pytest.mark.parametrize("method,meta", [
    ("Pull", {}), ("Pull", {"table": 3}), ("Load", {"directory": "d", "step": 1, "strict": 1}),
    ("Save", {"directory": "d", "step": True}), ("Nope", {}),
])
def test_meta_validation_matches_the_reference(method, meta):
    errors = []
    for pkg in (service, jservice):
        with pytest.raises(pkg.PSFrameError) as err:
            pkg.validate_meta(method, meta)
        errors.append(str(err.value))
    assert errors[0] == errors[1]


# ---- the wire, across the packages ----

@pytest.mark.parametrize("client,server", [("port", "jax"), ("jax", "port")])
@pytest.mark.usefixtures("reference_native")
def test_remote_store_works_across_the_packages(tmp_path, client, server):
    """Pull, push, stats, save and load through one package's client
    against the other's shards: the rows a local store gives, bit for bit."""
    servers = _fleet(server, {"t": IO, "a": IO_ADAM}, 2)
    remote = PKG[client].RemoteEmbeddingStore("t", IO.dim, [s.address for s in servers])
    try:
        remote.wait_ready()
        local = jhost_store.HostEmbeddingStore(dim=IO.dim, optimizer=IO.optimizer,
                                               learning_rate=IO.learning_rate,
                                               init_scale=IO.init_scale)
        rng = np.random.default_rng(3)
        ids = rng.integers(-(1 << 33), 1 << 33, (40, 7)).astype(np.int64)
        assert np.array_equal(remote.pull(ids), local.pull(ids))
        for _ in range(2):
            push = np.concatenate([ids.ravel(), ids[:5].ravel()])
            grads = rng.standard_normal((push.size, IO.dim)).astype(np.float32)
            remote.push_grad(push, grads)
            local.push_grad(push, grads)
        assert np.array_equal(remote.pull(ids), local.pull(ids))
        assert len(remote) == len(local)
        meta, _ = PKG[client].PSClient(servers[1].address).call("Stats", {})
        assert meta["shard"] == 1 and meta["num_shards"] == 2 and meta["restored_step"] is None
        assert remote.restored_steps() == [None, None]
        remote.save_snapshot(str(tmp_path), 4)
        for s in range(2):
            assert os.path.exists(tmp_path / "host_stores" / "4" / service.snapshot_filename("t", s, 2))
        assert remote.load_snapshot(str(tmp_path), 4)
        assert remote.restored_steps() == [4, 4]
        assert not remote.load_snapshot(str(tmp_path), 9, strict=False)
        with pytest.raises(FileNotFoundError):
            remote.load_snapshot(str(tmp_path), 9)
        # A malformed request fails at the boundary, with the reference's
        # status and message.
        channel = grpc.insecure_channel(servers[0].address)
        call = channel.unary_unary(f"/{service.PS_SERVICE_NAME}/Pull",
                                   request_serializer=lambda b: b,
                                   response_deserializer=lambda b: b)
        with pytest.raises(grpc.RpcError) as err:
            call(service.encode_frame({"table": "nope"}, {"ids": np.zeros(2, np.int64)}),
                 timeout=10)
        assert err.value.code() == grpc.StatusCode.INVALID_ARGUMENT
        assert "unknown table 'nope'" in err.value.details()
        channel.close()
    finally:
        remote.close()
        _stop(servers)


@pytest.mark.usefixtures("reference_native")
def test_a_snapshot_of_either_package_restores_into_the_other(tmp_path):
    jax_fleet = _fleet("jax", {"t": IO}, 2)
    remote = jservice.RemoteEmbeddingStore("t", IO.dim, [s.address for s in jax_fleet])
    ids = np.arange(-50, 150, dtype=np.int64)
    try:
        remote.push_grad(ids, np.ones((ids.size, IO.dim), np.float32))
        want = remote.pull(ids)
        remote.save_snapshot(str(tmp_path), 8)
    finally:
        remote.close()
        _stop(jax_fleet)
    port_fleet = _fleet("port", {"t": IO}, 2)
    try:
        assert [s.restore_latest(str(tmp_path)) for s in port_fleet] == [8, 8]
        remote = service.RemoteEmbeddingStore("t", IO.dim, [s.address for s in port_fleet])
        assert np.array_equal(remote.pull(ids), want) and remote.restored_steps() == [8, 8]
        remote.close()
    finally:
        _stop(port_fleet)


# ---- reshard ----

@pytest.mark.parametrize("old,new", [(2, 3), (3, 2)])
@pytest.mark.usefixtures("reference_native")
def test_reshard_matches_the_reference(tmp_path, old, new):
    """The port's reshard of a snapshot the reference's shards wrote equals
    the reference's, file for file (rows and optimizer slots), and loads
    into a fleet of the new size with the same rows."""
    tables = {"t": IO, "a": IO_ADAM}
    fleet = _fleet("jax", tables, old)
    addrs = [s.address for s in fleet]
    ids = np.random.default_rng(5).integers(-(1 << 20), 1 << 20, 400).astype(np.int64)
    want = {}
    try:
        for key, io in tables.items():
            remote = jservice.RemoteEmbeddingStore(key, io.dim, addrs)
            for _ in range(2):
                remote.push_grad(ids, np.linspace(-1, 1, ids.size * io.dim, dtype=np.float32)
                                 .reshape(ids.size, io.dim))
            want[key] = remote.pull(ids)
            remote.save_snapshot(str(tmp_path / "src"), 6)
            remote.close()
    finally:
        _stop(fleet)
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    shutil.copytree(tmp_path / "src", ours)
    shutil.copytree(tmp_path / "src", theirs)
    counts = reshard.reshard_step(str(ours), 6, new)
    assert counts == jreshard.reshard_step(str(theirs), 6, new)
    assert counts == {"t": np.unique(ids).size, "a": np.unique(ids).size}
    for key in tables:
        for j in range(new):
            name = service.snapshot_filename(key, j, new)
            a, b = ours / "host_stores" / "6" / name, theirs / "host_stores" / "6" / name
            assert a.read_bytes() == b.read_bytes(), name
            header, rid, t, rows = reshard.read_snapshot(str(a))
            jheader, jid, jt, jrows = jreshard.read_snapshot(str(a))
            assert header == jheader and np.array_equal(rows, jrows) and np.array_equal(t, jt)
    # Both sizes' files now sit side by side: a mixed snapshot is refused.
    for mod, root in ((reshard, ours), (jreshard, theirs)):
        with pytest.raises(ValueError, match="MULTIPLE"):
            mod.reshard_step(str(root), 6, new)
    # The new sharding restores into a fleet of the new size.
    for i in range(old):
        for key in tables:
            os.remove(ours / "host_stores" / "6" / service.snapshot_filename(key, i, old))
    fleet = _fleet("port", tables, new)
    try:
        assert {s.restore_latest(str(ours)) for s in fleet} == {6}
        for key, io in tables.items():
            remote = service.RemoteEmbeddingStore(key, io.dim, [s.address for s in fleet])
            assert np.array_equal(remote.pull(ids), want[key])
            remote.close()
    finally:
        _stop(fleet)
    # A torn snapshot (one shard's file missing) is refused.
    os.remove(ours / "host_stores" / "6" / service.snapshot_filename("t", 0, new))
    with pytest.raises(FileNotFoundError, match="torn"):
        reshard.reshard_step(str(ours), 6, old)


def test_reshard_cli_rewrites_and_prunes(tmp_path):
    fleet = _fleet("port", {"t": IO}, 2)
    remote = service.RemoteEmbeddingStore("t", IO.dim, [s.address for s in fleet])
    ids = np.arange(100, dtype=np.int64)
    try:
        want = remote.pull(ids)
        remote.save_snapshot(str(tmp_path), 2)
    finally:
        remote.close()
        _stop(fleet)
    proc = subprocess.run(
        [sys.executable, "-m", "elasticdl_tpu_torch.ps.reshard", "--directory", str(tmp_path),
         "--step", "2", "--new-shards", "3", "--prune-old"],
        cwd=_REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert sorted(os.listdir(tmp_path / "host_stores" / "2")) == [
        service.snapshot_filename("t", j, 3) for j in range(3)]
    fleet = _fleet("jax", {"t": IO}, 3)
    try:
        assert {s.restore_latest(str(tmp_path)) for s in fleet} == {2}
        remote = jservice.RemoteEmbeddingStore("t", IO.dim, [s.address for s in fleet])
        assert np.array_equal(remote.pull(ids), want)
        remote.close()
    finally:
        _stop(fleet)


# ---- the trainer on a fleet ----

def _port_spec():
    return deepfm.model_spec(**DFM)


def test_multi_rank_world_without_a_fleet_raises():
    """Several ranks with host-tier tables and no PS fleet would train one
    copy of the rows each: refused, pointing at --num_ps_pods; with PS
    addresses the stores are the fleet's."""
    spec = _port_spec()
    with pytest.raises(NotImplementedError, match="num_ps_pods"):
        Trainer(spec, device="cpu", mesh=Mesh({"dp": 2}, rank=0))
    fleet = _fleet("port", spec.host_io, 1)
    try:
        trainer = Trainer(spec, device="cpu", mesh=Mesh({"dp": 2}, rank=1),
                          config=JobConfig(ps_addresses=fleet[0].address))
        assert trainer._remote_ps and not trainer.has_local_host_stores()
        assert trainer._contributor_slice("ids", 64) == slice(32, 64)
    finally:
        _stop(fleet)


def test_eval_job_fails_loud_on_a_fresh_or_divergent_fleet(tmp_path):
    spec = _port_spec()
    fleet = _fleet("port", spec.host_io, 2)
    addrs = ",".join(s.address for s in fleet)
    try:
        def trainer(job_type):
            return Trainer(_port_spec(), device="cpu",
                           config=JobConfig(job_type=job_type, ps_addresses=addrs))

        with pytest.raises(RuntimeError, match="no PS shard restored"):
            trainer("evaluation").restore_host_stores(str(tmp_path), 5)
        assert trainer("training").restore_host_stores(str(tmp_path), 5)
        store = service.RemoteEmbeddingStore(KEY, 5, [s.address for s in fleet])
        store.pull(np.arange(32, dtype=np.int64))
        store.save_snapshot(str(tmp_path), 7)
        fleet[0]._load({"directory": str(tmp_path), "step": 7, "strict": True}, {})
        store.close()
        with pytest.raises(RuntimeError, match="divergent"):
            trainer("prediction").restore_host_stores(str(tmp_path), 7)
        assert trainer("training").restore_host_stores(str(tmp_path), 7)
        fleet[1]._load({"directory": str(tmp_path), "step": 7, "strict": True}, {})
        assert trainer("evaluation").restore_host_stores(str(tmp_path), 7)
    finally:
        _stop(fleet)


def test_two_gloo_ranks_push_only_their_slices():
    """Two ranks against one 2-shard fleet: each pulls and pushes only its
    contributor slice of the global batch, and the first step's loss is one
    process's on the whole batch."""
    from elasticdl_tpu.models import deepfm as jdeepfm

    params = jax.device_get(jdeepfm.model_spec(**DFM).init(jax.random.key(0)))
    rng = np.random.default_rng(7)
    batches = [{
        "dense": rng.uniform(0, 100, (64, 13)).astype(np.float32),
        "cat": rng.integers(-(1 << 31), 1 << 31, (64, 26)).astype(np.int32),
        "labels": rng.integers(0, 2, (64,)).astype(np.int32),
    } for _ in range(2)]
    spec = _port_spec()
    fleet = _fleet("port", spec.host_io, 2)
    try:
        ranks = run_ranks(host_tier_steps, 2, DFM, params,
                          ",".join(s.address for s in fleet), batches)
    finally:
        _stop(fleet)
    one = Trainer(spec, device="cpu", config=JobConfig())
    state = one.init_state(0)
    state.model.load_jax_params(params)
    _, m = one.run_train_step(state, batches[0])
    ids = spec.host_io[KEY].ids_fn(batches[0])
    for r, out in enumerate(ranks):
        assert out["remote"] and len(out["pushed"]) == 2
        assert np.array_equal(out["pushed"][0].ravel(), ids[r * 32:(r + 1) * 32].ravel())
        assert abs(out["losses"][0] - float(m["loss"])) <= 5e-5
    assert ranks[0]["losses"] == ranks[1]["losses"]


# ---- the in-process job against the JAX job, each on a 2-shard fleet ----

N_TRAIN, N_VAL, MB, PER_TASK = 96, 36, 8, 2
JOB = dict(model_def="deepfm.model_spec", minibatch_size=MB, num_minibatches_per_task=PER_TASK,
           evaluation_steps=4, checkpoint_steps=4, keep_checkpoint_max=2, task_pipelining=False)


class _Recording:
    def __init__(self, proxy):
        self._proxy, self.calls = proxy, []

    def call(self, method, request):
        if method in ("ReportTaskResult", "ReportCheckpoint"):
            self.calls.append((method, dict(request)))
        return self._proxy.call(method, request)

    def reports(self, task_type):
        return [r for m, r in self.calls
                if m == "ReportTaskResult" and r["success"] and r.get("task_type") == task_type]


class _Mux:
    def __init__(self, train, val):
        self._train, self._val = train, val

    def read_records(self, shard):
        r = self._train if os.path.basename(shard.name).startswith("train") else self._val
        return r.read_records(shard)


def _job(pkg, train, val, ckpt, addrs, params):
    """One worker's job over ``DirectMasterProxy`` in ``pkg``'s package."""
    if pkg == "jax":
        from elasticdl_tpu.common.config import JobConfig as Config
        from elasticdl_tpu.data.reader import create_data_reader
        from elasticdl_tpu.master.evaluation_service import EvaluationService
        from elasticdl_tpu.master.servicer import MasterServicer
        from elasticdl_tpu.master.task_dispatcher import TaskDispatcher
        from elasticdl_tpu.models import deepfm as model
        from elasticdl_tpu.worker.worker import DirectMasterProxy, Worker

        kw = dict(devices=jax.devices()[:1])
    else:
        from elasticdl_tpu_torch.common.config import JobConfig as Config
        from elasticdl_tpu_torch.data.reader import create_data_reader
        from elasticdl_tpu_torch.master.evaluation_service import EvaluationService
        from elasticdl_tpu_torch.master.servicer import MasterServicer
        from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
        from elasticdl_tpu_torch.models import deepfm as model
        from elasticdl_tpu_torch.worker.worker import DirectMasterProxy, Worker

        kw = dict(device="cpu")
    config = Config(training_data=train, validation_data=val, checkpoint_dir=ckpt,
                    ps_addresses=addrs, use_async=True, **JOB)
    reader, eval_reader = create_data_reader(train), create_data_reader(val)
    servicer = MasterServicer(
        TaskDispatcher(reader.create_shards(MB * PER_TASK), num_epochs=1),
        evaluation=EvaluationService(eval_reader.create_shards(MB * PER_TASK),
                                     evaluation_steps=config.evaluation_steps))
    master = _Recording(DirectMasterProxy(servicer))
    worker = Worker(config, master, _Mux(reader, eval_reader), worker_id="w0",
                    spec=model.model_spec(**DFM), **kw)
    if pkg == "port":
        worker.trainer.init_state = lambda seed, f=worker.trainer.init_state: _carry(f(seed), params)
    result = worker.run()
    return result, servicer.JobStatus({}), master, worker


def _carry(state, params):
    state.model.load_jax_params(params)
    return state


@pytest.mark.usefixtures("reference_native")
def test_port_job_on_a_fleet_matches_the_jax_job(tmp_path):
    from elasticdl_tpu.models import deepfm as jdeepfm
    from elasticdl_tpu_torch.data.synthetic import synthetic_criteo

    train, val = str(tmp_path / "train.rio"), str(tmp_path / "val.rio")
    synthetic_criteo(train, N_TRAIN, seed=11, container="recordio")
    synthetic_criteo(val, N_VAL, seed=12, container="recordio")
    params = jax.device_get(jdeepfm.model_spec(**DFM).init(jax.random.key(0)))
    spec = _port_spec()
    out, stores = {}, {}
    for pkg in ("jax", "port"):
        fleet = _fleet(pkg, spec.host_io, 2)
        addrs = ",".join(s.address for s in fleet)
        try:
            out[pkg] = _job(pkg, train, val, str(tmp_path / f"{pkg}_ckpt"), addrs, params)
            from elasticdl_tpu_torch.data.reader import create_data_reader

            records = create_data_reader(train).read_records(
                create_data_reader(train).create_shards(N_TRAIN)[0])
            from elasticdl_tpu_torch.data.codecs import criteo_feed

            ids = np.unique(spec.host_io[KEY].ids_fn(criteo_feed(list(records))))
            remote = service.RemoteEmbeddingStore(KEY, 5, addrs.split(","))
            stores[pkg] = (len(remote), remote.pull(ids))
            remote.close()
        finally:
            _stop(fleet)
    (jres, jstatus, jmaster, jworker), (res, status, master, worker) = out["jax"], out["port"]
    assert status["done"] == jstatus["done"] == N_TRAIN // (MB * PER_TASK)
    assert res["step"] == jres["step"] == N_TRAIN // MB
    assert status["eval_rounds"] == jstatus["eval_rounds"] >= 2
    assert [r["task_id"] for r in master.reports("training")] == [
        r["task_id"] for r in jmaster.reports("training")]
    np.testing.assert_allclose([r["metrics"]["loss"] for r in master.reports("training")],
                               [r["metrics"]["loss"] for r in jmaster.reports("training")],
                               rtol=1e-5)
    for r, jr in zip(master.reports("evaluation"), jmaster.reports("evaluation")):
        for k in jr["metrics"]:
            np.testing.assert_allclose(r["metrics"][k], jr["metrics"][k], rtol=1e-5, atol=1e-7)
    ckpts = [r["step"] for m, r in master.calls if m == "ReportCheckpoint"]
    assert ckpts == [r["step"] for m, r in jmaster.calls if m == "ReportCheckpoint"]
    # Every checkpoint's host half is on disk as each shard's slice.
    for step in sorted(set(ckpts))[-2:]:
        for s in range(2):
            assert os.path.exists(tmp_path / "port_ckpt" / "host_stores" / str(step)
                                  / service.snapshot_filename(KEY, s, 2))
    ours = worker.trainer.host_state(worker.state)
    theirs = jax.device_get(jworker.trainer.host_state(jworker.state).params)
    tree = deepfm.params_to_jax(worker.state.model)
    np.testing.assert_allclose(tree["dense_linear"]["w"], theirs["dense_linear"]["w"], atol=1e-4)
    for name, layer in theirs["mlp"].items():
        for w in ("w", "b"):
            np.testing.assert_allclose(tree["mlp"][name][w], layer[w], rtol=1e-4, atol=1e-4)
    assert ours["step"] == res["step"]
    assert stores["port"][0] == stores["jax"][0]
    np.testing.assert_allclose(stores["port"][1], stores["jax"][1], rtol=0, atol=1e-6)


# ---- the process job: PS pods through the CLI ----

def _ps_pid(log_path):
    """The pid in a PS pod's "PS shard i/n serving ... (pid N)" log line."""
    line = next(x for x in log_path.read_text().splitlines()
                if "serving" in x and "(pid " in x)
    return int(line.rsplit("(pid ", 1)[1].split(")")[0])


def test_cli_job_with_ps_pods_survives_a_sigkilled_shard(tmp_path, monkeypatch):
    """``--num_ps_pods=2 --use_async`` through the CLI on the CPU: the master
    launches two PS pods before the worker; after the first checkpoint PS
    shard 1 is SIGKILLed; the pod manager relaunches it, it restores its
    slice from the newest snapshot, the worker's pulls ride out the gap, and
    the job ends at the epoch's step count."""
    from elasticdl_tpu_torch.data.synthetic import synthetic_criteo

    monkeypatch.setenv("ELASTICDL_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [_REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    monkeypatch.delenv("GRAFT_CHAOS", raising=False)
    train = synthetic_criteo(str(tmp_path / "train.rio"), 512, seed=11, container="recordio")
    val = synthetic_criteo(str(tmp_path / "val.rio"), 100, seed=12, container="recordio")
    ckpt, logs = tmp_path / "ckpt", tmp_path / "logs"
    # The worker stalls 4 s at its first task boundary past step 4 (the
    # first checkpoint), so the kill lands while the job still has work.
    chaos = "stall:worker=psjob-worker-0,point=task,step=4,ms=4000"
    cmd = [sys.executable, "-m", "elasticdl_tpu_torch.client.main", "train", "--local",
           "--job_name=psjob", "--model_def=deepfm.model_spec",
           "--model_params=buckets_per_feature=512;embedding_dim=4;hidden=16;host_tier=true",
           f"--training_data={train}", f"--validation_data={val}", "--minibatch_size=64",
           "--num_minibatches_per_task=2", "--evaluation_steps=8", f"--checkpoint_dir={ckpt}",
           "--checkpoint_steps=4", f"--pod_log_dir={logs}", "--num_ps_pods=2", "--use_async=true",
           "--max_worker_relaunch=2", f"--chaos={chaos}"]
    with open(tmp_path / "cli.log", "w") as cli_log:
        proc = subprocess.Popen(cmd, cwd=_REPO, stdout=cli_log, stderr=subprocess.STDOUT,
                                start_new_session=True)
    try:
        snap = ckpt / "host_stores"
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline and proc.poll() is None:
            if snap.exists() and any(
                    (snap / d / service.snapshot_filename(KEY, 1, 2)).exists()
                    for d in os.listdir(snap)):
                break
            time.sleep(0.05)
        assert proc.poll() is None, (tmp_path / "cli.log").read_text()[-3000:]
        os.kill(_ps_pid(logs / "psjob-ps-1.log"), signal.SIGKILL)
        rc = proc.wait(timeout=180)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    text = (tmp_path / "cli.log").read_text()
    assert rc == 0, text[-3000:]
    status = ast.literal_eval(next(x for x in text.splitlines()
                                   if "job finished: " in x).split("job finished: ", 1)[1])
    assert status["done"] == 4 and status["eval_rounds"] >= 1
    assert 0.0 < status["eval_metrics"]["auc"] < 1.0
    relaunch = (logs / "psjob-ps-1-r1.log").read_text()
    assert "restored PS shard 1 from step" in relaunch, relaunch[-2000:]
    summary = next(json.loads(x[len("[worker-event] "):])
                   for x in (logs / "psjob-worker-0.log").read_text().splitlines()
                   if x.startswith("[worker-event] ") and '"summary"' in x)
    assert summary["steps"] == 8
    final = max(int(d) for d in os.listdir(snap))
    assert final == 8
    for s in range(2):
        assert (snap / str(final) / service.snapshot_filename(KEY, s, 2)).exists()
