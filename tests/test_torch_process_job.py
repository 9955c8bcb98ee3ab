"""The PyTorch port's process-level elastic job against the JAX package's.

The control plane is held against the JAX package where both run the same
inputs: ``journal.replay`` of one event log (a torn final line tolerated,
mid-file garbage refused), one ``FakePodBackend`` event sequence through
both ``PodManager``s, and the rendered pod manifests.  Then the port's job
runs for real in worker processes on the CPU (``ELASTICDL_TORCH_DEVICE=cpu``
in their environment), at tests/test_torch_job.py's width (SEQ 64, dim 64,
2 layers, vocab 512, f32, plain attention): a SIGKILLed worker relaunched
and restored from the published checkpoint, a SIGTERMed one snapshotting,
exiting 3 and resuming from the snapshot, a master restart replaying its
journal, and the CLI's local mode.  The subprocess cases are the
counterparts of tests/test_pod_manager.py's crash relaunch,
tests/test_preemption.py, tests/test_master_restart.py's restart and
tests/test_client.py's local job; each process wait has a deadline of at
most 60 s.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import pytest

from elasticdl_tpu.client import api as jax_api
from elasticdl_tpu.common.config import JobConfig as JaxJobConfig
from elasticdl_tpu.data.reader import Shard as JaxShard
from elasticdl_tpu.master import journal as jax_journal
from elasticdl_tpu.master import pod_manager as jax_pm
from elasticdl_tpu.master.rendezvous import RendezvousServer as JaxRendezvousServer
from elasticdl_tpu.master.servicer import MasterServicer as JaxMasterServicer
from elasticdl_tpu.master.task_dispatcher import TaskDispatcher as JaxTaskDispatcher
from elasticdl_tpu_torch.client import api, zoo
from elasticdl_tpu_torch.common.checkpoint import CheckpointManager, read_manifest
from elasticdl_tpu_torch.common.config import JobConfig
from elasticdl_tpu_torch.data.reader import Shard, create_data_reader
from elasticdl_tpu_torch.data.synthetic import generate
from elasticdl_tpu_torch.master import journal
from elasticdl_tpu_torch.master import pod_manager as pm
from elasticdl_tpu_torch.master.main import Master
from elasticdl_tpu_torch.master.servicer import MasterServer, MasterServicer
from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
from elasticdl_tpu_torch.worker.worker import RESTART_EXIT_CODE

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQ, VOCAB, MB, PER_TASK = 64, 512, 8, 2
N_TRAIN = 96  # 6 tasks of 2 steps
_MODEL_PARAMS = (f"vocab={VOCAB};dim=64;n_heads=4;n_layers=2;max_seq={SEQ};seq_len={SEQ};"
                 "compute_dtype=float32")
WAIT_S = 60.0


# ---- the control plane against the JAX package ----------------------------


def _journal_log(tmp_path):
    """An event log written by the JAX package's journaled control plane:
    leases on two workers, a success, a failure, a requeue-flagged return,
    a reconcile and a worker loss."""
    path = str(tmp_path / "master_journal.wal")
    shards = [JaxShard(name="d", start=i * 10, end=(i + 1) * 10) for i in range(6)]
    dispatcher = JaxTaskDispatcher(shards, num_epochs=2)
    servicer = JaxMasterServicer(dispatcher, rendezvous=JaxRendezvousServer())
    j = jax_journal.MasterJournal(path)
    servicer.set_journal(j)
    dispatcher.attach_journal(j)
    servicer.rotate_journal()
    servicer.RegisterWorker({"worker_id": "w1", "held_tasks": []})
    servicer.RegisterWorker({"worker_id": "w2", "held_tasks": []})
    servicer.GetTask({"worker_id": "w1", "lease": 3})
    servicer.GetTask({"worker_id": "w2", "lease": 2})
    servicer.ReportTaskResult({"worker_id": "w1", "task_id": 0, "success": True,
                               "seq": 1, "model_version": 4})
    servicer.ReportTaskResult({"worker_id": "w2", "task_id": 3, "success": False, "seq": 1})
    servicer.ReportTaskResult({"worker_id": "w1", "task_id": 1, "success": False,
                               "requeue": True, "seq": 2})
    servicer.RegisterWorker({"worker_id": "w1", "held_tasks": [2], "incarnation": "b"})
    servicer.rendezvous.remove("w2")
    j.close()
    return path


def _replay(module, shard_cls, path):
    shards = [shard_cls(name="d", start=i * 10, end=(i + 1) * 10) for i in range(6)]
    return module.replay(path, shards, num_epochs=2, task_type="training",
                         task_timeout_s=600.0)


def _replay_view(result):
    return {
        "dispatcher": result.dispatcher.snapshot(),
        **{f: getattr(result, f) for f in (
            "group_version", "group_log", "model_version", "membership_version",
            "report_seqs", "incarnations", "restarts", "events_applied", "torn_tail")},
    }


@pytest.mark.parametrize("tail", ["clean", "torn_final_line", "mid_file_garbage"])
def test_journal_replay_matches_the_jax_package(tmp_path, tail):
    path = _journal_log(tmp_path)
    if tail == "torn_final_line":
        with open(path, "ab") as f:
            f.write(b'{"kind": "repo')
    elif tail == "mid_file_garbage":
        with open(path, "rb") as f:
            lines = f.read().split(b"\n")
        lines.insert(1, b"\x00GARBAGE\x00")
        with open(path, "wb") as f:
            f.write(b"\n".join(lines))
        with pytest.raises(jax_journal.JournalError):
            _replay(jax_journal, JaxShard, path)
        with pytest.raises(journal.JournalError):
            _replay(journal, Shard, path)
        return
    ours = _replay_view(_replay(journal, Shard, path))
    theirs = _replay_view(_replay(jax_journal, JaxShard, path))
    assert ours == theirs
    assert ours["torn_tail"] == (tail == "torn_final_line")
    assert ours["events_applied"] > 0 and ours["dispatcher"]["doing"]


def test_pod_manager_matches_the_jax_package():
    """One pod-event sequence through both packages' ``PodManager`` over a
    ``FakePodBackend``: start two slots, a failure (relaunched, budget
    charged), a RESTART (relaunched free), failures past the budget, a
    scale up and down, a success."""
    def drive(module, config_cls):
        backend = module.FakePodBackend()
        config = config_cls(job_name="j", max_worker_relaunch=2)
        mgr = module.PodManager(backend, config)
        seen = []
        mgr.add_listener(lambda name, phase: seen.append((name, phase)))
        mgr.start(2)
        steps = [mgr.counts()]
        backend.fail_pod("j-worker-0")
        backend.set_phase("j-worker-0-r1", module.PodPhase.RESTART)
        for name in ("j-worker-0-r2", "j-worker-0-r3"):
            backend.fail_pod(name)
        steps.append(mgr.counts())
        mgr.scale(3)
        mgr.scale(2)
        backend.succeed_pod("j-worker-1")
        steps.append(mgr.counts())
        infos = {n: (i.slot, i.relaunches, i.phase) for n, i in mgr._by_name.items()}
        return steps, seen, list(backend.start_log), mgr.live_pods(), infos

    ours, theirs = drive(pm, JobConfig), drive(jax_pm, JaxJobConfig)
    assert ours == theirs
    starts = ours[2]
    assert starts[:5] == ["j-worker-0", "j-worker-1", "j-worker-0-r1", "j-worker-0-r2",
                          "j-worker-0-r3"]
    assert ours[4]["j-worker-0-r3"][1:] == (2, pm.PodPhase.FAILED)  # budget spent


def _strip_accelerator(manifest):
    manifest = json.loads(json.dumps(manifest))
    spec = manifest["spec"]
    spec.pop("nodeSelector", None)
    container = spec["containers"][0]
    container.pop("image")
    container.pop("command")
    resources = container.pop("resources", {})
    return manifest, resources


def test_pod_manifests_match_the_jax_package_but_the_card():
    kw = dict(job_name="mjob", model_def="transformer_lm.model_spec", training_data="t.rio")
    ours, theirs = JobConfig(**kw), JaxJobConfig(**kw)
    m, jm = api.render_master_pod_manifest(ours), jax_api.render_master_pod_manifest(theirs)
    assert m["spec"]["containers"][0]["command"] == [
        "python", "-m", "elasticdl_tpu_torch.master.main"]
    # The config bus: one env var, the same fields (the model zoo is each
    # package's own).
    env = {e["name"]: e.get("value") for e in m["spec"]["containers"][0]["env"]}
    jenv = {e["name"]: e.get("value") for e in jm["spec"]["containers"][0]["env"]}
    bus, jbus = json.loads(env.pop("ELASTICDL_JOB_CONFIG")), json.loads(
        jenv.pop("ELASTICDL_JOB_CONFIG"))
    assert env == jenv and sorted(bus) == sorted(jbus)
    assert {k: v for k, v in bus.items() if k != "model_zoo"} == {
        k: v for k, v in jbus.items() if k != "model_zoo"}
    for manifest in (m, jm):
        manifest["spec"]["containers"][0]["env"] = []
    assert _strip_accelerator(m) == _strip_accelerator(jm)

    w = pm.render_worker_pod_manifest(ours, "mjob-worker-0", {"A": "1"})
    jw = jax_pm.render_worker_pod_manifest(theirs, "mjob-worker-0", {"A": "1"})
    assert w["spec"]["containers"][0]["command"] == [
        "python", "-m", "elasticdl_tpu_torch.worker.main"]
    (rest, res), (jrest, jres) = _strip_accelerator(w), _strip_accelerator(jw)
    assert rest == jrest
    assert res == {"requests": {"nvidia.com/gpu": "1"}, "limits": {"nvidia.com/gpu": "1"}}
    assert "google.com/tpu" in jres["requests"]


def test_master_refuses_ps_pods(tmp_path):
    """PS pods (the host tier) are ported: the master refuses a negative
    count before it binds a port or starts a pod, and for a positive one
    builds the PS fleet (its pod manager and the shards' addresses on the
    workers' config bus) before the workers."""
    from elasticdl_tpu_torch.master.pod_manager import FakePodBackend

    train = str(tmp_path / "t.rio")
    generate("lm", train, 16, seed=0, seq_len=SEQ, vocab=VOCAB)
    with pytest.raises(ValueError, match="num_ps_pods"):
        Master(JobConfig(training_data=train, num_ps_pods=-1))
    config = JobConfig(training_data=train, num_ps_pods=2, job_name="psj")
    master = Master(config, pod_backend=FakePodBackend(auto_run=False),
                    ps_backend=FakePodBackend(auto_run=False))
    try:
        assert master.ps_manager is not None
        assert len(config.ps_addresses.split(",")) == 2
        assert all(a.startswith("localhost:") for a in config.ps_addresses.split(","))
    finally:
        master.shutdown()


#: The package name of the port's zoo test: no other test imports a zoo
#: under it, and the test takes it back out of ``sys.modules`` at its end,
#: so a JAX zoo test in the same process never gets this PyTorch template
#: from the import cache.
PORT_ZOO = "torch_port_zoo"


def _drop_zoo_modules(package: str) -> None:
    for name in [m for m in sys.modules if m == package or m.startswith(package + ".")]:
        del sys.modules[name]


def test_zoo_template_validates_on_the_meta_device(tmp_path):
    """``zoo init`` writes a PyTorch template that ``zoo build`` validates
    (the module built on the meta device); a broken module is reported."""
    zoo_dir = tmp_path / PORT_ZOO
    try:
        zoo.zoo_init(str(zoo_dir))
        assert "import torch" in (zoo_dir / "template.py").read_text()
        assert zoo.zoo_build(str(zoo_dir), validate_only=True) == 0
        (zoo_dir / "broken.py").write_text("import nonexistent_pkg_xyz\n")
        failures = zoo.validate_zoo(str(zoo_dir))
        assert [name for name, _ in failures] == ["broken.py"]
    finally:
        _drop_zoo_modules(PORT_ZOO)


def test_port_and_jax_zoo_cycles_share_one_process(tmp_path):
    """The port's zoo cycle, then tests/test_client.py's JAX cycle, in one
    process (as one test-runner worker may run both files): the JAX
    ``zoo build`` must find its own template, not a PyTorch one the port's
    test left in the import cache."""
    from elasticdl_tpu.client import zoo as jax_zoo

    test_zoo_template_validates_on_the_meta_device(tmp_path / "port")
    zoo_dir = str(tmp_path / "jax" / "myzoo")
    jax_zoo.zoo_init(zoo_dir)
    try:
        specs, import_failures = jax_zoo.discover_model_specs(zoo_dir)
        assert any("template" in k for k in specs) and import_failures == []
        assert jax_zoo.zoo_build(zoo_dir, validate_only=True) == 0
    finally:
        _drop_zoo_modules("myzoo")


# ---- the job in worker processes on the CPU --------------------------------


@pytest.fixture
def cpu_workers(monkeypatch):
    """Worker subprocesses (which inherit this environment) run on the CPU
    and import the package from this checkout."""
    monkeypatch.setenv("ELASTICDL_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [_REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    monkeypatch.setenv("OMP_NUM_THREADS", "2")  # tiny models; many processes share the CPU
    monkeypatch.delenv("GRAFT_CHAOS", raising=False)


def _train_data(tmp_path, n=N_TRAIN):
    path = str(tmp_path / "train.rio")
    generate("lm", path, n, seed=0, seq_len=SEQ, vocab=VOCAB)
    return path


def _config(tmp_path, train, **kw):
    kw = dict(dict(job_name="pj", model_def="transformer_lm.model_spec",
                   model_params=_MODEL_PARAMS, training_data=train, minibatch_size=MB,
                   num_minibatches_per_task=PER_TASK, checkpoint_dir=str(tmp_path / "ckpt"),
                   checkpoint_steps=4, max_worker_relaunch=2, shutdown_grace_s=30.0,
                   pod_log_dir=str(tmp_path / "logs")), **kw)
    return JobConfig(**kw)


def _wait(cond, what, timeout=WAIT_S):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        value = cond()
        if value:
            return value
        time.sleep(0.05)
    pytest.fail(f"timed out after {timeout:.0f}s waiting for {what}")


def _log(tmp_path, pod):
    path = tmp_path / "logs" / f"{pod}.log"
    return path.read_text() if path.exists() else ""


def _events(text):
    """The ``[worker-event]`` lines of a worker log, by kind."""
    out = {}
    for line in text.splitlines():
        if line.startswith("[worker-event] "):
            event = json.loads(line[len("[worker-event] "):])
            assert event["event"] not in out, text[-2000:]
            out[event["event"]] = event
    return out


def _run_master(master):
    result = {}
    thread = threading.Thread(
        target=lambda: result.update(status=master.run(poll_interval_s=0.05)), daemon=True)
    thread.start()
    return thread, result


@pytest.mark.parametrize("standby", [False, True], ids=["cold", "warm_standby"])
def test_sigkilled_worker_is_relaunched_and_restores_the_published_step(
        tmp_path, cpu_workers, monkeypatch, standby):
    """The first incarnation stalls at its first task boundary past step 4
    (``worker:task`` chaos hook, its own pod name only); once the manifest
    names step 4 it is SIGKILLed.  The pod manager relaunches it under a
    fresh name, charging the budget: a cold process, or with a warm standby
    the parked spare (``worker/main.py:_park_as_standby``), adopted under
    that name.  The relaunch joins from step 4 and finishes the job with
    every task done once."""
    monkeypatch.setenv("GRAFT_CHAOS", "stall:worker=pj-worker-0,point=task,step=4,ms=120000")
    train = _train_data(tmp_path)
    backend = pm.ProcessPodBackend(log_dir=str(tmp_path / "logs"), warm_standby=standby)
    master = Master(_config(tmp_path, train), pod_backend=backend)
    thread, result = _run_master(master)
    try:
        _wait(lambda: (read_manifest(master.config.checkpoint_dir) or {}).get("step") == 4,
              "the step-4 checkpoint")
        if standby:
            # Only a warmed spare is adopted (a cold spawn replaces one
            # still importing); the first worker stalls meanwhile.
            _wait(lambda: "standby warmed" in _log(tmp_path, "standby.go.1"), "the warm spare")
        pid = backend.pid("pj-worker-0")
        os.kill(pid, signal.SIGKILL)
        thread.join(timeout=WAIT_S)
        assert not thread.is_alive()
    finally:
        master.shutdown()
    status = result["status"]
    assert status["finished"] and status["done"] == N_TRAIN // (MB * PER_TASK)
    assert status["abandoned"] == 0 and status["duplicate_done"] == 0
    relaunched = _log(tmp_path, "pj-worker-0-r1")
    assert "joined from checkpoint step 4" in relaunched
    assert ("standby adopted as pj-worker-0-r1" in relaunched) == standby
    events = _events(relaunched)
    summary = events["summary"]
    assert events["ready"]["joined_step"] == 4 and events["ready"]["device"] == "cpu"
    assert events["first_step"]["step"] == 5
    # The relaunch trained every task the master had not seen reported.
    assert summary["step"] == 4 + summary["steps"] >= N_TRAIN // MB
    assert read_manifest(master.config.checkpoint_dir)["step"] == summary["step"]
    info = master.pod_manager.pod_info("pj-worker-0-r1")
    assert info.relaunches == 1 and info.phase == pm.PodPhase.SUCCEEDED


def _spawn_worker(config, log_path, worker_id, env_extra=None):
    env = dict(os.environ)
    env.update(config.to_env())
    env["ELASTICDL_WORKER_ID"] = worker_id
    env.update(env_extra or {})
    with open(log_path, "w") as log:  # the child keeps its own fd
        return subprocess.Popen(
            [sys.executable, "-m", "elasticdl_tpu_torch.worker.main"],
            env=env, stdout=log, stderr=subprocess.STDOUT, cwd=_REPO,
        )


def test_sigterm_snapshots_exits_3_and_the_relaunch_resumes(tmp_path, cpu_workers):
    """SIGTERM during a task (the first worker stalls 2 s at its first
    boundary past step 4): the worker parks, reports its pipelined task,
    saves and publishes the live state and exits ``RESTART_EXIT_CODE``.
    Periodic checkpoints are off, so the step restored can only be the
    snapshot's; the relaunch resumes from it and ends at the job's last
    step with no task trained twice."""
    train = _train_data(tmp_path)
    servicer = MasterServicer(TaskDispatcher(
        create_data_reader(train).create_shards(MB * PER_TASK), num_epochs=1))
    server = MasterServer(servicer, port=0).start()
    procs = []
    try:
        config = _config(tmp_path, train, checkpoint_steps=0, master_addr=server.address)
        os.makedirs(tmp_path / "logs")
        log0 = tmp_path / "logs" / "w0.log"
        procs.append(_spawn_worker(config, log0, "pre-w0", {
            "GRAFT_CHAOS": "stall:worker=pre-w0,point=task,step=4,ms=2000"}))
        _wait(lambda: "[graftchaos] stall" in log0.read_text(), "the stall")
        procs[0].send_signal(signal.SIGTERM)
        assert procs[0].wait(timeout=WAIT_S) == RESTART_EXIT_CODE
        snap = CheckpointManager(config.checkpoint_dir).latest_step()
        assert snap is not None and snap >= 4
        assert read_manifest(config.checkpoint_dir)["step"] == snap
        assert f"preemption snapshot at step {snap}" in log0.read_text()
        status = servicer.JobStatus({})
        assert status["done"] == snap // PER_TASK and status["doing"] == 0

        log1 = tmp_path / "logs" / "w1.log"
        procs.append(_spawn_worker(config, log1, "pre-w0"))
        assert procs[1].wait(timeout=WAIT_S) == 0
        text = log1.read_text()
        assert f"joined from checkpoint step {snap}" in text
        summary = _events(text)["summary"]
        assert summary["step"] == N_TRAIN // MB == snap + summary["steps"]
        status = servicer.JobStatus({})
        assert status["finished"] and status["done"] == N_TRAIN // (MB * PER_TASK)
        assert status["duplicate_done"] == 0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        server.stop()


def test_master_restart_replays_its_journal_and_finishes(tmp_path, cpu_workers):
    """The first master is shut down (its worker with it) once a checkpoint
    report has persisted the watermark and rotated the journal; a new
    master over the same checkpoint directory replays the journal and
    finishes the job with every task done once."""
    train = _train_data(tmp_path)
    n_tasks = N_TRAIN // (MB * PER_TASK)
    m1 = Master(_config(tmp_path, train, checkpoint_steps=2),
                pod_backend=pm.ProcessPodBackend(log_dir=str(tmp_path / "logs")))
    # What Master.run starts, without its supervision loop (which would
    # outlive the "crash" below).
    m1.server.start()
    m1.rendezvous.set_expected(1)
    m1.pod_manager.start()
    progress = tmp_path / "ckpt" / "job_progress.json"
    try:
        _wait(lambda: progress.exists() and m1.servicer.JobStatus({})["done"] >= 2,
              "a persisted watermark")
    finally:
        m1.shutdown()  # the "crash": kills the worker, stops the server
    assert os.path.exists(tmp_path / "ckpt" / journal.JOURNAL_FILENAME)

    m2 = Master(_config(tmp_path, train, checkpoint_steps=2),
                pod_backend=pm.ProcessPodBackend(log_dir=str(tmp_path / "logs2")))
    replayed = m2.servicer.JobStatus({})
    assert replayed["journal"]["restarts"] >= 1
    persisted = json.loads(progress.read_text())
    assert replayed["done"] >= len(persisted["done_shards"]) > 0
    thread, result = _run_master(m2)
    thread.join(timeout=WAIT_S)
    assert not thread.is_alive()
    status = result["status"]
    assert status["finished"] and status["done"] == n_tasks
    assert status["duplicate_done"] == 0


def test_cli_local_train_job(tmp_path, cpu_workers):
    """``python -m elasticdl_tpu_torch.client.main train`` in local mode:
    the in-process master, one worker process on the CPU, checkpoints and
    the published manifest at the job's last step."""
    train = _train_data(tmp_path)
    ckpt = str(tmp_path / "ckpt")
    proc = subprocess.run(
        [sys.executable, "-m", "elasticdl_tpu_torch.client.main", "train", "--local",
         "--job_name=cli-local", "--model_def=transformer_lm.model_spec",
         f"--model_params={_MODEL_PARAMS}", f"--training_data={train}",
         f"--minibatch_size={MB}", f"--num_minibatches_per_task={PER_TASK}",
         f"--checkpoint_dir={ckpt}", "--checkpoint_steps=4",
         f"--pod_log_dir={tmp_path / 'logs'}"],
        cwd=_REPO, capture_output=True, text=True, timeout=WAIT_S,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert read_manifest(ckpt)["step"] == N_TRAIN // MB
    assert CheckpointManager(ckpt).all_steps()[0] == N_TRAIN // MB
    summary = _events(_log(tmp_path, "cli-local-worker-0"))["summary"]
    assert summary["steps"] == N_TRAIN // MB and summary["launches"] == {}


def test_cli_local_deepfm_job_with_an_eval_round(tmp_path, cpu_workers):
    """``--model_def=deepfm.model_spec`` through the CLI: Criteo RecordIO
    files, the native preprocessing feed, a worker process on the CPU,
    eval rounds whose finalized metrics carry ``auc`` (the histogram
    vectors crossed the wire as lists), the manifest at the last step."""
    import ast

    from elasticdl_tpu_torch.data.synthetic import synthetic_criteo

    train = synthetic_criteo(str(tmp_path / "train.rio"), 512, seed=11, container="recordio")
    val = synthetic_criteo(str(tmp_path / "val.rio"), 150, seed=12, container="recordio")
    ckpt = str(tmp_path / "ckpt")
    proc = subprocess.run(
        [sys.executable, "-m", "elasticdl_tpu_torch.client.main", "train", "--local",
         "--job_name=cli-dfm", "--model_def=deepfm.model_spec",
         "--model_params=buckets_per_feature=512;embedding_dim=4;hidden=16,16",
         f"--training_data={train}", f"--validation_data={val}", "--minibatch_size=64",
         "--num_minibatches_per_task=2", "--evaluation_steps=4", f"--checkpoint_dir={ckpt}",
         "--checkpoint_steps=8", f"--pod_log_dir={tmp_path / 'logs'}"],
        cwd=_REPO, capture_output=True, text=True, timeout=WAIT_S,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = next(x for x in proc.stderr.splitlines() if "job finished: " in x)
    status = ast.literal_eval(line.split("job finished: ", 1)[1])
    assert status["done"] == 4 and status["eval_rounds"] >= 2
    assert sorted(status["eval_metrics"]) == ["accuracy", "auc", "calibration", "loss"]
    assert 0.0 < status["eval_metrics"]["auc"] < 1.0
    assert read_manifest(ckpt)["step"] == 8
    summary = _events(_log(tmp_path, "cli-dfm-worker-0"))["summary"]
    assert summary["steps"] == 8 and summary["eval_steps"] > 0


def test_cli_usage():
    proc = subprocess.run(
        [sys.executable, "-m", "elasticdl_tpu_torch.client.main", "--help"],
        cwd=_REPO, capture_output=True, text=True, timeout=WAIT_S,
    )
    assert proc.returncode == 0
    assert "python -m elasticdl_tpu_torch.client.main {train|evaluate|predict|zoo}" in proc.stderr


@pytest.mark.parametrize("device,error", [
    (None, "CUDA is not available"),
    ("mps", "unsupported device 'mps'"),
])
def test_worker_process_refuses_a_missing_or_unknown_device(tmp_path, cpu_workers, device,
                                                            error):
    """``ELASTICDL_TORCH_DEVICE`` unset means the card: without one the
    worker process raises and exits non-zero (no fallback to the CPU); a
    device name it does not know raises too."""
    train = _train_data(tmp_path, n=16)
    servicer = MasterServicer(TaskDispatcher(
        create_data_reader(train).create_shards(MB * PER_TASK), num_epochs=1))
    server = MasterServer(servicer, port=0).start()
    try:
        config = _config(tmp_path, train, master_addr=server.address)
        env = {k: v for k, v in os.environ.items() if k != "ELASTICDL_TORCH_DEVICE"}
        if device is not None:
            env["ELASTICDL_TORCH_DEVICE"] = device
        env.update(config.to_env())
        proc = subprocess.run(
            [sys.executable, "-m", "elasticdl_tpu_torch.worker.main"], env=env, cwd=_REPO,
            capture_output=True, text=True, timeout=WAIT_S,
        )
    finally:
        server.stop()
    assert proc.returncode != 0
    assert error in proc.stderr
    assert servicer.JobStatus({})["done"] == 0
