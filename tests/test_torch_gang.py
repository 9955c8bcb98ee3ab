"""Gang mode of the PyTorch port against the JAX package.

1. The data-parallel step: two gloo ranks (tests/_torch_gloo_ranks.py)
   each take half of a global batch; the JAX ``Trainer`` runs the same
   batches on a 2-device ``(dp=2, ep=1)`` CPU mesh
   (``dcn_data_parallelism=2``) from the same weights (carried with
   ``load_jax_params``), for ``transformer_lm`` (2 layers, dim 64, 4 heads,
   L = 128) and DeepFM (narrow), one batch with a masked tail.  Losses,
   metrics and parameters after 3 steps at rtol 2e-4, atol 2e-5
   (tests/test_trainer_allreduce.py's), and the ranks against the port's
   own single-device step at rtol 1e-5, atol 1e-6.  One exception, for
   ``transformer_lm``: an element whose reference gradient at the first
   step is below ten times AdamW's eps (1e-8) takes a first update of
   ``lr * g / (|g| + eps)``, which follows the last bits of a gradient
   that is float noise around zero; at L = 128 one element of ``tok_emb``
   has |g| = 1.7e-9 in JAX and 2.7e-9 in the port, single device and gang
   alike, and ends 4e-5 away after 3 steps.  Such elements are held within
   the 3 steps' AdamW movement (3 lr) instead; there may be at most one in
   10,000 (5 of 139,584 here).
2. ``settle_membership``: the port's and the JAX package's run the cases
   of tests/test_settle.py with the same scripted master and clock.
3. The death push: the cases of tests/test_death_push.py through both
   packages' ``Worker.death_watch_tick``.
4. Lockstep: two port worker processes on the CPU through a
   ``MasterServer`` walk the same ``GetGroupTask`` sequence (the group log's
   order) and only one report per task lands (tests/test_multihost.py's
   expectations).
5. Kill and resume (tests/test_multihost.py's kill scenario with the port's
   tiny model, through the CLI's local mode): rank 1 is SIGKILLed, rank 0
   snapshots and exits 3, both are relaunched, the gang re-forms from the
   snapshot and finishes with no task lost or done twice, and no step
   trained twice (the final step is the epoch's).  In-process, the
   survivor's choice of state: the state of the reported tasks, the copy
   taken at a failed task's start, nothing when its last report was
   refused or it was not rank 0.  (DeepFM on ``(dp=2, ep=2)`` builds now,
   with its table sharded over ``ep``; tests/test_torch_opt_shard.py trains
   it against the JAX 4-device mesh.)

Each process test waits at most ``WAIT_S`` for its processes.
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

import elasticdl_tpu.parallel  # noqa: F401  (the JAX package's own import order)
from elasticdl_tpu.common.config import JobConfig as JaxJobConfig
from elasticdl_tpu.models import deepfm as jdeepfm
from elasticdl_tpu.models.spec import load_model_spec as jax_load_model_spec
from elasticdl_tpu.parallel.mesh import create_mesh as jax_create_mesh
from elasticdl_tpu.parallel.trainer import Trainer as JaxTrainer
from elasticdl_tpu.worker import main as jax_main
from elasticdl_tpu.worker.worker import Worker as JaxWorker
from elasticdl_tpu_torch.common.checkpoint import read_manifest
from elasticdl_tpu_torch.common.config import JobConfig
from elasticdl_tpu_torch.data import codecs
from elasticdl_tpu_torch.data.reader import create_data_reader
from elasticdl_tpu_torch.data.synthetic import generate
from elasticdl_tpu_torch.master.rendezvous import RendezvousServer
from elasticdl_tpu_torch.master.servicer import MasterServer, MasterServicer
from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
from elasticdl_tpu_torch.models import deepfm, transformer_lm as tlm
from elasticdl_tpu_torch.parallel.mesh import Mesh
from elasticdl_tpu_torch.parallel.trainer import MASK_KEY, Trainer
from elasticdl_tpu_torch.worker import main as port_main
from elasticdl_tpu_torch.worker.worker import Worker

from _torch_gloo_ranks import data_parallel_steps, free_port, run_ranks

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT_S = 90.0

# ---- 1. the data-parallel step against the JAX 2-device mesh -------------------------

LM = dict(vocab=512, dim=64, n_heads=4, n_layers=2, max_seq=128, seq_len=128,
          compute_dtype="float32")
DFM = dict(buckets_per_feature=512, embedding_dim=4, hidden=(16,), compute_dtype="float32",
           host_tier=False)


def _lm_batches():
    rng = np.random.default_rng(0)
    out = []
    for i in range(3):
        toks = rng.integers(0, LM["vocab"], size=(8, LM["seq_len"] + 1)).astype(np.int32)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if i == 1:  # a wrap-padded tail: 5 real rows, rank 1 holds one
            batch[MASK_KEY] = (np.arange(8) < 5).astype(np.float32)
        out.append(batch)
    return out


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


ADAM_EPS, LR = 1e-8, 3e-4  # the AdamW of both models' specs (optax's defaults)
spec_of = {"transformer_lm": tlm.model_spec, "deepfm": deepfm.model_spec}
module_of = {"transformer_lm": tlm, "deepfm": deepfm}


def _jax_two_device(jspec):
    config = JaxJobConfig(distribution_strategy="AllReduce", dcn_data_parallelism=2)
    return JaxTrainer(jspec, config, jax_create_mesh(jax.devices(), num_devices=2,
                                                     dcn_parallelism=2))


@pytest.mark.parametrize("kind", ["transformer_lm", "deepfm"])
def test_two_rank_step_matches_the_jax_two_device_mesh(kind):
    if kind == "transformer_lm":
        jspec = jax_load_model_spec("elasticdl_tpu.models", "transformer_lm.model_spec", **LM)
        model_kw, batches = LM, _lm_batches()
    else:
        jspec = jdeepfm.model_spec(**DFM)
        model_kw, batches = DFM, _dfm_batches(deepfm.model_spec(**DFM))
    jtrainer = _jax_two_device(jspec)
    assert dict(jtrainer.mesh.shape) == {"dp": 2, "ep": 1}
    jstate = jtrainer.init_state(jax.random.key(0))
    params = jax.device_get(jstate.params)
    ranks = run_ranks(data_parallel_steps, 2, kind, model_kw, params, batches)
    ref = []
    for batch in batches:
        jstate, m = jtrainer.run_train_step(jstate, dict(batch))
        ref.append({k: np.asarray(v) for k, v in jax.device_get(m).items()})
    jeval = {k: np.asarray(v) for k, v in
             jax.device_get(jtrainer.run_eval_step(jstate, dict(batches[0]))).items()}
    # The port on one device, from the same weights: what the gang adds.
    single = Trainer(spec_of[kind](**model_kw), device="cpu")
    sstate = single.init_state(0)
    sstate.model.load_jax_params(params)
    for batch in batches:
        sstate, _ = single.run_train_step(sstate, batch)
    single_leaves = jax.tree.leaves(module_of[kind].params_to_jax(sstate.model))
    # Elements whose first reference update follows a noise gradient.
    noise = [np.zeros(np.shape(w), bool) for w in jax.tree.leaves(params)]
    if kind == "transformer_lm":
        b0 = batches[0]
        grads = jax.grad(lambda p: jspec.loss(jspec.apply(p, {"tokens": b0["tokens"]},
                                                          train=True), b0))(params)
        noise = [np.abs(np.asarray(g)) < 10 * ADAM_EPS for g in jax.tree.leaves(grads)]
        assert sum(int(n.sum()) for n in noise) <= sum(n.size for n in noise) // 10_000
    for rank, out in enumerate(ranks):
        for step, (got, want) in enumerate(zip(out["metrics"], ref)):
            assert sorted(got) == sorted(want), (rank, step)
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=2e-5,
                                           err_msg=f"rank {rank} step {step} {k}")
        want_leaves = jax.tree.leaves(jax.device_get(jstate.params))
        got_leaves = jax.tree.leaves(out["params"])
        assert len(got_leaves) == len(want_leaves) == len(single_leaves)
        for g, w, one, n in zip(got_leaves, want_leaves, single_leaves, noise):
            g, w = np.asarray(g), np.asarray(w)
            np.testing.assert_allclose(g[~n], w[~n], rtol=2e-4, atol=2e-5)
            assert np.all(np.abs(g[n] - w[n]) <= 3 * LR)
            np.testing.assert_allclose(g, np.asarray(one), rtol=1e-5, atol=1e-6)
        assert sorted(out["eval"]) == sorted(jeval)
        for k in jeval:
            np.testing.assert_allclose(out["eval"][k], jeval[k], rtol=2e-4, atol=2e-5,
                                       err_msg=f"eval {k}")
    # The ranks hold one state, bit for bit.
    for g, w in zip(jax.tree.leaves(ranks[0]["params"]), jax.tree.leaves(ranks[1]["params"])):
        assert np.array_equal(np.asarray(g), np.asarray(w))


def test_inner_axes_larger_than_one_rank_name_their_roadmap_items():
    # The ring is ported (tests/test_torch_ring_tp.py trains it against the
    # JAX trainer): a sequence-parallel model builds on an inner axis of
    # two ranks and rings over it, its examples whole on a flat mesh.
    tr = Trainer(tlm.model_spec(**LM), device="cpu", mesh=Mesh({"dp": 2}, rank=1))
    assert (tr.ctx.axis_name, tr.ctx.axis_size, tr.ctx.axis_index) == ("dp", 2, 1)
    assert tr.contributor_axes == () and tr.num_contributors() == 1
    tr = Trainer(tlm.model_spec(**LM), device="cpu", mesh=Mesh({"dp": 1, "ep": 2}))
    assert (tr.ctx.axis_name, tr.ctx.axis_size) == ("ep", 2) and tr.reduce_axes == ("dp", "ep")
    # Tensor parallelism too: the tp axis leaves the reductions.
    tr = Trainer(tlm.model_spec(parallelism="tensor", **LM), device="cpu",
                 mesh=Mesh({"dp": 1, "tp": 2}))
    assert tr.ctx.tp_axis == "tp" and tr.reduce_axes == ("dp",)
    # Sharded tables over an ep axis of two ranks are ported: DeepFM under
    # the ParameterServer strategy builds on (dp=2, ep=2) and shards its
    # table over ep.
    tr = Trainer(deepfm.model_spec(**DFM), device="cpu", mesh=Mesh({"dp": 2, "ep": 2}, rank=3),
                 config=JobConfig(distribution_strategy="ParameterServer"))
    assert tr.axis_name == "ep" and tr.sharded_embeddings
    assert (tr.ctx.axis_name, tr.ctx.axis_size, tr.ctx.axis_index) == ("ep", 2, 1)
    assert tr._table_grad_axes == ("dp",)


# ---- 2. settle_membership ------------------------------------------------------------


class _DirectMaster:
    """The two RPCs the settle loop uses, on a rendezvous in process; RPCs
    raise at the poll numbers in ``fail``."""

    def __init__(self, rdzv, fail=()):
        self.r, self.fail, self.step = rdzv, set(fail), 0

    def call(self, method, req):
        if self.step in self.fail:
            raise ConnectionError("master briefly unreachable")
        if method == "Heartbeat":
            return {"version": self.r.heartbeat(req["worker_id"], req.get("version"))}
        if method == "GetMembership":
            return self.r.membership()
        raise AssertionError(method)


def _settle_case(name):
    """A fresh rendezvous and (worker, actions by poll number, fail, max_s)
    for each case of tests/test_settle.py."""
    r = RendezvousServer()
    if name == "full_confirmed_gang":
        r.set_expected(2)
        r.register("A", "hostA:1")
        return r, ("A", {3: lambda: r.register("B", "hostB:1")}, (), 50.0)
    if name == "stale_incarnation":
        r.set_expected(2)
        r.register("stale", "h1:1")
        r.register("A", "h2:1")
        return r, ("A", {4: lambda: r.remove("stale"), 6: lambda: r.register("B", "h1:2")},
                   (), 50.0)
    if name == "deadline_degrades":
        r.set_expected(3)
        r.register("A", "h1:1")
        r.register("B", "h2:1")
        return r, ("A", {}, (), 5.0)
    if name == "no_expected":
        r.register("A", "h1:1")
        return r, ("A", {}, (), 50.0)
    if name == "master_blips":
        r.set_expected(2)
        r.register("A", "h1:1")
        return r, ("A", {2: lambda: r.register("B", "h2:1")}, (1, 3, 4), 50.0)
    assert name == "scale_down"
    r.set_expected(4)
    for w, h in (("A", "h1:1"), ("B", "h2:1"), ("C", "h3:1"), ("D", "h4:1")):
        r.register(w, h)
    r.set_expected(2)
    for w in "BCD":
        r.heartbeat(w, r.membership()["version"])
    return r, ("A", {3: lambda: r.remove("C"),
                     5: lambda: (r.remove("D"), r.heartbeat("B", r.membership()["version"]))},
               (), 50.0)


def _drive_settle(settle, name):
    r, (worker, actions, fail, max_s) = _settle_case(name)
    master = _DirectMaster(r, fail)
    t, steps = [0.0], [0]

    def sleep(dt):
        steps[0] += 1
        master.step = steps[0]
        t[0] += max(dt, 0.05)
        fn = actions.get(steps[0])
        if fn:
            fn()

    view = settle(master, worker, r.membership(), poll_s=0.05, stable_s=1.0, max_s=max_s,
                  clock=lambda: t[0], sleep=sleep)
    return view, t[0], steps[0]


@pytest.mark.parametrize("name", ["full_confirmed_gang", "stale_incarnation",
                                  "deadline_degrades", "no_expected", "master_blips",
                                  "scale_down"])
def test_settle_membership_matches_the_reference(name):
    view, elapsed, steps = _drive_settle(port_main.settle_membership, name)
    ref = _drive_settle(jax_main.settle_membership, name)
    assert (view, elapsed, steps) == ref
    # The reference tests' expectations.
    confirmed = all(view["confirmed"][w] == view["version"] for w in view["workers"])
    if name in ("full_confirmed_gang", "master_blips"):
        assert view["world_size"] == 2 and confirmed and elapsed < 10
    elif name == "stale_incarnation":
        assert sorted(view["workers"]) == ["A", "B"] and confirmed and elapsed < 10
    elif name == "deadline_degrades":
        assert view["world_size"] == 2 and elapsed >= 5.0
    elif name == "no_expected":
        assert view["world_size"] == 1 and 1.0 <= elapsed < 5.0
    else:
        assert sorted(view["workers"]) == ["A", "B"] and steps >= 5 and elapsed < 10


# ---- 3. the death push ----------------------------------------------------------------

_TWO = {"version": 0, "world_size": 2, "ranks": {"w-a": 0, "w-b": 1},
        "addresses": {"w-a": "h1:1", "w-b": "h2:1"}}
_ALONE = {"version": 1, "world_size": 1, "ranks": {"w-a": 0}, "addresses": {"w-a": "h1:1"}}
_JOIN = {"version": 1, "world_size": 3, "ranks": {"w-a": 0, "w-b": 1, "w-c": 2},
         "addresses": {"w-a": "h1:1", "w-b": "h2:1", "w-c": "h3:1"}}
# Each case: config overrides, group mode, then steps: ("view", membership),
# ("tick", now), ("apply", membership: the task loop re-formed), ("down",)
# and ("up",) for the master's reachability.
DEATH_CASES = {
    "departure_after_grace": ({}, True, [("view", _ALONE), ("tick", 100.0), ("tick", 101.0),
                                         ("tick", 102.5)]),
    "main_thread_wins": ({}, True, [("view", _ALONE), ("tick", 100.0), ("apply", _ALONE),
                                    ("tick", 105.0)]),
    "pure_join": ({}, True, [("view", _JOIN), ("tick", 100.0), ("tick", 105.0),
                             ("tick", 200.0)]),
    "identical_churn": ({}, True, [("view", dict(_TWO, version=2)), ("tick", 100.0),
                                   ("tick", 200.0)]),
    "grace_disabled": ({"death_push_grace_s": 0.0}, True, [("view", _ALONE), ("tick", 100.0),
                                                          ("tick", 200.0)]),
    "not_group_mode": ({}, False, [("view", _ALONE), ("tick", 100.0), ("tick", 200.0)]),
    "master_unreachable": ({}, True, [("view", _ALONE), ("tick", 100.0), ("down",),
                                      ("tick", 105.0), ("up",), ("tick", 105.0)]),
}
DEATH_WANT = {
    "departure_after_grace": [False, False, True],
    "main_thread_wins": [False, False],
    "pure_join": [False, False, False],
    "identical_churn": [False, False],
    "grace_disabled": [False, False],
    "not_group_mode": [False, False],
    "master_unreachable": [False, False, True],
}


def _death_push(worker_cls, config, name):
    overrides, group, steps = DEATH_CASES[name]
    view = {"m": dict(_TWO), "up": True}

    class Master:
        def call(self, method, req):
            assert method == "GetMembership"
            if not view["up"]:
                raise ConnectionError("master briefly down")
            return dict(view["m"])

    w = worker_cls.__new__(worker_cls)  # no trainer or device for the tick
    w.config = config(model_def="mnist.model_spec", training_data="x", multihost=True,
                      **overrides)
    w.master, w.worker_id = Master(), "w-a"
    w._membership_version, w._group_mode = 0, group
    w._ranks, w._addresses = dict(_TWO["ranks"]), dict(_TWO["addresses"])
    w._reforming = False
    state, out = {"pending_since": None}, []
    for step in steps:
        if step[0] == "view":
            view["m"] = step[1]
        elif step[0] == "apply":
            w._membership_version = step[1]["version"]
            w._ranks, w._addresses = dict(step[1]["ranks"]), dict(step[1]["addresses"])
        elif step[0] in ("down", "up"):
            view["up"] = step[0] == "up"
        else:
            out.append((w.death_watch_tick(state, now=step[1]), state["pending_since"]))
    return out


@pytest.mark.parametrize("name", sorted(DEATH_CASES))
def test_death_push_matches_the_reference(name):
    got = _death_push(Worker, JobConfig, name)
    assert got == _death_push(JaxWorker, JaxJobConfig, name)
    assert [fired for fired, _ in got] == DEATH_WANT[name]


def test_a_task_loop_handling_the_loss_itself_is_not_pushed():
    """The port's ``_reforming``: a task loop whose collective failed is not
    blocked; it waits for the membership itself, and the push stands down."""
    w = Worker.__new__(Worker)
    w.config = JobConfig(multihost=True)
    w.master = type("M", (), {"call": staticmethod(lambda m, r: dict(_ALONE))})()
    w.worker_id, w._membership_version, w._group_mode = "w-a", 0, True
    w._ranks, w._addresses = dict(_TWO["ranks"]), dict(_TWO["addresses"])
    w._reforming = True
    state = {"pending_since": None}
    assert [w.death_watch_tick(state, now=t) for t in (100.0, 110.0)] == [False, False]


# ---- 5a. the survivor's snapshot, in-process ---------------------------------------------

# Each case: this worker's rank in the old world of two, where the
# collective fails (at the second training task's first or second step, or
# in an eval step after it), whether the master counts rank 0's reports,
# and the step the survivor must save (None: no snapshot).  Tasks are 2
# steps.
SURVIVOR_CASES = {
    "failed_at_the_tasks_first_step": (0, "first_step", True, 2),
    "failed_inside_the_task": (0, "second_step", True, 2),
    "failed_in_eval_after_the_task": (0, "eval", True, 4),
    "last_report_refused": (0, "first_step", False, None),
    "survivor_is_not_rank_0": (1, "first_step", True, None),
}


@pytest.mark.parametrize("name", sorted(SURVIVOR_CASES))
def test_the_survivors_snapshot_holds_what_the_master_counted(tmp_path, name):
    """A collective fails in a gang: the survivor saves the state of the
    training tasks whose reports the master counted, and never the steps
    of the failed task (the master requeues it).  Only the old world's
    rank 0 knows what was reported."""
    from elasticdl_tpu_torch.common.checkpoint import CheckpointManager
    from elasticdl_tpu_torch.master.task_dispatcher import Task
    from elasticdl_tpu_torch.parallel.trainer import CollectiveError, TrainLoopError
    from elasticdl_tpu_torch.worker.worker import WorkerRestartRequired

    rank, fail, counted, want = SURVIVOR_CASES[name]
    train, ckpt = str(tmp_path / "train.rio"), str(tmp_path / "ckpt")
    generate("lm", train, 32, seed=0, seq_len=64, vocab=512)
    reader = create_data_reader(train)
    shards = reader.create_shards(16)
    ranks = {"w-a": rank, "w-b": 1 - rank}
    calls = []

    class Master:
        def call(self, method, req):
            calls.append(method)
            if method == "ReportTaskResult":
                return {"accepted": counted}
            if method == "GetMembership":  # w-b is gone
                return {"version": 1, "world_size": 1, "ranks": {"w-a": 0},
                        "addresses": {"w-a": "h1:1"}}
            assert method == "ReportCheckpoint", method
            return {}

    spec = tlm.model_spec(vocab=512, dim=64, n_heads=4, n_layers=2, max_seq=64, seq_len=64,
                          compute_dtype="float32")
    worker = Worker(JobConfig(training_data=train, minibatch_size=8, checkpoint_dir=ckpt,
                              checkpoint_steps=0, multihost=True),
                    Master(), reader, worker_id="w-a", spec=spec, device="cpu")
    worker._apply_membership({"version": 0, "world_size": 2, "ranks": ranks,
                              "addresses": {"w-a": "h1:1", "w-b": "h2:1"}}, initial=True)
    worker.state, worker._steps_dispatched = worker.trainer.init_state(0), 0

    def settle(task_id):
        fetch, n_steps = worker._dispatch_training_task(Task(task_id, shards[task_id]))
        worker._steps_dispatched += n_steps
        worker._flush(({"worker_id": "w-a", "task_id": task_id, "task_type": "training",
                        "success": True}, fetch))
        return worker.trainer.host_state(worker.state)

    settled = settle(0)
    report = {"worker_id": "w-a", "task_id": 1, "task_type": "training", "success": True}
    if fail == "eval":
        settled = settle(1)
        cause = CollectiveError("the peer is gone")
    else:
        # The step both dispatch paths run (a fused task's scan included).
        step_of, done = worker.trainer._train_step, worker.state.step
        ran = 0 if fail == "first_step" else 1

        def failing_step(state, batch):
            if state.step - done >= ran:
                raise CollectiveError("the peer is gone")
            return step_of(state, batch)

        worker.trainer._train_step = failing_step
        with pytest.raises(TrainLoopError) as failed:
            worker._dispatch_training_task(Task(1, shards[1]))
        assert worker.state.step == done + ran
        cause = failed.value
    with pytest.raises(WorkerRestartRequired):
        worker._group_resync(report, "test", cause)
    reports = 2 if fail == "eval" else 1
    assert calls.count("ReportTaskResult") == (reports if rank == 0 else 0)
    steps = CheckpointManager(ckpt).all_steps()
    if want is None:
        assert steps == [] and "ReportCheckpoint" not in calls
        return
    assert steps == [want] and read_manifest(ckpt)["step"] == want
    saved = CheckpointManager(ckpt).restore(want)
    assert sorted(saved) == sorted(settled)
    for key, value in settled.items():
        np.testing.assert_array_equal(np.asarray(saved[key]), np.asarray(value), err_msg=key)


# ---- 4 and 5. worker processes on the CPU ----------------------------------------------

MODEL_PARAMS = "vocab=512;dim=64;n_heads=4;n_layers=2;max_seq=64;seq_len=64;compute_dtype=float32"


def _events(text):
    out = []
    for line in text.splitlines():
        if line.startswith("[worker-event] "):
            out.append(json.loads(line[len("[worker-event] "):]))
    return out


def _by_kind(text, kind):
    return [e for e in _events(text) if e["event"] == kind]


@pytest.fixture
def cpu_gang(monkeypatch):
    """Worker subprocesses (which inherit this environment) on the CPU,
    importing the package from this checkout, logging state digests."""
    monkeypatch.setenv("ELASTICDL_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("ELASTICDL_STATE_DIGEST", "1")
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [_REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    monkeypatch.delenv("GRAFT_CHAOS", raising=False)
    monkeypatch.delenv("ELASTICDL_TORCH_DIST_BACKEND", raising=False)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "per_step"])
def test_two_worker_processes_walk_one_group_log(tmp_path, cpu_gang, fused):
    train = str(tmp_path / "train.rio")
    generate("lm", train, 96, seed=0, seq_len=64, vocab=512)
    reader = create_data_reader(train)
    rendezvous = RendezvousServer()
    rendezvous.set_expected(2)
    servicer = MasterServicer(TaskDispatcher(reader.create_shards(16)), rendezvous=rendezvous)
    server = MasterServer(servicer, port=0).start()
    config = JobConfig(model_def="transformer_lm.model_spec", model_params=MODEL_PARAMS,
                       training_data=train, minibatch_size=8, checkpoint_dir=str(tmp_path / "ck"),
                       checkpoint_steps=4, master_addr=server.address, multihost=True,
                       dcn_data_parallelism=2, coordinator_port=free_port(),
                       fused_task_scan=fused)
    logs, procs = {}, {}
    try:
        for w in ("w-a", "w-b"):
            logs[w] = str(tmp_path / f"{w}.log")
            env = dict(os.environ, **config.to_env(), ELASTICDL_WORKER_ID=w)
            procs[w] = subprocess.Popen([sys.executable, "-m", "elasticdl_tpu_torch.worker.main"],
                                        cwd=_REPO, env=env, stdout=open(logs[w], "w"),
                                        stderr=subprocess.STDOUT)
        rcs = {w: p.wait(timeout=WAIT_S) for w, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
        server.stop()
    text = {w: open(path).read() for w, path in logs.items()}
    assert rcs == {"w-a": 0, "w-b": 0}, text
    # One train_scan a task, or (without the flag) one step a minibatch.
    assert all(("task dispatch: fused" in t) is fused for t in text.values()), text
    summaries = {w: _by_kind(text[w], "summary")[0] for w in text}
    gang = {w: _by_kind(text[w], "gang")[0] for w in text}
    assert sorted(g["rank"] for g in gang.values()) == [0, 1]
    assert all(g["world"] == 2 and g["mesh"] == {"dp": 2, "ep": 1} for g in gang.values())
    # Both ranks ran the group log's tasks in its order; one report each.
    logged = [e["task"]["task_id"] for e in servicer._group_log if e.get("task")]
    assert summaries["w-a"]["tasks"] == summaries["w-b"]["tasks"] == logged
    assert len(logged) == 6 and servicer.dispatcher.finished()
    counts = servicer.dispatcher.counts()
    assert counts["done"] == 6 and counts["duplicate_done"] == 0
    # One state: equal digests at every checkpoint, equal first-step losses.
    digests = {w: {e["step"]: e["digest"] for e in _by_kind(text[w], "checkpoint")} for w in text}
    assert digests["w-a"] == digests["w-b"] and sorted(digests["w-a"]) == [4, 8, 12]
    assert (_by_kind(text["w-a"], "first_step")[0]["loss"]
            == _by_kind(text["w-b"], "first_step")[0]["loss"])
    assert read_manifest(str(tmp_path / "ck"))["step"] == 12


def test_sigkill_of_a_rank_reforms_the_gang_from_the_survivors_snapshot(tmp_path, cpu_gang):
    train = str(tmp_path / "train.rio")
    generate("lm", train, 256, seed=0, seq_len=64, vocab=512)
    ckpt, pods = str(tmp_path / "ckpt"), str(tmp_path / "pods")
    job = "gang"
    w0, w1 = f"{job}-worker-0", f"{job}-worker-1"
    cmd = [sys.executable, "-m", "elasticdl_tpu_torch.client.main", "train", "--local",
           f"--job_name={job}", "--model_def=transformer_lm.model_spec",
           f"--model_params={MODEL_PARAMS}", f"--training_data={train}", "--minibatch_size=8",
           "--num_minibatches_per_task=2", f"--checkpoint_dir={ckpt}", "--checkpoint_steps=4",
           f"--pod_log_dir={pods}", "--num_workers=2", "--multihost=true",
           "--dcn_data_parallelism=2", "--max_worker_relaunch=2",
           f"--coordinator_port={free_port()}",
           # Rank 1 stalls at its first task boundary past step 10: rank 0
           # blocks in that step's collective, where the SIGKILL finds it.
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
        os.kill(_by_kind(open(path).read(), "ready")[0]["pid"], signal.SIGKILL)
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
    # Every world ran its tasks as one train_scan each.
    assert all("task dispatch: fused" in t for t in logs.values()), logs
    # Rank 0 survived and snapshotted the state of the tasks it reported;
    # both relaunches joined from it.
    assert _by_kind(logs[w0], "gang")[0]["rank"] == 0
    snap = int(logs[w0].split("pre-restart snapshot at step ", 1)[1].split()[0])
    assert snap >= 10
    for n in (f"{w0}-r1", f"{w1}-r1"):
        assert _by_kind(logs[n], "ready")[0]["joined_step"] == snap, logs[n]
        assert _by_kind(logs[n], "gang")[0]["world"] == 2
    # Every task done once: none lost, none done twice, none abandoned.
    status = eval(cli.split("job finished: ", 1)[1].splitlines()[0])  # a dict literal
    assert status["finished"] and status["done"] == 16, status
    assert status["duplicate_done"] == 0 and status["abandoned"] == 0, status
    # One state in each world: equal digests at every shared checkpoint.
    for a, b in ((w0, w1), (f"{w0}-r1", f"{w1}-r1")):
        da = {e["step"]: e["digest"] for e in _by_kind(logs[a], "checkpoint")}
        db = {e["step"]: e["digest"] for e in _by_kind(logs[b], "checkpoint")}
        shared = set(da) & set(db)
        assert shared and all(da[s] == db[s] for s in shared), (da, db)
    # Every example trained once: 16 tasks of 2 steps.
    final = _by_kind(logs[f"{w0}-r1"], "summary")[0]
    assert read_manifest(ckpt)["step"] == final["step"] == 32
