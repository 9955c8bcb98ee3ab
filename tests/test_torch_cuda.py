"""The port's CUDA kernels against their plain versions, on a card.

Every case here needs an NVIDIA card (the kernels have no CPU mode), is
marked ``cuda`` and skips without one.  The file imports neither JAX nor
the JAX package, so it also runs on a machine with the card and no JAX,
without the repo's conftest (which sets JAX up):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Limits are chip_smoke.py's, set from the kernels' readings on the card
(PERF.md): for the forward, O's error norm over O's norm, O's largest
error over O's largest element, lse's largest absolute error; for the
backward, each gradient's error norm over the reference's norm and its
largest error over the largest element, and delta's largest error over
its largest element.
"""

import contextlib
import copy
import dataclasses

import numpy as np
import pytest
import torch

from elasticdl_tpu_torch.models import cifar10_resnet, mnist, wide_deep
from elasticdl_tpu_torch.models import transformer_lm as tlm
from elasticdl_tpu_torch.ops import flash_attention as tfa
from elasticdl_tpu_torch.ops import kernels
from elasticdl_tpu_torch.parallel.trainer import Trainer

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_FWD_TOL = {torch.float32: (1e-5, 1e-4, 2e-5), torch.bfloat16: (1e-2, 2**-5, 1e-4)}
_BWD_TOL = {torch.float32: (1e-5, 1e-4, 1e-5), torch.bfloat16: (2e-3, 2**-5, 1e-5)}

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from elasticdl_tpu_torch.common.device import set_matmul_precision

    set_matmul_precision()


def _arrays(shape, seed, n=3):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(shape) * 0.5).astype(np.float32) for _ in range(n)]


def _qkv_views(b, l, h, d, dtype, seed=0):
    """q, k, v as views into one fused [B, L, 3*H*D] projection on the card,
    as the model hands them to the kernels."""
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy((rng.standard_normal((b, l, 3 * h * d)) * 0.5).astype(np.float32))
    return tfa._split_qkv(qkv.to(dtype).cuda(), h)


def _assert_fwd_close(out, lse, ref, ref_lse):
    o_rel, o_max, lse_abs = _FWD_TOL[ref.dtype]
    err = out.float() - ref.float()
    assert (err.norm() / ref.float().norm()).item() <= o_rel
    assert (err.abs().max() / ref.float().abs().max()).item() <= o_max
    assert (lse - ref_lse).abs().max().item() <= lse_abs


@pytest.mark.parametrize("d", [64, 128, 36])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain_version(card, dtype, causal, d):
    """Contiguous q, k, v; D=36 takes the bf16 kernel's padded route."""
    q, k, v = (torch.from_numpy(a).to(_DTYPES[dtype]).cuda() for a in _arrays((2, 256, 3, d), 0))
    out, lse = tfa.flash_attention_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    _assert_fwd_close(out, lse, *tfa.flash_attention_plain(q, k, v, causal))


@pytest.mark.parametrize("d", [64, 128, 36])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_reads_fused_qkv_views(card, dtype, causal, d):
    q, k, v = _qkv_views(2, 256, 3, d, _DTYPES[dtype])
    out, lse = tfa.flash_attention_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    _assert_fwd_close(out, lse, *tfa.flash_attention_plain(q, k, v, causal))


def test_cuda_kernel_long_sequence(card):
    """L=8192, the contract's longest: 128 key tiles through the ring."""
    q, k, v = _qkv_views(1, 8192, 2, 64, torch.bfloat16, seed=3)
    out, lse = tfa.flash_attention_fwd(q, k, v, True)
    torch.cuda.synchronize()
    _assert_fwd_close(out, lse, *tfa.flash_attention_plain(q, k, v, True))


@pytest.mark.parametrize("d", [64, 128, 36])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fused", [False, True])
def test_cuda_backward_kernels_match_plain_version(card, fused, dtype, causal, d):
    """Kernels against plain versions; D=36 takes the bf16 kernels' padded
    route."""
    b, l, h = 2, 256, 3
    tdt = _DTYPES[dtype]
    rng = np.random.default_rng(8)
    g = torch.from_numpy(rng.standard_normal((b, l, h, d)).astype(np.float32)).to(tdt).cuda()
    if fused:
        q, k, v = _qkv_views(b, l, h, d, tdt, seed=8)
        dq_buf, dk_buf, dv_buf = tfa._split_qkv(torch.empty((b, l, 3 * h * d), dtype=tdt,
                                                            device="cuda"), h)
    else:
        q, k, v = (torch.from_numpy(a).to(tdt).cuda() for a in _arrays((b, l, h, d), 8))
        dq_buf = dk_buf = dv_buf = None
    o, lse = tfa.flash_attention_fwd(q, k, v, causal)
    dq, delta = tfa.flash_attention_bwd_dq(q, k, v, o, lse, g, causal, dq=dq_buf)
    dk, dv = tfa.flash_attention_bwd_dkv(q, k, v, g, lse, delta, causal, dk=dk_buf, dv=dv_buf)
    torch.cuda.synchronize()
    ref_dq, ref_delta = tfa.flash_attention_bwd_dq_plain(q, k, v, o, lse, g, causal)
    ref = (ref_dq, *tfa.flash_attention_bwd_dkv_plain(q, k, v, g, lse, ref_delta, causal))
    rel, largest, delta_tol = _BWD_TOL[tdt]
    assert ((delta - ref_delta).abs().max() / ref_delta.abs().max()).item() <= delta_tol
    for x, r in zip((dq, dk, dv), ref):
        err = x.float() - r.float()
        assert (err.norm() / r.float().norm()).item() <= rel
        assert (err.abs().max() / r.float().abs().max()).item() <= largest


def test_cuda_training_step_launches_each_kernel_once_per_layer(card):
    qkv = torch.randn((2, 256, 3 * 2 * 64), device="cuda", dtype=torch.bfloat16,
                      requires_grad=True)
    kernels.reset_counts()
    tfa.flash_attention(*tfa._split_qkv(qkv, 2), True).float().square().sum().backward()
    counts = kernels.counts()
    assert [counts.get(n, 0) for n in (tfa.KERNEL, tfa.DQ_KERNEL, tfa.DKV_KERNEL)] == [1, 1, 1]
    assert qkv.grad is not None and torch.isfinite(qkv.grad).all()


@pytest.mark.parametrize("remat", [False, True])
def test_cuda_transformer_lm_trains_through_the_kernels(card, remat):
    layers = 2
    spec = tlm.model_spec(compute_dtype="bfloat16", vocab=512, dim=128, n_heads=2,
                          n_layers=layers, max_seq=256, seq_len=256, remat=remat)
    trainer = Trainer(spec, device="cuda")
    state = trainer.init_state(0)
    toks = np.random.default_rng(0).integers(0, 512, (4, 257)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    kernels.reset_counts()
    state, metrics = trainer.run_train_steps(state, [batch, batch])
    counts = kernels.counts()
    forwards = (2 if remat else 1) * layers * 2
    assert [counts.get(n, 0) for n in (tfa.KERNEL, tfa.DQ_KERNEL, tfa.DKV_KERNEL)] == [
        forwards, 2 * layers, 2 * layers]
    losses = [float(m["loss"]) for m in metrics]
    assert all(np.isfinite(losses)) and losses[1] < losses[0]
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in state.model.parameters())


def test_cuda_tiny_job_over_the_direct_master(card, tmp_path):
    """A tiny elastic job on the card: 4 training tasks through the
    kernels, eval rounds over a ragged validation file (each eval step's
    forward through the kernel), checkpoints published, a replica's hot
    reload of the last one serving the worker's final module."""
    from elasticdl_tpu_torch.common.checkpoint import read_manifest
    from elasticdl_tpu_torch.common.config import JobConfig
    from elasticdl_tpu_torch.data.reader import create_data_reader
    from elasticdl_tpu_torch.data.synthetic import generate
    from elasticdl_tpu_torch.master.evaluation_service import EvaluationService
    from elasticdl_tpu_torch.master.servicer import MasterServicer
    from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
    from elasticdl_tpu_torch.parallel.trainer import outputs_to_numpy
    from elasticdl_tpu_torch.serving.server import ServingServer
    from elasticdl_tpu_torch.worker.worker import DirectMasterProxy, Worker

    seq, vocab, layers, mb = 256, 512, 2, 4
    model = dict(compute_dtype="bfloat16", vocab=vocab, dim=128, n_heads=2, n_layers=layers,
                 max_seq=seq, seq_len=seq, remat=False)
    train, val = str(tmp_path / "train.rio"), str(tmp_path / "val.rio")
    generate("lm", train, 32, seed=0, seq_len=seq, vocab=vocab)
    generate("lm", val, 10, seed=1, seq_len=seq, vocab=vocab)
    ckpt = str(tmp_path / "ckpt")
    config = JobConfig(model_def="transformer_lm.model_spec", minibatch_size=mb,
                       num_minibatches_per_task=2, evaluation_steps=4, checkpoint_dir=ckpt,
                       checkpoint_steps=4, keep_checkpoint_max=2)
    reader, eval_reader = create_data_reader(train), create_data_reader(val)
    servicer = MasterServicer(
        TaskDispatcher(reader.create_shards(2 * mb)),
        evaluation=EvaluationService(eval_reader.create_shards(2 * mb), 4),
    )

    class Mux:
        def read_records(self, shard):
            return (reader if shard.name == train else eval_reader).read_records(shard)

    spec = tlm.model_spec(**model)
    worker = Worker(config, DirectMasterProxy(servicer), Mux(), spec=spec)
    assert worker.trainer.device.type == "cuda"
    kernels.reset_counts()
    result = worker.run()
    counts = kernels.counts()
    status = servicer.JobStatus({})
    assert status["done"] == 4 and status["duplicate_done"] == 0 and result["step"] == 8
    eval_steps = status["eval_rounds"] * 3  # 10 records: 2 tasks, 3 minibatches a round
    assert status["eval_rounds"] >= 1 and np.isfinite(status["eval_metrics"]["loss"])
    assert counts.get(tfa.DQ_KERNEL, 0) == counts.get(tfa.DKV_KERNEL, 0) == 8 * layers
    assert counts.get(tfa.KERNEL, 0) == (8 + eval_steps) * layers
    assert read_manifest(ckpt)["step"] == 8
    server = ServingServer(spec, checkpoint_dir=ckpt, max_batch=2, batch_buckets=[2])
    try:
        assert server.live_step == 8
        toks = np.random.default_rng(2).integers(0, vocab, (2, seq)).astype(np.int32)
        served = server._run_batch({"tokens": toks}, 2)[0]
        ref = outputs_to_numpy(server.trainer.run_predict_step(worker.state.model, {"tokens": toks}))
        # The same weights through the same kernels: chip_smoke.py's bf16
        # limit on the error norm over the norm.
        assert np.linalg.norm(served - ref) / np.linalg.norm(ref) <= 1e-2
    finally:
        server.stop(grace=0)


def test_cuda_checkpoint_round_trip_of_a_cuda_state(card, tmp_path):
    """Snapshot -> host -> disk -> card, bit-exact, with a train step
    updating the live state in place between the snapshot and its host
    copy; the restored state's next step matches the live run's."""
    from elasticdl_tpu_torch.common.checkpoint import CheckpointManager

    spec = tlm.model_spec(compute_dtype="bfloat16", vocab=512, dim=128, n_heads=2,
                          n_layers=2, max_seq=256, seq_len=256)
    trainer = Trainer(spec, device="cuda")
    state = trainer.init_state(0)
    toks = np.random.default_rng(0).integers(0, 512, (4, 257)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    state, _ = trainer.run_train_steps(state, [batch, batch])
    want = trainer.host_state(state)
    mgr = CheckpointManager(str(tmp_path))
    snap = trainer.snapshot_state(state)
    assert all(v.is_cuda for k, v in snap.items() if k.startswith("params/"))
    state, live = trainer.run_train_steps(state, [batch])  # in place, after the snapshot
    saved = trainer.to_host(snap)  # the background host copy
    assert sorted(saved) == sorted(want)
    for key in want:
        assert np.array_equal(saved[key], want[key]), key
    mgr.save(2, saved)
    mgr.publish(2)
    restored = trainer.adopt_restored(mgr.restore(2), trainer.init_state(1))
    got = trainer.host_state(restored)
    assert sorted(got) == sorted(want) and restored.step == 2
    for key in want:
        assert np.array_equal(got[key], want[key]), key
    assert all(p.is_cuda for p in restored.model.parameters())
    assert all(st["exp_avg"].is_cuda for st in restored.optimizer.state.values())
    # The restored state's step 3 against the live one's: the same loss,
    # and the same parameters and moments after it (limit 1e-5 on the
    # error norm over the norm; wrong moments or count miss by far more).
    restored, resumed = trainer.run_train_steps(restored, [batch])
    assert float(resumed[0]["loss"]) == pytest.approx(float(live[0]["loss"]), rel=1e-6)
    a, b = trainer.host_state(state), trainer.host_state(restored)
    for key in a:
        ref = a[key].astype(np.float64)
        assert np.linalg.norm(b[key] - ref) <= 1e-5 * max(np.linalg.norm(ref), 1e-30), key


# ---- DeepFM on the card (plain PyTorch: no hand-written kernel) ----


def _criteo_records(n, seed=0):
    from elasticdl_tpu_torch.data.codecs import encode_criteo_example

    rng = np.random.default_rng(seed)
    return [encode_criteo_example(int(rng.integers(0, 2)),
                                  [int(rng.integers(0, 1000)) for _ in range(13)],
                                  [int(rng.integers(0, 1 << 32)) for _ in range(26)])
            for _ in range(n)]


def test_cuda_gather_rows_out_of_range_reads_nan_without_a_device_assert(card):
    """Out-of-range ids of either sign read NaN rows on the card and drop
    their cotangents; no device assert poisons the context (the next
    operation and a synchronise still work)."""
    from elasticdl_tpu_torch.ops.embedding import gather_rows, logical_rows, pack_table

    table = pack_table(torch.randn(1000, 9, device="cuda"), 9).requires_grad_(True)
    rows = logical_rows(table, 9)
    ids = torch.tensor([0, -1, rows, -(2**40), 2**40, 7], device="cuda")
    out = gather_rows(table, ids, 9)
    (out * 3.0).sum().backward()
    torch.cuda.synchronize()
    assert torch.isnan(out[1:5]).all() and torch.isfinite(out[[0, 5]]).all()
    touched = table.grad.reshape(-1, 16)[:, :9].abs().sum(1).nonzero().flatten().tolist()
    assert touched == [0, 7] and torch.isfinite(table.grad).all()
    assert float((torch.ones(4, device="cuda") * 2).sum()) == 8.0


def test_cuda_deepfm_step_matches_the_cpu(card):
    """The preprocessed feed's wire dtypes (uint16 ids, float16 dense,
    uint8 labels) reach the card bit for bit; DeepFM's logits and
    gradients on the card equal the CPU's on the same weights (f32, TF32
    off: error norm over norm at most 1e-4)."""
    from elasticdl_tpu_torch.models import deepfm
    from elasticdl_tpu_torch.parallel.trainer import MASK_KEY

    spec = deepfm.model_spec(buckets_per_feature=512, embedding_dim=8, hidden=(64, 64),
                             compute_dtype="float32")
    batch = dict(spec.feed(_criteo_records(256)))
    batch[MASK_KEY] = (np.arange(256) < 250).astype(np.float32)
    results = {}
    for device in ("cpu", "cuda"):
        trainer = Trainer(spec, device=device)
        state = trainer.init_state(None)
        if device == "cpu":
            state.model.reset_parameters(torch.Generator().manual_seed(0))
            tree = deepfm.params_to_jax(state.model)
        else:
            state.model.load_jax_params(tree)
        placed = trainer.shard_batch(batch)
        for k in ("cat", "dense", "labels"):
            assert placed[k].dtype == torch.from_numpy(batch[k]).dtype
            assert placed[k].cpu().numpy().tobytes() == batch[k].tobytes(), k
        placed = dict(placed)
        mask = placed.pop(MASK_KEY)
        logits = spec.apply(state.model, placed, train=True)
        spec.loss(logits, placed, mask=mask).backward()
        results[device] = {"logits": logits.detach().cpu(),
                           **{n: p.grad.cpu() for n, p in state.model.named_parameters()}}
    for key, ref in results["cpu"].items():
        got = results["cuda"][key]
        assert float((got - ref).norm() / ref.norm().clamp_min(1e-30)) <= 1e-4, key


# ---- gang mode on the card ---------------------------------------------------------

_GANG_MODEL = dict(vocab=512, dim=64, n_heads=4, n_layers=2, max_seq=128, seq_len=128,
                   compute_dtype="bfloat16", remat=False)


def _gang_batches(n=3, b=8):
    rng = np.random.default_rng(4)
    out = []
    for i in range(n):
        toks = rng.integers(0, 512, size=(b, 129)).astype(np.int32)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if i == 1:
            batch["__mask__"] = (np.arange(b) < 5).astype(np.float32)
        out.append(batch)
    return out


def test_cuda_nccl_world_of_one_equals_the_bare_trainer(card, monkeypatch):
    """A Trainer over a one-rank NCCL group takes the bare Trainer's steps
    bit for bit (a sum over one rank divided by one is exact), with
    deterministic kernels where PyTorch has a choice."""
    import datetime

    import torch.distributed as dist

    from _torch_gloo_ranks import free_port
    from elasticdl_tpu_torch.parallel.mesh import create_mesh

    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True, warn_only=True)
    spec = tlm.model_spec(**_GANG_MODEL)

    def run(mesh):
        trainer = Trainer(spec, device="cuda", mesh=mesh)
        state = trainer.init_state(0)
        state, _ = trainer.run_train_steps(state, _gang_batches())
        return trainer.host_state(state)

    t = datetime.timedelta(seconds=60)
    store = dist.TCPStore("127.0.0.1", free_port(), 1, True, timeout=t)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1, timeout=t,
                            device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        bare = run(None)
        gang = run(create_mesh())
    finally:
        dist.destroy_process_group()
        torch.use_deterministic_algorithms(False)
    assert sorted(bare) == sorted(gang)
    assert all(np.array_equal(bare[k], gang[k]) for k in bare)


def test_cuda_gloo_rank_pair_on_card_tensors(card, monkeypatch):
    """Two gloo ranks on the one card, on card tensors: an exact psum, one
    state on both ranks, and losses within the bf16 loss tolerance of one
    process on the whole batches (tests/test_torch_train.py's 2e-3)."""
    from _torch_gloo_ranks import card_reduce_and_steps, run_ranks

    monkeypatch.setenv("ELASTICDL_TORCH_DEVICE", "cuda")
    monkeypatch.setenv("ELASTICDL_TORCH_DIST_BACKEND", "gloo")
    ranks = run_ranks(card_reduce_and_steps, 2, _GANG_MODEL, _gang_batches())
    trainer = Trainer(tlm.model_spec(**_GANG_MODEL), device="cuda")
    state = trainer.init_state(0)
    single = []
    for batch in _gang_batches():
        state, m = trainer.run_train_step(state, batch)
        single.append(float(m["loss"]))
    for summed, losses, host in ranks:
        assert summed.tolist() == [3.0] * 5
        assert max(abs(a - b) for a, b in zip(losses, single)) <= 2e-3, (losses, single)
    (_, _, a), (_, _, b) = ranks
    assert sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k]) for k in a)


_PS_SHARD_PROBE = r"""
import os, sys, json
import numpy as np
import torch
from elasticdl_tpu_torch.common.config import JobConfig
from elasticdl_tpu_torch.models.spec import load_model_spec_for_job
from elasticdl_tpu_torch.ps.service import PSServer, RemoteEmbeddingStore

config = JobConfig(model_def="deepfm.model_spec",
                   model_params="buckets_per_feature=1048576;embedding_dim=8;hidden=400,400")
spec = load_model_spec_for_job(config)  # the "auto" resolution: the host tier
key = next(iter(spec.host_io))
servers = [PSServer(spec.host_io, shard=s, num_shards=2).start() for s in range(2)]
store = RemoteEmbeddingStore(key, spec.host_io[key].dim, [s.address for s in servers])
ids = np.arange(-4096, 4096, dtype=np.int64)
rows = store.pull(ids)
store.push_grad(ids, np.ones_like(rows))
moved = bool(np.abs(store.pull(ids) - rows).max() > 0)
store.close()
for s in servers:
    s.stop(grace=0)
print(json.dumps({"moved": moved, "cuda_initialized": torch.cuda.is_initialized()}))
"""


def test_cuda_ps_shard_never_initialises_the_card(card):
    """A PS shard is a host process: building the full-width host-tier spec
    and serving pulls and pushes leaves CUDA uninitialised in its process,
    on a machine whose card the workers use."""
    import json
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", _PS_SHARD_PROBE], cwd=repo, capture_output=True,
                          text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=repo))
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"moved": True, "cuda_initialized": False}


# ---- the model zoo on the card ------------------------------------------------------

_ZOO = {
    "mnist": (mnist, {}),
    "resnet14": (cifar10_resnet, dict(depth=14, width=8)),
    "wide_deep": (wide_deep, dict(buckets=64, hidden=(32, 16))),
}


def _zoo_batches(name, n=3, b=32):
    rng = np.random.default_rng(11)
    out = []
    for _ in range(n):
        if name == "wide_deep":
            batch = {"dense": rng.uniform(0, 100, (b, 5)).astype(np.float32),
                     "cat": rng.integers(0, 1 << 31, (b, 9)).astype(np.int32),
                     "labels": (rng.random(b) < 0.3).astype(np.int32)}
        else:
            size, ch = (28, 1) if name == "mnist" else (32, 3)
            batch = {"images": rng.random((b, size, size, ch), dtype=np.float32),
                     "labels": rng.integers(0, 10, b).astype(np.int32)}
        batch["__mask__"] = (np.arange(b) < b - 3).astype(np.float32)
        out.append(batch)
    return out


@pytest.mark.parametrize("name", sorted(_ZOO))
def test_cuda_zoo_model_steps_match_the_cpu(card, name):
    """Three training steps of each zoo model on the card and on the CPU
    from the same weights, f32 with TF32 off (Wide&Deep under the
    ParameterServer strategy, a world of one): every loss and every
    parameter after the steps within 1e-4 (error norm over norm)."""
    from elasticdl_tpu_torch.common.config import JobConfig

    mod, kw = _ZOO[name]
    strategy = "ParameterServer" if name == "wide_deep" else "AllReduce"
    spec = mod.model_spec(compute_dtype="float32", **kw)
    batches = _zoo_batches(name)
    results = {}
    for device in ("cpu", "cuda"):
        trainer = Trainer(spec, device=device, config=JobConfig(distribution_strategy=strategy))
        state = trainer.init_state(None if device == "cuda" else 0)
        if device == "cpu":
            tree = mod.params_to_jax(state.model)
        else:
            state.model.load_jax_params(tree)
        losses = []
        for batch in batches:
            state, metrics = trainer.run_train_step(state, batch)
            losses.append(float(metrics["loss"]))
        results[device] = (losses, {n: p.detach().cpu() for n, p in state.model.named_parameters()})
    (cl, cp), (gl, gp) = results["cpu"], results["cuda"]
    np.testing.assert_allclose(gl, cl, rtol=1e-4)
    for key, ref in cp.items():
        assert float((gp[key] - ref).norm() / ref.norm().clamp_min(1e-30)) <= 1e-4, key


def test_cuda_preprocessing_and_crosses_equal_the_host(card):
    """The layers' torch branch and Wide&Deep's uint32 crosses on card
    tensors give the host's integers exactly."""
    from elasticdl_tpu_torch import preprocessing as pre

    rng = np.random.default_rng(12)
    ids = rng.integers(-(1 << 31), 1 << 31, (512, 9), dtype=np.int64)
    for layer, x in ((pre.Hashing(1 << 20), ids),
                     (pre.IndexLookup(num_oov=3).adapt(ids[:64, 0]), ids[:128, 0]),
                     (pre.Discretization([-1.0, 0.0, 2.5]), rng.normal(0, 2, 256)),
                     (pre.RoundIdentity(7), rng.normal(3, 4, 256))):
        np.testing.assert_array_equal(layer(torch.from_numpy(x).cuda()).cpu().numpy(), layer(x))
    cat = torch.from_numpy(ids.astype(np.int32))
    np.testing.assert_array_equal(wide_deep.wide_ids(cat.cuda(), 65536).cpu().numpy(),
                                  wide_deep.wide_ids(cat, 65536).numpy())


# ---- the ring and tensor parallelism across gloo ranks on the card ---------------------

_RT_MODEL = dict(vocab=512, dim=64, n_heads=4, n_layers=2, max_seq=128, seq_len=128,
                 compute_dtype="float32")


@pytest.mark.parametrize("world", [2, 4])
def test_cuda_ring_and_tp_pair_across_gloo_ranks(card, monkeypatch, world):
    """The ring over ``world`` gloo ranks on card tensors (each rank's
    sequence shard; key and value blocks through host copies) against the
    plain attention over the whole sequence, output and gradients, at
    tests/test_ring_attention.py's rtol 2e-4, atol 2e-5; the tp pair's
    sums exact."""
    from _torch_gloo_ranks import ring_tp_cases, run_ranks
    from elasticdl_tpu_torch.ops.ring_attention import attention_reference

    monkeypatch.setenv("ELASTICDL_TORCH_DEVICE", "cuda")
    monkeypatch.setenv("ELASTICDL_TORCH_DIST_BACKEND", "gloo")
    q, k, v, cot = _arrays((2, 128, 4, 16), 21, n=4)
    tp_x, tp_cot = _arrays((world, 3, 5), 22, n=2)
    ranks = run_ranks(ring_tp_cases, world, q, k, v, cot, tp_x, tp_cot, "cuda")
    leaves = [torch.from_numpy(a).cuda().requires_grad_() for a in (q, k, v)]
    for causal in (False, True):
        ref = attention_reference(*leaves, causal=causal)
        got = np.concatenate([r[f"out_causal={causal}"] for r in ranks], axis=1)
        np.testing.assert_allclose(got, ref.detach().cpu().numpy(), rtol=2e-4, atol=2e-5)
    (ref * torch.from_numpy(cot).cuda()).sum().backward()
    for j, leaf in enumerate(leaves):
        got = np.concatenate([r["grads"][j] for r in ranks], axis=1)
        np.testing.assert_allclose(got, leaf.grad.cpu().numpy(), rtol=2e-4, atol=2e-5)
    for rank, r in enumerate(ranks):
        # The sums' order is gloo's: exact for two ranks.
        np.testing.assert_allclose(r["all_reduce"][0], tp_x.sum(axis=0), rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(r["all_reduce"][1], tp_cot[rank])
        np.testing.assert_array_equal(r["grad_sync"][0], tp_x[rank])
        np.testing.assert_allclose(r["grad_sync"][1], tp_cot.sum(axis=0), rtol=1e-6, atol=1e-7)


def test_cuda_ring_and_tp_trainers_on_two_gloo_ranks(card, monkeypatch):
    """``transformer_lm`` on the card over two gloo ranks: the sequence path
    on ``{dp: 2}`` (the ring) and the tensor path on ``(dp 1, tp 2)``, f32,
    3 steps from carried weights: losses within 1e-4 of one process (the
    f32 limit of chip_smoke.py's phase 15), one state on both ranks, half
    the matmul weights a tp rank."""
    from _torch_gloo_ranks import lm_mesh_runs, run_ranks

    monkeypatch.setenv("ELASTICDL_TORCH_DEVICE", "cuda")
    monkeypatch.setenv("ELASTICDL_TORCH_DIST_BACKEND", "gloo")
    batches = _gang_batches()
    runs, singles = [], []
    for parallelism, mesh in (("sequence", {}), ("tensor", dict(tensor_parallelism=2))):
        model = dict(_RT_MODEL, parallelism=parallelism)
        trainer = Trainer(tlm.model_spec(**model), device="cuda")
        state = trainer.init_state(0)
        params = copy.deepcopy(tlm.params_to_jax(state.model))
        losses = []
        for batch in batches:
            state, m = trainer.run_train_step(state, batch)
            losses.append(float(m["loss"]))
        singles.append((losses, sum(int(getattr(b, w).nbytes) for b in state.model.blocks.values()
                                    for w in ("wqkv", "wo", "w1", "w2"))))
        runs.append(dict(model=model, mesh=mesh, params=params, batches=batches))
    ranks = run_ranks(lm_mesh_runs, 2, runs, "cuda")
    for i, (losses, weights) in enumerate(singles):
        got = [[float(m["loss"]) for m in r[i]["metrics"]] for r in ranks]
        assert got[0] == got[1] and max(abs(a - b) for a, b in zip(got[0], losses)) <= 1e-4
        assert all(np.array_equal(ranks[0][i]["host"][k], ranks[1][i]["host"][k])
                   for k in ranks[0][i]["host"])
        assert ranks[0][i]["matmul_bytes"] * (2 if i else 1) == weights


def test_cuda_in_process_fleet_scales_up_and_back(card, tmp_path):
    """Two replicas on the card behind the fleet controller: real traffic
    through the p2c client blows a 1 ms target (one batcher deadline is
    3 ms), the controller scales 2 -> 3, idle polls retire back to 2.
    Every flush launches the forward kernel once a layer; every replica
    answers the same tokens alike."""
    import random

    from elasticdl_tpu_torch.common import gauge
    from elasticdl_tpu_torch.common.config import JobConfig
    from elasticdl_tpu_torch.serving.client import FleetServingClient
    from elasticdl_tpu_torch.serving.fleet import (
        AutoscaleConfig,
        InProcessServingBackend,
        ServingFleetController,
    )
    from elasticdl_tpu_torch.serving.server import ServingServer

    layers = 2
    spec = tlm.model_spec(compute_dtype="bfloat16", vocab=256, dim=128, n_heads=2,
                          n_layers=layers, max_seq=128, seq_len=128)
    state = spec.init(seed=0, device="cuda")
    servers = []

    def factory(slot):
        server = ServingServer(
            spec, max_batch=2, max_delay_ms=3, batch_buckets=(1, 2),
            gauges=gauge.Registry(), gauge_port=0, target_p99_ms=1.0,
            state=copy.deepcopy(state), device="cuda",
        )
        server.warmup()
        servers.append(server)
        return server.start()

    backend = InProcessServingBackend(factory)
    ctl = ServingFleetController(
        backend, JobConfig(job_name="fleet-cuda"),
        state_path=str(tmp_path / "fleet-pods.json"),
        autoscale=AutoscaleConfig(min_replicas=2, max_replicas=3, target_p99_ms=1.0,
                                  up_consecutive=2, down_consecutive=3, cooldown_polls=1),
        autoscale_enabled=False, gauges=gauge.Registry(),
    )
    toks = np.random.default_rng(0).integers(0, 256, (1, 128)).astype(np.int32)
    fc = None
    try:
        ctl.start(2)
        fc = FleetServingClient(ctl.wait_ready(2, timeout_s=120.0), rng=random.Random(0))

        def flushes():
            return sum(sum(s._batcher.stats()["flushes_by_bucket"].values()) for s in servers)

        answers = []
        for _ in range(2):
            answers += [fc.predict_outputs({"tokens": toks}) for _ in range(10)]
            ctl.poll_once()
        assert [(e["from"], e["to"]) for e in ctl.events()] == [(2, 3)]
        fc.set_replicas(ctl.wait_ready(3, timeout_s=120.0))
        kernels.reset_counts()
        f0 = flushes()
        answers += [fc.predict_outputs({"tokens": toks}) for _ in range(12)]
        assert kernels.counts().get(tfa.KERNEL, 0) == layers * (flushes() - f0)
        assert all(s._requests > 0 for s in servers)  # p2c reached all three
        assert all(np.array_equal(a, answers[0]) for a in answers)
        assert answers[0].shape == (1, 128, 256) and np.isfinite(answers[0]).all()
        for _ in range(6):
            ctl.poll_once()
        assert [(e["from"], e["to"]) for e in ctl.events()] == [(2, 3), (3, 2)]
        assert ctl.pods.counts()["live"] == 2
        fc.set_replicas(ctl.wait_ready(2, timeout_s=30.0))
        assert np.array_equal(fc.predict_outputs({"tokens": toks}), answers[0])
    finally:
        if fc is not None:
            fc.close()
        ctl.stop()
        backend.close()


def test_cuda_padded_head_takes_no_alignment1_gemm(card, monkeypatch):
    """GPT-2's head (vocab 50257, dim 768) at a small B x L: a profiled
    training step runs the head's three products over the head padded to
    50304 rows, launches no alignment-1 GEMM (cuBLAS's fallback for an odd
    leading dimension) and opens one ``lm:head_pad`` range per head
    product; its loss and ``tok_emb`` gradient match the plain unpadded
    product's within bf16 tolerance (error norm over norm, a few ulps)."""
    from torch.profiler import ProfilerActivity, profile

    vocab = 50257
    spec = tlm.model_spec(compute_dtype="bfloat16", vocab=vocab, dim=768, n_heads=12,
                          n_layers=1, max_seq=256, seq_len=256, remat=False)
    toks = np.random.default_rng(0).integers(0, vocab, (2, 257)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(toks[:, :-1]).cuda(),
             "labels": torch.from_numpy(toks[:, 1:]).cuda()}

    def step(model):
        loss = spec.loss(spec.apply(model, batch, train=True), batch)
        loss.backward()
        torch.cuda.synchronize()
        return loss.detach(), model.tok_emb.grad

    model = spec.init(seed=0, device="cuda")
    assert model.head_pad == 47
    step(model)  # warm: the kernels' build, cuBLAS's handles
    model.zero_grad(set_to_none=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        loss, grad = step(model)
    events = prof.events()
    ran = [e.name for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    assert ran and not [k for k in ran if "align1" in k]
    # The range's host side (a CUDA activity adds its span on the device too).
    host = [e.name for e in events if e.device_type == torch.autograd.DeviceType.CPU]
    assert host.count("lm:head_pad") == 1
    with monkeypatch.context() as patch:
        patch.setattr(tlm.TransformerLM, "head_pad", 0)
        plain = spec.init(seed=0, device="cuda")
        want_loss, want_grad = step(plain)
    assert abs(loss - want_loss).item() <= 2**-8 * abs(want_loss).item()
    assert ((grad - want_grad).norm() / want_grad.norm()).item() <= 2e-2


# ---- the fused task dispatch (train_scan / eval_scan as CUDA graphs) -------------

_SCAN_T = 3


def _scan_case(name):
    """(trainer, stacked host batch of T steps) at a small width."""
    from elasticdl_tpu_torch.common.config import JobConfig

    if name.startswith("transformer_lm"):
        # GPT-2's vocabulary runs the head over zero rows (``head_pad``).
        vocab = 50257 if name == "transformer_lm_vocab50257" else 512
        spec = tlm.model_spec(compute_dtype="bfloat16", vocab=vocab, dim=128, n_heads=2,
                              n_layers=2, max_seq=256, seq_len=256, remat=True)
        toks = np.random.default_rng(5).integers(0, vocab, (_SCAN_T, 4, 257)).astype(np.int32)
        stacked = {"tokens": toks[:, :, :-1], "labels": toks[:, :, 1:]}
        return Trainer(spec, device="cuda"), stacked
    mod, kw = _ZOO[name]
    strategy = "ParameterServer" if name == "wide_deep" else "AllReduce"
    batches = _zoo_batches(name, n=_SCAN_T)
    stacked = {k: np.stack([b[k] for b in batches]) for k in batches[0] if k != "__mask__"}
    trainer = Trainer(mod.model_spec(compute_dtype="float32", **kw), device="cuda",
                      config=JobConfig(distribution_strategy=strategy))
    return trainer, stacked


def _scan_steps(stacked):
    return [{k: v[i] for k, v in stacked.items()} for i in range(_SCAN_T)]


def _assert_states(got, want, rel):
    assert sorted(got) == sorted(want)
    for k in want:
        if rel == 0:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            err = np.abs(got[k].astype(np.float64) - want[k]).max()
            assert err <= rel * max(np.abs(want[k]).max(), 1e-30), k


@pytest.mark.parametrize(
    "name", ["transformer_lm", "transformer_lm_vocab50257", "mnist", "resnet14", "wide_deep"])
def test_cuda_train_scan_replays_one_graph_equal_to_the_eager_loop(card, name):
    """A warm-up task (eager), then ``train_scan`` captures the T steps and
    replays them under ``set_sync_debug_mode("error")``; the per-step loop
    from the same state on the same batch gives the same losses, parameters
    and optimizer slots (bit for bit; Wide&Deep's table gradients sum with
    atomics: 1e-6 relative) and the same kernel launch counts."""
    deterministic = torch.backends.cudnn.deterministic
    # cuDNN's default convolution backward sums with atomics (two eager
    # runs of MNIST differ in the last bit); its deterministic algorithms
    # make the convolutional models comparable bit for bit.
    torch.backends.cudnn.deterministic = True
    try:
        _train_scan_against_the_eager_loop(name)
    finally:
        torch.backends.cudnn.deterministic = deterministic


def _train_scan_against_the_eager_loop(name):
    trainer, stacked = _scan_case(name)
    state = trainer.init_state(0)
    state, _ = trainer.train_scan(state, trainer.shard_stacked_batch(stacked))  # eager
    assert trainer.scan_graphs() == []
    start = trainer.host_state(state)
    kernels.reset_counts()
    placed = trainer.shard_stacked_batch(stacked)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, fused = trainer.train_scan(state, placed)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    fused_counts = kernels.counts()
    (graph,) = trainer.scan_graphs()
    assert graph["kind"] == "train_scan" and graph["pool_bytes"] >= 0
    assert state.step == 2 * _SCAN_T
    fused_state = trainer.host_state(state)
    state = trainer.adopt_restored(start, state)
    kernels.reset_counts()
    state, per_step = trainer.run_train_steps(state, _scan_steps(stacked))
    assert kernels.counts() == fused_counts
    if name.startswith("transformer_lm"):
        assert fused_counts[tfa.KERNEL] == 2 * 2 * _SCAN_T  # remat: two forwards a layer
    rel = 1e-6 if name == "wide_deep" else 0
    want = torch.stack([m["loss"] for m in per_step]).cpu().numpy()
    _assert_states({"loss": fused["loss"].cpu().numpy()}, {"loss": want}, rel)
    _assert_states(fused_state, trainer.host_state(state), rel)


def test_cuda_restore_drops_the_graphs_and_the_next_scan_trains_the_restored_state(card):
    trainer, stacked = _scan_case("transformer_lm")
    state = trainer.init_state(0)
    for _ in range(2):  # eager, then captured
        state, _ = trainer.train_scan(state, trainer.shard_stacked_batch(stacked))
    assert len(trainer.scan_graphs()) == 1
    saved = trainer.host_state(state)
    state, _ = trainer.train_scan(state, trainer.shard_stacked_batch(stacked))
    # A restore replaces the optimizer's slots: the graph points at dead
    # tensors and must go; the next scan captures anew on the live ones.
    state = trainer.adopt_restored(saved, state)
    state, fused = trainer.train_scan(state, trainer.shard_stacked_batch(stacked))
    assert len(trainer.scan_graphs()) == 1
    got = trainer.host_state(state)
    state = trainer.adopt_restored(saved, state)
    state, per_step = trainer.run_train_steps(state, _scan_steps(stacked))
    _assert_states(got, trainer.host_state(state), 0)
    assert torch.equal(fused["loss"], torch.stack([m["loss"] for m in per_step]))


def test_cuda_eval_scan_replays_equal_to_per_step_eval(card):
    trainer, stacked = _scan_case("wide_deep")
    state = trainer.init_state(0)
    for _ in range(2):
        got = trainer.eval_scan(state, trainer.shard_stacked_batch(stacked))
    assert [g["kind"] for g in trainer.scan_graphs()] == ["eval_scan"]
    per_step = [trainer.eval_step(state, trainer.shard_batch(b)) for b in _scan_steps(stacked)]
    for k in got:
        assert torch.equal(got[k], torch.stack([m[k] for m in per_step])), k


def test_cuda_a_fifth_scan_variant_raises(card):
    from elasticdl_tpu_torch.parallel.trainer import ScanBudgetError

    trainer, stacked = _scan_case("mnist")
    state = trainer.init_state(0)
    for t in (1, 2, 3, 1, 2, 3):  # each variant eager, then captured
        part = {k: v[:t] for k, v in stacked.items()}
        state, _ = trainer.train_scan(state, trainer.shard_stacked_batch(part))
    twice = {k: np.concatenate([v, v]) for k, v in stacked.items()}
    state, _ = trainer.train_scan(state, trainer.shard_stacked_batch(twice))
    with pytest.raises(ScanBudgetError):
        trainer.train_scan(state, trainer.shard_stacked_batch(
            {k: np.concatenate([v, v, v]) for k, v in stacked.items()}))
    assert len(trainer.scan_graphs()) == 3


def test_cuda_a_step_that_syncs_fails_the_capture_without_falling_back(card):
    from elasticdl_tpu_torch.parallel.trainer import TrainLoopError

    trainer, stacked = _scan_case("mnist")
    state = trainer.init_state(0)
    state, _ = trainer.train_scan(state, trainer.shard_stacked_batch(stacked))  # eager
    step = trainer._train_step  # the step a scan runs

    def syncing(state, batch):
        out = step(state, batch)
        float(out[1]["loss"])  # a host sync: illegal under capture
        return out

    trainer._train_step = syncing
    with pytest.raises(TrainLoopError) as info:
        trainer.train_scan(state, trainer.shard_stacked_batch(stacked))
    assert info.value.state is None and trainer.scan_graphs() == []


def test_cuda_eval_and_predict_after_a_replay_see_the_trained_weights(card):
    """A replayed training graph updates the weights behind autograd's
    back: the model's kept bf16 casts (keyed on version counters) must not
    serve the old weights, and a captured eval must cast afresh."""
    trainer, stacked = _scan_case("transformer_lm")
    state = trainer.init_state(0)
    placed = trainer.shard_stacked_batch(stacked)
    for _ in range(2):  # eager, then captured: train and eval in turns
        state, _ = trainer.train_scan(state, placed)
        trainer.eval_scan(state, placed)
    state, _ = trainer.train_scan(state, placed)  # a replay
    got = trainer.eval_scan(state, placed)  # a replay
    per_step = [trainer.eval_step(state, b) for b in _scan_steps(placed)]
    for k in got:
        assert torch.equal(got[k], torch.stack([m[k] for m in per_step])), k
    toks = {"tokens": stacked["tokens"][0]}
    live = trainer.run_predict_step(state.model, toks)
    fresh = trainer.adopt_restored(trainer.host_state(state)).model
    assert torch.equal(live, trainer.run_predict_step(fresh, toks))


def test_cuda_an_unused_parameter_does_not_hold_the_capture_back(card):
    """A parameter that takes no gradient gets no optimizer slots: the
    second task still captures, and a restore (which gives it slots) costs
    one eager task before the next capture, never the per-step loop for
    good.  Each path trains as the eager loop does (cuDNN deterministic, as
    ``test_cuda_train_scan_replays_one_graph_equal_to_the_eager_loop``)."""
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        _unused_parameter_case()
    finally:
        torch.backends.cudnn.deterministic = deterministic


def _unused_parameter_case():
    trainer, stacked = _scan_case("mnist")
    init = trainer.spec.init

    def with_unused_head(seed, device):
        model = init(seed=seed, device=device)
        model.register_parameter("unused_head", torch.nn.Parameter(torch.zeros(4, 2, device=device)))
        return model

    trainer.spec = dataclasses.replace(trainer.spec, init=with_unused_head)
    state = trainer.init_state(0)
    placed = trainer.shard_stacked_batch(stacked)
    state, _ = trainer.train_scan(state, placed)  # eager
    state, _ = trainer.train_scan(state, placed)  # captured
    assert [g["kind"] for g in trainer.scan_graphs()] == ["train_scan"]
    saved = trainer.host_state(state)
    state = trainer.adopt_restored(saved, state)
    state, _ = trainer.train_scan(state, placed)  # eager: the restore added slots
    state, fused = trainer.train_scan(state, placed)  # captured again
    assert len(trainer.scan_graphs()) == 1 and state.step == 4 * _SCAN_T
    got = trainer.host_state(state)
    state = trainer.adopt_restored(saved, state)
    state, _ = trainer.run_train_steps(state, _scan_steps(stacked))
    state, per_step = trainer.run_train_steps(state, _scan_steps(stacked))
    _assert_states(got, trainer.host_state(state), 0)
    assert torch.equal(fused["loss"], torch.stack([m["loss"] for m in per_step]))


def test_cuda_zoo_template_trains_through_the_worker_on_the_fused_path(card, tmp_path,
                                                                     monkeypatch):
    """The ``zoo init`` template (a plain ``torch.optim.Adam``) through the
    worker's default path on the card: its first task eager, the next
    captured and then replayed, each task one ``train_scan``; the trainer
    made the optimizer capturable; the state equals the per-step path's."""
    import sys

    from elasticdl_tpu_torch.client import zoo
    from elasticdl_tpu_torch.common.config import JobConfig
    from elasticdl_tpu_torch.data.reader import Shard, create_data_reader
    from elasticdl_tpu_torch.data.synthetic import generate
    from elasticdl_tpu_torch.master.task_dispatcher import Task
    from elasticdl_tpu_torch.models.spec import load_model_spec
    from elasticdl_tpu_torch.worker.worker import Worker

    zoo.zoo_init(str(tmp_path / "cuda_zoo"))
    monkeypatch.syspath_prepend(str(tmp_path))
    try:
        spec = load_model_spec("cuda_zoo", "template.model_spec")
    finally:
        for name in [m for m in sys.modules if m.split(".")[0] == "cuda_zoo"]:
            del sys.modules[name]
    spec = dataclasses.replace(spec, feed=mnist.model_spec().feed)
    mb, tasks = 16, 3
    path = str(tmp_path / "mnist.rio")
    generate("mnist", path, tasks * 2 * mb, seed=3)

    def run(**cfg):
        config = JobConfig(model_def="template.model_spec", training_data=path,
                           minibatch_size=mb, task_pipelining=False, **cfg)
        worker = Worker(config, master=None, reader=create_data_reader(path), spec=spec)
        assert worker.trainer.device.type == "cuda"
        worker.state = worker.trainer.init_state(0)
        scans = []
        scan = worker.trainer.train_scan

        def counted(state, stacked):
            scans.append(int(next(iter(stacked.values())).shape[0]))
            return scan(state, stacked)

        worker.trainer.train_scan = counted
        for i in range(tasks):
            worker._run_training_task(
                Task(task_id=i, shard=Shard(name=path, start=2 * mb * i, end=2 * mb * (i + 1))))
        return worker, scans

    fused, scans = run()
    assert scans == [2] * tasks and fused.state.step == 2 * tasks
    assert all(g["capturable"] for g in fused.state.optimizer.param_groups)
    assert [g["kind"] for g in fused.trainer.scan_graphs()] == ["train_scan"]
    per_step, none = run(fused_task_scan=False)
    assert none == [] and per_step.state.step == 2 * tasks
    _assert_states(fused.trainer.host_state(fused.state),
                   per_step.trainer.host_state(per_step.state), 0)


def test_cuda_training_tasks_on_the_device_clock_and_captures_counted(card, tmp_path):
    """A small fused job through the worker's task path on the card: every
    training task records its device time (``device_task`` > 0) and each
    after the first the card's wait before it (``device_gap``); the
    variant's capture counts once, and once more after a restore replaces
    the state; a task that captures starts on the device's clock at its
    replay, so its device time leaves the capture out; the tasks' device
    times and gaps add up to the span from the first task's start event to
    the last task's fetch event (none fell out of the chain)."""
    from elasticdl_tpu_torch.common.config import JobConfig
    from elasticdl_tpu_torch.data.reader import Shard, create_data_reader
    from elasticdl_tpu_torch.data.synthetic import generate
    from elasticdl_tpu_torch.master.task_dispatcher import Task
    from elasticdl_tpu_torch.worker.worker import Worker

    seq, vocab, mb, tasks = 256, 512, 4, 6
    path = str(tmp_path / "train.rio")
    generate("lm", path, tasks * 2 * mb, seed=0, seq_len=seq, vocab=vocab)
    spec = tlm.model_spec(compute_dtype="bfloat16", vocab=vocab, dim=128, n_heads=2, n_layers=2,
                          max_seq=seq, seq_len=seq, remat=False)
    config = JobConfig(model_def="transformer_lm.model_spec", training_data=path,
                       minibatch_size=mb, num_minibatches_per_task=2)
    worker = Worker(config, master=None, reader=create_data_reader(path), spec=spec)
    worker.state = worker.trainer.init_state(0)
    entries, events = [], []
    add, dispatched = worker.phases.add, worker._device_clock.dispatched

    def recorded_add(name, seconds):
        entries.append((name, seconds))
        add(name, seconds)

    def recorded_dispatch(start, end):
        events.append((start, end))
        dispatched(start, end)

    worker.phases.add = recorded_add
    worker._device_clock.dispatched = recorded_dispatch

    def run(i):
        worker._run_training_task(
            Task(task_id=i, shard=Shard(name=path, start=2 * mb * i, end=2 * mb * (i + 1))))

    for i in range(2):
        run(i)  # the variant's eager task, then its capture and first replay
    saved = worker.trainer.host_state(worker.state)
    for i in range(2, 4):
        run(i)
    assert worker.phases.counts()["capture"] == 1
    # A restore replaces the state's tensors: the graph goes, the next task
    # captures anew.
    worker.state = worker.trainer.adopt_restored(saved, worker.state)
    for i in range(4, tasks):
        run(i)
    counts = worker.phases.counts()
    assert counts["capture"] == 2 and len(worker.trainer.scan_graphs()) == 1
    task_s = [s for name, s in entries if name == "device_task"]
    gap_s = [s for name, s in entries if name == "device_gap"]
    capture_s = [s for name, s in entries if name == "capture"]
    assert len(task_s) == tasks and all(s > 0 for s in task_s)
    assert task_s[1] < capture_s[0]
    assert len(gap_s) == tasks - 1 and all(s >= 0 for s in gap_s)
    assert counts["device_task"] == tasks and counts["device_gap"] == tasks - 1
    assert len(events) == tasks
    span_s = events[0][0].elapsed_time(events[-1][1]) / 1e3
    assert sum(task_s) + sum(gap_s) == pytest.approx(span_s, rel=0.05)


# ---- the fused dispatch in a one-rank NCCL world (a gang's captured scan) ---------


@contextlib.contextmanager
def _nccl_world_of_one(monkeypatch, model="transformer_lm"):
    """A one-rank NCCL process group on this card, with deterministic
    kernels where PyTorch has a choice (the comparisons are bit for bit):
    ``(trainer over the group, stacked host batch of T steps)``.  ``model``
    ``"deepfm"``: DeepFM's table row-sharded over the group
    (ParameterServer) with an explicit ``ragged`` lookup."""
    import datetime

    import torch.distributed as dist

    from _torch_gloo_ranks import free_port
    from elasticdl_tpu_torch.parallel.mesh import create_mesh

    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True, warn_only=True)
    t = datetime.timedelta(seconds=60)
    store = dist.TCPStore("127.0.0.1", free_port(), 1, True, timeout=t)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1, timeout=t,
                            device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        if model == "deepfm":
            from elasticdl_tpu_torch.common.config import JobConfig
            from elasticdl_tpu_torch.models import deepfm

            spec = deepfm.model_spec(buckets_per_feature=512, embedding_dim=8, hidden=(64, 64))
            trainer = Trainer(spec, device="cuda", mesh=create_mesh(), config=JobConfig(
                distribution_strategy="ParameterServer", embedding_lookup_impl="ragged"))
            batches = [dict(spec.feed(_criteo_records(256, seed=i))) for i in range(_SCAN_T)]
        else:
            trainer = Trainer(tlm.model_spec(**dict(_GANG_MODEL, remat=True)), device="cuda",
                              mesh=create_mesh())
            batches = [{k: v for k, v in b.items() if k != "__mask__"} for b in _gang_batches()]
        assert dist.get_backend(trainer._group) == "nccl" and trainer._scan_captures()
        yield trainer, {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    finally:
        dist.destroy_process_group()
        torch.use_deterministic_algorithms(False)


def _zero_mask(trainer):
    """The all-zero contributor mask, which ``set_active_contributors``
    refuses (an empty subgroup has no mean) and which is the only other
    mask of a world of one: the step then weighs every example by 0."""
    trainer._active_np = np.zeros(trainer.num_contributors(), np.float32)
    trainer._write_weight()


def _warm_and_capture(trainer, stacked):
    """(state, placed, the state after the variant's eager task): the next
    ``train_scan`` captures and replays."""
    state = trainer.init_state(0)
    placed = trainer.shard_stacked_batch(stacked)
    state, _ = trainer.train_scan(state, placed)  # eager: the communicator, the slots
    assert trainer.scan_graphs() == []
    return state, placed, trainer.host_state(state)


def test_cuda_nccl_world_of_one_replays_the_scan_equal_to_the_loop(card, monkeypatch):
    """Over a one-rank NCCL group ``train_scan`` captures the T steps with
    their all-reduces and replays them under ``set_sync_debug_mode("error")``;
    the per-step loop over the same group from the same state gives the
    same losses, parameters and optimizer slots bit for bit, and the same
    flash launches (remat: two forwards a layer)."""
    with _nccl_world_of_one(monkeypatch) as (trainer, stacked):
        state, placed, start = _warm_and_capture(trainer, stacked)
        kernels.reset_counts()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            state, fused = trainer.train_scan(state, placed)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        fused_counts = kernels.counts()
        (graph,) = trainer.scan_graphs()
        assert graph["collectives"].get("grads:all_reduce", 0) >= _SCAN_T
        got = trainer.host_state(state)
        state = trainer.adopt_restored(start, state)
        kernels.reset_counts()
        state, per_step = trainer.run_train_steps(state, _scan_steps(placed), pre_sharded=True)
        assert kernels.counts() == fused_counts
        assert fused_counts[tfa.KERNEL] == 2 * 2 * _SCAN_T
        assert torch.equal(fused["loss"], torch.stack([m["loss"] for m in per_step]))
        _assert_states(got, trainer.host_state(state), 0)


def test_cuda_nccl_world_of_one_replay_reads_the_mask_set_before_it(card, monkeypatch):
    """The contributor weights are device tensors the graph reads: a replay
    after the mask changed trains with the new mask (the eager loop's
    result under it), not the mask of the capture."""
    with _nccl_world_of_one(monkeypatch) as (trainer, stacked):
        state, placed, start = _warm_and_capture(trainer, stacked)
        state, ones = trainer.train_scan(state, placed)  # captured with the mask all ones
        ones_state = trainer.host_state(state)
        state = trainer.adopt_restored(start, state)
        state, _ = trainer.train_scan(state, placed)  # the graph anew, on the restored tensors
        start = trainer.host_state(state)
        _zero_mask(trainer)
        state, zero = trainer.train_scan(state, placed)  # a replay
        assert len(trainer.scan_graphs()) == 1
        got = trainer.host_state(state)
        state = trainer.adopt_restored(start, state)
        state, per_step = trainer.run_train_steps(state, _scan_steps(placed), pre_sharded=True)
        trainer.set_active_contributors(None)
        assert float(zero["loss"].abs().sum()) == 0.0 and float(ones["loss"].min()) > 0
        assert torch.equal(zero["loss"], torch.stack([m["loss"] for m in per_step]))
        _assert_states(got, trainer.host_state(state), 0)
        assert any(not np.array_equal(got[k], ones_state[k]) for k in got if "params/" in k)


def test_cuda_a_replay_adds_its_collective_calls_as_an_eager_task_does(card, monkeypatch):
    """``Reducer.calls`` and ``by_op`` after a replayed task grow by what the
    same task adds eagerly (the capture itself adds nothing)."""
    with _nccl_world_of_one(monkeypatch) as (trainer, stacked):
        state, placed, _ = _warm_and_capture(trainer, stacked)
        red = trainer.reducer
        before, keys = red.calls, dict(red.by_op)
        state, _ = trainer.train_scan(state, placed)  # capture, then one replay
        replayed = red.calls - before
        assert set(red.by_op) == set(keys)
        before = red.calls
        state, _ = trainer.train_scan(state, placed)  # one more replay
        assert red.calls - before == replayed
        before = red.calls
        state, _ = trainer.run_train_steps(state, _scan_steps(placed), pre_sharded=True)
        assert red.calls - before == replayed > 0
        (graph,) = trainer.scan_graphs()
        assert sum(graph["collectives"].values()) == replayed


def test_cuda_nccl_world_of_one_replays_the_ragged_lookup_equal_to_the_loop(card, monkeypatch):
    """DeepFM's table row-sharded over a one-rank NCCL group with an explicit
    ``ragged`` lookup: ``train_scan`` captures the route's equal-split
    all-to-alls over the group (three a step: ids, vectors, cotangents; no
    count all-gather) and replays them under ``set_sync_debug_mode("error")``;
    the per-step loop from the same state gives the same losses,
    parameters and optimizer slots bit for bit."""
    with _nccl_world_of_one(monkeypatch, "deepfm") as (trainer, stacked):
        assert trainer.sharded_embeddings and trainer.ctx.embedding_impl == "ragged"
        assert trainer.ctx.group is not None and trainer.scan_unsupported() is None
        state, placed, start = _warm_and_capture(trainer, stacked)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            state, fused = trainer.train_scan(state, placed)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        (graph,) = trainer.scan_graphs()
        assert graph["collectives"].get("lookup:all_to_all") == 3 * _SCAN_T, graph["collectives"]
        assert "lookup:all_gather" not in graph["collectives"]
        got = trainer.host_state(state)
        state = trainer.adopt_restored(start, state)
        state, per_step = trainer.run_train_steps(state, _scan_steps(placed), pre_sharded=True)
        assert torch.equal(fused["loss"], torch.stack([m["loss"] for m in per_step]))
        _assert_states(got, trainer.host_state(state), 0)


def test_cuda_ragged_lookup_reads_nothing_back_to_the_host(card, monkeypatch):
    """The ragged route's forward and backward over a one-rank NCCL group,
    deterministic algorithms on, raise nothing under
    ``set_sync_debug_mode("error")``: the plan, the gathers, the exchanges
    and the scatter-add stay on the device.  Rows equal the local gather
    (NaN for ids past the table, either sign), the table gradient its
    scatter-add."""
    from elasticdl_tpu_torch.ops.embedding import (
        embedding_lookup,
        gather_rows,
        logical_rows,
        pack_table,
    )

    with _nccl_world_of_one(monkeypatch, "deepfm") as (trainer, _):
        gen = torch.Generator(device="cuda").manual_seed(0)
        table = pack_table(torch.randn(4096, 9, device="cuda", generator=gen), 9)
        rows = logical_rows(table, 9)
        ids = torch.randint(-8, rows + 8, (64, 26), device="cuda", generator=gen)
        cot = torch.randn(64, 26, 9, device="cuda", generator=gen)
        got_t, want_t = table.clone().requires_grad_(True), table.clone().requires_grad_(True)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = embedding_lookup(got_t, ids, trainer.ctx, dim=9)
            torch.where(torch.isnan(out), 0.0, out * cot).sum().backward()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        want = gather_rows(want_t, ids, 9)
        torch.where(torch.isnan(want), 0.0, want * cot).sum().backward()
        assert "lookup:all_to_all" in trainer.reducer.by_op  # the real exchange ran
        assert torch.equal(torch.isnan(out), torch.isnan(want))
        ok = ~torch.isnan(want)
        assert torch.equal(out[ok], want[ok])
        torch.testing.assert_close(got_t.grad, want_t.grad, rtol=1e-5, atol=1e-6)
