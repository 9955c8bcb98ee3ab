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

import numpy as np
import pytest
import torch

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
