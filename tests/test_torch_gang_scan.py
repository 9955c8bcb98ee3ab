"""The fused task dispatch in a gang (``Trainer.train_scan`` over a process
group) against the JAX package's ``train_scan`` on a 2-device mesh, and
against the port's own per-step gang loop.

Two gloo ranks on the CPU (``tests/_torch_gloo_ranks.py``), where the scan
runs its steps eagerly, one call a task (over gloo it does so on the card
too; over NCCL it captures: ``tests/test_torch_cuda.py``).  Sizes:
``transformer_lm`` 2 layers of dim 64 (4 heads, 128 tokens, global batch
8), DeepFM at 512 buckets a feature (dim 4, MLP 16, global batch 64);
T = 3 steps a scan.  Each run: a scan, a masked tail step (the worker's
ragged tail), the contributor mask set to ``[1, 0]``, a second scan.

Tolerances: against JAX those of ``tests/test_torch_gang.py`` (rtol 2e-4 /
atol 2e-5; an element whose first reference gradient is noise, below 10
Adam epsilons, may take a step of the other sign: within one learning rate
a step).  Against the per-step loop: bit for bit (metrics, parameters,
optimizer slots).
"""

import jax
import numpy as np
import pytest
import torch

import elasticdl_tpu.parallel  # noqa: F401  (the JAX package's own import order)
from elasticdl_tpu.common.config import JobConfig as JaxJobConfig
from elasticdl_tpu.models import deepfm as jdeepfm
from elasticdl_tpu.models.spec import load_model_spec as jax_load_model_spec
from elasticdl_tpu.parallel.mesh import create_mesh as jax_create_mesh
from elasticdl_tpu.parallel.trainer import Trainer as JaxTrainer
from elasticdl_tpu_torch.data import codecs
from elasticdl_tpu_torch.models import deepfm, transformer_lm as tlm
from elasticdl_tpu_torch.ops.embedding import IMPL_DENSE, IMPL_RAGGED
from elasticdl_tpu_torch.parallel.mesh import Mesh
from elasticdl_tpu_torch.parallel.trainer import MASK_KEY, Trainer

from _torch_gloo_ranks import (
    gang_scan_against_loop,
    gang_scans,
    gang_steps_device_and_host_weights,
    run_ranks,
)

T = 3
LM = dict(vocab=512, dim=64, n_heads=4, n_layers=2, max_seq=128, seq_len=128,
          compute_dtype="float32")
DFM = dict(buckets_per_feature=512, embedding_dim=4, hidden=(16,), compute_dtype="float32",
           host_tier=False)
ADAM_EPS, LR = 1e-8, 3e-4  # the AdamW of both models' specs (optax's defaults)


def _lm_batch(rng, b=8):
    toks = rng.integers(0, LM["vocab"], size=(b, LM["seq_len"] + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _dfm_batch(rng, b=64):
    records = [
        codecs.encode_criteo_example(
            int(rng.integers(0, 2)),
            [None if rng.random() < 0.1 else int(rng.integers(0, 1000)) for _ in range(13)],
            [int(rng.integers(0, 1 << 32)) for _ in range(26)],
        )
        for _ in range(b)
    ]
    return dict(deepfm.model_spec(**DFM).feed(records))


def _stack(batches):
    return {k: np.stack([b[k] for b in batches]) for k in batches[0]}


def _plan(kind, seed=0):
    """A scan of T steps, a masked tail step (5 of 8 or 41 of 64 real: rank
    1 holds the padding), the mask ``[1, 0]``, a second scan."""
    rng = np.random.default_rng(seed)
    make = _lm_batch if kind == "transformer_lm" else _dfm_batch
    first = [make(rng) for _ in range(T)]
    tail = make(rng)
    n = len(tail["labels"])
    tail[MASK_KEY] = (np.arange(n) < (5 * n) // 8).astype(np.float32)
    second = [make(rng) for _ in range(T)]
    return [("scan", _stack(first)), ("step", tail), ("mask", [1.0, 0.0]),
            ("scan", _stack(second))]


def _jax_run(jspec, plan):
    """The plan on the JAX ``Trainer`` over a ``(dp=2, ep=1)`` CPU mesh:
    (the initial weights, each scan's or step's metrics, the final
    parameters)."""
    config = JaxJobConfig(distribution_strategy="AllReduce", dcn_data_parallelism=2)
    jtr = JaxTrainer(jspec, config, jax_create_mesh(jax.devices(), num_devices=2,
                                                    dcn_parallelism=2))
    assert dict(jtr.mesh.shape) == {"dp": 2, "ep": 1}
    jstate = jtr.init_state(jax.random.key(0))
    params = jax.device_get(jstate.params)
    out = []
    for kind, value in plan:
        if kind == "mask":
            jtr.set_active_contributors(value)
            continue
        if kind == "step":
            jstate, m = jtr.run_train_step(jstate, dict(value))
            m = {k: np.asarray(v)[None] for k, v in jax.device_get(m).items()}
        else:
            jstate, m = jtr.train_scan(jstate, jtr.shard_stacked_batch(value))
            m = {k: np.asarray(v) for k, v in jax.device_get(m).items()}
        out.append(m)
    return params, out, jax.device_get(jstate.params)


@pytest.mark.parametrize("kind", ["transformer_lm", "deepfm"])
def test_two_rank_train_scan_matches_the_jax_train_scan(kind):
    if kind == "transformer_lm":
        jspec = jax_load_model_spec("elasticdl_tpu.models", "transformer_lm.model_spec", **LM)
        model_kw = LM
    else:
        jspec, model_kw = jdeepfm.model_spec(**DFM), DFM
    plan = _plan(kind)
    params, ref, ref_params = _jax_run(jspec, plan)
    ranks = run_ranks(gang_scans, 2, kind, model_kw, params, plan)
    n_steps = sum(len(m["loss"]) for m in ref)
    assert n_steps == 2 * T + 1
    # Elements whose first reference update follows a noise gradient.
    noise = [np.zeros(np.shape(w), bool) for w in jax.tree.leaves(params)]
    if kind == "transformer_lm":
        b0 = {k: v[0] for k, v in plan[0][1].items()}
        grads = jax.grad(lambda p: jspec.loss(jspec.apply(p, {"tokens": b0["tokens"]},
                                                          train=True), b0))(params)
        noise = [np.abs(np.asarray(g)) < 10 * ADAM_EPS for g in jax.tree.leaves(grads)]
        assert sum(int(n.sum()) for n in noise) <= sum(n.size for n in noise) // 10_000
    for rank, out in enumerate(ranks):
        assert out["captures"] is False and out["unsupported"] is None
        assert len(out["metrics"]) == len(ref)
        for i, (got, want) in enumerate(zip(out["metrics"], ref)):
            assert sorted(got) == sorted(want), (rank, i)
            for k in want:
                assert got[k].shape == want[k].shape, (rank, i, k)
                np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=2e-5,
                                           err_msg=f"rank {rank} entry {i} {k}")
        got_leaves = jax.tree.leaves(out["params"])
        want_leaves = jax.tree.leaves(ref_params)
        assert len(got_leaves) == len(want_leaves)
        for g, w, n in zip(got_leaves, want_leaves, noise):
            g, w = np.asarray(g), np.asarray(w)
            np.testing.assert_allclose(g[~n], w[~n], rtol=2e-4, atol=2e-5)
            assert np.all(np.abs(g[n] - w[n]) <= n_steps * LR)
    # The ranks hold one state, bit for bit.
    for g, w in zip(jax.tree.leaves(ranks[0]["params"]), jax.tree.leaves(ranks[1]["params"])):
        assert np.array_equal(np.asarray(g), np.asarray(w))


def _assert_runs_equal(a, b):
    assert len(a["metrics"]) == len(b["metrics"])
    for i, (x, y) in enumerate(zip(a["metrics"], b["metrics"])):
        assert sorted(x) == sorted(y), i
        for k in x:
            np.testing.assert_array_equal(x[k], y[k], err_msg=f"entry {i} {k}")
    assert sorted(a["state"]) == sorted(b["state"])
    for k in a["state"]:
        np.testing.assert_array_equal(a["state"][k], b["state"][k], err_msg=k)


# (kind, create_mesh's dcn, JobConfig, what the trainer must have resolved)
_LOOP_CASES = {
    "eager": ("transformer_lm", 2, {}, {"sharded_opt": False}),
    "sharded_optimizer": ("transformer_lm", 2, {"optimizer_sharding": "sharded"},
                          {"sharded_opt": True}),
    "dense_table": ("deepfm", 1, {"distribution_strategy": "ParameterServer",
                                  "embedding_lookup_impl": IMPL_DENSE},
                    {"impl": IMPL_DENSE, "axis_size": 2}),
    "ragged_table": ("deepfm", 1, {"distribution_strategy": "ParameterServer",
                                   "embedding_lookup_impl": IMPL_RAGGED},
                     {"impl": IMPL_RAGGED, "axis_size": 2}),
}


@pytest.mark.parametrize("case", sorted(_LOOP_CASES))
def test_gang_scan_equals_the_per_step_gang_loop_bit_for_bit(case):
    """Over gloo the scan runs the gang's steps eagerly: the same metrics
    and the same state as the per-step loop, bit for bit, for the plain
    data-parallel step, the sharded optimizer, and a table row-sharded over
    both ranks on the dense and on the ragged route."""
    kind, dcn, config, facts = _LOOP_CASES[case]
    model_kw = LM if kind == "transformer_lm" else DFM
    ranks = run_ranks(gang_scan_against_loop, 2, kind, model_kw, dcn, config, _plan(kind, 1))
    for out in ranks:
        assert out["facts"]["unsupported"] is None
        for k, v in facts.items():
            assert out["facts"][k] == v, (k, out["facts"])
        assert out["fused"]["step"] == out["per_step"]["step"] == 2 * T + 1
        _assert_runs_equal(out["fused"], out["per_step"])


@pytest.mark.parametrize("kind", ["transformer_lm", "deepfm"])
def test_per_step_gang_step_is_unchanged_by_device_weights(kind):
    """The contributor weights as 0-d device tensors give the per-step gang
    step the results it had with host floats, bit for bit, through a masked
    step and a mask change."""
    model_kw = LM if kind == "transformer_lm" else DFM
    ranks = run_ranks(gang_steps_device_and_host_weights, 2, kind, model_kw, _plan(kind, 2))
    for out in ranks:
        _assert_runs_equal(out["device"], out["host"])


def test_set_active_contributors_writes_the_device_weights_in_place():
    """The weights a captured step reads are one pair of tensors for the
    trainer's life; a mask change rewrites them, the refusals leave them."""
    tr = Trainer(tlm.model_spec(**LM), device="cpu", mesh=Mesh({"dp": 2, "ep": 1}, rank=1))
    w, n = tr._weight()
    assert (float(w), float(n)) == (1.0, 2.0) and w.dtype == n.dtype == torch.float32
    tr.set_active_contributors([1, 0])
    assert tr._weight()[0] is w and tr._weight()[1] is n
    assert (float(w), float(n)) == (0.0, 1.0)
    with pytest.raises(ValueError, match="every contributor"):
        tr.set_active_contributors([0, 0])
    assert (float(w), float(n)) == (0.0, 1.0)
    tr.set_active_contributors(None)
    assert (float(w), float(n)) == (1.0, 2.0)


@pytest.mark.parametrize("backend,device,ragged,host_tier", [
    ("gloo", "cpu", True, False),
    ("gloo", "cuda", True, False),
    ("nccl", "cuda", True, False),
    ("nccl", "cuda", False, False),
    ("nccl", "cuda", True, True),
])
def test_scan_unsupported_refuses_only_host_tier_tables(
        monkeypatch, backend, device, ragged, host_tier):
    """A row-sharded table scans on either lookup route, eagerly over gloo
    and captured over NCCL on the card: the ragged route has static shapes
    and no host copy inside the step.  Host-tier tables stay refused, as in
    the reference.  (The card is only named here: nothing runs on it.)"""
    import torch.distributed as dist

    from elasticdl_tpu_torch.common.config import JobConfig

    group = object()
    monkeypatch.setattr(dist, "get_backend", lambda g=None: backend)
    # A gang's host tier lives behind the PS service; no call reaches it here.
    config = JobConfig(distribution_strategy="ParameterServer",
                       embedding_lookup_impl=IMPL_RAGGED if ragged else IMPL_DENSE,
                       ps_addresses="127.0.0.1:1" if host_tier else "")
    tr = Trainer(deepfm.model_spec(**dict(DFM, host_tier=host_tier)), device="cpu",
                 config=config, mesh=Mesh({"dp": 2}, rank=0, groups={("dp",): group}))
    assert tr._group is group and tr.ctx.axis_size == 2
    tr.device = torch.device(device)
    why = tr.scan_unsupported()
    assert tr._scan_captures() is (backend == "nccl")
    if host_tier:
        assert "host-tier" in why
    else:
        assert tr.sharded_embeddings and why is None


@pytest.mark.parametrize("backend", ["gloo", "nccl"])
def test_the_scan_captures_only_where_every_group_of_the_mesh_is_nccl(monkeypatch, backend):
    """On ``(dp 1, tp 2)`` the gradients reduce over no group (``dp`` has one
    rank), yet the tp sums run inside the step over the ``tp`` line: over
    gloo the scan must run eagerly on the card too, and capture only over
    NCCL.  (The card is only named here: nothing runs on it.)"""
    import torch.distributed as dist

    group = object()
    monkeypatch.setattr(dist, "get_backend", lambda g=None: backend)
    tr = Trainer(tlm.model_spec(parallelism="tensor", **LM), device="cpu",
                 mesh=Mesh({"dp": 1, "tp": 2}, rank=0,
                           groups={("dp", "tp"): group, ("tp",): group}))
    assert tr._group is None and tr.tp_size == 2 and tr.ctx.tp_group is group
    assert tr._scan_captures() is False  # the CPU
    tr.device = torch.device("cuda")
    assert tr._scan_captures() is (backend == "nccl")
    assert tr.scan_unsupported() is None
