"""The ring and tensor-parallel paths of the port's ``transformer_lm``
against the JAX package.

1. The ring (``ops/ring_attention.py``) over 2 and 4 gloo ranks
   (tests/_torch_gloo_ranks.py), each holding its sequence shard, against
   the JAX ``ring_attention`` under ``shard_map`` on as many fake CPU
   devices: the output causal and not, and the gradients, at
   tests/test_ring_attention.py's rtol 2e-4, atol 2e-5; the first token
   attends only to itself; n - 1 rotations a call.
2. ``tp_all_reduce`` and ``tp_grad_sync`` over 2 ranks against the JAX
   pair: forward and backward, exact (a sum of two f32 values).
3. ``model_spec(parallelism="tensor")`` dense on one process against the
   JAX dense path: logits at rtol 2e-4, atol 2e-5; ``params_from_jax``
   with ``tp`` holds rank ``i``'s columns and rows.
4. The JAX ``Trainer`` against the port's on the same meshes from the
   same weights, 4 steps of 8 examples at f32 (one with a masked tail):
   ``(dp 2, tp 2)`` (tensor parallelism), ``{dp: 2}`` and ``(dp 2, ep 2)``
   (the ring).  Losses, metrics, an eval step and the parameters at rtol
   2e-4, atol 2e-5 (tests/test_torch_gang.py's, with its rule for the
   elements whose first reference gradient is below ten times AdamW's
   eps: those are held within the 4 steps' AdamW movement, 4 lr); every
   rank gathers one state bit for bit; a tp rank holds half the matmul
   weights.
5. A ``(dp 2, tp 2)`` save with the sharded optimizer restores bit for bit
   into ``(1, 2)``, ``(2, 1)`` and a world of one and trains there
   (tests/test_mesh2d.py's ``test_checkpoint_restores_across_2d_shapes``).
6. Without a process group: a tp trainer's axis roles and slices of a
   batch, and a sequence-parallel trainer's.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

import elasticdl_tpu.parallel  # noqa: F401  (the JAX package's own import order)
from elasticdl_tpu.common.config import JobConfig as JaxJobConfig
from elasticdl_tpu.common.jax_compat import shard_map
from elasticdl_tpu.models.spec import load_model_spec as jax_load_model_spec
from elasticdl_tpu.ops.ring_attention import ring_attention as jax_ring_attention
from elasticdl_tpu.parallel import collectives as jax_coll
from elasticdl_tpu.parallel.mesh import create_mesh as jax_create_mesh
from elasticdl_tpu.parallel.trainer import Trainer as JaxTrainer
from elasticdl_tpu_torch.common.checkpoint import CheckpointManager
from elasticdl_tpu_torch.common.config import JobConfig
from elasticdl_tpu_torch.models import transformer_lm as tlm
from elasticdl_tpu_torch.ops.embedding import ParallelContext
from elasticdl_tpu_torch.ops.ring_attention import ring_attention
from elasticdl_tpu_torch.parallel import collectives as coll
from elasticdl_tpu_torch.parallel.mesh import Mesh
from elasticdl_tpu_torch.parallel.trainer import MASK_KEY, Trainer, _OPT_KEEP

from _torch_gloo_ranks import lm_mesh_runs, ring_tp_cases, run_ranks

RTOL, ATOL = 2e-4, 2e-5
ADAM_EPS, LR = 1e-8, 3e-4
B, L, H, D = 2, 64, 4, 16

# ---- 1. and 2. the ring and the tp pair ----------------------------------------------


def _ring_inputs():
    rng = np.random.default_rng(12)
    q, k, v, cot = (rng.standard_normal((B, L, H, D)).astype(np.float32) for _ in range(4))
    tp_x = rng.standard_normal((4, 3, 5)).astype(np.float32)
    tp_cot = rng.standard_normal((4, 3, 5)).astype(np.float32)
    return q, k, v, cot, tp_x, tp_cot


@pytest.fixture(scope="module")
def ring_worlds():
    inputs = _ring_inputs()
    return inputs, {n: run_ranks(ring_tp_cases, n, *inputs) for n in (2, 4)}


def _jax_ring(n, fn, *arrays, out_specs=None):
    mesh = jax_create_mesh(jax.devices(), num_devices=n, axis_name="sp")
    spec = P(None, "sp")
    mapped = shard_map(fn, mesh=mesh, in_specs=(spec,) * len(arrays),
                       out_specs=out_specs or spec, check_vma=False)
    placed = [jax.device_put(jnp.asarray(a), NamedSharding(mesh, spec)) for a in arrays]
    return jax.device_get(jax.jit(mapped)(*placed))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("n", [2, 4])
def test_ring_forward_matches_the_jax_ring(ring_worlds, n, causal):
    (q, k, v, *_), ranks = ring_worlds
    got = np.concatenate([r[f"out_causal={causal}"] for r in ranks[n]], axis=1)
    want = _jax_ring(n, lambda q, k, v: jax_ring_attention(q, k, v, axis_name="sp",
                                                           causal=causal), q, k, v)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n", [2, 4])
def test_ring_gradients_match_the_jax_ring(ring_worlds, n):
    (q, k, v, cot, *_), ranks = ring_worlds

    def local_grads(q, k, v, c):
        return jax.grad(lambda q, k, v: jnp.sum(
            jax_ring_attention(q, k, v, axis_name="sp", causal=True) * c), argnums=(0, 1, 2))(q, k, v)

    want = _jax_ring(n, local_grads, q, k, v, cot, out_specs=(P(None, "sp"),) * 3)
    for j, name in enumerate("qkv"):
        got = np.concatenate([r["grads"][j] for r in ranks[n]], axis=1)
        np.testing.assert_allclose(got, np.asarray(want[j]), rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("n", [2, 4])
def test_ring_first_token_attends_only_to_itself_and_rotates_n_minus_1_times(ring_worlds, n):
    (q, k, v, *_), ranks = ring_worlds
    first = ranks[n][0]["out_causal=True"][:, 0]
    np.testing.assert_allclose(first, v[:, 0], rtol=RTOL, atol=ATOL)
    # Three forwards and one backward a rank: 4 (n - 1) rotations, each
    # one exchange of K and V (none skipped for a fully masked block); and
    # the tp pair's two sums.
    assert all(r["calls"] == 4 * (n - 1) + 2 for r in ranks[n])
    assert all(set(r["by_op"]) == {"ring:p2p", "tp:all_reduce"} for r in ranks[n])


@pytest.mark.parametrize("name", ["all_reduce", "grad_sync"])
def test_tp_pair_matches_the_jax_pair(ring_worlds, name):
    (*_, tp_x, tp_cot), ranks = ring_worlds
    jfn = jax_coll.tp_all_reduce if name == "all_reduce" else jax_coll.tp_grad_sync
    mesh = jax_create_mesh(jax.devices(), num_devices=2, tensor_parallelism=2)

    def local(x, c):
        y, vjp = jax.vjp(lambda x: jfn(x, "tp"), x)
        return y, vjp(c)[0]

    spec = P("tp")
    mapped = shard_map(local, mesh=mesh, in_specs=(spec, spec), out_specs=(spec, spec),
                       check_vma=False)
    y, gx = jax.device_get(jax.jit(mapped)(jnp.asarray(tp_x[:2]), jnp.asarray(tp_cot[:2])))
    for rank, r in enumerate(ranks[2]):
        got_y, got_g = r[name]
        np.testing.assert_array_equal(got_y, np.asarray(y)[rank])
        np.testing.assert_array_equal(got_g, np.asarray(gx)[rank])


def test_tp_pair_is_the_identity_on_a_line_of_one_and_the_ring_needs_its_axis():
    x = torch.arange(6.0, requires_grad=True)
    red = coll.Reducer(Mesh({"dp": 1}))
    for fn in (coll.tp_all_reduce, coll.tp_grad_sync):
        assert fn(x, red, None) is x
    q = torch.zeros(1, 8, 2, 4)
    with pytest.raises(ValueError, match="needs the ParallelContext"):
        ring_attention(q, q, q, axis_name="dp", causal=True)
    # An axis of one rank is the local attention.
    one = ParallelContext(axis_name="dp", axis_size=1)
    torch.testing.assert_close(ring_attention(q, q, q, axis_name="dp", causal=True, ctx=one),
                               ring_attention(q, q, q, causal=True))


# ---- 3. the tensor path dense, and its shards -------------------------------------------

LM = dict(vocab=128, dim=32, n_heads=4, n_layers=2, max_seq=32, seq_len=32,
          compute_dtype="float32")


def _jax_spec(parallelism):
    return jax_load_model_spec("elasticdl_tpu.models", "transformer_lm.model_spec",
                               parallelism=parallelism, **LM)


def _batches(n=4, size=8):
    rng = np.random.default_rng(5)
    out = []
    for i in range(n):
        toks = rng.integers(0, LM["vocab"], size=(size, LM["seq_len"] + 1)).astype(np.int32)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if i == 1:  # a wrap-padded tail: 5 real rows
            batch[MASK_KEY] = (np.arange(size) < 5).astype(np.float32)
        out.append(batch)
    return out


def test_tensor_spec_dense_matches_the_jax_dense_path():
    jspec = _jax_spec("tensor")
    params = jax.device_get(jspec.init(jax.random.key(3)))
    tokens = _batches(1)[0]["tokens"]
    want = np.asarray(jspec.apply(params, {"tokens": jnp.asarray(tokens)}))
    spec = tlm.model_spec(parallelism="tensor", **LM)
    assert spec.batch_shard_dim == 0 and spec.tensor_sharding is not None
    model = tlm.params_from_jax(params, LM["n_heads"], "float32", device="cpu")
    with torch.no_grad():
        got = spec.apply(model, {"tokens": torch.from_numpy(tokens)}).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # The sequence path reads the same weights as [q | k | v]: another function.
    with torch.no_grad():
        seq = tlm.model_spec(**LM).apply(model, {"tokens": torch.from_numpy(tokens)}).numpy()
    assert np.abs(seq - want).max() > 1e-2


def test_params_from_jax_holds_a_tp_ranks_columns_and_rows():
    params = jax.device_get(_jax_spec("tensor").init(jax.random.key(3)))
    shards = [tlm.params_from_jax(params, LM["n_heads"], "float32", device="cpu", tp_rank=i,
                                  tp=2) for i in range(2)]
    dims = {"wqkv": 1, "wo": 0, "w1": 1, "w2": 0}
    for name in params["blocks"]:
        for key, d in dims.items():
            parts = [getattr(m.blocks[name], key).detach().numpy() for m in shards]
            assert parts[0].shape[d] * 2 == np.shape(params["blocks"][name][key])[d]
            np.testing.assert_array_equal(np.concatenate(parts, axis=d),
                                          params["blocks"][name][key])
    np.testing.assert_array_equal(shards[1].tok_emb.detach().numpy(), params["tok_emb"])


# ---- 4. and 5. the trainers on meshes, and the checkpoint across shapes ---------------------

CASES = {
    # name: (parallelism, JAX create_mesh kwargs, port create_mesh kwargs, world)
    "tp_dp2_tp2": ("tensor", dict(num_devices=4, tensor_parallelism=2),
                   dict(tensor_parallelism=2), 4),
    "ring_dp2": ("sequence", dict(num_devices=2), {}, 2),
    "ring_dp2_ep2": ("sequence", dict(num_devices=4, dcn_parallelism=2),
                     dict(dcn_parallelism=2), 4),
}


def _jax_run(name, batches):
    parallelism, mesh_kw, _, _ = CASES[name]
    jspec = _jax_spec(parallelism)
    trainer = JaxTrainer(jspec, JaxJobConfig(distribution_strategy="AllReduce"),
                         jax_create_mesh(jax.devices(), **mesh_kw))
    state = trainer.init_state(jax.random.key(0))
    params = jax.device_get(state.params)
    b0 = batches[0]
    grads = jax.grad(lambda p: jspec.loss(jspec.apply(p, {"tokens": b0["tokens"]},
                                                       train=True), b0))(params)
    metrics = []
    for batch in batches:
        state, m = trainer.run_train_step(state, dict(batch))
        metrics.append({k: np.asarray(v) for k, v in jax.device_get(m).items()})
    ev = jax.device_get(trainer.run_eval_step(state, dict(batches[0])))
    return {"params": params, "metrics": metrics, "eval": {k: np.asarray(v) for k, v in ev.items()},
            "final": jax.device_get(state.params), "grads": grads}


def _flat(tree, prefix="params/"):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + k + "/")
        else:
            yield prefix + k, np.asarray(v)


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """The JAX runs, then the port's: a world of 4 (``(dp 2, tp 2)``, the
    same with the sharded optimizer saving its final state, and ``(dp 2,
    ep 2)``), then a world of 2 (``{dp: 2}``, and the save restored into
    ``(1, 2)`` and ``(2, 1)``)."""
    batches = _batches()
    jax_runs = {name: _jax_run(name, batches) for name in CASES}
    ckpt = str(tmp_path_factory.mktemp("tp_ckpt"))
    tp_model = dict(LM, parallelism="tensor")

    def run(name, **extra):
        parallelism, _, mesh_kw, _ = CASES[name]
        return dict(model=dict(LM, parallelism=parallelism), mesh=mesh_kw,
                    params=jax_runs[name]["params"], batches=batches, **extra)

    four = run_ranks(lm_mesh_runs, 4, [
        run("tp_dp2_tp2"), run("ring_dp2_ep2"),
        dict(run("tp_dp2_tp2"), batches=batches[:2], config=dict(optimizer_sharding="sharded"),
             save=ckpt),
    ])
    canonical = CheckpointManager(ckpt).restore()
    two = run_ranks(lm_mesh_runs, 2, [
        run("ring_dp2"),
        dict(model=tp_model, mesh=dict(tensor_parallelism=2), canonical=canonical,
             batches=batches[2:3], config=dict(optimizer_sharding="sharded")),
        dict(model=tp_model, mesh={}, canonical=canonical, batches=batches[2:3],
             config=dict(optimizer_sharding="sharded")),
    ])
    port = {"tp_dp2_tp2": [r[0] for r in four], "ring_dp2_ep2": [r[1] for r in four],
            "ring_dp2": [r[0] for r in two]}
    restores = {"(2, 2) save": [r[2] for r in four], "(1, 2)": [r[1] for r in two],
                "(2, 1)": [r[2] for r in two]}
    return jax_runs, port, restores, canonical


@pytest.mark.parametrize("name", list(CASES))
def test_the_port_on_a_mesh_matches_the_jax_trainer(mesh_runs, name):
    jax_runs, port, _, _ = mesh_runs
    ref, ranks = jax_runs[name], port[name]
    assert ranks[0]["shape"] == dict(jax_create_mesh(jax.devices(), **CASES[name][1]).shape)
    for rank, out in enumerate(ranks):
        for step, (got, want) in enumerate(zip(out["metrics"], ref["metrics"])):
            assert sorted(got) == sorted(want), (rank, step)
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                           err_msg=f"rank {rank} step {step} {k}")
        for k in ref["eval"]:
            np.testing.assert_allclose(out["eval"][k], ref["eval"][k], rtol=RTOL, atol=ATOL,
                                       err_msg=f"eval {k}")
    # Elements whose first reference gradient is float noise around zero
    # follow its last bits through AdamW's normalisation.
    grads = dict(_flat(ref["grads"]))
    noise = {k: np.abs(g) < 10 * ADAM_EPS for k, g in grads.items()}
    assert sum(int(n.sum()) for n in noise.values()) <= sum(n.size for n in noise.values()) // 10_000
    for key, want in _flat(ref["final"]):
        got, n = ranks[0]["host"][key], noise[key]
        np.testing.assert_allclose(got[~n], want[~n], rtol=RTOL, atol=ATOL, err_msg=key)
        assert np.all(np.abs(got[n] - want[n]) <= 4 * LR), key
    # The ranks gather one state, bit for bit.
    for out in ranks[1:]:
        for key, value in ranks[0]["host"].items():
            assert np.array_equal(out["host"][key], value), key


def test_a_tp_rank_holds_half_the_matmul_weights(mesh_runs):
    _, port, _, _ = mesh_runs
    tp = port["tp_dp2_tp2"]
    full = port["ring_dp2_ep2"][0]["matmul_bytes"]
    assert all(r["matmul_bytes"] * 2 == full for r in tp)
    assert all("tp:all_reduce" in r["by_op"] and "ring:p2p" not in r["by_op"] for r in tp)
    assert all("ring:p2p" in r["by_op"] for r in port["ring_dp2_ep2"] + port["ring_dp2"])


@pytest.mark.parametrize("target", ["(1, 2)", "(2, 1)", "world of one"])
def test_a_tp_checkpoint_restores_across_shapes(mesh_runs, target):
    _, _, restores, canonical = mesh_runs
    saved = restores["(2, 2) save"][0]
    assert saved["step"] == 2 and int(canonical["step"]) == 2
    for key, value in saved["host"].items():
        assert np.array_equal(np.asarray(canonical[key]), value), key
    if target == "world of one":
        trainer = Trainer(tlm.model_spec(parallelism="tensor", **LM), device="cpu",
                          config=JobConfig(optimizer_sharding="sharded"))
        state = trainer.adopt_restored(copy.deepcopy(canonical))
        restored = trainer.host_state(state)
        state, m = trainer.run_train_step(state, _batches()[2])
        outs = [{"restored": restored, "step": state.step,
                 "metrics": [{"loss": np.asarray(m["loss"].detach())}]}]
    else:
        outs = restores[target]
        assert outs[0]["shape"] == ({"dp": 1, "tp": 2} if target == "(1, 2)" else {"dp": 2})
    for out in outs:
        for key, value in canonical.items():
            np.testing.assert_array_equal(out["restored"][key], np.asarray(value), err_msg=key)
        assert out["step"] == 3 and np.isfinite(out["metrics"][0]["loss"])
    if target != "world of one":
        assert outs[0]["metrics"][0]["loss"] == outs[1]["metrics"][0]["loss"]


# ---- 6. axis roles without a process group ---------------------------------------------


def test_tensor_parallel_axis_roles_and_batch_slices():
    spec = tlm.model_spec(parallelism="tensor", **LM)
    batch = _batches(1)[0]
    for rank in range(4):
        tr = Trainer(spec, device="cpu", mesh=Mesh({"dp": 2, "tp": 2}, rank=rank),
                     config=JobConfig(optimizer_sharding="sharded"))
        assert (tr.tp_axis, tr.tp_size, tr.reduce_axes) == ("tp", 2, ("dp",))
        assert tr.contributor_axes == ("dp",) and tr.num_contributors() == 2
        assert tr._weight() == (1.0, 2.0)
        placed = tr.shard_batch(batch)
        dp = rank // 2  # a dp row's tp ranks take the same examples
        np.testing.assert_array_equal(placed["tokens"].numpy(), batch["tokens"][dp * 4:(dp + 1) * 4])
        state = tr.init_state(0)
        wqkv = state.model.blocks["b0"].wqkv
        assert tuple(wqkv.shape) == (LM["dim"], 3 * LM["dim"] // 2)
        assert tr.sharded_state()
        assert tr.restore_template(state)["params/blocks/b0/wqkv"] == (LM["dim"], 3 * LM["dim"])
        plan = tr._opt_plan
        assert plan["blocks/b0/wqkv"] is _OPT_KEEP and plan["tok_emb"] is not _OPT_KEEP
    # A sequence-parallel model on {dp: 2}: one contributor, whole examples,
    # its half of each sequence; the [B] mask whole.
    tr = Trainer(tlm.model_spec(**LM), device="cpu", mesh=Mesh({"dp": 2}, rank=1))
    assert tr.tp_axis is None and tr.num_contributors() == 1 and tr._weight() == (1.0, 2.0)
    placed = tr.shard_batch(_batches(2)[1])
    assert tuple(placed["tokens"].shape) == (8, LM["seq_len"] // 2)
    np.testing.assert_array_equal(placed["labels"].numpy(),
                                  _batches(2)[1]["labels"][:, LM["seq_len"] // 2:])
    assert tuple(placed[MASK_KEY].shape) == (8,)
    # Prediction takes whole sequences on every rank: no ring, the
    # single device's outputs.
    state = tr.init_state(0)
    tokens = _batches(1)[0]["tokens"]
    want = Trainer(tlm.model_spec(**LM), device="cpu").run_predict_step(state.model,
                                                                        {"tokens": tokens})
    torch.testing.assert_close(tr.run_predict_step(state.model, {"tokens": tokens}), want,
                               rtol=0, atol=0)
    # On (dp 2, ep 2) the examples split over dp and the mask follows them.
    tr = Trainer(tlm.model_spec(**LM), device="cpu", mesh=Mesh({"dp": 2, "ep": 2}, rank=2))
    placed = tr.shard_batch(_batches(2)[1])
    assert tuple(placed["tokens"].shape) == (4, LM["seq_len"] // 2)
    np.testing.assert_array_equal(placed[MASK_KEY].numpy(), [1, 0, 0, 0])
    assert tr._weight() == (1.0, 4.0)
