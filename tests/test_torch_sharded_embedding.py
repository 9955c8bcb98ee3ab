"""The port's sharded embedding lookups (``elasticdl_tpu_torch/ops/embedding.py``,
the ``dense`` and ``ragged`` routes) against the JAX package's
(``elasticdl_tpu/ops/embedding.py``) on the forced host devices.

The counterparts of tests/test_embedding.py's sharded cases: the port's
routes run on 2- and 4-rank gloo worlds (tests/_torch_gloo_ranks.py), each
rank holding its rows of the table and its slice of the ids; the JAX lookup
runs under ``shard_map`` on a 2- and 4-device mesh (``dense`` and
``ragged_emulated``, the reference's CPU route of the ragged routing; the
port's ``ragged`` is the real all-to-all, which gloo has on the CPU).  The
same numpy-seeded tables (plain ``[V, D]`` and packed ``[V/8, 8*D]``), ids
and cotangents go through both.  Cases: random ids, skewed ids (every id on
the last shard), every rank's ids on the next rank's shard (one full chunk
of the ragged route's send buffer, the others all padding), 2-D ids,
duplicate ids (the table gradient accumulates them), out-of-range ids (NaN
rows, cotangents dropped).  Tolerances, the reference test's: rows rtol
1e-6 (a gather moves values), gradients rtol 1e-5, atol 1e-6.  All cases of
one world run in one spawned world, whose ``Reducer`` records each case's
collective calls.
"""

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
from elasticdl_tpu.ops import embedding as jemb
from elasticdl_tpu.parallel.mesh import create_mesh as jax_create_mesh
from elasticdl_tpu_torch.common.config import JobConfig
from elasticdl_tpu_torch.ops import embedding as temb

from _torch_gloo_ranks import (
    run_ranks,
    sharded_lookup_cases,
    sharded_lookup_cases_one_rank_group,
)

VOCAB, DIM = 64, 16
WORLDS = (2, 4)
IMPLS = {"dense": "dense", "ragged": "ragged_emulated"}  # port route: JAX route
LAYOUTS = ("plain", "packed")
CASES = ("random", "skewed", "one_owner", "ids_2d", "duplicates", "out_of_range")


def _table() -> np.ndarray:
    return np.random.default_rng(0).standard_normal((VOCAB, DIM)).astype(np.float32)


def _layout(layout: str) -> np.ndarray:
    table = _table()
    if layout == "plain":
        return table
    pack = jemb.row_pack(DIM)
    return table.reshape(VOCAB // pack, pack * DIM)


def _ids_and_cot(case: str, world: int):
    rng = np.random.default_rng(1)
    if case == "random":
        ids = rng.integers(0, VOCAB, 32)
    elif case == "skewed":  # every rank's ids on the last shard
        ids = rng.integers((world - 1) * VOCAB // world, VOCAB, 32)
    elif case == "one_owner":  # rank r's ids all on shard r + 1 (mod world)
        shard = VOCAB // world
        ids = np.concatenate([rng.integers(o * shard, (o + 1) * shard, 32 // world)
                              for o in np.roll(np.arange(world), -1)])
    elif case == "ids_2d":  # [batch, features], the tabular models' shape
        ids = rng.integers(0, VOCAB, (16, 5))
    elif case == "duplicates":  # id 3 from every rank
        ids = np.array([3] * 8 + [0, 1, 2, 4, 5, 6, 7, 8])
    else:
        ids = np.array([3, -7, 3, VOCAB * 4, 9, 2**30, 1, 0, VOCAB, -(2**30)]
                       + list(range(6)))
    ids = ids.astype(np.int32)
    cot = rng.standard_normal(ids.shape + (DIM,)).astype(np.float32)
    return ids, cot


def _key(world, impl, layout, case):
    return f"{world}-{impl}-{layout}-{case}"


@pytest.fixture(scope="module")
def port_results():
    """Every case of each world from one spawned gloo world."""
    results = {}
    for world in WORLDS:
        keys, cases = [], []
        for impl in IMPLS:
            for layout in LAYOUTS:
                for case in CASES:
                    ids, cot = _ids_and_cot(case, world)
                    keys.append(_key(world, impl, layout, case))
                    cases.append({"impl": impl, "table": _layout(layout), "dim": DIM,
                                  "ids": ids, "cot": cot})
        ranks = run_ranks(sharded_lookup_cases, world, cases)
        for i, key in enumerate(keys):
            out = np.concatenate([r["cases"][i][0] for r in ranks])
            grad = np.concatenate([r["cases"][i][1] for r in ranks])
            results[key] = (out, grad)
            results[f"{key}-calls"] = [r["cases"][i][2] for r in ranks]
        results[f"{world}-by_op"] = [r["by_op"] for r in ranks]
    return results


def _jax_lookup(world, impl, layout, case):
    """The JAX sharded lookup's output and table gradient on a
    ``world``-device mesh."""
    mesh = jax_create_mesh(jax.devices(), num_devices=world)
    axis = mesh.axis_names[0]
    ctx = jemb.ParallelContext(axis_name=axis, sharded_embeddings=True,
                               embedding_impl=IMPLS[impl])
    ids, cot = _ids_and_cot(case, world)

    def fwd(t, i):
        return jemb.embedding_lookup(t, i, ctx, dim=DIM)

    def local_loss(t, i, c):
        vec = jemb.embedding_lookup(t, i, ctx, dim=DIM)
        return jnp.sum(jnp.where(jnp.isnan(vec), 0.0, vec * c))

    specs = (P(axis), P(axis))
    out_fn = shard_map(fwd, mesh=mesh, in_specs=specs, out_specs=P(axis), check_vma=False)
    grad_fn = shard_map(jax.grad(local_loss), mesh=mesh, in_specs=specs + (P(axis),),
                        out_specs=P(axis), check_vma=False)
    sh = lambda a: jax.device_put(jnp.asarray(a), NamedSharding(mesh, P(axis)))  # noqa: E731
    table = _layout(layout)
    out = np.asarray(jax.jit(out_fn)(sh(table), sh(ids)))
    grad = np.asarray(jax.jit(grad_fn)(sh(table), sh(ids), sh(cot)))
    return out, grad


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("impl", sorted(IMPLS))
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_lookup_matches_the_reference(port_results, world, impl, layout, case):
    got_out, got_grad = port_results[_key(world, impl, layout, case)]
    want_out, want_grad = _jax_lookup(world, impl, layout, case)
    assert got_out.shape == want_out.shape and got_grad.shape == want_grad.shape
    # NaN exactly where the reference reads NaN (ids no shard owns).
    np.testing.assert_array_equal(np.isnan(got_out), np.isnan(want_out))
    ok = ~np.isnan(want_out)
    np.testing.assert_allclose(got_out[ok], want_out[ok], rtol=1e-6)
    np.testing.assert_allclose(got_grad, want_grad, rtol=1e-5, atol=1e-6)
    ids, cot = _ids_and_cot(case, world)
    # And against the plain gather on one device: rows and the scatter-add.
    flat = ids.reshape(-1)
    good = (flat >= 0) & (flat < VOCAB)
    table = _table()
    np.testing.assert_array_equal(got_out.reshape(-1, DIM)[good], table[flat[good]])
    assert np.isnan(got_out.reshape(-1, DIM)[~good]).all()
    want = np.zeros_like(table)
    np.add.at(want, flat[good], cot.reshape(-1, DIM)[good])
    np.testing.assert_allclose(got_grad.reshape(-1, DIM), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("world", WORLDS)
def test_each_route_ran_its_collectives(port_results, world):
    """The dense route all-gathers ids and reduce-scatters vectors; the
    ragged one exchanges ids, vectors and cotangents all-to-all; all
    through the Reducer, timed by op."""
    for by_op in port_results[f"{world}-by_op"]:
        assert set(by_op) == {"lookup:all_gather", "lookup:reduce_scatter", "lookup:all_to_all"}
        assert all(v >= 0 for v in by_op.values())


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("world", WORLDS)
def test_ragged_route_makes_three_equal_split_all_to_alls(port_results, world, case):
    """A forward and backward of the ragged route: the ids, the vectors and
    the cotangents, each one ``all_to_all`` of ``n * L`` rows (the
    Reducer's equal split: chunks of ``L``, no split sizes from the host),
    and no ``all_gather`` of counts; whatever the ids, skew and padding
    included."""
    ids, _ = _ids_and_cot(case, world)
    per_rank = ids.size // world
    for layout in LAYOUTS:
        for calls in port_results[f"{_key(world, 'ragged', layout, case)}-calls"]:
            assert calls == [("all_to_all", world * per_rank)] * 3, calls


def test_explicit_ragged_on_a_one_rank_group_runs_the_real_all_to_all():
    """An explicit ``ragged`` lookup over a one-rank gloo group runs its
    three exchanges through the group, as the reference honours the request
    on a one-device axis, and equals the local gather: NaN rows for ids past
    the table, their cotangents dropped."""
    ids = np.array([0, 5, VOCAB - 1, VOCAB, -1, 5, 2**30], np.int32)
    cot = np.random.default_rng(2).standard_normal(ids.shape + (DIM,)).astype(np.float32)
    cases = [{"impl": "ragged", "table": _layout(layout), "dim": DIM, "ids": ids, "cot": cot}
             for layout in LAYOUTS]
    (rank,) = run_ranks(sharded_lookup_cases_one_rank_group, 1, cases)
    good = (ids >= 0) & (ids < VOCAB)
    want_grad = np.zeros((VOCAB, DIM), np.float32)
    np.add.at(want_grad, ids[good], cot[good])
    for out, grad, calls in rank["cases"]:
        assert calls == [("all_to_all", ids.size)] * 3, calls
        np.testing.assert_array_equal(out[good], _table()[ids[good]])
        assert np.isnan(out[~good]).all()
        np.testing.assert_allclose(grad.reshape(-1, DIM), want_grad, rtol=1e-5, atol=1e-6)
    assert rank["calls_by_op"] == {"lookup:all_to_all": 3 * len(LAYOUTS)}


def test_resolve_impl_matches_the_reference():
    for impl in temb.LOOKUP_IMPLS:
        for n in (1, 2, 8):
            # The card's answer is the TPU's (the reference's multi-chip route).
            assert temb.resolve_impl(impl, "cuda", n) == jemb.resolve_impl(impl, "tpu", n)
            assert temb.resolve_impl(impl, "cpu", n) == jemb.resolve_impl(impl, "cpu", n)
    assert temb.resolve_impl("auto", "cuda", 2) == "ragged"
    assert temb.resolve_impl("auto", "cuda", 1) == "dense"
    assert temb.resolve_impl("auto", "cpu", 4) == "dense"
    with pytest.raises(ValueError, match="unknown"):
        temb.resolve_impl("bogus")


def test_lookup_impls_match_the_reference_and_the_config():
    assert temb.LOOKUP_IMPLS == jemb.LOOKUP_IMPLS
    assert (temb.IMPL_AUTO, temb.IMPL_RAGGED, temb.IMPL_RAGGED_EMULATED, temb.IMPL_DENSE) == (
        jemb.IMPL_AUTO, jemb.IMPL_RAGGED, jemb.IMPL_RAGGED_EMULATED, jemb.IMPL_DENSE)
    for impl in temb.LOOKUP_IMPLS:
        JobConfig(embedding_lookup_impl=impl).validate()
        JaxJobConfig(embedding_lookup_impl=impl).validate()
    with pytest.raises(ValueError):
        JobConfig(embedding_lookup_impl="bogus").validate()


def test_one_rank_axis_is_the_local_gather():
    """A sharded context over one rank (no process group): the dense route's
    ``n == 1`` path, the plain gather, NaN rows for ids past the table."""
    table = torch.from_numpy(_layout("packed").copy())
    ids = torch.tensor([0, 5, VOCAB - 1, VOCAB, -1])
    for impl in ("auto", "dense", "ragged_emulated"):
        ctx = temb.ParallelContext(axis_name="dp", sharded_embeddings=True, embedding_impl=impl)
        out = temb.embedding_lookup(table, ids, ctx, dim=DIM).numpy()
        np.testing.assert_array_equal(out[:3], _table()[[0, 5, VOCAB - 1]])
        assert np.isnan(out[3:]).all()
