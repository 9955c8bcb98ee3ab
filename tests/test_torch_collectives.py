"""The port's collectives (``elasticdl_tpu_torch/parallel/collectives.py``)
and mesh functions against the JAX package's.

Four spawned gloo processes on the CPU (tests/_torch_gloo_ranks.py) reduce
numpy-seeded trees (leaves above and below ``min_elems``, one that pads to
the local fan-in, a scalar) in flat mode and in hierarchical mode with
``collective_local_size=2``; the JAX ``collectives.psum``/``pmean`` run on a
4-device CPU mesh under ``shard_map`` with the same inputs and local size.
Tolerance rtol 1e-5, atol 1e-6 (tests/test_collectives.py's).  The
contributor mask: an all-ones mask equals the plain route bit for bit;
excluding one rank renormalises by |G'| as the reference does.  The pure
functions (``contributor_count``, ``describe``, ``interhost_bytes_per_step``,
``dp_factorization``, ``resolve_2d_shape``, ``mesh_shape``) match for
n = 1..16.
"""

import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from elasticdl_tpu.common.jax_compat import shard_map
from elasticdl_tpu.parallel import collectives as jcoll
from elasticdl_tpu.parallel import mesh as jmesh
from elasticdl_tpu_torch.parallel import collectives as coll
from elasticdl_tpu_torch.parallel import mesh as tmesh

from _torch_gloo_ranks import collectives_cases, run_ranks

WORLD, LOCAL = 4, 2
ACTIVE = np.array([1, 1, 0, 1], np.float32)
SHAPES = {"big": (4099,), "mat": (64, 80), "small": (10,), "scalar": ()}


def _trees():
    rng = np.random.default_rng(0)
    return [{k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
            for _ in range(WORLD)]


@pytest.fixture(scope="module")
def ranks():
    return run_ranks(collectives_cases, WORLD, _trees(), ACTIVE, LOCAL)


def _jax_reduce(trees, mode, masked=False, mean=False):
    mesh = jmesh.create_mesh(jax.devices(), num_devices=WORLD)
    topo = jcoll.resolve_topology(mesh, ("dp",), mode=mode, local_size=LOCAL)
    stacked = {k: np.stack([t[k] for t in trees]) for k in SHAPES}
    active = jax.numpy.asarray(ACTIVE)

    def local(tree):
        tree = {k: v[0] for k, v in tree.items()}
        if masked:
            w = jcoll.contributor_weight(active, ("dp",))
            n = jcoll.psum(w, ("dp",))
            return {k: jcoll.psum(v * w, ("dp",), topo) / n for k, v in tree.items()}
        if mean:
            return {k: jcoll.pmean(v, ("dp",), topo) for k, v in tree.items()}
        return {k: jcoll.psum(v, ("dp",), topo) for k, v in tree.items()}

    fn = shard_map(local, mesh=mesh, in_specs=({k: P("dp") for k in SHAPES},),
                   out_specs={k: P() for k in SHAPES}, check_vma=False)
    return {k: np.asarray(v) for k, v in jax.jit(fn)(stacked).items()}


@pytest.mark.parametrize("mode,name", [("flat", "flat"), ("hierarchical", "hier")])
@pytest.mark.parametrize("op", ["psum", "pmean", "masked"])
def test_reductions_match_the_jax_collectives(ranks, mode, name, op):
    trees = _trees()
    ref = _jax_reduce(trees, mode, masked=op == "masked", mean=op == "pmean")
    for rank, out in enumerate(ranks):
        got = out[f"{name}_{op}"]
        assert sorted(got) == sorted(SHAPES)
        for k in SHAPES:
            assert got[k].shape == SHAPES[k], (k, got[k].shape)
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, atol=1e-6,
                                       err_msg=f"{op} {mode} rank {rank} {k}")
    # Every rank holds the same result, bit for bit.
    for out in ranks[1:]:
        for k in SHAPES:
            assert np.array_equal(out[f"{name}_{op}"][k], ranks[0][f"{name}_{op}"][k]), k


@pytest.mark.parametrize("name", ["flat", "hier"])
def test_the_all_ones_mask_is_the_plain_route_bit_for_bit(ranks, name):
    for out in ranks:
        for k in SHAPES:
            assert np.array_equal(out[f"{name}_ones"][k], out[f"{name}_pmean"][k]), k


def test_excluding_a_contributor_renormalises_over_the_rest(ranks):
    trees = _trees()
    want = {k: sum(trees[r][k] for r in range(WORLD) if ACTIVE[r]) / ACTIVE.sum() for k in SHAPES}
    for out in ranks:
        for k in SHAPES:
            np.testing.assert_allclose(out["flat_masked"][k], want[k], rtol=1e-5, atol=1e-6)


def test_topology_description_and_bytes_match_the_jax_values(ranks):
    mesh = jmesh.create_mesh(jax.devices(), num_devices=WORLD)
    jtopo = jcoll.resolve_topology(mesh, ("dp",), mode="hierarchical", local_size=LOCAL)
    assert ranks[0]["describe"] == jtopo.describe()
    # auto without a host grouping (one host here) is flat in both.
    assert ranks[0]["auto"] is None
    assert jcoll.resolve_topology(mesh, ("dp",), mode="auto") is None
    topo = coll.CollectiveTopology("dp", 2, 2)
    assert topo.local_groups == jtopo.local_groups and topo.cross_groups == jtopo.cross_groups
    sizes = [int(np.prod(s)) if s else 1 for s in SHAPES.values()] + [111_000_000]
    for n, t, jt in ((WORLD, None, None), (WORLD, topo, jtopo), (1, None, None)):
        assert coll.interhost_bytes_per_step(sizes, n, t) == jcoll.interhost_bytes_per_step(
            sizes, n, jt)
    for shape in ({"dp": 4}, {"dp": 2, "ep": 3}):
        port, jax_mesh = tmesh.Mesh(shape), _duck_mesh(shape)
        for axes in (("dp",), tuple(shape)):
            assert coll.contributor_count(port, axes) == jcoll.contributor_count(jax_mesh, axes)
        assert tmesh.mesh_shape(port) == jmesh.mesh_shape(jax_mesh)
    with pytest.raises(ValueError, match="collective mode"):
        coll.resolve_topology(tmesh.Mesh({"dp": 4}), ("dp",), mode="ring")


class _Dev:
    def __init__(self, process_index):
        self.process_index = process_index


def _duck_mesh(shape, owners=None):
    """A stand-in for a JAX mesh (the mesh functions read ``shape``,
    ``axis_names``, ``devices`` and each device's ``process_index``):
    more fake devices than the test process holds."""
    n = int(np.prod(list(shape.values())))
    owners = owners if owners is not None else [0] * n
    devs = np.empty(n, dtype=object)
    for i in range(n):
        devs[i] = _Dev(owners[i])
    return types.SimpleNamespace(shape=dict(shape), axis_names=tuple(shape),
                                 devices=devs.reshape(tuple(shape.values())))


def test_dp_factorization_and_resolve_2d_shape_tables_match():
    for n in range(1, 17):
        divisors = [d for d in range(1, n + 1) if n % d == 0]
        for local in [0] + divisors:
            assert tmesh.dp_factorization(tmesh.Mesh({"dp": n}), local_size=local) == \
                jmesh.dp_factorization(_duck_mesh({"dp": n}), local_size=local), (n, local)
        for per_host in divisors:
            owners = [i // per_host for i in range(n)]
            port = tmesh.Mesh({"dp": n}, hosts=tuple(f"h{o}" for o in owners))
            assert tmesh.dp_factorization(port) == jmesh.dp_factorization(
                _duck_mesh({"dp": n}, owners)), (n, per_host)
        # Interleaved hosts demote to flat in both.
        owners = [i % 2 for i in range(n)]
        port = tmesh.Mesh({"dp": n}, hosts=tuple(f"h{o}" for o in owners))
        assert tmesh.dp_factorization(port) == jmesh.dp_factorization(
            _duck_mesh({"dp": n}, owners)), n
        for tp in range(1, 9):
            assert tmesh.resolve_2d_shape(n, tp) == jmesh.resolve_2d_shape(n, tp), (n, tp)
    with pytest.raises(ValueError, match="does not divide"):
        tmesh.dp_factorization(tmesh.Mesh({"dp": 4}), local_size=3)
    with pytest.raises(ValueError, match="at least one device"):
        tmesh.resolve_2d_shape(0, 2)


def test_two_d_mesh_lines_and_positions():
    """A ``(dp, ep)`` mesh lays ranks out as the reference lays devices
    (``reshape(dcn, -1)``): rank ``d * ep + e``."""
    shape = {"dp": 2, "ep": 3}
    for rank in range(6):
        m = tmesh.Mesh(shape, rank=rank)
        assert (m.position("dp"), m.position("ep")) == divmod(rank, 3)
        assert m.line(("ep",)) == [3 * (rank // 3) + e for e in range(3)]
        assert m.line(("dp",)) == [rank % 3, rank % 3 + 3]
        assert m.line(("dp", "ep")) == list(range(6))
        assert coll.contributor_index(m, ("dp", "ep")) == rank
        assert coll.contributor_index(m, ("dp",)) == rank // 3


def test_left_out_collectives_name_their_roadmap_items():
    # psum_scatter is ported (tests/test_torch_opt_shard.py runs it across
    # ranks); over a line of one rank it keeps its input.
    x = torch.arange(6.0)
    assert torch.equal(coll.psum_scatter(x, "dp", coll.Reducer(tmesh.Mesh({"dp": 1}))), x)
    # The tensor-parallel pair is ported (tests/test_torch_ring_tp.py runs
    # it across ranks); over a line of one rank (no group) both are the
    # identity, forward and backward.
    red = coll.Reducer(tmesh.Mesh({"dp": 1, "tp": 1}))
    for fn in (coll.tp_all_reduce, coll.tp_grad_sync):
        y = torch.arange(6.0, requires_grad=True)
        out = fn(y, red, None)
        assert out is y
        (out * torch.arange(6.0)).sum().backward()
        assert torch.equal(y.grad, torch.arange(6.0))


def test_the_reducer_counts_calls_by_op_eagerly_and_at_each_replay():
    """Each ``"<tag>:<op>"`` call counts as it runs, and a replay of a
    captured graph adds its tally's calls and seconds: ``calls_by_op`` and
    ``by_op`` read one record, the per-op form of ``calls`` and
    ``seconds``."""
    red = coll.Reducer(tmesh.Mesh({"dp": 1}))
    for op in ("all_to_all", "all_to_all", "all_reduce"):
        red._collective(lambda: None, None, [torch.zeros(1)], op, "lookup")
    assert red.calls == 3 and red.calls_by_op == {"lookup:all_to_all": 2, "lookup:all_reduce": 1}
    tally = {"lookup:all_to_all": [24, 0.5], "grads:all_reduce": [8, 0.25]}
    red.add_replay(tally)
    red.add_replay(tally)
    assert red.calls == 3 + 2 * 32
    assert red.calls_by_op == {"lookup:all_to_all": 50, "lookup:all_reduce": 1,
                               "grads:all_reduce": 16}
    assert red.by_op["grads:all_reduce"] == 0.5 and set(red.by_op) == set(red.calls_by_op)
    assert red.seconds == pytest.approx(sum(red.by_op.values()))
