"""The port's embedding lookup (``elasticdl_tpu_torch/ops/embedding.py``)
against the JAX package's local route (``elasticdl_tpu/ops/embedding.py``).

Same numpy-seeded tables and ids through both; the packed layout (dim 9 in
16-lane strides, 8 rows a physical row, as DeepFM's table) and the plain
one.  Tolerances (f32): rows exact (a gather moves values); gradients
rtol 1e-6 (duplicate ids sum in another order).  Geometry helpers equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import elasticdl_tpu.parallel  # noqa: F401  (the JAX package's own import order)
from elasticdl_tpu.ops import embedding as jemb
from elasticdl_tpu_torch.ops import embedding as temb

VOCAB = 300


def _table(dim: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((VOCAB, dim)).astype(np.float32)


def _layouts(table: np.ndarray, layout: str):
    """(jax array, torch tensor, dim) of one table in one layout."""
    dim = table.shape[1]
    if layout == "plain":
        return jnp.asarray(table), torch.from_numpy(table.copy()), dim
    packed = np.asarray(jemb.pack_table(jnp.asarray(table), dim))
    return jnp.asarray(packed), torch.from_numpy(packed.copy()), dim


@pytest.mark.parametrize("dim", list(range(1, 131)))
def test_geometry_helpers_equal_the_reference(dim):
    assert temb.row_stride(dim) == jemb.row_stride(dim)
    assert temb.row_pack(dim) == jemb.row_pack(dim)
    for vocab in (1, 7, 2048, 26 * 512, 26 * 65536, 10**6 + 3):
        assert temb.pad_vocab(vocab, dim) == jemb.pad_vocab(vocab, dim)
        assert temb.table_shape(vocab, dim) == jemb.table_shape(vocab, dim)
        assert temb.table_bytes(vocab, dim) == jemb.table_bytes(vocab, dim)
        assert temb.exceeds_hbm_guard(vocab, dim) == jemb.exceeds_hbm_guard(
            vocab, dim, num_devices=1)
    rows, width = temb.table_shape(VOCAB, dim)
    assert temb._pack_geometry(width, dim) == jemb._pack_geometry(width, dim)
    assert temb.logical_rows(torch.zeros(rows, width), dim) == jemb.logical_rows(
        jnp.zeros((rows, width)), dim)


def test_constants_equal_the_reference():
    assert temb.LANES == jemb.LANES
    assert temb.PHYSICAL_ROW_MULTIPLE == jemb.PHYSICAL_ROW_MULTIPLE
    assert temb.HOST_TIER_GUARD_BYTES == jemb.HOST_TIER_GUARD_BYTES
    # DeepFM at the bench width: 26 x 65536 ids of dim 9 is 212,992 x 128
    # f32 (109.05 MB); three of them stay under the guard (the mesh tier).
    assert temb.table_shape(26 * 65536, 9) == (212992, 128)
    assert not temb.exceeds_hbm_guard(26 * 65536, 9)


@pytest.mark.parametrize("dim", [1, 4, 9, 16, 100, 128, 130])
def test_pack_unpack_round_trip(dim):
    table = _table(dim, seed=dim)
    ours = temb.pack_table(torch.from_numpy(table), dim)
    theirs = np.asarray(jemb.pack_table(jnp.asarray(table), dim))
    np.testing.assert_array_equal(ours.numpy(), theirs)
    np.testing.assert_array_equal(temb.unpack_table(ours, dim)[:VOCAB].numpy(), table)
    np.testing.assert_array_equal(
        temb.unpack_table(ours, dim).numpy(), np.asarray(jemb.unpack_table(jnp.asarray(theirs), dim)))
    flat = temb.pack_table(torch.from_numpy(table.reshape(-1)), dim)
    np.testing.assert_array_equal(flat.numpy(), theirs)


@pytest.mark.parametrize("layout", ["packed", "plain"])
@pytest.mark.parametrize("dim", [9, 4, 16])
def test_gather_rows_and_gradient_match_the_reference(layout, dim):
    rng = np.random.default_rng(7)
    jtable, ttable, d = _layouts(_table(dim, seed=1), layout)
    ids = rng.integers(0, VOCAB, (12, 26)).astype(np.int32)
    ids[0, :5] = ids[1, :5]  # duplicates accumulate
    weights = rng.standard_normal((12, 26, d)).astype(np.float32)

    def jloss(table):
        return jnp.sum(jemb.gather_rows(table, jnp.asarray(ids), d) * weights)

    jrows = np.asarray(jemb.gather_rows(jtable, jnp.asarray(ids), d))
    jgrad = np.asarray(jax.grad(jloss)(jtable))

    ttable.requires_grad_(True)
    rows = temb.gather_rows(ttable, torch.from_numpy(ids), d)
    (rows * torch.from_numpy(weights)).sum().backward()
    np.testing.assert_array_equal(rows.detach().numpy(), jrows)
    np.testing.assert_allclose(ttable.grad.numpy(), jgrad, rtol=1e-6, atol=1e-6)
    # embedding_lookup's local route is gather_rows.
    out = temb.embedding_lookup(ttable.detach(), torch.from_numpy(ids), temb.ParallelContext(), dim=d)
    np.testing.assert_array_equal(out.numpy(), jrows)


@pytest.mark.parametrize("layout", ["packed", "plain"])
def test_out_of_range_ids_read_nan_and_drop_their_cotangent(layout):
    """tests/test_embedding.py:202's case, with the gradient: ids of either
    sign outside the vocabulary read NaN rows, and nothing of their
    cotangent reaches the table (the JAX transpose drops it too)."""
    table = _table(9, seed=2)
    jtable, ttable, d = _layouts(table, layout)
    rows = temb.logical_rows(ttable, d)
    ids = np.array([0, -1, VOCAB - 1, rows, 2**30, -(2**30)], np.int32)
    out = temb.gather_rows(ttable, torch.from_numpy(ids), d).numpy()
    np.testing.assert_array_equal(out[0], table[0])
    np.testing.assert_array_equal(out[2], table[VOCAB - 1])
    for bad in (1, 3, 4, 5):
        assert np.isnan(out[bad]).all(), bad
    jout = np.asarray(jemb.gather_rows(jtable, jnp.asarray(ids), d))
    np.testing.assert_array_equal(np.isnan(out), np.isnan(jout))

    weights = np.ones((len(ids), d), np.float32)
    keep = np.array([1, 0, 1, 0, 0, 0], np.float32)[:, None]  # the loss skips NaN rows

    def jloss(t):
        rows_ = jemb.gather_rows(t, jnp.asarray(ids), d)
        return jnp.sum(jnp.where(keep > 0, rows_, 0.0) * weights)

    jgrad = np.asarray(jax.grad(jloss)(jtable))
    ttable.requires_grad_(True)
    g = temb.gather_rows(ttable, torch.from_numpy(ids), d)
    (torch.where(torch.from_numpy(keep) > 0, g, 0.0) * torch.from_numpy(weights)).sum().backward()
    np.testing.assert_array_equal(ttable.grad.numpy(), jgrad)
    assert np.isfinite(ttable.grad.numpy()).all()


def test_integer_table_fills_zero():
    table = torch.arange(32, dtype=torch.int32).reshape(16, 2)
    out = temb.gather_rows(table, torch.tensor([1, -1, 16]))
    assert out.tolist() == [[2, 3], [0, 0], [0, 0]]


def test_lookup_validation_and_the_sharded_route():
    ctx = temb.ParallelContext()
    with pytest.raises(ValueError, match="pack_table"):
        temb.embedding_lookup(torch.zeros(64), torch.zeros(2, dtype=torch.int64), ctx)
    with pytest.raises(ValueError, match="stride"):
        temb.embedding_lookup(torch.zeros(64, 6), torch.zeros(2, dtype=torch.int64), ctx, dim=3)
    # The sharded routes are ported (tests/test_torch_sharded_embedding.py
    # runs them across ranks); across ranks they need the trainer's Reducer.
    sharded = temb.ParallelContext(axis_name="dp", sharded_embeddings=True, axis_size=2)
    with pytest.raises(ValueError, match="reducer"):
        temb.embedding_lookup(torch.zeros(64, 8), torch.zeros(2, dtype=torch.int64), sharded)
    # Replicated tables under a mesh axis take the local route, as in the
    # reference.
    replicated = temb.ParallelContext(axis_name="dp", sharded_embeddings=False)
    assert temb.embedding_lookup(torch.ones(64, 8), torch.zeros(2, dtype=torch.int64),
                                 replicated).shape == (2, 8)
