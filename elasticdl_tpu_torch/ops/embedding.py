"""Embedding lookup of the PyTorch port: the local route of
``elasticdl_tpu/ops/embedding.py``.

Storage is the reference's lane-packed layout, kept so that a table and
its optimizer moments match the JAX package's arrays one for one (the
canonical state, ``params/fm_table``): a table of ``V'`` logical rows of
``dim`` values is a 2-D ``[V'/pack, pack*stride]`` array, ``stride`` the
next power of two >= ``dim`` (dead lanes zero) and ``pack = 128 //
stride`` logical rows to one 128-lane physical row.  ``V'`` pads to a
multiple of ``pack * PHYSICAL_ROW_MULTIPLE``.

On the card that layout needs no lane select: a contiguous ``[P,
pack*stride]`` table viewed as ``[P*pack, stride]`` IS the logical rows at
a ``stride``-value (64-byte at dim 9) pitch.  So the lookup is one
``index_select`` of that view followed by ``[:, :dim]``, and its autograd
backward is the dense scatter-add of the cotangents into a zero
full-table gradient, which is what the JAX transpose computes.

The out-of-vocabulary contract (``gather_rows``): an id outside
``[0, logical rows)``, of either sign, reads a row of NaN (0 for integer
tables) and its cotangent is dropped.  An out-of-range ``index_select`` on
the card is a device-side assert that poisons the process's CUDA context,
so the ids are masked first: redirected to row 0, and the rows they read
replaced by NaN (which also gives them a zero cotangent).

**Sharded routes** (the ParameterServer strategy, ``ParallelContext``
with ``sharded_embeddings``): each rank of the table's axis group holds a
contiguous range of whole physical rows of the padded packed table, ``P /
n`` of them; logical id ``i`` lives on shard ``i // rows_local`` at local
row ``i - shard * rows_local`` (``rows_local = logical_rows(local_table,
dim)``).  The lookup is collective, as in the reference:

- ``dense``: ``all_gather`` every rank's ids, gather the rows this shard
  owns (zeros elsewhere), reduce-scatter the ``[n, L, dim]`` vectors so
  each rank gets its own ``L`` rows summed over the shards (one nonzero
  each, so the sum is exact).  Its backward is the transpose: all-gather
  the cotangents, scatter-add the owned ones into the local shard.
- ``ragged``: the reference's statically shaped route.  Sort the ``L``
  ids by owner and lay them out in an ``[n * L]`` send buffer, chunk ``j``
  the ids owned by rank ``j`` and then ``-1`` padding; one equal-split
  ``all_to_all_single`` takes chunk ``j`` to rank ``j``, gather locally,
  one equal-split ``all_to_all_single`` of the ``[n * L, dim]`` vectors
  back, and each requester picks its ``L`` rows.  Its backward sends the
  cotangents the same way, requester to owner, and ``index_add_``s them
  into a zeroed local-shard gradient.  The plan (owners, the stable sort,
  each owner's chunk bounds by ``searchsorted``) is made on the device and
  every buffer is built by gathers, so neither direction reads anything
  back to the host and the route captures in a CUDA graph.  The reference
  sizes its receive buffers ``n * L`` too, but its
  ``lax.ragged_all_to_all`` takes the split sizes on the device and puts
  only the ``L`` real ids, rows and cotangents on the wire.
  ``all_to_all_single`` has no such form: its splits are host integers or
  equal chunks.  So here the padding crosses the wire as well, and each
  rank sends and receives ``n * L`` ids, rows and cotangents: ``n`` times
  the reference's bytes, the dense route's volume.

Ids that no shard owns (either sign, past the padded vocab) read NaN rows
and their cotangents are dropped on both routes, as on one device: the
ragged route clamps them to an owner, where they miss its range, as a
``-1`` padding slot misses every owner's.  ``resolve_impl`` picks the
route: ``dense`` on a one-rank axis (whose ``n == 1`` path is the local
gather) and on the CPU, ``ragged`` on the card across ranks.  An explicit
``ragged`` request on a one-rank axis runs the real exchange over the
axis's group where there is one, as the reference does, and keeps its rows
where there is none.  Every collective goes through the trainer's ``Reducer``
(``ParallelContext.reducer``), which times it and names the op when it
fails.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from elasticdl_tpu_torch.common.trace import profiler_range

#: Lanes of one physical row in the reference's packed layout.
LANES = 128

#: Physical row counts pad to a multiple of this, so the padded table
#: divides over every power-of-two mesh size up to 256 (the reference's
#: elastic resizes never reshape a table).
PHYSICAL_ROW_MULTIPLE = 256

#: Auto host-tier promotion: a table whose padded storage plus two Adam
#: moments (3x) per device exceeds this belongs on the host tier.
HOST_TIER_GUARD_BYTES = 4 << 30


#: Lookup implementations (``ParallelContext.embedding_impl``, the
#: ``--embedding_lookup_impl`` flag).
IMPL_AUTO = "auto"
IMPL_RAGGED = "ragged"
#: The reference's CPU stand-in for the ragged all-to-all, which XLA:CPU
#: lacks.  gloo has ``all_to_all_single`` on the CPU, so in the port it runs
#: the real ragged route.
IMPL_RAGGED_EMULATED = "ragged_emulated"
IMPL_DENSE = "dense"
LOOKUP_IMPLS = (IMPL_AUTO, IMPL_RAGGED, IMPL_RAGGED_EMULATED, IMPL_DENSE)


@dataclasses.dataclass(frozen=True)
class ParallelContext:
    """How the current step is parallelised (the reference's trace-time
    context): ``axis_name`` is the mesh axis tables shard over (None on one
    device), ``sharded_embeddings`` whether tables are row-sharded over it,
    ``embedding_impl`` the sharded route (resolved by the trainer through
    ``resolve_impl``).  ``axis_name`` is also the sequence axis the ring
    attention rotates over.  ``tp_axis`` names the tensor-parallel axis of a
    ``(dp, tp)`` mesh (None elsewhere): a model with a ``tensor_sharding``
    plan runs its column/row-split path when it is set.  The port adds what
    the reference's ``lax`` collectives know from the trace: each axis's
    size, this rank's position on the last one, the process groups of its
    lines and the ``Reducer`` the collectives run through."""

    axis_name: Optional[str] = None
    sharded_embeddings: bool = False
    embedding_impl: str = IMPL_AUTO
    axis_size: int = 1
    axis_index: int = 0
    group: Any = None
    reducer: Any = None
    tp_axis: Optional[str] = None
    tp_size: int = 1
    tp_group: Any = None


def row_stride(dim: int) -> int:
    """Lanes a logical row occupies in packed storage: the next power of two
    >= dim for dim <= 128, else the next multiple of 128."""
    if dim <= 0:
        raise ValueError(f"embedding dim must be positive, got {dim}")
    if dim >= LANES:
        return ((dim + LANES - 1) // LANES) * LANES
    stride = 1
    while stride < dim:
        stride *= 2
    return stride


def row_pack(dim: int) -> int:
    """Logical rows per 128-lane physical row (1 when dim >= 128)."""
    return max(1, LANES // row_stride(dim))


def pad_vocab(vocab_size: int, dim: int = LANES) -> int:
    """Padded logical vocab: the smallest multiple of
    pack*PHYSICAL_ROW_MULTIPLE >= vocab_size."""
    multiple = row_pack(dim) * PHYSICAL_ROW_MULTIPLE
    return ((vocab_size + multiple - 1) // multiple) * multiple


def table_shape(vocab_size: int, dim: int) -> Tuple[int, int]:
    """Packed storage shape [physical_rows, pack*stride] for a padded vocab."""
    pack = row_pack(dim)
    return pad_vocab(vocab_size, dim) // pack, pack * row_stride(dim)


def table_bytes(vocab_size: int, dim: int, itemsize: int = 4) -> int:
    """Padded packed storage bytes of one table (without the optimizer)."""
    rows, width = table_shape(vocab_size, dim)
    return rows * width * itemsize


def exceeds_hbm_guard(vocab_size: int, dim: int, num_devices: int = 1) -> bool:
    """True when the per-device share of the table and two Adam moments
    exceeds HOST_TIER_GUARD_BYTES (the table row-shards over
    ``num_devices``; the port runs on one)."""
    return 3 * table_bytes(vocab_size, dim) > HOST_TIER_GUARD_BYTES * max(1, num_devices)


def init_table(generator: torch.Generator, vocab_size: int, dim: int,
               scale: float = 0.01, device: Any = None) -> torch.Tensor:
    """A fresh packed ``[P, pack*stride]`` table (``table_shape``) of
    normal draws times ``scale`` from ``generator``, the reference's
    ``init_table``: every element is drawn, the padding rows and dead lanes
    too (the lookup never reads them)."""
    out = torch.empty(table_shape(vocab_size, dim), device=device)
    return out.normal_(0.0, 1.0, generator=generator).mul_(scale)


def _pack_geometry(width: int, dim: int) -> Tuple[int, int]:
    """(pack, stride) of a table of physical width ``width`` holding
    ``dim``-value logical rows; ``width == dim`` is the plain layout."""
    if width == dim:
        return 1, dim
    stride = row_stride(dim)
    if width % stride:
        raise ValueError(
            f"table width {width} is not a multiple of the canonical "
            f"stride {stride} for dim {dim}"
        )
    return width // stride, stride


def pack_table(table: torch.Tensor, dim: int) -> torch.Tensor:
    """A plain [V, dim] (or flat [V*dim]) table in the padded packed
    [P, pack*stride] layout; rows past V and lanes past dim are zero."""
    if table.dim() == 1:
        if table.shape[0] % dim:
            raise ValueError(
                f"flat table of {table.shape[0]} elements is not a multiple of dim {dim}"
            )
        table = table.reshape(-1, dim)
    if table.dim() != 2 or table.shape[1] != dim:
        raise ValueError(f"expected a [V, {dim}] or flat [V*{dim}] table, got {tuple(table.shape)}")
    rows, width = table_shape(table.shape[0], dim)
    stride = row_stride(dim)
    out = table.new_zeros((rows * (width // stride), stride))
    out[: table.shape[0], :dim] = table
    return out.reshape(rows, width)


def unpack_table(table: torch.Tensor, dim: int) -> torch.Tensor:
    """The [V', dim] logical view of a packed table (padding included)."""
    _, stride = _pack_geometry(table.shape[1], dim)
    return table.reshape(-1, stride)[:, :dim]


def logical_rows(table: torch.Tensor, dim: int) -> int:
    """Number of logical rows a packed [P, pack*stride] table holds."""
    pack, _ = _pack_geometry(table.shape[1], dim)
    return table.shape[0] * pack


def gather_rows(
    table: torch.Tensor, ids: torch.Tensor, dim: Optional[int] = None
) -> torch.Tensor:
    """Logical rows ``ids`` of a packed table as ``ids.shape + (dim,)``.

    ``table`` is ``[P, pack*stride]`` (``dim`` defaults to the full width: a
    plain ``[V, dim]`` table is the ``pack == 1`` case).  Out-of-range ids
    (either sign) read NaN rows (0 for integer tables) and their cotangents
    are dropped; no out-of-range index reaches the device.
    """
    width = table.shape[1]
    if dim is None:
        dim = width
    _, stride = _pack_geometry(width, dim)
    rows = table.reshape(-1, stride)  # a view of a contiguous table
    flat = ids.reshape(-1).to(torch.int64)
    oob = (flat < 0) | (flat >= rows.shape[0])
    out = rows.index_select(0, torch.where(oob, 0, flat))[:, :dim]
    out = out.masked_fill(oob[:, None], float("nan") if table.is_floating_point() else 0)
    return out.reshape(tuple(ids.shape) + (dim,))


def embedding_lookup(
    table: torch.Tensor,
    ids: torch.Tensor,
    ctx: ParallelContext = ParallelContext(),
    dim: Optional[int] = None,
) -> torch.Tensor:
    """Look up ``ids`` (any shape) in a packed 2-D ``table``; the output has
    shape ``ids.shape + (dim,)``.  In a sharded context ``table`` is this
    rank's row range of the padded global table and the lookup is
    collective (module docstring): every rank of the axis group must call
    it, with the same number of ids."""
    if table.dim() != 2:
        raise ValueError(
            f"table must be 2-D packed [P, pack*stride] (got shape "
            f"{tuple(table.shape)}); convert flat tables with pack_table()"
        )
    if dim is None:
        dim = table.shape[1]
    _pack_geometry(table.shape[1], dim)  # raises on an inconsistent width/dim
    with profiler_range("lookup:forward"):
        if not (ctx.sharded_embeddings and ctx.axis_name):
            return gather_rows(table, ids, dim)
        impl = resolve_impl(ctx.embedding_impl, table.device.type, ctx.axis_size)
        # n = 1 is a local gather on the dense route; an explicit ragged
        # request still runs the ragged route, as in the reference.
        if impl == IMPL_DENSE or (ctx.axis_size == 1 and impl == IMPL_RAGGED_EMULATED):
            if ctx.axis_size == 1:
                return gather_rows(table, ids, dim)
            return _DenseLookup.apply(table, ids, ctx, dim)
        return _RaggedLookup.apply(table, ids, ctx, dim)


def resolve_impl(impl: str, platform: Optional[str] = None,
                 axis_size: Optional[int] = None) -> str:
    """``auto`` for (platform, axis size): ``dense`` on a one-rank axis (the
    local gather, without the ragged route's sort and exchange), ``ragged``
    on the card across ranks (the reference's multi-chip answer), ``dense``
    on the CPU.  Explicit impls pass through; an unknown one raises."""
    if impl not in LOOKUP_IMPLS:
        raise ValueError(f"unknown embedding lookup impl {impl!r}; one of {LOOKUP_IMPLS}")
    if impl != IMPL_AUTO:
        return impl
    if axis_size == 1:
        return IMPL_DENSE
    return IMPL_RAGGED if platform == "cuda" else IMPL_DENSE


def _scatter_add_rows(shape, rows: torch.Tensor, g: torch.Tensor, dim: int) -> torch.Tensor:
    """The transpose of ``gather_rows``: ``g`` (``[m, dim]``) added into a
    zeroed packed table gradient of ``shape`` at logical ``rows``; rows
    outside the table drop their cotangents."""
    _, stride = _pack_geometry(shape[1], dim)
    grad = g.new_zeros((shape[0] * shape[1] // stride, stride))
    oob = (rows < 0) | (rows >= grad.shape[0])
    # Masked rather than filtered: a boolean index would sync with the card.
    g = g.masked_fill(oob[:, None], 0.0)
    grad[:, :dim].index_add_(0, torch.where(oob, 0, rows), g)
    return grad.reshape(shape)


def _reducer(ctx: ParallelContext):
    if ctx.reducer is None:
        raise ValueError("a sharded lookup needs ParallelContext.reducer (the trainer's)")
    return ctx.reducer


class _DenseLookup(torch.autograd.Function):
    """The dense route (n > 1): all_gather the ids, masked local gather,
    reduce-scatter the vectors; NaN rows for ids no shard owns."""

    @staticmethod
    def forward(fctx, local_table, ids, ctx: ParallelContext, dim: int):
        n, me, red = ctx.axis_size, ctx.axis_index, _reducer(ctx)
        rows_local = logical_rows(local_table, dim)
        flat = ids.reshape(-1).to(torch.int64)
        count = flat.shape[0]
        bad = (flat < 0) | (flat >= n * rows_local)
        all_ids = red.all_gather(flat, ctx.group, tag="lookup")  # [n * L]
        owner = torch.div(all_ids, rows_local, rounding_mode="floor")
        mine = owner == me
        safe = torch.where(mine, all_ids - owner * rows_local, 0)
        vectors = gather_rows(local_table, safe, dim).masked_fill(~mine[:, None], 0.0)
        # Each rank its own block, summed over the shards (one nonzero each).
        out = red.reduce_scatter(vectors.reshape(-1), ctx.group, tag="lookup")
        out = out.view(count, dim).masked_fill(bad[:, None], float("nan"))
        fctx.save_for_backward(safe, mine, bad)
        fctx.table_shape, fctx.ctx, fctx.dim = tuple(local_table.shape), ctx, dim
        return out.reshape(tuple(ids.shape) + (dim,))

    @staticmethod
    def backward(fctx, g):
        with profiler_range("lookup:backward"):
            safe, mine, bad = fctx.saved_tensors
            ctx, dim = fctx.ctx, fctx.dim
            g = g.reshape(-1, dim).masked_fill(bad[:, None], 0.0).contiguous()
            # The transpose of the reduce-scatter: every rank's cotangents.
            g_all = _reducer(ctx).all_gather(g.reshape(-1), ctx.group,
                                             tag="lookup").view(-1, dim)
            rows = torch.where(mine, safe, -1)
            return _scatter_add_rows(fctx.table_shape, rows, g_all, dim), None, None, None


class _RaggedLookup(torch.autograd.Function):
    """The ragged route with static shapes: ``[n * L]`` send and receive
    buffers, chunk ``j`` for rank ``j``, ``-1`` padding (the reference's
    ``id_buf``), and equal-split ``all_to_all_single`` calls, so no split
    size and no count comes to the host.  The padding crosses the wire
    (the module docstring says what that costs).  A padding slot reads a
    NaN row at the owner and drops its cotangent, as a junk id does."""

    @staticmethod
    def forward(fctx, local_table, ids, ctx: ParallelContext, dim: int):
        n, me = ctx.axis_size, ctx.axis_index
        rows_local = logical_rows(local_table, dim)
        flat = ids.reshape(-1).to(torch.int64)
        send_src, send_ok, place = _routing_plan(flat, rows_local, n)
        sent = torch.where(send_ok, flat.index_select(0, send_src), -1)
        local_rows = _exchange(sent, ctx) - me * rows_local
        vecs = gather_rows(local_table, local_rows, dim)  # NaN where not owned
        out = _exchange(vecs, ctx).index_select(0, place)
        fctx.save_for_backward(send_src, send_ok, local_rows)
        fctx.table_shape, fctx.ctx, fctx.dim = tuple(local_table.shape), ctx, dim
        return out.reshape(tuple(ids.shape) + (dim,))

    @staticmethod
    def backward(fctx, g):
        with profiler_range("lookup:backward"):
            send_src, send_ok, local_rows = fctx.saved_tensors
            ctx, dim = fctx.ctx, fctx.dim
            g_sent = g.reshape(-1, dim).index_select(0, send_src)
            g_sent = g_sent.masked_fill(~send_ok[:, None], 0.0)
            g_at_owner = _exchange(g_sent, ctx)
            return _scatter_add_rows(fctx.table_shape, local_rows, g_at_owner, dim), None, None, None


def _routing_plan(flat: torch.Tensor, rows_local: int, n: int):
    """The ragged route's plan for this rank's ``L`` ids, on their device:
    ``(send_src, send_ok, place)``.  Slot ``q = j * L + p`` of the ``[n *
    L]`` send buffer holds id ``send_src[q]`` where ``send_ok[q]`` (the
    ``p``-th id that rank ``j`` owns, in id order) and padding elsewhere;
    id ``i`` sits at slot ``place[i]``.  Junk ids get a clamped owner,
    whose row range they then miss."""
    L = flat.shape[0]
    owner = torch.div(flat, rows_local, rounding_mode="floor").clamp_(0, n - 1)
    perm = torch.argsort(owner, stable=True)
    by_owner = owner.index_select(0, perm)
    # bounds[j]: the ids owned by ranks before j (bounds[n] == L).
    bounds = torch.searchsorted(by_owner, torch.arange(n + 1, device=flat.device))
    p = torch.arange(L, device=flat.device)
    src = bounds[:-1, None] + p  # [n, L]: each slot's place in owner order
    send_ok = (src < bounds[1:, None]).reshape(-1)
    send_src = perm.index_select(0, src.clamp_(max=L - 1).reshape(-1))
    place = by_owner * L + p - bounds.index_select(0, by_owner)
    return send_src, send_ok, place.index_select(0, torch.argsort(perm))


def _exchange(x: torch.Tensor, ctx: ParallelContext) -> torch.Tensor:
    """``all_to_all_single`` of ``x``'s ``[n * L]`` rows in equal chunks:
    chunk ``j`` to group rank ``j``, and chunk ``j`` of the result from it.
    A one-rank axis without a group keeps its rows."""
    if ctx.group is None and ctx.axis_size == 1:
        return x
    return _reducer(ctx).all_to_all(torch.empty_like(x), x.contiguous(), ctx.group,
                                    tag="lookup")
