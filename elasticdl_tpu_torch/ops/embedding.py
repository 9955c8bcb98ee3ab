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

The sharded routes (``ragged``, ``dense`` over a mesh axis) are a later
slice of the port; ``embedding_lookup`` raises for them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

#: Lanes of one physical row in the reference's packed layout.
LANES = 128

#: Physical row counts pad to a multiple of this, so the padded table
#: divides over every power-of-two mesh size up to 256 (the reference's
#: elastic resizes never reshape a table).
PHYSICAL_ROW_MULTIPLE = 256

#: Auto host-tier promotion: a table whose padded storage plus two Adam
#: moments (3x) per device exceeds this belongs on the host tier.
HOST_TIER_GUARD_BYTES = 4 << 30


@dataclasses.dataclass(frozen=True)
class ParallelContext:
    """How the current step is parallelised (the reference's trace-time
    context, without the sharded routes' choice): ``axis_name`` is the mesh
    axis a sharded step runs under (None on one device),
    ``sharded_embeddings`` whether tables are row-sharded over it."""

    axis_name: Optional[str] = None
    sharded_embeddings: bool = False


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
    shape ``ids.shape + (dim,)``.  The local route only: a sharded context
    raises."""
    if table.dim() != 2:
        raise ValueError(
            f"table must be 2-D packed [P, pack*stride] (got shape "
            f"{tuple(table.shape)}); convert flat tables with pack_table()"
        )
    if dim is None:
        dim = table.shape[1]
    _pack_geometry(table.shape[1], dim)  # raises on an inconsistent width/dim
    if ctx.sharded_embeddings and ctx.axis_name:
        raise NotImplementedError(
            "sharded embedding lookups (ragged, dense over a mesh axis) are "
            "not ported yet (ROADMAP, PyTorch port queue: sharded embedding "
            "lookups)"
        )
    return gather_rows(table, ids, dim)
