"""The world's shape over process groups: the port's counterpart of the
reference's device mesh.

Port of ``elasticdl_tpu/parallel/mesh.py``.  In the port each worker
process owns one device, so a mesh is the world of ranks laid out as the
reference lays out its devices:

- 1-D (``dcn_parallelism <= 1``), axis ``dp``: every rank a data-parallel
  replica;
- 2-D ``(dp, ep)`` (``dcn_parallelism > 1``): ``dp = dcn_parallelism``
  rows of ``ep = world / dcn_parallelism`` consecutive ranks, rank
  ``d * ep + e`` at row ``d``, column ``e``.  Examples shard over ``dp``;
  the inner ``ep`` axis is the embedding and sequence axis;
- 2-D ``(dp, tp)`` (``tensor_parallelism > 1``): ``dp = world / tp`` rows
  of ``tp`` consecutive ranks.  The inner ``tp`` axis holds a
  tensor-parallel model's weight shards (``ModelSpec.tensor_sharding``) and
  carries its per-block activation sums; examples shard over ``dp``.

A ``Mesh`` holds this rank's position, the world's process group and one
group per axis line this rank lies on (``torch.distributed.new_group``,
made on every rank in the same order, as the call requires).  The
hierarchical collective route's intra-host and inter-host subgroups come
from ``dp_factorization`` (``collectives.resolve_topology``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

from elasticdl_tpu_torch.common.log_utils import get_logger

DATA_AXIS = "dp"
EMBED_AXIS = "ep"
MODEL_AXIS = "tp"

logger = get_logger("mesh")


@dataclasses.dataclass
class Mesh:
    """The world's shape and this rank's place in it.

    ``shape``: axis name -> size, outer axis first (its product is the
    world size); ``rank``: this process's rank; ``hosts``: the host of
    each rank (equal strings mean one host; empty: unknown); ``groups``:
    axis tuple -> the process group over this rank's line along those
    axes (None for a line of one rank, unless the line is a world of one
    with a process group)."""

    shape: Dict[str, int]
    rank: int = 0
    hosts: Tuple[str, ...] = ()
    groups: Dict[Tuple[str, ...], Any] = dataclasses.field(default_factory=dict)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        n = 1
        for v in self.shape.values():
            n *= v
        return n

    def position(self, axis: str) -> int:
        """This rank's index along ``axis`` (row-major over the axes)."""
        names = self.axis_names
        stride = 1
        for a in names[names.index(axis) + 1:]:
            stride *= self.shape[a]
        return (self.rank // stride) % self.shape[axis]

    def line(self, axes: Sequence[str]) -> List[int]:
        """The world ranks of this rank's line along ``axes``: every rank
        that differs from it only in those axes' positions, in row-major
        order over them."""
        names = self.axis_names
        strides = {}
        stride = 1
        for a in reversed(names):
            strides[a] = stride
            stride *= self.shape[a]
        base = self.rank - sum(self.position(a) * strides[a] for a in axes)
        ranks = [base]
        for a in axes:
            ranks = [r + i * strides[a] for r in ranks for i in range(self.shape[a])]
        return sorted(ranks)

    def group(self, axes: Sequence[str]):
        """The process group over this rank's line along ``axes`` (see
        ``groups``)."""
        return self.groups.get(tuple(a for a in self.axis_names if a in axes))


def _world() -> Tuple[int, int, Any]:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank(), dist.group.WORLD
    return 1, 0, None


def create_mesh(
    dcn_parallelism: int = 1,
    hosts: Sequence[str] = (),
    world: Optional[Tuple[int, int, Any]] = None,
    tensor_parallelism: int = 1,
) -> Mesh:
    """The mesh over the current process group's world (a world of one
    without a group when none is initialized).  ``dcn_parallelism > 1``
    builds ``(dp, ep)`` and must divide the world; ``tensor_parallelism >
    1`` builds ``(dp, tp)`` with ``tp`` consecutive ranks a row and must
    divide the world too (``resolve_world_shape`` picks a legal degree);
    the two are mutually exclusive.  ``hosts`` names each rank's host for
    the hierarchical route.  Every rank must call this with the same
    arguments: the axis groups are collective to make."""
    n, rank, world_group = world if world is not None else _world()
    if tensor_parallelism > 1:
        if dcn_parallelism > 1:
            raise ValueError("tensor_parallelism and dcn_parallelism are mutually "
                             "exclusive (no 3-D mesh)")
        if n % tensor_parallelism:
            raise ValueError(f"tensor_parallelism {tensor_parallelism} does not divide "
                             f"{n} ranks (resolve_world_shape picks legal shapes)")
        shape = {DATA_AXIS: n // tensor_parallelism, MODEL_AXIS: tensor_parallelism}
    elif dcn_parallelism > 1:
        if n % dcn_parallelism:
            raise ValueError(f"dcn_parallelism {dcn_parallelism} does not divide {n} ranks")
        shape = {DATA_AXIS: dcn_parallelism, EMBED_AXIS: n // dcn_parallelism}
    else:
        shape = {DATA_AXIS: n}
    if hosts and len(hosts) != n:
        raise ValueError(f"{len(hosts)} hosts for {n} ranks")
    mesh = Mesh(shape, rank=rank, hosts=tuple(hosts))
    names = mesh.axis_names
    # Every line of every axis subset, made on every rank in one order.
    subsets = [names] + ([(a,) for a in names] if len(names) > 1 else [])
    for axes in subsets:
        lines = sorted({tuple(Mesh(shape, rank=r).line(axes)) for r in range(n)})
        for ranks in lines:
            if len(ranks) == n and world_group is not None:
                pg = world_group  # a world of one with a group reduces over it
            elif len(ranks) == 1:
                continue
            else:
                import torch.distributed as dist

                pg = dist.new_group(list(ranks))
            if rank in ranks:
                mesh.groups[axes] = pg
    return mesh


def resolve_2d_shape(n_devices: int, tensor_parallelism: int) -> Tuple[int, int]:
    """Legal ``(dp, tp)`` shape for ``n_devices`` live devices under a
    configured tensor-parallel degree: ``tp`` is kept and ``dp = n // tp``
    shrinks first; only when fewer than ``tp`` devices remain does ``tp``
    shrink, to the largest divisor of the configured degree that fits."""
    n = int(n_devices)
    if n < 1:
        raise ValueError(f"need at least one device, got {n}")
    tp = max(1, int(tensor_parallelism))
    while tp > n:
        tp -= 1
        while tp > 1 and tensor_parallelism % tp:
            tp -= 1
    return n // tp, tp


def resolve_world_shape(n_ranks: int, tensor_parallelism: int) -> Tuple[int, int]:
    """The ``(dp, tp)`` shape a world of ``n_ranks`` processes trains on:
    ``resolve_2d_shape``'s, when it uses every rank; otherwise ``tp``
    degrades along the configured degree's divisors to the largest that
    divides the world.  The reference leaves the ranks past ``dp * tp``
    idle until the next reform; a port rank is a process of the world,
    whose every collective needs it, so none can sit out (ROADMAP, "Found
    while porting")."""
    dp, tp = resolve_2d_shape(n_ranks, tensor_parallelism)
    if dp * tp != n_ranks:
        tp = max(d for d in range(1, tp + 1) if tensor_parallelism % d == 0 and n_ranks % d == 0)
    return n_ranks // tp, tp


def mesh_shape(mesh: Mesh) -> Tuple[int, int]:
    """The ``(dp, tp)`` view of any mesh: a 1-D mesh is ``(n, 1)``; a
    ``(dp, ep)`` mesh reports its full size as dp (no model axis)."""
    tp = int(mesh.shape.get(MODEL_AXIS, 1))
    return mesh.size // tp, tp


def dp_factorization(mesh: Mesh, axis_name: str = DATA_AXIS, local_size: int = 0) -> tuple:
    """Factor ``axis_name``'s positions into ``(n_host, n_local)`` for the
    hierarchical collective route (parallel/collectives.py).

    ``local_size > 0`` pins the local fan-in (it must divide the axis
    size): the CPU tests' way to emulate hosts, and an operator override.
    ``local_size == 0`` groups the positions by the hosts of their ranks
    (``mesh.hosts``; one rank a device, so a host's ranks are its local
    replicas) when those groups are contiguous, equal-sized and disjoint;
    otherwise, or on one host or with the hosts unknown, ``(1, n)``: no
    hierarchy, flat collectives.  Interleaved hosts demote to flat loudly."""
    n = mesh.shape[axis_name]
    if local_size:
        if n % local_size:
            raise ValueError(
                f"collective_local_size {local_size} does not divide the "
                f"{axis_name!r} axis size {n}"
            )
        return n // local_size, local_size
    if not mesh.hosts:
        return 1, n
    # The hosts of each position's ranks (one host on a 1-D mesh; an inner
    # row's hosts on a 2-D one).
    line = Mesh(mesh.shape, rank=mesh.rank).line((axis_name,))
    names = mesh.axis_names
    inner = [a for a in names if a != axis_name]
    owners = []
    for r in line:
        row = Mesh(mesh.shape, rank=r).line(inner) if inner else [r]
        owners.append(frozenset(mesh.hosts[x] for x in row))
    runs = []
    for o in owners:
        if runs and runs[-1][0] == o:
            runs[-1][1] += 1
        else:
            runs.append([o, 1])
    lengths = {length for _, length in runs}
    if len(runs) <= 1 or len(lengths) != 1:
        return 1, n
    sets = [o for o, _ in runs]
    if len(set(sets)) != len(sets) or len(frozenset().union(*sets)) != sum(len(s) for s in sets):
        logger.warning(
            "%s axis of this mesh has interleaved host groups; demoting to "
            "flat collectives (no contiguous equal host grouping)", axis_name,
        )
        return 1, n
    return len(runs), lengths.pop()


class MeshManager:
    """Owns the current mesh.  A world is fixed per process in the port
    (a membership change restarts the worker), so ``reform`` rebuilds the
    mesh over the same world: the ``dcn_parallelism`` fallback and the
    ``(dp, tp)`` resolution of the reference's resize, and nothing else."""

    def __init__(self, dcn_parallelism: int = 1, hosts: Sequence[str] = (),
                 tensor_parallelism: int = 1):
        self._dcn = dcn_parallelism
        self._tp = max(1, int(tensor_parallelism))
        self._hosts = tuple(hosts)
        self._mesh: Optional[Mesh] = None
        self._version = -1

    @property
    def mesh(self) -> Mesh:
        if self._mesh is None:
            self.reform(version=0)
        assert self._mesh is not None
        return self._mesh

    @property
    def version(self) -> int:
        return self._version

    def reform(self, version: int) -> Mesh:
        n = _world()[0]
        dcn, tp = self._dcn, 1
        if self._tp > 1:
            dp0, tp0 = resolve_2d_shape(n, self._tp)
            dp, tp = resolve_world_shape(n, self._tp)
            if (dp, tp) != (dp0, tp0):
                logger.warning(
                    "tensor_parallelism=%d: %d ranks factor to dp=%d x tp=%d with %d "
                    "left over, and no rank can sit out of the world; tp degrades to "
                    "%d (dp=%d)", self._tp, n, dp0, tp0, n - dp0 * tp0, tp, dp,
                )
        elif dcn > 1 and n % dcn:
            # Training availability beats layout (the reference's fallback):
            # a world the configured hierarchy does not divide trains flat.
            logger.warning(
                "dcn_data_parallelism=%d does not divide %d ranks; falling "
                "back to a flat 1-D mesh", dcn, n,
            )
            dcn = 1
        old = mesh_shape(self._mesh) if self._mesh is not None else None
        self._mesh = create_mesh(dcn, self._hosts, tensor_parallelism=tp)
        new = mesh_shape(self._mesh)
        logger.info("membership v%d -> mesh of %d ranks (%s -> dp%dxtp%d)", version,
                    self._mesh.size, "none" if old is None else "dp%dxtp%d" % old, *new)
        self._version = version
        return self._mesh

    def num_devices(self) -> int:
        return self.mesh.size
