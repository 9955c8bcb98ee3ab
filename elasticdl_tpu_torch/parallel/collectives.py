"""The collective layer every gradient and metric reduction of the port
routes through.

Port of ``elasticdl_tpu/parallel/collectives.py`` onto
``torch.distributed`` process groups (``parallel/mesh.py``).

**Hierarchical reduce** (``--collective hierarchical|flat|auto``): the
data-parallel axis of ``n`` ranks factors into ``(n_host, n_local)``
(``mesh.dp_factorization``: the ranks' hosts, or
``--collective_local_size`` to pin or emulate it).  A big buffer then
reduces in three steps, as the reference's ``_hier_reduce_leaf``:

    1. ``reduce_scatter_tensor`` in the intra-host group: each local rank
       ends with 1/n_local of its host's partial sum;
    2. ``all_reduce`` of that part in the inter-host group;
    3. ``all_gather_into_tensor`` in the intra-host group.

Leaves under ``min_elems`` take one flat ``all_reduce``.  ``Reducer.psum``
and ``Reducer.pmean`` take a dict of tensors (the gradient tree) and
reduce it as few flat buffers (one per route and dtype), not one call per
leaf.

**Timeout-bounded participation** (the contributor mask): a contribution
scaled by this rank's 0/1 ``contributor_weight`` and a mean renormalised
by the mask's sum is the reference's ``sum / |G'|``.  With an all-ones mask
every formula is the plain route bit for bit (multiplying by 1.0 and
dividing by the exact count ``n`` change nothing).

**Backends.**  NCCL reduces card tensors on the card.  gloo reduces them
too: in the installed PyTorch its CUDA path takes ``all_reduce``,
``reduce_scatter_tensor`` and ``all_gather_into_tensor`` on card tensors
and copies through host memory itself (checked on an H100, PyTorch 2.11),
so the port hands it card tensors as they are.

**The sharded state's collectives** (the ParameterServer strategy's
lookups, the sharded optimizer): ``Reducer.all_gather``,
``reduce_scatter`` and ``all_to_all``, and ``psum_scatter`` (a
reduce-scatter over one axis's group, flat on the wire, shard ``i`` on
axis position ``i``, as the reference's).  Every call goes through
``Reducer._collective``, which times it by tag and op (``by_op``) and, when
the backend refuses or a peer is gone, raises ``CollectiveFailed`` naming
the op; nothing retries or moves a tensor elsewhere.

**The tensor-parallel pair** (the 2-D ``(dp, tp)`` mesh): Megatron's *g*
(``tp_all_reduce``: a sum over the ``tp`` group forward, the identity
backward) and *f* (``tp_grad_sync``: the identity forward, a sum over
``tp`` backward), each an ``autograd.Function`` over the tp line's group
and flat on the wire, as the reference's custom-VJP pair.

**The ring's rotation** (``Reducer.ring_shift``, sequence parallelism):
every rank of an axis line sends a block to the next position and receives
the previous position's, one ``isend``/``irecv`` pair a tensor.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

FLAT = "flat"
HIERARCHICAL = "hierarchical"
AUTO = "auto"
MODES = (FLAT, HIERARCHICAL, AUTO)

#: Leaves smaller than this reduce with ONE flat collective even under a
#: hierarchical topology (``--collective_min_elems``).
DEFAULT_MIN_ELEMS = 4096

Axes = Union[str, Sequence[str]]


def _as_axes(axes: Axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


class CollectiveTopology:
    """The factorization one mesh's reduce axis resolves to.

    ``axis``'s ``n = n_host * n_local`` positions group contiguously:
    position ``h * n_local + l`` is local replica ``l`` of host ``h``.
    ``local_groups``/``cross_groups`` are those position tables (the
    reference's ``axis_index_groups``); ``local_pg``/``cross_pg`` the
    process groups of this rank's intra-host and inter-host lines."""

    def __init__(self, axis: str, n_host: int, n_local: int,
                 min_elems: int = DEFAULT_MIN_ELEMS, local_pg=None, cross_pg=None):
        self.axis = axis
        self.n_host = int(n_host)
        self.n_local = int(n_local)
        self.min_elems = int(min_elems)
        self.local_groups = [
            [h * self.n_local + l for l in range(self.n_local)] for h in range(self.n_host)
        ]
        self.cross_groups = [
            [h * self.n_local + l for h in range(self.n_host)] for l in range(self.n_local)
        ]
        self.local_pg = local_pg
        self.cross_pg = cross_pg

    @property
    def hierarchical(self) -> bool:
        """Both factors non-trivial; else the route is a flat reduce."""
        return self.n_host > 1 and self.n_local > 1

    def describe(self) -> dict:
        return {
            "axis": self.axis,
            "n_host": self.n_host,
            "n_local": self.n_local,
            "hierarchical": self.hierarchical,
            "min_elems": self.min_elems,
        }

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"CollectiveTopology({self.axis!r}, host={self.n_host}, local={self.n_local})"


def resolve_topology(
    mesh,
    axes: Sequence[str],
    mode: str = AUTO,
    local_size: int = 0,
    min_elems: int = DEFAULT_MIN_ELEMS,
) -> Optional[CollectiveTopology]:
    """The collective mode of one mesh: a topology with the hierarchical
    route armed for the outer axis, or None (flat everything).

    ``flat`` never factors; ``hierarchical`` factors by ``local_size`` (or
    the ranks' hosts) and is None when no factorization exists; ``auto``
    goes hierarchical exactly when the mesh has a real multi-host,
    multi-local grouping (or ``local_size`` says to emulate one).  Every
    rank must call this with the same arguments: the subgroups are
    collective to make."""
    if mode not in MODES:
        raise ValueError(f"collective mode must be one of {MODES}, got {mode!r}")
    if mode == FLAT or not axes:
        return None
    import torch.distributed as dist

    from elasticdl_tpu_torch.parallel.mesh import Mesh, dp_factorization

    axis = axes[0]
    n_host, n_local = dp_factorization(mesh, axis, local_size=local_size)
    topo = CollectiveTopology(axis, n_host, n_local, min_elems=min_elems)
    if not topo.hierarchical:
        return None
    assert n_host * n_local == mesh.shape[axis]
    # The world ranks of every position of this rank's line along the axis,
    # then every intra-host and inter-host group of it, made in one order.
    line = mesh.line((axis,))
    n_world = mesh.size
    lines = sorted({tuple(Mesh(mesh.shape, rank=r).line((axis,))) for r in range(n_world)})
    for ranks in lines:
        for table, attr in ((topo.local_groups, "local_pg"), (topo.cross_groups, "cross_pg")):
            for positions in table:
                members = [ranks[p] for p in positions]
                pg = dist.new_group(members)
                if tuple(ranks) == tuple(line) and mesh.rank in members:
                    setattr(topo, attr, pg)
    return topo


def contributor_count(mesh, axes: Axes) -> int:
    """How many contributor-mask slots this mesh's batch axes carry."""
    n = 1
    for a in _as_axes(axes):
        n *= int(mesh.shape[a])
    return n


def contributor_index(mesh, axes: Axes) -> int:
    """This rank's row-major linear index over ``axes``: its slot in the
    replicated mask."""
    idx = 0
    for a in _as_axes(axes):
        idx = idx * int(mesh.shape[a]) + mesh.position(a)
    return idx


def contributor_weight(active, mesh, axes: Axes) -> float:
    """This rank's 0/1 participation weight: ``active[contributor_index]``.
    A contribution times this weight is the subgroup psum: an excluded
    rank still takes part in the collective but adds exactly zero, and a
    mean divides by the mask's sum, |G'|."""
    return float(active[contributor_index(mesh, axes)])


def leaf_elems(x) -> int:
    """Element count of one leaf (shapeless scalars count 1): what the
    ``min_elems`` routing and the bytes model both judge."""
    shape = getattr(x, "shape", ())
    return int(np.prod(shape)) if len(shape) else 1


class CollectiveFailed(RuntimeError):
    """A collective call failed (a peer is gone, the group timed out, or
    the backend refused the tensors); the message names the op."""


class Reducer:
    """The collectives of one mesh: the group of each reduction and the
    seconds spent inside the collective calls (``seconds``, ``calls``, and
    per ``"<tag>:<op>"`` one ``[calls, seconds]`` record, read as
    ``by_op`` (seconds) and ``calls_by_op``: ``grads`` for the gradient and
    metric reductions, ``lookup`` for the sharded embedding routes, ``zero`` for
    the sharded optimizer, ``snapshot`` for the gathers of a canonical
    state).  Under gloo the call returns once the reduction is done; on card
    tensors the stream's earlier work is waited for first, outside the
    clock, so ``seconds`` is the collective's own.  Under NCCL the call
    only enqueues, and ``seconds`` is the host's enqueue time.  A call
    onto a stream that a CUDA graph captures (``capturing``) is recorded,
    not run: it goes to the capture's tally, and each replay of the graph
    adds the tally's calls and their enqueue seconds (``add_replay``), so
    the counters read as they would after the same steps run eagerly."""

    def __init__(self, mesh, topo: Optional[CollectiveTopology] = None):
        self.mesh = mesh
        self.topo = topo
        # The counters are bumped by the task loop and by the checkpoint
        # thread's snapshot gathers.
        self._lock = threading.Lock()  # lock-order: leaf
        self.seconds = 0.0
        self.calls = 0
        self._ops: Dict[str, List] = {}  # "<tag>:<op>": [calls, seconds]
        self._capture_tally: Optional[Dict[str, List]] = None

    @property
    def by_op(self) -> Dict[str, float]:
        """The seconds by ``"<tag>:<op>"``."""
        with self._lock:
            return {key: dt for key, (_, dt) in self._ops.items()}

    @property
    def calls_by_op(self) -> Dict[str, int]:
        """The calls by ``"<tag>:<op>"``."""
        with self._lock:
            return {key: n for key, (n, _) in self._ops.items()}

    def _add(self, key: str, n: int, dt: float) -> None:
        """``n`` calls of ``key`` that took ``dt`` seconds ran."""
        with self._lock:
            self.calls += n
            self.seconds += dt
            entry = self._ops.setdefault(key, [0, 0.0])
            entry[0] += n
            entry[1] += dt

    @contextmanager
    def capturing(self) -> Iterator[Dict[str, List]]:
        """The calls recorded while a CUDA graph captures: yields the tally
        ``{"<tag>:<op>": [calls, seconds]}`` that each replay adds with
        ``add_replay``.  Only calls onto a capturing stream go there (the
        checkpoint thread's gathers run as ever).  One capture at a time."""
        with self._lock:
            if self._capture_tally is not None:
                raise RuntimeError("a capture is already open")
            tally: Dict[str, List] = {}
            self._capture_tally = tally
        try:
            yield tally
        finally:
            with self._lock:
                self._capture_tally = None

    def add_replay(self, tally: Dict[str, List]) -> None:
        """One replay of a captured graph: its recorded calls ran."""
        for key, (n, dt) in tally.items():
            self._add(key, n, dt)

    def _collective(self, fn, group, tensors: List[torch.Tensor], op: str = "all_reduce",
                    tag: str = "grads") -> None:
        import torch.distributed as dist

        if tensors[0].is_cuda and dist.get_backend(group) == "gloo":
            torch.cuda.current_stream().synchronize()
        t0 = time.perf_counter()
        try:
            fn()
        except Exception as e:
            where = "card" if tensors[0].is_cuda else "host"
            raise CollectiveFailed(f"{op} ({tag}) of {where} tensors failed: {e}") from e
        dt = time.perf_counter() - t0
        key = f"{tag}:{op}"
        with self._lock:
            if (self._capture_tally is not None and tensors[0].is_cuda
                    and torch.cuda.is_current_stream_capturing()):
                entry = self._capture_tally.setdefault(key, [0, 0.0])
                entry[0] += 1
                entry[1] += dt
                return
        self._add(key, 1, dt)

    def all_reduce(self, buf: torch.Tensor, group, tag: str = "grads") -> torch.Tensor:
        import torch.distributed as dist

        self._collective(lambda: dist.all_reduce(buf, group=group), group, [buf],
                         "all_reduce", tag)
        return buf

    def all_gather(self, x: torch.Tensor, group, tag: str = "grads") -> torch.Tensor:
        """Every rank's ``x`` (equal sizes), flat, in group-rank order:
        ``[n * x.numel()]`` (``all_gather_into_tensor``)."""
        import torch.distributed as dist

        flat = x.reshape(-1).contiguous()
        out = flat.new_empty(dist.get_world_size(group) * flat.numel())
        self._collective(lambda: dist.all_gather_into_tensor(out, flat, group=group),
                         group, [flat], "all_gather", tag)
        return out

    def reduce_scatter(self, flat: torch.Tensor, group, tag: str = "grads") -> torch.Tensor:
        """The sum over the group of ``flat`` (``[n * k]``), chunk ``i`` to
        group rank ``i`` (``reduce_scatter_tensor``): this rank's ``[k]``."""
        import torch.distributed as dist

        n = dist.get_world_size(group)
        if flat.numel() % n:
            raise ValueError(f"reduce_scatter of {flat.numel()} elements over {n} ranks")
        flat = flat.contiguous()
        out = flat.new_empty(flat.numel() // n)
        self._collective(lambda: dist.reduce_scatter_tensor(out, flat, group=group),
                         group, [flat], "reduce_scatter", tag)
        return out

    def all_to_all(self, out: torch.Tensor, x: torch.Tensor, group,
                   tag: str = "lookup") -> torch.Tensor:
        """``all_to_all_single`` along dim 0 in equal chunks: chunk ``j`` of
        ``x`` to group rank ``j``, chunk ``j`` of ``out`` from it.  No split
        size comes to the host, so the call records into a CUDA graph like
        the other calls."""
        import torch.distributed as dist

        self._collective(lambda: dist.all_to_all_single(out, x, group=group),
                         group, [x], "all_to_all", tag)
        return out

    def ring_shift(self, tensors: List[torch.Tensor], group, shift: int = 1,
                   tag: str = "ring") -> List[torch.Tensor]:
        """Each of ``tensors`` sent to the position ``shift`` ahead on
        ``group``'s line, and the one ``shift`` behind received in its place
        (fresh tensors): one ``isend``/``irecv`` pair a tensor, all posted
        together (``batch_isend_irecv``), so no rank blocks in a send before
        its receive is posted.  gloo moves host memory only: card tensors
        cross through host copies there, inside the timed call."""
        import torch.distributed as dist

        n = dist.get_world_size(group)
        me = dist.get_group_rank(group, dist.get_rank())
        to = dist.get_global_rank(group, (me + shift) % n)
        frm = dist.get_global_rank(group, (me - shift) % n)
        device = tensors[0].device
        staged = tensors[0].is_cuda and dist.get_backend(group) == "gloo"
        out: List[torch.Tensor] = []

        def run() -> None:
            sends = [t.detach().contiguous() for t in tensors]
            if staged:
                sends = [t.cpu() for t in sends]
            recvs = [torch.empty_like(t) for t in sends]
            ops = ([dist.P2POp(dist.isend, t, to, group) for t in sends]
                   + [dist.P2POp(dist.irecv, t, frm, group) for t in recvs])
            for work in dist.batch_isend_irecv(ops):
                work.wait()
            out.extend(t.to(device) for t in recvs)

        self._collective(run, group, list(tensors), "p2p", tag)
        return out

    def _hier_reduce(self, flat: torch.Tensor) -> torch.Tensor:
        """The 3-step hierarchical all-reduce of one flat buffer over
        ``topo.axis``: zero-padded to n_local divisibility (exact for a
        sum), reduce-scattered in the host group, all-reduced across
        hosts, all-gathered in the host group."""
        import torch.distributed as dist

        topo = self.topo
        n = flat.numel()
        pad = (-n) % topo.n_local
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        part = flat.new_empty(flat.numel() // topo.n_local)
        self._collective(
            lambda: dist.reduce_scatter_tensor(part, flat, group=topo.local_pg),
            topo.local_pg, [flat], "reduce_scatter")
        self.all_reduce(part, topo.cross_pg)
        full = flat.new_empty(flat.numel())
        self._collective(
            lambda: dist.all_gather_into_tensor(full, part, group=topo.local_pg),
            topo.local_pg, [part], "all_gather")
        return full[:n]

    def psum(self, tree: Dict[str, torch.Tensor], axes: Axes) -> Dict[str, torch.Tensor]:
        """Sum every tensor of ``tree`` over the named mesh axes.  Leaves
        at or above the topology's ``min_elems`` take the hierarchical
        route when it covers an axis; the rest one flat ``all_reduce``;
        each route one flat buffer per dtype.  Returns views into the
        reduced buffers; the inputs are not modified."""
        names = _as_axes(axes)
        group = self.mesh.group(names)
        if group is None:  # a line of one rank: the sum is the input
            return dict(tree)
        topo = self.topo
        hier_axis = topo is not None and topo.hierarchical and topo.axis in names
        routes: Dict[tuple, List[str]] = {}
        for key, x in tree.items():
            big = hier_axis and leaf_elems(x) >= topo.min_elems
            routes.setdefault((big, x.dtype, x.device), []).append(key)
        out: Dict[str, torch.Tensor] = {}
        for (big, _dtype, _device), keys in routes.items():
            flat = torch.cat([tree[k].reshape(-1) for k in keys])
            if big:
                rest = tuple(a for a in names if a != topo.axis)
                rest_group = self.mesh.group(rest) if rest else None
                if rest_group is not None:
                    self.all_reduce(flat, rest_group)
                flat = self._hier_reduce(flat)
            else:
                self.all_reduce(flat, group)
            at = 0
            for k in keys:
                n = leaf_elems(tree[k])
                out[k] = flat[at:at + n].view(tree[k].shape)
                at += n
        return out

    def pmean(self, tree: Dict[str, torch.Tensor], axes: Axes) -> Dict[str, torch.Tensor]:
        """``psum / n`` with the same routing."""
        n = contributor_count(self.mesh, axes)
        return {k: v / n for k, v in self.psum(tree, axes).items()}


def psum_scatter(x: torch.Tensor, axis: str, reducer: Reducer, tag: str = "zero") -> torch.Tensor:
    """The reference's ``psum_scatter(x, axis, tiled=True)`` over the
    port's process groups: ``x`` flattened and summed over ``axis``'s group
    by one ``reduce_scatter``, flat on the wire, this rank's ``1/n`` chunk
    returned (shard ``i`` on axis position ``i``).  A line of one rank
    keeps the input."""
    flat = x.reshape(-1)
    group = reducer.mesh.group((axis,))
    return flat if group is None else reducer.reduce_scatter(flat, group, tag)


class _TpAllReduce(torch.autograd.Function):
    """Megatron's *g*: the sum over the tp group forward, the identity
    backward (the cotangent at a sum's output is already replicated over
    the tp ranks, and each rank's partial contributed to it linearly)."""

    @staticmethod
    def forward(ctx, x, reducer, group):
        return reducer.all_reduce(x.clone(), group, tag="tp")

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _TpGradSync(torch.autograd.Function):
    """Megatron's *f*: the identity forward, the sum over the tp group
    backward (every tp rank's branch consumed the replicated activation,
    so its gradient is the sum of the ranks' partials)."""

    @staticmethod
    def forward(ctx, x, reducer, group):
        ctx.reducer, ctx.group = reducer, group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.reducer.all_reduce(g.contiguous().clone(), ctx.group, tag="tp"), None, None


def tp_all_reduce(x: torch.Tensor, reducer: Reducer, group) -> torch.Tensor:
    """Megatron's *g* over the tensor-parallel line ``group`` (after each
    row-split matmul): the partial activations summed forward, the
    cotangent passed through backward.  Flat (no hierarchical route): the
    mesh puts ``tp`` on consecutive ranks, and the per-block activation is
    far below any residue worth scattering.  ``group`` None (a line of one
    rank): the identity.  A failed sum raises ``CollectiveFailed``."""
    return x if group is None else _TpAllReduce.apply(x, reducer, group)


def tp_grad_sync(x: torch.Tensor, reducer: Reducer, group) -> torch.Tensor:
    """Megatron's *f* over ``group`` (on the replicated activation after
    each norm, before a column-split matmul): the identity forward, the
    partial cotangents summed backward, so the norm gains and everything
    upstream see the whole gradient.  ``group`` None: the identity."""
    return x if group is None else _TpGradSync.apply(x, reducer, group)


def interhost_bytes_per_step(
    leaf_sizes: Sequence[int],
    n_replicas: int,
    topo: Optional[CollectiveTopology] = None,
    itemsize: int = 4,
) -> int:
    """Analytic per-replica inter-host bytes of one step's gradient
    all-reduce over ``leaf_sizes`` (element counts): a flat all-reduce
    moves ``2 * size * (n-1)/n`` elements a replica; the hierarchical
    route's only inter-host step moves ``2 * (size/n_local) *
    (n_host-1)/n_host``.  Leaves below ``min_elems`` are flat either way."""
    if n_replicas <= 1:
        return 0
    total = 0.0
    for size in leaf_sizes:
        if topo is not None and topo.hierarchical and size >= topo.min_elems:
            residue = -(-size // topo.n_local)
            total += 2.0 * residue * (topo.n_host - 1) / topo.n_host
        else:
            total += 2.0 * size * (n_replicas - 1) / n_replicas
    return int(total * itemsize)
