"""The trainer of the PyTorch port: single-device training, evaluation
and prediction, and the canonical state checkpoints store.

Port of ``elasticdl_tpu/parallel/trainer.py``: ``TrainState``,
``Trainer.init_state``, ``run_train_step``, the synchronous loop of
``run_train_steps``, ``train_step`` (the single-device reading of
``build_train_step``'s ``local_step``), the eval step (``eval_step``,
``run_eval_step``, ``build_eval_step``), the predict path
(``run_predict_step``, ``build_predict_step``) the serving tier runs, and
the canonical state (``host_state``, ``snapshot_state``,
``adopt_restored``: the reference's ``host_state``, ``snapshot_state``,
``restore_template`` and ``adopt_restored``), the host half of the host
tier (below), and the fused task dispatch (``shard_stacked_batch``,
``train_scan``, ``eval_scan``: the reference's ``lax.scan`` over a task's
T steps, here one captured CUDA graph a task; below).

Data parallelism over a process group (``mesh``: ``parallel/mesh.py``):
each rank owns one device and holds the whole state; every rank feeds the
same global batch and ``shard_batch`` takes its part (the reference's
``_batch_spec_for``): a data-parallel model's contiguous slice of the
examples over the reduce axes; a sequence-parallel model's examples over
the outer axes and its slice of each sequence over the last one (the ring
runs in the forward and the backward, ``ops/ring_attention.py``).  A step
weighs the loss by ``count / psum(count)`` (or ``w / psum(w)`` without a
mask: this rank's contributor weight over the active ranks' count), sums
the gradients, the loss and the metrics over the reduce axes through
``collectives`` in one reduction, then steps the optimizer, so a failed
collective leaves the module and the optimizer as they were
(``CollectiveError``).  Eval reduces the same way.

**Tensor parallelism** (a spec with ``tensor_sharding`` on a ``(dp, tp)``
mesh): each rank's module holds its slice of every planned weight (the
columns or rows on the plan's dim, ``shard_parameters``), the forward's
tp sums run inside ``apply`` (``ParallelContext.tp_group``), and the
reductions run over ``dp`` alone (``reduce_axes``): the tp ranks see the
same examples, *f* and *g* leave the replicated leaves' gradients whole
on every rank, and a shard's gradient is its own, so a sum over ``tp``
would count them ``tp`` times.  The sharded optimizer leaves the shards
alone (``_OPT_KEEP``); the canonical state holds them whole (gathered on
their dim, sliced again by ``adopt_restored``).

**Sharded state** (the reference's ParameterServer half, read from the
job config):

- ``--distribution_strategy=ParameterServer`` with a spec that declares
  ``embedding_tables``: each table is row-sharded over the mesh's LAST
  axis (``axis_name``; ``dp`` itself on a flat ``{dp: n}`` mesh, ``ep`` on
  ``(dp, ep)``).  The module's table parameter holds this rank's ``P / n``
  physical rows, the forward's lookup is collective (``ParallelContext``,
  ``ops/embedding.py``), and the table's gradient, which the lookup's
  backward already summed over the table axis, is reduced over the other
  axes only (``_tree_psum_except``: on a flat mesh not at all; summing it
  over the table axis too would multiply it by ``n``).
- ``--optimizer_sharding=sharded`` (or ``auto`` past
  ``--optimizer_sharding_auto_mb`` of moments): the ZeRO-style update over
  the OUTER (``dp``) axis.  Every dense leaf is flattened and zero-padded
  to ``padded`` (a multiple of ``n``); this rank keeps shard ``[padded /
  n]`` of each as a parameter of its optimizer (views into one flat
  buffer); the gradient is reduce-scattered instead of all-reduced, the
  optimizer steps the shards (and the local table rows), and an all-gather
  writes the updated shards back into the full leaves.  That is the
  reference's gather-the-updates-then-apply, since Adam(W) is elementwise
  and neither model clips by a global norm.  Table leaves keep their
  co-sharded moments (``_OPT_KEEP``).

``--embedding_lookup_impl`` picks the lookup route (``resolve_impl``); a
value of any of the three flags the port cannot honour raises.  Every
collective of a step runs before ``optimizer.step()`` except the sharded
optimizer's all-gather, which runs right after it: when that one fails,
the shards have stepped and the full leaves have not, so it raises
``CollectiveError`` with ``state_intact=False`` and the caller rebuilds
from a checkpoint (the reference's gangs always resume from the periodic
checkpoint).

The canonical state is a flat ``{path: numpy array}`` dict, whatever the
world and layout that wrote it (whole tables, param-shaped moments):

- ``params/<p>``: each parameter, ``<p>`` its module path with ``/`` for
  ``.`` — the JAX parameter-tree path (``params/blocks/b0/wqkv``), as
  ``transformer_lm.params_to_jax`` gives it;
- ``opt_state/mu/<p>`` and ``opt_state/nu/<p>``: the Adam(W) moments (optax's
  ``ScaleByAdamState`` ``mu``/``nu``; torch's ``exp_avg``/``exp_avg_sq``),
  and ``opt_state/count``, the optimizer's update count;
- or, for SGD with momentum, ``opt_state/trace/<p>`` (optax's
  ``TraceState`` ``trace``; torch's ``momentum_buffer``) and no count;
- ``step``: the step.

With sharded state, ``snapshot_state`` (and ``host_state``) gathers the
tables' rows and the flat moments from the ranks: a collective every rank
must call at the same point; ``adopt_restored`` slices a canonical state
into this rank's layout without one.

**The host tier** (``spec.host_io``, the reference's pull/inject/push):
each table's rows live in a native store, in this process
(``HostEmbeddingStore``) or behind the PS service's shards
(``RemoteEmbeddingStore``, when ``config.ps_addresses`` is set; a world of
more than one rank needs it).  A step computes the batch's ids on the host,
pulls their rows (this rank's contributor slice only), uploads them from
pinned memory as a leaf the step differentiates, and right after
``backward`` starts the copy of the leaf's gradient into pinned host memory
with an event behind it (``HostGrad``); the push reads that copy and is the
step's one wait for the device (the loss and the metrics stay there).  With
``use_async`` up to ``async_staleness`` pushes stay outstanding while the
next batches pull and their steps are enqueued: the reference's async-PS
window, rows one (or D) pushes stale, the dense state exact.  A failed pull
or push fails the run through ``TrainLoopError``; it is never skipped.
Host stores checkpoint beside the canonical state as
``host_stores/<step>/<key>.bin`` (native format), or, on a PS fleet, as each
shard's own slice.

**The fused task dispatch** (the reference's ``train_scan`` and
``eval_scan``, one dispatch a task): ``shard_stacked_batch`` uploads a
task's stacked ``[T, mb, ...]`` batch in one pinned copy a leaf into a
device buffer kept per batch variant, and on the card ``train_scan`` runs
the T steps as ONE ``torch.cuda.CUDAGraph``: the steps are captured once,
each reading its ``stacked[i]`` view and writing ``metrics[i]``, and each
later task of that variant is one replay.  The variant is the batch's keys,
shapes and dtypes (T included); each scan has the reference's budget of 4,
and a fifth variant raises ``ScanBudgetError`` (the reference's
``JitSanViolation``).  A variant runs its first task eagerly, and so does
a task whose optimizer slots are not laid out as the last eager task left
them (a restore): the capture needs the optimizer's slots and the
libraries' first-call work (cuBLAS and cuDNN workspaces, the kernels'
shared-memory attributes) done.  On the card the trainer turns on
``capturable`` in Adam(W), whatever the model's factory asked for, which
keeps the step count on the card, so a replay advances it (SGD with
momentum, the other optimizer the canonical state holds, updates on the
card alone).  The Python ``TrainState.step`` advances by T once a call.  A graph points at
the state's tensors, so every graph is dropped when the module, the
optimizer or any parameter, buffer or slot tensor is replaced (a restore,
a recovery): a stale graph would train tensors no one reads.  A failed
capture or replay raises ``TrainLoopError(None, ...)`` (recover from the
checkpoint; the reference's scan donates its state) and never falls back
to eager steps.  On the CPU, which the caller must ask for, both scans run
their steps eagerly, bit for bit the per-step loop.  Kernel launches and
collective calls under capture are counted at each replay
(``ops/kernels.capturing``, ``Reducer.capturing``).  Neither scan runs
with host-tier tables (as in the reference).

In a process group (a gang) the backend decides (``_scan_captures``,
logged once): over NCCL the steps' collectives are enqueued on the
capturing stream and recorded into the graph with the kernels, so a task
is one replay as alone; over gloo, whose calls wait for the stream on the
host (``Reducer._collective``), the scans run their steps eagerly, one
call a task, on the card as on the CPU.  Neither is a fallback of the
other.  The contributor weights are 0-d device tensors
(``_weight``, the reference's ``_active_device``) that
``set_active_contributors`` writes in place, so a replay reads the mask
set before it.  A row-sharded table scans on either lookup route: the
ragged one moves statically shaped buffers by equal-split all-to-alls, so
over NCCL the graph records them with the rest of the step.
"""

from __future__ import annotations

import dataclasses
import inspect
import os
import shutil
import time
from collections import deque
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from elasticdl_tpu_torch.common import durable, trace
from elasticdl_tpu_torch.common.config import DistributionStrategy
from elasticdl_tpu_torch.common.device import resolve_device, set_matmul_precision
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.common.metrics import HIST_PREFIX
from elasticdl_tpu_torch.models.spec import EmbeddingTableSpec, ModelSpec, shard_parameters
from elasticdl_tpu_torch.ops import kernels
from elasticdl_tpu_torch.ops.embedding import (
    IMPL_AUTO,
    ParallelContext,
    pack_table,
    resolve_impl,
    table_shape,
)
from elasticdl_tpu_torch.parallel import collectives as coll
from elasticdl_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh

logger = get_logger("parallel.trainer")

#: The padding mask of a batch: real examples 1.0, padding 0.0.  The loss
#: weighs by it; the model never sees it (the reference pops it too).
MASK_KEY = "__mask__"

#: Canonical-state path prefixes and keys (see the module docstring).
PARAMS, MU, NU = "params/", "opt_state/mu/", "opt_state/nu/"
TRACE = "opt_state/trace/"
COUNT_KEY, STEP_KEY = "opt_state/count", "step"

#: Each optimizer family's canonical slots: (torch's per-parameter state
#: name, the canonical prefix), and whether optax keeps an update count.
_ADAM_LAYOUT = ((("exp_avg", MU), ("exp_avg_sq", NU)), True)
_SGD_MOMENTUM_LAYOUT = ((("momentum_buffer", TRACE),), False)


def optimizer_layout(optimizer: torch.optim.Optimizer) -> Tuple[Tuple[Tuple[str, str], ...], bool]:
    """(slots, has_count) of ``optimizer`` in the canonical state: Adam and
    AdamW keep two moments and a count, SGD with momentum one trace.  Any
    other optimizer raises: its state would not survive a checkpoint."""
    if isinstance(optimizer, (torch.optim.Adam, torch.optim.AdamW)):
        return _ADAM_LAYOUT
    if isinstance(optimizer, torch.optim.SGD) and all(
            g["momentum"] > 0 and g["dampening"] == 0 for g in optimizer.param_groups):
        return _SGD_MOMENTUM_LAYOUT
    raise NotImplementedError(
        f"the canonical state holds Adam(W) and SGD with momentum (no dampening), "
        f"not {type(optimizer).__name__} with {optimizer.defaults}")

def make_capturable(optimizer: torch.optim.Optimizer) -> None:
    """Turn on ``capturable`` where the optimizer has it (Adam(W): its step
    count then lives on the card), whatever the model's factory asked
    for: the trainer that captures the update owns the choice.  SGD with
    momentum, the other optimizer ``optimizer_layout`` holds, has no host
    work in its update to begin with."""
    if "capturable" in optimizer.defaults:
        optimizer.defaults["capturable"] = True
        for group in optimizer.param_groups:
            group["capturable"] = True


#: ``--optimizer_sharding`` values.
OPT_MODES = ("replicated", "sharded", "auto")

#: The fused scans' variant budgets (the reference's ``jit_budgets``: full
#: tasks share one T, the job's last task adds a second; headroom beyond).
SCAN_BUDGETS = {"train_scan": 4, "eval_scan": 4}


class ScanBudgetError(RuntimeError):
    """A fused scan met more batch variants than its budget (the
    reference's ``JitSanViolation``): something upstream feeds a shape the
    job should not have."""


class ScanMetrics(dict):
    """A scan's metrics: ``{name: [T, ...] tensor}``, step i's in row i."""


class _Graph:
    """One captured scan: the graph, the stacked inputs it reads, the
    outputs it writes (``{name: [T, ...]}``), the kernel launches and the
    collective calls one replay runs, the capture's seconds and the bytes
    of its pool."""

    __slots__ = ("graph", "inputs", "outputs", "tally", "collectives", "capture_s",
                 "pool_bytes")

    def __init__(self, graph, inputs, outputs, tally, collectives, capture_s, pool_bytes):
        self.graph, self.inputs, self.outputs = graph, inputs, outputs
        self.tally, self.collectives = tally, collectives
        self.capture_s, self.pool_bytes = capture_s, pool_bytes


@dataclasses.dataclass
class TrainState:
    """The reference's ``TrainState(step, params, opt_state)``: here the
    module holds the parameters and the optimizer its moments.  A train
    step updates both in place (the reference donates its state) and
    returns a state with the next step number."""

    step: int
    model: torch.nn.Module
    optimizer: Optional[torch.optim.Optimizer]


class TrainLoopError(RuntimeError):
    """A step failed mid-run of ``run_train_steps`` (the reference's
    ``TrainLoopError``).

    A step updates the module and the optimizer in place, so a failure
    inside one leaves a state no one can vouch for.  ``state`` carries the
    state after the last completed step when the failure came before the
    failed step touched the module or the optimizer (the batch iterator or
    its placement on the device), or None: the worker then rebuilds from
    the checkpoint."""

    def __init__(self, state: Optional[TrainState], cause: BaseException):
        super().__init__(f"train loop failed: {cause!r}")
        self.state = state
        self.cause = cause


class CollectiveError(RuntimeError):
    """A collective of a train or eval step failed (a peer died, the
    group timed out).  ``state_intact``: the module and the optimizer are
    as they were before the step, which holds for every collective before
    the optimizer's update; only the sharded optimizer's all-gather after
    it leaves them torn (False)."""

    def __init__(self, message: str, state_intact: bool = True):
        super().__init__(message)
        self.state_intact = state_intact


class _OptShard:
    """How one dense leaf's optimizer slots lay out over the data-parallel
    axis: the canonical leaf flattens to ``[size]``, zero-pads to
    ``[padded]`` (a multiple of the shard count) and each rank keeps
    ``[padded / n]``, at ``offset`` in its flat shard buffer."""

    __slots__ = ("shape", "size", "padded", "offset")

    def __init__(self, shape: Tuple[int, ...], size: int, padded: int, offset: int):
        self.shape, self.size, self.padded, self.offset = shape, size, padded, offset

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"_OptShard(shape={self.shape}, size={self.size}, padded={self.padded})"


#: Plan marker for the leaves the dp-sharding leaves alone: row-sharded
#: tables and tensor-parallel shards, whose optimizer slots already
#: co-shard with them.
_OPT_KEEP = "keep"


def opt_shard_plan(
    params: List[Tuple[str, torch.Tensor]],
    tables: List[EmbeddingTableSpec],
    sharded_embeddings: bool,
    n_shards: int,
    tp_paths=(),
) -> Dict[str, Any]:
    """``{path: _OptShard or _OPT_KEEP}`` over the model's parameters in
    their order: ``_OPT_KEEP`` for row-sharded tables and the
    tensor-parallel leaves (``tp_paths``), an ``_OptShard`` (offsets packed
    in that order) for every other leaf."""
    table_paths = {"/".join(t.path) for t in tables} if sharded_embeddings else set()
    kept = table_paths | set(tp_paths)
    plan: Dict[str, Any] = {}
    offset = 0
    for path, p in params:
        if path in kept:
            plan[path] = _OPT_KEEP
            continue
        size = p.numel()
        padded = -(-size // n_shards) * n_shards
        plan[path] = _OptShard(tuple(p.shape), size, padded, offset)
        offset += padded // n_shards
    return plan


def _tree_psum_except(reducer: "coll.Reducer", tree: Dict[str, torch.Tensor], skip,
                      axes, skip_axes) -> Dict[str, torch.Tensor]:
    """psum ``tree`` over ``axes``, except the keys in ``skip``, which psum
    over ``skip_axes`` only (empty: left alone).  Sharded-table gradients
    come out of the collective lookup's backward already summed over the
    table axis; they still need the other axes' contributions (other
    examples), but summing them over the table axis again would multiply
    them by its size."""
    main = {k: v for k, v in tree.items() if k not in skip}
    rest = {k: v for k, v in tree.items() if k in skip}
    out = reducer.psum(main, axes) if main else {}
    if rest:
        out.update(reducer.psum(rest, skip_axes) if skip_axes else rest)
    return out


def _module_param(model: torch.nn.Module, path: Tuple[str, ...]):
    """(owning module, attribute name) of the parameter at ``path``."""
    module = model
    for name in path[:-1]:
        module = getattr(module, name)
    return module, path[-1]


def pad_embedding_tables(model: torch.nn.Module, tables: List[EmbeddingTableSpec]) -> None:
    """Bring each declared table parameter into the padded packed ``[P,
    pack*stride]`` layout (``ops/embedding.py``), in place, so its shape is
    the same over every mesh size; tables already in it stay as they are,
    plain ``[V, dim]`` or flat ``[V*dim]`` ones are packed and zero-padded."""
    for t in tables:
        module, name = _module_param(model, t.path)
        leaf = getattr(module, name)
        target = table_shape(t.vocab_size, t.dim)
        if leaf.dim() == 2 and tuple(leaf.shape) == target:
            continue
        with torch.no_grad():
            packed = pack_table(leaf.detach(), t.dim)
        if packed.shape[1] != target[1] or packed.shape[0] > target[0]:
            raise ValueError(
                f"table {t.path}: shape {tuple(leaf.shape)} packs to "
                f"{tuple(packed.shape)}, incompatible with the declared vocab "
                f"{t.vocab_size} x dim {t.dim} (padded shape {target})"
            )
        if packed.shape[0] < target[0]:
            packed = torch.cat([packed, packed.new_zeros(target[0] - packed.shape[0], target[1])])
        setattr(module, name, torch.nn.Parameter(packed))


class _ZeroShards:
    """This rank's shards of the dense leaves under the sharded optimizer:
    one flat buffer ``buf`` of ``sum(padded / n)`` elements, and per leaf a
    parameter viewing its ``[padded / n]`` slice (``params``, which the
    optimizer steps).  The model's full leaves stay the ones the forward
    reads."""

    def __init__(self, leaves: List[Tuple[str, torch.nn.Parameter, _OptShard]],
                 n: int, pos: int):
        dtypes = {p.dtype for _, p, _ in leaves}
        if len(dtypes) != 1:
            raise ValueError(f"the sharded optimizer needs one parameter dtype, got {dtypes}")
        self.leaves, self.n, self.pos = leaves, n, pos
        self.total = sum(e.padded // n for _, _, e in leaves)
        self.buf = torch.zeros(self.total, dtype=dtypes.pop(), device=leaves[0][1].device)
        self.params = [torch.nn.Parameter(self.buf[e.offset:e.offset + e.padded // n])
                       for _, _, e in leaves]
        self.refresh()

    def refresh(self) -> None:
        """The shards from the live full leaves (after a load)."""
        with torch.no_grad():
            for (_, p, e), shard in zip(self.leaves, self.params):
                shard.copy_(self.split(p.detach().reshape(-1), e))

    def split(self, flat: torch.Tensor, e: _OptShard) -> torch.Tensor:
        """This rank's ``[padded / n]`` chunk of a flat ``[size]`` leaf."""
        k = e.padded // self.n
        lo, hi = self.pos * k, min((self.pos + 1) * k, e.size)
        part = flat[lo:hi] if hi > lo else flat[:0]
        return torch.nn.functional.pad(part, (0, k - part.numel()))

    def grad_buffer(self) -> torch.Tensor:
        """Every leaf's flat padded gradient laid out for one reduce-scatter:
        ``[n, total]``, row ``i`` the concatenation of each leaf's chunk
        ``i``, flattened."""
        rows = []
        for _, p, e in self.leaves:
            g = p.grad.reshape(-1) if p.grad is not None else p.new_zeros(e.size)
            rows.append(torch.nn.functional.pad(g, (0, e.padded - e.size)).view(self.n, -1))
        return torch.cat(rows, dim=1).reshape(-1)

    def set_grads(self, shard: torch.Tensor) -> None:
        for (_, _, e), p in zip(self.leaves, self.params):
            p.grad = shard[e.offset:e.offset + e.padded // self.n]

    def unflatten(self, full: torch.Tensor, e: _OptShard) -> torch.Tensor:
        """A leaf in its shape from an all-gathered ``[n * total]`` buffer."""
        k = e.padded // self.n
        return full.view(self.n, self.total)[:, e.offset:e.offset + k].reshape(-1)[:e.size].view(e.shape)

    def write_back(self, full: torch.Tensor) -> None:
        """The gathered updated shards into the full leaves."""
        with torch.no_grad():
            for _, p, e in self.leaves:
                p.copy_(self.unflatten(full, e))


class HostGrad:
    """A host-tier table's gradient on its way to the store.  On the card
    the copy into pinned host memory is started without waiting and an
    event recorded behind it; ``numpy()`` waits for that event alone, the
    step's one synchronisation with the device."""

    __slots__ = ("tensor", "event")

    def __init__(self, grad: torch.Tensor):
        grad = grad.detach()
        if grad.is_cuda:
            self.tensor = torch.empty(grad.shape, dtype=grad.dtype, pin_memory=True)
            self.tensor.copy_(grad, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.tensor, self.event = grad, None

    def numpy(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.tensor.numpy()


def _zero_of(optimizer) -> Optional[_ZeroShards]:
    return getattr(optimizer, "_zero_shards", None)


class Snapshot(dict):
    """A canonical state of device copies (``Trainer.snapshot_state``);
    ``ready``: on the card, the event recorded after the copies."""

    ready: Optional[Any] = None


class Trainer:
    """Owns the device; trains the model and runs its predict forward."""

    def __init__(self, spec: ModelSpec, device: Any = None, mesh: Optional[Mesh] = None,
                 config: Any = None):
        self.spec = spec
        self.device = resolve_device(device)
        self.config = config
        set_matmul_precision()
        # The three flags of the sharded state, checked here: a value the
        # port cannot honour raises, never falls back.
        self.strategy = getattr(config, "distribution_strategy", DistributionStrategy.ALLREDUCE)
        if self.strategy not in DistributionStrategy.ALL:
            raise ValueError(f"--distribution_strategy must be one of "
                             f"{DistributionStrategy.ALL}, got {self.strategy!r}")
        self.optimizer_sharding = getattr(config, "optimizer_sharding", "replicated")
        if self.optimizer_sharding not in OPT_MODES:
            raise ValueError(f"--optimizer_sharding must be one of {OPT_MODES}, "
                             f"got {self.optimizer_sharding!r}")
        self.embedding_lookup_impl = getattr(config, "embedding_lookup_impl", IMPL_AUTO)
        resolve_impl(self.embedding_lookup_impl)  # raises on an unknown route
        self._apply_takes_ctx = "ctx" in inspect.signature(spec.apply).parameters
        self._predict_takes_ctx = spec.predict is not None and (
            "ctx" in inspect.signature(spec.predict).parameters)
        # The sharded optimizer's plan, resolved per state (``init_state``);
        # None: the replicated layout.
        self._opt_plan: Optional[Dict[str, Any]] = None
        # The optimizer's canonical slots, from a probe of the spec's factory.
        self._opt_slots, self._opt_count = (
            optimizer_layout(spec.optimizer([torch.nn.Parameter(torch.zeros(1))]))
            if spec.optimizer else ((), False))
        self._loss_takes_mask = spec.loss is not None and (
            "mask" in inspect.signature(spec.loss).parameters
        )
        self._metrics_take_mask = spec.metrics is not None and (
            "mask" in inspect.signature(spec.metrics).parameters
        )
        self._adopt_mesh_axes(mesh or Mesh({"dp": 1}))
        # Host-tier tables (spec.host_io): in this process, or behind the
        # PS service's shards (config.ps_addresses).  Replaced wholesale on
        # a restore that re-initialises them (task loop only).
        self._host_stores: Dict[str, Any] = {}  # single-writer: main
        self._remote_ps = False
        if spec.host_io:
            self._host_stores = self._make_host_stores()
        # The fused scans (task loop only): the variants each has met, the
        # variants warmed on this process, the captured graphs with the
        # state signature they point at, and the stacked batches' device
        # buffers by variant.
        self._scan_variants: Dict[str, set] = {k: set() for k in SCAN_BUDGETS}
        self._scan_warm: set = set()
        self._warm_slots: Optional[tuple] = None  # the optimizer's slots after an eager task
        self._graphs: Dict[Tuple[str, tuple], _Graph] = {}
        self._graph_sig: Optional[tuple] = None
        self._stacked_bufs: Dict[tuple, Dict[str, torch.Tensor]] = {}
        self._scan_mode_logged = False  # gil-atomic (a log-once flag: a race logs twice)
        # The worker's ``PhaseTimers`` (None alone): each capture adds a
        # ``capture`` entry, so its count is the number of captures.
        self.phases = None
        # On the card, a timing event recorded just before a task's first
        # replay or eager step (``_mark_task_start``); the caller clears it
        # before the task and reads it after.
        self.task_start: Optional[torch.cuda.Event] = None

    def _make_host_stores(self) -> Dict[str, Any]:
        """The host-tier stores: one ``RemoteEmbeddingStore`` a table over
        the PS fleet when ``config.ps_addresses`` is set (the only legal
        layout in a world of several ranks, whose processes must share one
        store), else in-process ``HostEmbeddingStore``s."""
        spec = self.spec
        if spec.batch_shard_dim != 0:
            # Per-token tables only (ids [B, S]: the rows shard with the
            # sequence); a [B, F] table would silently feature-slice.
            not_per_token = [k for k, io in spec.host_io.items() if not io.per_token]
            if not_per_token:
                raise NotImplementedError(
                    "host-tier tables under sequence parallelism must declare "
                    f"per_token=True (ids [B, S]); table(s) {not_per_token} do not"
                )
            if self.mesh.size > 1:
                raise NotImplementedError(
                    "host-tier tables with sequence parallelism are single-process "
                    "only; multi-process meshes need per-token process slicing"
                )
        addrs = [a.strip() for a in getattr(self.config, "ps_addresses", "").split(",")
                 if a.strip()]
        if addrs:
            from elasticdl_tpu_torch.ps.service import RemoteEmbeddingStore

            self._remote_ps = True
            return {key: RemoteEmbeddingStore(key, io.dim, addrs)
                    for key, io in spec.host_io.items()}
        if self.mesh.size > 1:
            raise NotImplementedError(
                "host-tier embedding tables on a multi-process mesh need the PS "
                "service tier: run with --num_ps_pods > 0 (or set --ps_addresses "
                "to an external PS fleet)"
            )
        return self._local_host_stores()

    def _local_host_stores(self) -> Dict[str, Any]:
        from elasticdl_tpu_torch.ps.host_store import HostEmbeddingStore

        return {
            key: HostEmbeddingStore(dim=io.dim, optimizer=io.optimizer,
                                    learning_rate=io.learning_rate,
                                    init_scale=io.init_scale)
            for key, io in self.spec.host_io.items()
        }

    # ---- the mesh ----

    def _adopt_mesh_axes(self, mesh: Mesh) -> None:
        """Axis roles (the reference's ``_adopt_mesh_axes``).  ``tp_axis``
        is the last axis when it is ``tp`` and the spec has a
        ``tensor_sharding`` plan; reductions run over every other axis
        (``reduce_axes``).  Contributors are the EXAMPLE shards: the reduce
        axes for a data-parallel model (a tp rank is never excluded alone),
        the outer axes for a sequence-parallel one (its last-axis slices
        hold pieces of the same examples; on a flat mesh that is one
        contributor).  Embedding tables and the ring use the LAST axis,
        the sharded optimizer the first.  The collective topology and the
        forward's context resolve here and the contributor mask resets to
        all-active."""
        names = mesh.axis_names
        self.mesh = mesh
        self.tp_axis = (MODEL_AXIS if self.spec.tensor_sharding is not None
                        and names[-1] == MODEL_AXIS else None)
        self.tp_size = int(mesh.shape[self.tp_axis]) if self.tp_axis else 1
        self.reduce_axes = tuple(a for a in names if a != self.tp_axis)
        self.contributor_axes = (self.reduce_axes if self.spec.batch_shard_dim == 0
                                 else names[:-1])
        cfg = self.config
        topo = coll.resolve_topology(
            mesh, self.reduce_axes,
            mode=getattr(cfg, "collective", coll.AUTO),
            local_size=int(getattr(cfg, "collective_local_size", 0)),
            min_elems=int(getattr(cfg, "collective_min_elems", coll.DEFAULT_MIN_ELEMS)),
        )
        self.reducer = coll.Reducer(mesh, topo)
        # The bare step (no group): a world of one without a process group.
        self._group = mesh.group(self.reduce_axes)
        self._active_np = np.ones(
            coll.contributor_count(mesh, self.contributor_axes) if self.contributor_axes else 1,
            np.float32,
        )
        # Ranks a contributor spans (a sequence-parallel example row's
        # slices): psum over the reduce axes of the contributor weights is
        # the mask's sum times this.
        self._ranks_per_contributor = (
            coll.contributor_count(mesh, self.reduce_axes) // self.num_contributors())
        # This rank's contributor weight and the weights' psum, on the
        # device (``_weight``): made once, written in place.
        self._w_dev = torch.empty((), dtype=torch.float32, device=self.device)
        self._n_active_dev = torch.empty((), dtype=torch.float32, device=self.device)
        self._write_weight()
        self.axis_name = names[-1]  # the embedding and sequence axis
        tables = self.spec.embedding_tables
        self.sharded_embeddings = (
            self.strategy == DistributionStrategy.PARAMETER_SERVER and bool(tables))
        n_table = int(mesh.shape[self.axis_name])
        if self.sharded_embeddings:
            for t in tables:
                rows = table_shape(t.vocab_size, t.dim)[0]
                if rows % n_table:
                    raise ValueError(
                        f"table {t.path}: {rows} physical rows do not divide over the "
                        f"{self.axis_name!r} axis of {n_table} ranks")
        self._table_keys = {"/".join(t.path) for t in tables} if self.sharded_embeddings else set()
        # Table gradients reduce over the axes other than the table's.
        self._table_grad_axes = tuple(a for a in self.reduce_axes if a != self.axis_name)
        self.ctx = ParallelContext(
            axis_name=self.axis_name,
            sharded_embeddings=self.sharded_embeddings,
            # Against the trainer's device and the TABLE axis's size: a
            # one-rank axis resolves to the local gather.
            embedding_impl=resolve_impl(self.embedding_lookup_impl, self.device.type, n_table),
            axis_size=n_table,
            axis_index=mesh.position(self.axis_name),
            group=mesh.group((self.axis_name,)),
            reducer=self.reducer,
            tp_axis=self.tp_axis,
            tp_size=self.tp_size,
            tp_group=mesh.group((self.tp_axis,)) if self.tp_axis else None,
        )
        self.opt_axis = names[0]  # the sharded optimizer's (data-parallel) axis

    def num_contributors(self) -> int:
        """Contributor-mask slots: one per example shard of this mesh."""
        return int(self._active_np.size)

    def active_contributors(self) -> np.ndarray:
        """The current 0/1 participation mask (a copy)."""
        return np.array(self._active_np)

    def set_active_contributors(self, active=None) -> None:
        """Set the contributor mask of the following steps (``None``:
        all-active).  Every rank must set the same mask; an all-zero mask
        is refused (an empty subgroup has no mean)."""
        n = self.num_contributors()
        if active is None:
            mask = np.ones(n, np.float32)
        else:
            mask = np.asarray(active, np.float32).reshape(-1)
            if mask.size != n:
                raise ValueError(f"active mask has {mask.size} slots, mesh has {n} contributors")
            if not mask.any():
                raise ValueError("cannot exclude every contributor")
        self._active_np = mask
        self._write_weight()

    def _write_weight(self) -> None:
        """Write this rank's contributor weight and the psum of the weights
        over the reduce axes (the reference's ``n_active``: the mask's sum
        |G'| times the ranks a contributor spans) into their device tensors,
        in place, on the current stream: the next step, or the next replay
        of a captured one, reads them.  The mask is replicated, so the sum
        is known here without a collective; a sum of 0/1 floats is exact."""
        w = (coll.contributor_weight(self._active_np, self.mesh, self.contributor_axes)
             if self.contributor_axes else float(self._active_np[0]))
        self._w_dev.fill_(w)
        self._n_active_dev.fill_(
            max(float(self._active_np.sum()) * self._ranks_per_contributor, 1.0))

    def _weight(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(this rank's contributor weight, the weights' psum): 0-d f32
        tensors on the device (the reference's ``_active_device``)."""
        return self._w_dev, self._n_active_dev

    def _psum(self, tree: Dict[str, torch.Tensor], skip=(), skip_axes=()) -> Dict[str, torch.Tensor]:
        """``tree`` summed over the reduce axes (the keys in ``skip`` over
        ``skip_axes`` only: ``_tree_psum_except``)."""
        try:
            return _tree_psum_except(self.reducer, tree, set(skip), self.reduce_axes, skip_axes)
        except Exception as e:
            raise CollectiveError(f"collective over {self.reduce_axes} failed: {e}") from e

    def _apply(self, model: torch.nn.Module, batch: Dict[str, torch.Tensor], train: bool,
               ctx: Optional[ParallelContext] = None):
        """The spec's forward, with this trainer's ``ParallelContext`` (or
        ``ctx``) when it takes one (a sharded lookup's, the ring's and the
        tp collectives run inside it and in its backward; the callers turn
        their failures into ``CollectiveError``)."""
        if self._apply_takes_ctx:
            return self.spec.apply(model, batch, train=train, ctx=ctx or self.ctx)
        return self.spec.apply(model, batch, train=train)

    def sharded_state(self) -> bool:
        """Whether no rank holds the whole state: tables row-sharded over
        more than one rank, weights split over a tp axis of more than one
        rank, or the sharded optimizer on.  Then ``snapshot_state`` is a
        collective, and a lone rank cannot save."""
        return ((self.sharded_embeddings and self.ctx.axis_size > 1) or self.tp_size > 1
                or self._opt_plan is not None)

    def _tp_dims(self, model: torch.nn.Module) -> Dict[str, int]:
        """``{path: dim}`` of the leaves split over the tp axis (the spec's
        ``tensor_sharding`` plan), empty without a tp axis of more than one
        rank."""
        return self.spec.tensor_sharding(model) if self.tp_size > 1 else {}

    # ---- state ----

    def init_state(self, seed: Optional[int]) -> TrainState:
        """Step 0: fresh weights from ``seed`` (None: uninitialised storage,
        for a restore to fill) on this trainer's device and, when the spec
        trains, their optimizer.  Every rank draws the whole model from the
        seed; under sharding it keeps its rows of each table and its shards
        of the dense leaves' optimizer slots."""
        model = self.spec.init(seed=seed, device=self.device)
        pad_embedding_tables(model, self.spec.embedding_tables)
        if self.sharded_embeddings and self.ctx.axis_size > 1:
            shard_parameters(model, dict.fromkeys(self._table_keys, 0),
                             self.ctx.axis_index, self.ctx.axis_size)
        if self.tp_size > 1:
            shard_parameters(model, self._tp_dims(model), self.mesh.position(self.tp_axis),
                             self.tp_size)
        optimizer = self._make_optimizer(model) if self.spec.optimizer else None
        return TrainState(step=0, model=model, optimizer=optimizer)

    def _make_optimizer(self, model: torch.nn.Module):
        """The spec's optimizer over the module's parameters, or, under the
        sharded optimizer, over this rank's shards of the dense leaves and
        its table rows (the shards ride on the optimizer as
        ``_zero_shards``)."""
        paths = self._param_paths(model)
        n = int(self.mesh.shape[self.opt_axis])
        plan = opt_shard_plan(paths, self.spec.embedding_tables, self.sharded_embeddings, n,
                              tp_paths=self._tp_dims(model))
        self._opt_plan = plan if self._resolve_opt_sharding(plan, paths) else None
        if self._opt_plan is None:
            optimizer = self.spec.optimizer(model.parameters())
        else:
            leaves = [(path, p, plan[path]) for path, p in paths if plan[path] is not _OPT_KEEP]
            zero = _ZeroShards(leaves, n, self.mesh.position(self.opt_axis))
            kept = [p for path, p in paths if plan[path] is _OPT_KEEP]
            optimizer = self.spec.optimizer(zero.params + kept)
            optimizer._zero_shards = zero
        if self.device.type == "cuda":
            make_capturable(optimizer)
        return optimizer

    def _resolve_opt_sharding(self, plan: Dict[str, Any], paths, mode: Optional[str] = None) -> bool:
        """Whether this mesh runs the sharded optimizer (the reference's
        ``_resolve_opt_sharding``) in ``mode`` (default: the flag's): never
        on a data-parallel axis of one rank; ``auto`` when the dense
        leaves' two Adam moments reach ``--optimizer_sharding_auto_mb`` a
        replica (row-sharded tables do not count: ``_OPT_KEEP``; SGD's one
        trace counts once)."""
        mode = mode or self.optimizer_sharding
        if mode == "replicated" or int(self.mesh.shape[self.opt_axis]) <= 1:
            return False
        if mode == "sharded":
            return True
        itemsize = {path: p.element_size() for path, p in paths}
        slots = len(self._opt_slots)
        per_replica = sum(slots * e.size * itemsize[path] for path, e in plan.items()
                          if isinstance(e, _OptShard))
        threshold = float(getattr(self.config, "optimizer_sharding_auto_mb", 64.0)) * (1 << 20)
        return per_replica >= threshold

    def _to_device(self, value: Any) -> torch.Tensor:
        if isinstance(value, torch.Tensor):
            return value.to(self.device)
        host = torch.from_numpy(np.ascontiguousarray(value))
        if self.device.type == "cuda":
            # Pinned and without waiting: a pageable upload synchronises the
            # stream, and the host could not queue the next step while the
            # card runs this one.
            return host.pin_memory().to(self.device, non_blocking=True)
        return host.to(self.device)

    def shard_batch(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """This rank's part of a GLOBAL host batch (numpy arrays or
        tensors), on the device, every rank feeding the same global batch
        (the reference's ``_batch_spec_for`` and ``_place_global``): the
        contiguous slice of the examples (dim 0) at its contributor index;
        for a sequence-parallel model also the contiguous slice of dim 1 at
        its position on the last axis, for the leaves that have a sequence
        dim (a ``[B]`` mask follows the examples only).  One rank: placing
        is all it comes to."""
        if self.num_contributors() > 1:
            batch = {k: v if np.ndim(v) == 0 else v[self._contributor_slice(k, v.shape[0])]
                     for k, v in batch.items()}
        if self.spec.batch_shard_dim == 1 and self.ctx.axis_size > 1:
            batch = {k: v[:, self._sequence_slice(k, v.shape[1])] if np.ndim(v) > 1 else v
                     for k, v in batch.items()}
        return {k: self._to_device(v) for k, v in batch.items()}

    def _sequence_slice(self, key: str, length: int) -> slice:
        """This rank's contiguous slice of a sequence of ``length`` at its
        position on the last (sequence) axis."""
        n, i = self.ctx.axis_size, self.ctx.axis_index
        if length % n:
            raise ValueError(
                f"batch dimension 1 of {key!r} (size {length}) not divisible by its "
                f"mesh axis {self.axis_name!r} (size {n})"
            )
        size = length // n
        return slice(i * size, (i + 1) * size)

    def _contributor_slice(self, key: str, n_examples: int) -> slice:
        """This rank's contiguous slice of ``n_examples`` examples at its
        contributor index: what it feeds of a global batch."""
        n = self.num_contributors()
        if n_examples % n:
            raise ValueError(
                f"batch dimension 0 of {key!r} (size {n_examples}) not divisible "
                f"by its mesh axes {self.contributor_axes} (size {n})"
            )
        size = n_examples // n
        i = coll.contributor_index(self.mesh, self.contributor_axes) if n > 1 else 0
        return slice(i * size, (i + 1) * size)

    # ---- training ----

    def train_step(
        self, state: TrainState, batch: Dict[str, torch.Tensor]
    ) -> Tuple[TrainState, Dict[str, torch.Tensor], Dict[str, HostGrad]]:
        """One step on a device batch (``_train_step``).  The public name is
        the one callers wrap (the worker's step clock): the fused scans run
        ``_train_step`` itself, so a wrapper sees a scan as one call."""
        return self._train_step(state, batch)

    def _train_step(
        self, state: TrainState, batch: Dict[str, torch.Tensor]
    ) -> Tuple[TrainState, Dict[str, torch.Tensor], Dict[str, HostGrad]]:
        """One step on a device batch: the loss (weighted by ``__mask__``
        when the loss takes one), its gradients, the optimizer update.
        Metrics stay on the device: ``loss`` is the weighted loss the step
        minimised; the others come from ``spec.metrics``, over real rows
        when both it and the loss take the mask, as in the reference.
        Histogram metrics (``HIST_PREFIX``, the AUC's) are evaluation
        machinery and dropped here, as the reference's train step does.

        Returns (state, metrics, ``{key: HostGrad}``).  With host-tier
        tables the batch carries their rows under their keys; the step
        differentiates them too, and the third value holds the rows'
        gradients on their way to the host (empty without such tables)."""
        spec = self.spec
        if spec.loss is None or state.optimizer is None:
            raise ValueError(f"model {spec.name!r} declares no loss or optimizer: it cannot train")
        if self._group is not None:
            return self._group_train_step(state, batch)
        batch = dict(batch)
        mask = batch.pop(MASK_KEY, None)
        host_in = self._host_leaves(batch)
        model, optimizer = state.model, state.optimizer
        optimizer.zero_grad(set_to_none=True)
        out = self._apply(model, dict(batch, **host_in), train=True)
        masked = mask is not None and self._loss_takes_mask
        if masked:
            # The reference weighs a shard's loss by count/total over the
            # mesh; without a group the total is this batch's own count, so
            # the weight is 1, and 0 for an all-padding batch.
            count = mask.float().sum()
            weight = count / count.clamp_min(1e-12)
            loss = spec.loss(out, batch, mask=mask) * weight
        else:
            loss = spec.loss(out, batch)
        loss.backward()
        host_grads = self._host_grads(host_in)
        with trace.profiler_range("optim:step"):
            optimizer.step()
        metrics = {}
        if spec.metrics is not None:
            with torch.no_grad():
                out = out.detach()
                if masked and self._metrics_take_mask:
                    raw = {k: v * weight for k, v in spec.metrics(out, batch, mask=mask).items()}
                else:
                    raw = spec.metrics(out, batch)
            metrics = {k: v for k, v in raw.items() if not k.startswith(HIST_PREFIX)}
        metrics["loss"] = loss.detach()
        return TrainState(state.step + 1, model, optimizer), metrics, host_grads

    def _host_leaves(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Pop the host-tier rows out of ``batch`` as leaves the step
        differentiates."""
        return {k: batch.pop(k).detach().requires_grad_()
                for k in self.spec.host_io if k in batch}

    def _host_grads(self, leaves: Dict[str, torch.Tensor]) -> Dict[str, HostGrad]:
        """Start each host-tier leaf's gradient on its way to the host, right
        after the backward (before the optimizer's update)."""
        return {k: HostGrad(leaf.grad if leaf.grad is not None else torch.zeros_like(leaf))
                for k, leaf in leaves.items()}

    def _group_train_step(
        self, state: TrainState, batch: Dict[str, torch.Tensor]
    ) -> Tuple[TrainState, Dict[str, torch.Tensor], Dict[str, HostGrad]]:
        """The data-parallel step over the process group (the reference's
        ``local_step``): this rank's loss weighed by ``count / total``
        (``total = psum(count)``, each count times this rank's contributor
        weight) or by ``w / |G'|``, its gradients (a sharded lookup's
        collectives run inside the forward and the backward); then ONE
        reduction of the gradients, the loss and the metrics (``psum(v *
        count) / total`` or ``psum(v * w) / |G'|``; table gradients over the
        non-table axes only) before the optimizer's update.  Under the
        sharded optimizer the dense gradients are reduce-scattered instead,
        and the updated shards all-gathered after the update."""
        spec = self.spec
        batch = dict(batch)
        mask = batch.pop(MASK_KEY, None)
        # Host-tier rows: this rank's slice; their gradients are this rank's
        # examples' cotangents of the contributor-weighted loss, pushed by
        # this rank alone (never summed over the group).
        host_in = self._host_leaves(batch)
        model, optimizer = state.model, state.optimizer
        zero = _zero_of(optimizer)
        w, n_active = self._weight()
        optimizer.zero_grad(set_to_none=True)
        if zero is not None:  # the full leaves are not the optimizer's
            model.zero_grad(set_to_none=True)
        masked = mask is not None and self._loss_takes_mask
        try:
            out = self._apply(model, dict(batch, **host_in), train=True)
            if masked:
                # The real examples of the active ranks: one scalar reduction
                # before the backward, which weighs by it.
                count = mask.float().sum() * w
                total = self._psum({"count": count})["count"].clamp_min(1e-12)
                loss = spec.loss(out, batch, mask=mask) * count / total
            else:
                loss = spec.loss(out, batch) * w / n_active
            loss.backward()
        except coll.CollectiveFailed as e:
            raise CollectiveError(f"a collective of the forward or backward failed: {e}") from e
        host_grads = self._host_grads(host_in)
        tree: Dict[str, torch.Tensor] = {}
        params = [(path, p) for path, p in self._param_paths(model) if p.grad is not None]
        if zero is not None:  # the leaves the sharded optimizer keeps whole
            kept = self._table_keys | set(self._tp_dims(model))
            params = [(path, p) for path, p in params if path in kept]
        for path, p in params:
            tree["grad/" + path] = p.grad
        tree["loss"] = loss.detach()
        if spec.metrics is not None:
            with torch.no_grad():
                detached = out.detach()
                if masked and self._metrics_take_mask:
                    raw = {k: v * count for k, v in spec.metrics(detached, batch, mask=mask).items()}
                else:
                    raw = {k: v * w for k, v in spec.metrics(detached, batch).items()}
            for k, v in raw.items():
                if not k.startswith(HIST_PREFIX):
                    tree["metric/" + k] = v
        tables = {"grad/" + k for k in self._table_keys}
        summed = self._psum(tree, skip=tables, skip_axes=self._table_grad_axes)
        if zero is not None:
            zero.set_grads(self._zero_scatter(zero))
        for path, p in params:
            p.grad = summed["grad/" + path]
        with trace.profiler_range("optim:step"):
            optimizer.step()
        if zero is not None:
            try:
                full = self.reducer.all_gather(zero.buf, self.mesh.group((self.opt_axis,)),
                                               tag="zero")
            except coll.CollectiveFailed as e:
                # After the update: the shards and their moments have
                # stepped, the full leaves have not.
                raise CollectiveError(
                    f"the sharded optimizer's all-gather failed after the update: {e}",
                    state_intact=False) from e
            zero.write_back(full)
            model.zero_grad(set_to_none=True)
        by_count = masked and self._metrics_take_mask
        metrics = {
            key[len("metric/"):]: v / total if by_count else v / n_active
            for key, v in summed.items() if key.startswith("metric/")
        }
        metrics["loss"] = summed["loss"]
        return TrainState(state.step + 1, model, optimizer), metrics, host_grads

    def _zero_scatter(self, zero: _ZeroShards) -> torch.Tensor:
        """The dense gradients summed over every axis, this rank's shards
        of them: a psum over the axes other than the shard axis (``ep`` on
        ``(dp, ep)``), then one reduce-scatter over it."""
        flat = zero.grad_buffer()
        try:
            rest = tuple(a for a in self.reduce_axes if a != self.opt_axis)
            if rest:
                flat = self.reducer.psum({"g": flat}, rest)["g"]
            return coll.psum_scatter(flat, self.opt_axis, self.reducer)
        except Exception as e:
            raise CollectiveError(f"the sharded optimizer's reduce-scatter failed: {e}") from e

    def run_train_step(self, state: TrainState, batch: Dict[str, Any]):
        """A training step from a HOST batch: (host-tier pull ->) place ->
        step (-> push of the rows' gradients)."""
        if not self.spec.host_io:
            return self.train_step(state, self.shard_batch(batch))[:2]
        placed, ids = self._place_host_batch(batch)
        state, metrics, host_grads = self.train_step(state, placed)
        self._push_host_grads(ids, host_grads)
        return state, metrics

    def run_train_steps(
        self,
        state: TrainState,
        batches: Iterable[Dict[str, Any]],
        use_async: bool = False,
        pre_sharded: bool = False,
    ) -> Tuple[TrainState, List[Dict[str, torch.Tensor]]]:
        """Train over an iterable of host batches (``pre_sharded``: already
        on the device; not with host-tier tables, whose pull needs the host
        batch).  Returns (state, [metrics per batch]); a failure raises
        ``TrainLoopError``.

        With host-tier tables, ``use_async=False`` is the synchronous loop
        (each pull sees every earlier push); ``use_async=True`` the
        reference's async-PS pipeline: up to ``config.async_staleness``
        steps' pushes stay outstanding while the next batches pull and
        their steps are enqueued, so the host's pull overlaps the device's
        step and a pull reads rows one (or D) pushes stale; dense state is
        exact either way.  With one batch both orders are the same."""
        if self.spec.host_io:
            if pre_sharded:
                raise ValueError("pre_sharded batches are incompatible with host-tier "
                                 "tables (the host pull needs the host batch)")
            return self._run_host_steps(state, batches, use_async)
        return self._step_loop(state, batches, pre_sharded, self.train_step)

    def _step_loop(self, state: TrainState, batches: Iterable[Dict[str, Any]],
                   pre_sharded: bool, step) -> Tuple[TrainState, List[Dict[str, torch.Tensor]]]:
        """``run_train_steps`` without host-tier tables, each batch through
        ``step`` (``train_step``, or ``_train_step`` inside a scan)."""
        metrics_out = []
        last_good: Optional[TrainState] = None  # after the last completed step
        batches = iter(batches)
        while True:
            try:
                batch = next(batches, None)
                if batch is None:
                    return state, metrics_out
                if not pre_sharded:
                    batch = self.shard_batch(batch)
            except Exception as e:
                # Nothing of this step ran: the last completed step's state
                # is intact.
                raise TrainLoopError(last_good, e) from e
            try:
                self._mark_task_start()
                state, metrics, _ = step(state, batch)
            except CollectiveError as e:
                # Before the update the state before the step is intact;
                # the sharded optimizer's all-gather after it tears it.
                raise TrainLoopError(state if e.state_intact else None, e) from e
            except Exception as e:
                raise TrainLoopError(None, e) from e
            metrics_out.append(metrics)
            last_good = state

    # ---- the fused task dispatch ----

    def scan_unsupported(self) -> Optional[str]:
        """Why the fused scans cannot run on this trainer, or None: host-tier
        tables (their pulls need each step's host batch; the reference
        refuses them too).  Both sharded lookup routes have static shapes
        and no host copy inside the step, so they scan wherever the trainer
        runs, captured or eagerly (``_scan_captures``)."""
        if self.spec.host_io:
            return "host-tier tables pull and push around every step"
        return None

    def _scan_captures(self) -> bool:
        """Whether the scans capture CUDA graphs: on the card, alone or when
        every process group of the mesh is NCCL's (its collectives only
        enqueue on the stream, so the graph records them).  Every group
        counts, not only the reduction's: a tp or table line runs its
        collectives inside the step too.  Over gloo, whose calls wait for
        the stream on the host (``Reducer._collective``), and on the CPU,
        the scans run their steps eagerly.  The choice is logged once."""
        groups = [g for g in self.mesh.groups.values() if g is not None]
        if self.device.type != "cuda":
            captures, why = False, "on the CPU"
        elif not groups:
            captures, why = True, "alone on the card"
        else:
            import torch.distributed as dist

            backends = sorted({dist.get_backend(g) for g in groups})
            captures = backends == ["nccl"]
            why = f"process groups over {'+'.join(backends)} on the card"
        if not self._scan_mode_logged:
            self._scan_mode_logged = True
            logger.info("scans: %s, %s", "one captured CUDA graph a task" if captures
                        else "the steps eagerly, one call a task", why)
        return captures

    @staticmethod
    def _variant(stacked: Dict[str, Any]) -> tuple:
        """A stacked batch's variant: its keys, shapes and dtypes."""
        return tuple(sorted((k, tuple(v.shape), str(v.dtype)) for k, v in stacked.items()))

    def shard_stacked_batch(self, stacked: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """A task's stacked HOST batch (``[T, mb, ...]`` a leaf: numpy
        arrays, or host tensors, pinned ones best) on the device in one copy
        a leaf, this rank's part of each step as ``shard_batch`` takes it.
        On the card the copies go from pinned memory into a device buffer
        kept for the batch's variant, so a captured scan reads them where
        it was captured; the returned tensors are that buffer, valid until
        the next call with the same variant."""
        if self.num_contributors() > 1:
            stacked = {k: v[:, self._contributor_slice(k, v.shape[1])]
                       for k, v in stacked.items()}
        if self.spec.batch_shard_dim == 1 and self.ctx.axis_size > 1:
            stacked = {k: v[:, :, self._sequence_slice(k, v.shape[2])] if np.ndim(v) > 2 else v
                       for k, v in stacked.items()}
        host = {k: v if isinstance(v, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(v))
                for k, v in stacked.items()}
        with trace.span("upload"):
            if self.device.type != "cuda":
                return {k: v.to(self.device) for k, v in host.items()}
            variant = self._variant(host)
            bufs = self._stacked_bufs.get(variant)
            if bufs is None:
                bufs = {k: torch.empty(v.shape, dtype=v.dtype, device=self.device)
                        for k, v in host.items()}
                self._stacked_bufs[variant] = bufs
            for k, v in host.items():
                src = v.contiguous()
                bufs[k].copy_(src if src.is_pinned() else src.pin_memory(), non_blocking=True)
            return dict(bufs)

    def pin_stacked(self, stacked: Dict[str, Any]) -> Dict[str, Any]:
        """A stacked host batch in pinned host tensors when this trainer
        runs on the card (as is on the CPU): the prep threads pin it, so
        ``shard_stacked_batch`` on the task loop only enqueues the copy."""
        if self.device.type != "cuda":
            return stacked
        return {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                for k, v in stacked.items()}

    def train_scan(self, state: TrainState, stacked: Dict[str, torch.Tensor]
                   ) -> Tuple[TrainState, ScanMetrics]:
        """All T steps of a task (``stacked`` from ``shard_stacked_batch``):
        (the state T steps on, ``{metric: [T] tensor}``).  On the card, alone
        or over NCCL, one replay of the variant's captured graph (the module
        docstring); eagerly on the CPU and over gloo.  A failure raises
        ``TrainLoopError``."""
        if self.spec.loss is None or state.optimizer is None:
            raise ValueError(f"model {self.spec.name!r} declares no loss or optimizer: it cannot train")
        n = self._scan_begin("train_scan", stacked)
        if not self._graph_ready("train_scan", stacked, state):
            with trace.span("eager_scan"):
                state, per_step = self._step_loop(state, self._steps_of(stacked, n), True,
                                                  self._train_step)
            self._warm_slots = self._slot_layout(state.optimizer)
            return state, self._stack_metrics(per_step)

        def body(views):
            step_state, per_step = state, []
            for batch in views:
                step_state, metrics, _ = self._train_step(step_state, batch)
                per_step.append(metrics)
            return per_step

        metrics = self._replay("train_scan", stacked, state, body)
        # The replay updated the state in place behind autograd's back: its
        # version counters (which caches key on) move as an eager step's.
        torch.autograd.graph.increment_version(self._state_tensors(state))
        return TrainState(state.step + n, state.model, state.optimizer), metrics

    def eval_scan(self, state: TrainState, stacked: Dict[str, torch.Tensor]) -> ScanMetrics:
        """The eval metrics of all T steps of a stacked device batch:
        ``{metric: [T, ...] tensor}``, the AUC histograms included (the
        caller weighs each step by its count).  On the card, alone or over
        NCCL, one replay of the variant's captured graph; eagerly on the
        CPU and over gloo."""
        n = self._scan_begin("eval_scan", stacked)
        if not self._graph_ready("eval_scan", stacked, state):
            with trace.span("eager_scan"):
                return self._stack_metrics([self._eval_step(state, b)
                                            for b in self._steps_of(stacked, n)])
        return self._replay("eval_scan", stacked, state,
                            lambda views: [self._eval_step(state, b) for b in views])

    @staticmethod
    def _steps_of(stacked: Dict[str, torch.Tensor], n: int) -> List[Dict[str, torch.Tensor]]:
        return [{k: v[i] for k, v in stacked.items()} for i in range(n)]

    @staticmethod
    def _stack_metrics(per_step: List[Dict[str, torch.Tensor]]) -> ScanMetrics:
        return ScanMetrics({k: torch.stack([m[k] for m in per_step]) for k in per_step[0]})

    def _scan_begin(self, kind: str, stacked: Dict[str, torch.Tensor]) -> int:
        """Check that the scan may run and its variant fits the budget;
        returns T."""
        reason = self.scan_unsupported()
        if reason is not None:
            raise NotImplementedError(f"{kind}: {reason}")
        sizes = {int(v.shape[0]) for v in stacked.values()}
        if len(sizes) != 1 or 0 in sizes:
            raise ValueError(f"{kind}: the stacked leaves need one leading step count >= 1, "
                             f"got {sorted(sizes)}")
        variant, seen = self._variant(stacked), self._scan_variants[kind]
        if variant not in seen:
            if len(seen) >= SCAN_BUDGETS[kind]:
                raise ScanBudgetError(
                    f"{kind}: batch variant {len(seen) + 1} past the budget of "
                    f"{SCAN_BUDGETS[kind]}: {variant}")
            seen.add(variant)
        return sizes.pop()

    @staticmethod
    def _state_tensors(state: TrainState) -> List[torch.Tensor]:
        """Every parameter, buffer and optimizer slot of ``state``."""
        tensors = list(state.model.parameters()) + list(state.model.buffers())
        if state.optimizer is not None:
            for st in state.optimizer.state.values():
                tensors += [v for v in st.values() if isinstance(v, torch.Tensor)]
        return tensors

    def _state_signature(self, state: TrainState) -> tuple:
        """What a captured graph points at: the module and the optimizer,
        and the storage of every parameter, buffer and optimizer slot."""
        return (id(state.model), id(state.optimizer),
                tuple(t.data_ptr() for t in self._state_tensors(state)))

    @staticmethod
    def _slot_layout(optimizer: torch.optim.Optimizer) -> tuple:
        """The names of the slots the optimizer holds for each of its
        parameters (None: none yet)."""
        layout = []
        for group in optimizer.param_groups:
            for p in group["params"]:
                st = optimizer.state.get(p)
                layout.append(None if st is None else tuple(sorted(st)))
        return tuple(layout)

    def _graph_ready(self, kind: str, stacked: Dict[str, torch.Tensor], state: TrainState) -> bool:
        """Whether this call replays a graph (captured now if need be) or
        runs its steps eagerly: always eagerly where the scans do not
        capture (``_scan_captures``: the CPU, a gloo group); where they do,
        for a variant's first call on this process (the libraries'
        first-call work, the optimizer's lazy slots, an NCCL group's
        communicator, which its first collective makes), and for a training
        call whose optimizer slots are not laid out as the last eager task
        left them (a restore cleared or added some: a capture would record
        their making, and every replay would make them anew).  The eager
        task lays them out, so each of these runs once.  A parameter that
        takes no gradient has no slots and needs none.  Drops every graph
        when the state's tensors changed."""
        if not self._scan_captures():
            return False
        sig = self._state_signature(state)
        if sig != self._graph_sig:
            if self._graphs:
                logger.info("state replaced: dropping %d captured graph(s)", len(self._graphs))
            self._graphs.clear()
            self._graph_sig = sig
        key = (kind, self._variant(stacked))
        if key in self._graphs:
            return True
        why = None
        if key not in self._scan_warm:
            self._scan_warm.add(key)
            why = "the variant's first task on this process"
        elif kind == "train_scan" and self._slot_layout(state.optimizer) != self._warm_slots:
            why = "the optimizer's slots changed since its last eager task (a restore)"
        if why is not None:
            logger.info("%s runs its %s steps eagerly: %s", kind, key[1], why)
        return why is None

    def _replay(self, kind: str, stacked: Dict[str, torch.Tensor], state: TrainState,
                body) -> ScanMetrics:
        """Replay the variant's graph (capturing it first when missing) on
        ``stacked`` and return fresh copies of its outputs."""
        key = (kind, self._variant(stacked))
        entry = self._graphs.get(key)
        try:
            if entry is None:
                with trace.span("capture"):
                    entry = self._capture(kind, stacked, body)
                self._graphs[key] = entry
                # The capture itself read nothing: the tensors it touched
                # are the same, but the signature covers the slots it may
                # have made.
                self._graph_sig = self._state_signature(state)
            with trace.span("replay"):
                self._mark_task_start()
                for k, v in stacked.items():
                    if v.data_ptr() != entry.inputs[k].data_ptr():
                        entry.inputs[k].copy_(v, non_blocking=True)
                entry.graph.replay()
            kernels.add_counts(entry.tally)
            self.reducer.add_replay(entry.collectives)
            # Copies, so the next replay cannot overwrite what the caller
            # holds.
            return ScanMetrics({k: v.clone() for k, v in entry.outputs.items()})
        except Exception as e:
            self._graphs.pop(key, None)
            raise TrainLoopError(None, e) from e

    def _mark_task_start(self) -> None:
        """On the card, record ``task_start`` on the current stream unless
        the task has one: its device work from here on, after its upload,
        its capture and the host's set-up, which the card does not run."""
        if self.task_start is None and self.device.type == "cuda":
            self.task_start = torch.cuda.Event(enable_timing=True)
            self.task_start.record()

    def _capture(self, kind: str, stacked: Dict[str, torch.Tensor], body) -> _Graph:
        """Capture ``body`` over the T step views of ``stacked`` into one
        graph, in a memory pool of its own: nothing runs; the module's
        Python state stays as it was.  Each capture adds a ``capture`` entry
        to ``phases`` (its seconds)."""
        inputs = dict(stacked)
        views = self._steps_of(inputs, int(next(iter(inputs.values())).shape[0]))
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        # thread_local: the prep and checkpoint threads may pin host memory
        # or wait on their own streams while this thread captures.
        # (c10d's watchdog thread queries an NCCL group's events meanwhile.)
        with kernels.capturing() as tally, self.reducer.capturing() as calls, torch.cuda.graph(
                graph, capture_error_mode="thread_local"):
            outputs = self._stack_metrics(body(views))
        capture_s = time.perf_counter() - t0
        pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        logger.info("%s: captured %d steps of %s in %.2f s (%d launches and %d collective "
                    "calls counted a replay, graph pool +%d bytes)", kind, len(views),
                    self._variant(stacked), capture_s, sum(tally.values()),
                    sum(n for n, _ in calls.values()), pool_bytes)
        if self.phases is not None:
            self.phases.add("capture", capture_s)
        return _Graph(graph, inputs, outputs, dict(tally), dict(calls), capture_s, pool_bytes)

    def scan_graphs(self) -> List[Dict[str, Any]]:
        """The captured graphs: kind, variant, capture seconds, the bytes
        of the graph's pool, launches and collective calls (by tag and op)
        counted a replay."""
        return [{"kind": kind, "variant": variant, "capture_s": g.capture_s,
                 "pool_bytes": g.pool_bytes, "launches": dict(g.tally),
                 "collectives": {k: n for k, (n, _) in g.collectives.items()}}
                for (kind, variant), g in self._graphs.items()]

    # ---- the host tier (spec.host_io) ----

    def _run_host_steps(self, state: TrainState, batches: Iterable[Dict[str, Any]],
                        use_async: bool) -> Tuple[TrainState, List[Dict[str, torch.Tensor]]]:
        """``run_train_steps`` with host-tier tables.  Each batch: its pull
        and upload, its step enqueued, then the oldest outstanding pushes
        until at most ``depth`` remain (0 in sync mode: this step's own).
        Every pull thus sees the same pushes as in the reference's order
        (pull n, push n-D, step n); the step goes to the device before the
        host waits.  A failure before a step touched the state leaves the
        last completed step's state once the outstanding pushes land
        (``TrainLoopError.state``); a failed step or push leaves none."""
        depth = max(1, int(getattr(self.config, "async_staleness", 1))) if use_async else 0
        pending: deque = deque()  # (ids, host grads) of steps not yet pushed
        metrics_out: List[Dict[str, torch.Tensor]] = []
        last_good: Optional[TrainState] = None

        def settle(keep: int) -> None:
            while len(pending) > keep:
                self._push_host_grads(*pending.popleft())

        def before_step(intact: Optional[TrainState], cause: BaseException) -> TrainLoopError:
            try:
                settle(0)
            except Exception:
                return TrainLoopError(None, cause)
            return TrainLoopError(intact, cause)

        batches = iter(batches)
        while True:
            try:
                batch = next(batches, None)
                if batch is None:
                    break
                placed, ids = self._place_host_batch(batch)
            except Exception as e:
                raise before_step(last_good, e) from e
            try:
                self._mark_task_start()
                state, metrics, host_grads = self.train_step(state, placed)
            except CollectiveError as e:
                raise before_step(state if e.state_intact else None, e) from e
            except Exception as e:
                raise TrainLoopError(None, e) from e
            pending.append((ids, host_grads))
            metrics_out.append(metrics)
            try:
                settle(depth)
            except Exception as e:
                raise TrainLoopError(None, e) from e
            last_good = state
        try:
            settle(0)
        except Exception as e:
            raise TrainLoopError(None, e) from e
        return state, metrics_out

    def _pull_host_rows(self, batch: Dict[str, Any], local: bool = True):
        """({key: each host-tier table's pulled rows}, {key: the ids whose
        gradients this process pushes}) for a HOST batch.  ``local``: only
        this rank's contributor slice of the examples, the one
        ``shard_batch`` places."""
        rows, ids = {}, {}
        for key, io in self.spec.host_io.items():
            table_ids = np.asarray(io.ids_fn(batch))
            if local:
                table_ids = table_ids[self._contributor_slice(key, table_ids.shape[0])]
            ids[key] = table_ids
            rows[key] = self._host_stores[key].pull(table_ids)
        return rows, ids

    def _place_host_batch(self, batch: Dict[str, Any]):
        """(this rank's device batch with each host-tier table's rows under
        its key, {key: the ids this process pushes}): the pull, then the
        upload of the batch's slice and of the rows."""
        rows, ids = self._pull_host_rows(batch)
        placed = self.shard_batch(batch)
        placed.update((k, self._to_device(v)) for k, v in rows.items())
        return placed, ids

    def _push_host_grads(self, ids: Dict[str, np.ndarray], host_grads: Dict[str, HostGrad]) -> None:
        """Push a step's row gradients into the host-tier stores.  Reading a
        gradient waits for the step that made it: the sync point the async
        pipeline moves past the next pulls.  The store applies its optimizer
        per distinct id with duplicates summed; in a world of several ranks
        each pushes its own examples, so an id on two ranks gets two
        applies, as the reference's per-worker async push does."""
        for key, grad in host_grads.items():
            self._host_stores[key].push_grad(ids[key], grad.numpy())

    def save_host_stores(self, directory: str, step: int, keep_max: int = 3) -> None:
        """Snapshot the host-tier stores beside the checkpoint, keeping the
        newest ``keep_max`` steps.  In process: ``host_stores/<step>/<key>.bin``
        in the native format, each file committed atomically.  On a PS
        fleet: ONE Save fan-out (each shard dumps and prunes its own slice of
        every table it serves), which callers rank-gate in a gang."""
        if not self._host_stores:
            return
        if self._remote_ps:
            next(iter(self._host_stores.values())).save_snapshot(
                directory, step, keep_max=keep_max)
            return
        root = os.path.join(directory, "host_stores")
        d = os.path.join(root, str(step))
        os.makedirs(d, exist_ok=True)
        for key, store in self._host_stores.items():
            # A crash mid-write leaves no snapshot or a whole one, never a
            # truncated file that poisons every relaunch.
            final = os.path.join(d, f"{key}.bin")
            tmp = durable.tmp_path(final)
            store.save(tmp)
            durable.atomic_replace(tmp, final)
        steps = sorted((int(x) for x in os.listdir(root) if x.isdigit()), reverse=True)
        for old in steps[max(keep_max, 1):]:
            shutil.rmtree(os.path.join(root, str(old)), ignore_errors=True)

    def restore_host_stores(self, directory: str, step: int) -> bool:
        """Load the host-tier snapshot of ``step``.  A table's missing file
        raises ``FileNotFoundError``: restored dense state with fresh rows is
        a torn checkpoint.  A file that fails to load re-initialises every
        store and raises the same, so a fallback to an older step never
        mixes rows of two steps.

        On a PS fleet the shards restored themselves at their (re)start
        (``ps/main.py``) and live on across worker restarts (async-PS: pushes
        are never un-applied); this checks the fleet instead.  A fleet that
        restored nothing, or divergent steps, fails an evaluation or
        prediction job; a training job logs divergence and goes on."""
        if not self._host_stores:
            return False
        if self._remote_ps:
            steps = next(iter(self._host_stores.values())).restored_steps()
            distinct = set(steps)
            job_type = getattr(self.config, "job_type", "training")
            scoring = job_type in ("evaluation", "prediction")
            if distinct == {None}:
                if scoring:
                    raise RuntimeError(
                        f"{job_type} job: no PS shard restored any snapshot — "
                        "refusing to score freshly initialized embedding rows")
                return True
            if len(distinct) > 1:
                msg = f"PS shards restored divergent steps {steps} — the fleet mixes model versions"
                if scoring:
                    raise RuntimeError(msg)
                logger.error("%s; continuing (async-PS training tolerance)", msg)
            return True
        paths = {key: os.path.join(directory, "host_stores", str(step), f"{key}.bin")
                 for key in self._host_stores}
        missing = [p for p in paths.values() if not os.path.exists(p)]
        if missing:
            # Checked before any store changes.
            raise FileNotFoundError(
                f"host store snapshot missing for step {step}: {missing[0]} "
                "(torn checkpoint — dense state and host rows must restore together)")
        try:
            for key, path in paths.items():
                self._host_stores[key].load(path)
        except (IOError, ValueError) as e:
            self._host_stores = self._local_host_stores()
            raise FileNotFoundError(
                f"host store snapshot for step {step} is unreadable ({e}); "
                "stores re-initialized") from e
        return True

    def has_local_host_stores(self) -> bool:
        """Whether host-tier rows live in this process (not on a PS fleet)."""
        return bool(self._host_stores) and not self._remote_ps

    def reset_host_stores(self) -> None:
        """Fresh in-process host stores (a restore that found no intact
        step must not keep a torn step's rows); a PS fleet keeps its own."""
        if self.has_local_host_stores():
            self._host_stores = self._local_host_stores()

    def wrap_host_stores(self, wrap) -> None:
        """Layer ``wrap(key, store)`` over every host-tier store: the serving
        tier puts its hot-id cache there (``serving/embedding_cache.py``).
        The wrapper needs the store's ``pull`` and ``dim``; training through
        it needs ``push_grad``, ``save`` and ``load`` too."""
        self._host_stores = {key: wrap(key, store) for key, store in self._host_stores.items()}

    # ---- evaluation ----

    def eval_step(
        self, state: TrainState, batch: Dict[str, torch.Tensor]
    ) -> Dict[str, torch.Tensor]:
        """Metrics of the module on a device batch (``_eval_step``; the
        public name is the one callers wrap, as ``train_step``'s)."""
        return self._eval_step(state, batch)

    def _eval_step(
        self, state: TrainState, batch: Dict[str, torch.Tensor]
    ) -> Dict[str, torch.Tensor]:
        """Metrics of the module on a device batch, without gradients and
        with the module in eval mode (``build_eval_step``'s ``local_eval``).
        A metrics function that takes a ``mask`` gets the batch's
        ``__mask__`` and returns means over real examples: the reference's
        psum(v * count) / psum(count) over the group, or v * count /
        max(count, 1e-12) without one; one without it gets the whole padded
        batch and the group's mean, as in the reference.  Metrics stay on
        the device."""
        spec = self.spec
        if spec.metrics is None:
            raise ValueError(f"model {spec.name!r} declares no metrics: it cannot evaluate")
        batch = dict(batch)
        mask = batch.pop(MASK_KEY, None)
        model = state.model
        was_training = model.training
        model.eval()
        try:
            with torch.no_grad():
                try:
                    out = self._apply(model, batch, train=False)
                except coll.CollectiveFailed as e:
                    raise CollectiveError(f"a collective of the eval forward failed: {e}") from e
                if mask is not None and self._metrics_take_mask:
                    metrics = spec.metrics(out, batch, mask=mask)
                    count = mask.float().sum()
                    if self._group is not None:
                        # psum(v * count) / psum(count), one reduction.
                        tree = {k: v * count for k, v in metrics.items()}
                        tree["__count__"] = count
                        summed = self._psum(tree)
                        total = summed.pop("__count__").clamp_min(1e-12)
                        return {k: v / total for k, v in summed.items()}
                    return {
                        k: v * count / count.clamp_min(1e-12) for k, v in metrics.items()
                    }
                metrics = dict(spec.metrics(out, batch))
                if self._group is not None:
                    n = coll.contributor_count(self.mesh, self.reduce_axes)
                    return {k: v / n for k, v in self._psum(metrics).items()}
                return metrics
        finally:
            model.train(was_training)

    def run_eval_step(self, state: TrainState, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """An eval step from a HOST batch: (host-tier pull ->) place ->
        evaluate."""
        if self.spec.host_io:
            return self.eval_step(state, self._place_host_batch(batch)[0])
        return self.eval_step(state, self.shard_batch(batch))

    # ---- the canonical state ----

    @staticmethod
    def _param_paths(model: torch.nn.Module) -> List[Tuple[str, torch.nn.Parameter]]:
        return [(name.replace(".", "/"), p) for name, p in model.named_parameters()]

    def snapshot_state(self, state: TrainState, copy: bool = True) -> "Snapshot":
        """The canonical state as fresh DEVICE copies (one clone per array,
        enqueued on the current stream): no later step's in-place update
        reaches them, so the host copy and the write can run off the task
        loop while training continues.  On the card, ``ready`` marks the
        clones' end on the stream.  ``copy=False``: the live tensors
        themselves where they are whole, valid until the next step.

        With sharded state this is a collective (every rank calls it at the
        same point, on the thread that runs the steps): each table's rows
        are all-gathered over the table axis and the dense leaves' moment
        shards over the data-parallel axis, so every rank ends with the
        whole canonical state and rank 0 can write it.  Without, it never
        waits for the device."""
        def take(t: torch.Tensor) -> torch.Tensor:
            return t.detach().clone() if copy else t.detach()

        snap = Snapshot({STEP_KEY: np.asarray(state.step, np.int64)})
        optimizer = state.optimizer
        opt_state = optimizer.state if optimizer is not None else {}
        zero = _zero_of(optimizer)
        stepped = bool(opt_state)  # every rank alike: the steps are lockstep
        zero_moments = self._gather_zero_moments(zero, opt_state) if zero and stepped else {}
        tp_dims = self._tp_dims(state.model)
        count = 0
        for st in opt_state.values():
            count = st.get("step", 0)
            break

        def whole(path: str, t: torch.Tensor) -> torch.Tensor:
            if path in self._table_keys:
                return self._gather_rows(t)
            if path in tp_dims:
                return self._gather(t, self.ctx.tp_group, tp_dims[path])
            return take(t)

        for path, p in self._param_paths(state.model):
            snap[PARAMS + path] = whole(path, p)
            if optimizer is None:
                continue
            full_shape = snap[PARAMS + path].shape
            if path in zero_moments:
                for (_, key), slot in zip(self._opt_slots, zero_moments[path]):
                    snap[key + path] = slot
                continue
            st = opt_state.get(p)
            for name, key in self._opt_slots:
                if st and st.get(name) is not None:
                    snap[key + path] = whole(path, st[name])
                else:
                    snap[key + path] = torch.zeros(full_shape, dtype=p.dtype, device=p.device)
        if optimizer is not None and self._opt_count:
            # torch keeps the count as a float tensor per parameter (all
            # equal); optax as one int32.
            snap[COUNT_KEY] = (
                take(count) if isinstance(count, torch.Tensor)
                else np.asarray(count, np.int32)
            )
        if self.device.type == "cuda":
            snap.ready = torch.cuda.Event()
            snap.ready.record()
        return snap

    def _gather_rows(self, local: torch.Tensor) -> torch.Tensor:
        """A row-sharded table (or its moment) whole: the table axis's ranks'
        rows in order (a fresh tensor); one rank: a clone."""
        return self._gather(local, self.ctx.group if self.ctx.axis_size > 1 else None, 0)

    def _gather(self, local: torch.Tensor, group, dim: int) -> torch.Tensor:
        """A leaf split over ``group``'s line on ``dim`` whole: the ranks'
        slices in line order along ``dim`` (a fresh tensor); no group: a
        clone."""
        if group is None:
            return local.detach().clone()
        try:
            full = self.reducer.all_gather(local.detach(), group, tag="snapshot")
        except coll.CollectiveFailed as e:
            raise CollectiveError(f"gathering a sharded leaf failed: {e}") from e
        n = full.numel() // local.numel()
        shape = list(local.shape)
        shape[dim] *= n
        return full.view((n,) + tuple(local.shape)).movedim(0, dim).reshape(shape)

    def _gather_zero_moments(self, zero: _ZeroShards, opt_state) -> Dict[str, tuple]:
        """Every dense leaf's optimizer slots ((mu, nu) or (trace,)),
        param-shaped, from the ranks' flat shards: ONE all-gather of this
        rank's shards of every slot."""
        names = [name for name, _ in self._opt_slots]
        mine = torch.cat([opt_state[p][name] for name in names for p in zero.params])
        try:
            full = self.reducer.all_gather(mine, self.mesh.group((self.opt_axis,)), tag="snapshot")
        except coll.CollectiveFailed as e:
            raise CollectiveError(f"gathering the optimizer's shards failed: {e}") from e
        full = full.view(zero.n, len(names), zero.total)
        slots = [full[:, j].reshape(-1) for j in range(len(names))]
        dense = torch.contiguous_format
        return {path: tuple(zero.unflatten(slot, e).clone(memory_format=dense) for slot in slots)
                for path, _, e in zero.leaves}

    @staticmethod
    def to_host(snapshot: Dict[str, Any]) -> Dict[str, np.ndarray]:
        """A canonical snapshot as host numpy arrays (the count back to
        optax's int32).  Card tensors copy into pinned host tensors (PyTorch's
        caching host allocator, so repeated saves reuse the blocks) on a side
        stream that waits only for the snapshot's ``ready`` event: a copy on
        the compute stream would queue the steps dispatched since the
        snapshot behind it, and a pageable copy would hold the driver, and
        every launch of the task loop, for its whole length."""
        out: Dict[str, Any] = {}
        on_card = [k for k, v in snapshot.items() if isinstance(v, torch.Tensor) and v.is_cuda]
        if on_card:
            stream = torch.cuda.Stream(snapshot[on_card[0]].device)
            ready = getattr(snapshot, "ready", None)
            if ready is not None:
                stream.wait_event(ready)
            with torch.cuda.stream(stream):
                for key in on_card:
                    value = snapshot[key].detach()
                    host = torch.empty(value.shape, dtype=value.dtype, pin_memory=True)
                    out[key] = host.copy_(value, non_blocking=True).numpy()
            stream.synchronize()
        for key, value in snapshot.items():
            if key in out:
                continue
            if isinstance(value, torch.Tensor):
                value = value.detach().to("cpu", copy=True).numpy()
            out[key] = np.asarray(value)
        if COUNT_KEY in out:
            out[COUNT_KEY] = out[COUNT_KEY].astype(np.int32)
        return {k: out[k] for k in snapshot}

    def host_state(self, state: TrainState) -> Dict[str, np.ndarray]:
        """The canonical state as host numpy arrays: the ONE layout
        checkpoints store and every restore reads."""
        return self.to_host(self.snapshot_state(state))

    def restore_template(self, state: TrainState) -> Dict[str, Tuple[int, ...]]:
        """The canonical state's keys and shapes for ``state``'s model (the
        reference's ``restore_template``: what a checkpoint must hold to
        restore into this layout): whole tables and param-shaped moments,
        whatever this rank keeps of them."""
        shapes: Dict[str, Tuple[int, ...]] = {STEP_KEY: ()}
        n = self.ctx.axis_size if self.sharded_embeddings else 1
        tp_dims = self._tp_dims(state.model)
        for path, p in self._param_paths(state.model):
            shape = tuple(p.shape)
            if path in self._table_keys:
                shape = (shape[0] * n,) + shape[1:]
            if path in tp_dims:
                d = tp_dims[path]
                shape = shape[:d] + (shape[d] * self.tp_size,) + shape[d + 1:]
            shapes[PARAMS + path] = shape
            if state.optimizer is not None:
                for _, key in self._opt_slots:
                    shapes[key + path] = shape
        if state.optimizer is not None and self._opt_count:
            shapes[COUNT_KEY] = ()
        return shapes

    def adopt_restored(
        self, arrays: Dict[str, Any], state: Optional[TrainState] = None
    ) -> TrainState:
        """Load a canonical state into ``state`` (default: a new one from
        ``init_state(None)``) on this trainer's device: parameters copied in
        place, the optimizer's slots set (Adam(W)'s moments and count, or
        SGD's trace), the step taken.  Under
        sharding each rank takes its rows of the tables and its shards of
        the dense moments, without a collective, so a checkpoint of any
        world size and layout restores into any other (the reference's
        ``shard_state`` of a canonical state is this, into a fresh state).  The paths must
        match the model's exactly; a state without an optimizer (a serving
        replica's) takes the parameters and the step only."""
        if state is None:
            state = self.init_state(None)
        model, optimizer = state.model, state.optimizer
        zero = _zero_of(optimizer)
        paths = self._param_paths(model)
        template = self.restore_template(state)
        params = {STEP_KEY} | {PARAMS + path for path, _ in paths}
        opt = {key + path for _, key in self._opt_slots for path, _ in paths}
        if self._opt_count:
            opt.add(COUNT_KEY)
        required = params | opt if optimizer is not None else params
        missing = required - set(arrays)
        unexpected = set(arrays) - params - opt
        if missing or unexpected:
            raise ValueError(
                "canonical state does not match the model: missing "
                f"{sorted(missing)[:8]}, unexpected {sorted(unexpected)[:8]}"
            )
        n, i = self.ctx.axis_size, self.ctx.axis_index
        tp_dims = self._tp_dims(model)
        tp_i = self.mesh.position(self.tp_axis) if tp_dims else 0

        def host(key: str, path: str) -> np.ndarray:
            arr = np.asarray(arrays[key], np.float32)
            if tuple(arr.shape) != template[key]:
                raise ValueError(f"{key}: shape {arr.shape} does not match {template[key]}")
            if path in self._table_keys and n > 1:
                k = arr.shape[0] // n
                arr = arr[i * k:(i + 1) * k]
            if path in tp_dims:
                arr = np.split(arr, self.tp_size, axis=tp_dims[path])[tp_i]
            return arr

        def load(arr: np.ndarray, dst: torch.Tensor) -> torch.Tensor:
            # On the card from pinned memory on the current stream, as
            # _to_device places a batch (a replica's reload runs on its own
            # stream while steps or flushes run on another).
            t = torch.from_numpy(np.ascontiguousarray(arr))
            dst.copy_(t.pin_memory() if dst.is_cuda else t, non_blocking=True)
            return dst

        def moment(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
            return load(arr, torch.empty_like(like, memory_format=torch.contiguous_format))

        with torch.no_grad():
            for path, p in paths:
                load(host(PARAMS + path, path), p)
            if zero is not None:
                zero.refresh()
            if optimizer is not None:
                # Adam's slots mean something once it has counted a step;
                # SGD's trace once the state has taken one.
                count = int(np.asarray(arrays[COUNT_KEY if self._opt_count else STEP_KEY]))
                capturable = any(g.get("capturable") for g in optimizer.param_groups)
                optimizer.state.clear()
                if count > 0:
                    def entry(slots, like):
                        st = {name: moment(a, like)
                              for (name, _), a in zip(self._opt_slots, slots)}
                        if self._opt_count:
                            # A capturable Adam keeps it on the card.
                            st["step"] = torch.tensor(
                                float(count), dtype=torch.float32,
                                device=like.device if capturable else "cpu")
                        return st

                    shards = {}
                    if zero is not None:
                        shards = {path: (e, sp) for (path, _, e), sp in zip(zero.leaves, zero.params)}
                    for path, p in paths:
                        slots = [host(key + path, path) for _, key in self._opt_slots]
                        if path in shards:
                            e, sp = shards[path]
                            slots = [zero.split(torch.from_numpy(np.ascontiguousarray(a)).reshape(-1), e)
                                     .numpy() for a in slots]
                            optimizer.state[sp] = entry(slots, sp)
                        else:
                            optimizer.state[p] = entry(slots, p)
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
        return TrainState(int(np.asarray(arrays[STEP_KEY])), model, optimizer)

    def opt_state_bytes_per_device(self, state: TrainState) -> Dict[str, int]:
        """This rank's resident optimizer-state bytes (the moments and the
        counts), keyed by its rank: the number the sharded optimizer and
        the sharded tables cut (the reference keys device ids)."""
        total = 0
        if state.optimizer is not None:
            for st in state.optimizer.state.values():
                total += sum(int(v.nbytes) for v in st.values() if isinstance(v, torch.Tensor))
        return {str(self.mesh.rank): total}

    def collective_bytes_per_step(self, state: TrainState) -> Dict[str, int]:
        """Analytic per-replica inter-host bytes of one step's dense-gradient
        all-reduce over the reduce axes under this mesh's resolved topology
        against the flat route (``collectives.interhost_bytes_per_step``),
        sharded tables left out: their gradients never cross the table
        axis.  A tensor-parallel leaf counts its local shard, 1/tp of it:
        each rank reduces only that over ``dp``."""
        sizes = [p.numel() for path, p in self._param_paths(state.model)
                 if path not in self._table_keys]
        n = coll.contributor_count(self.mesh, self.reduce_axes)
        return {
            "flat": coll.interhost_bytes_per_step(sizes, n, None),
            "resolved": coll.interhost_bytes_per_step(sizes, n, self.reducer.topo),
        }

    # ---- prediction ----

    def run_predict_step(self, state: torch.nn.Module, batch: Dict[str, Any]) -> Any:
        """Per-example outputs of the module ``state`` on ``batch`` (numpy
        arrays or tensors; ``__mask__`` is dropped), as tensors on the
        device."""
        batch = dict(batch)
        batch.pop(MASK_KEY, None)
        if self.spec.host_io:
            batch.update(self._pull_host_rows(batch, local=False)[0])
        # The whole batch on every rank: prediction is per example, so a
        # sequence-parallel model attends over whole sequences here (no
        # ring); a sharded model's collectives still run.
        tensors = {k: self._to_device(v) for k, v in batch.items()}
        ctx = self.ctx
        if self.spec.batch_shard_dim == 1:
            ctx = dataclasses.replace(ctx, axis_size=1, axis_index=0)
        with torch.inference_mode():
            if self.spec.predict is not None:
                if self._predict_takes_ctx:
                    return self.spec.predict(state, tensors, ctx=ctx)
                return self.spec.predict(state, tensors)
            return self._apply(state, tensors, train=False, ctx=ctx)


def outputs_to_numpy(outputs: Any) -> Any:
    """Device outputs -> host numpy, leaf-wise for dict-shaped outputs (the
    reference's ``jax.device_get``)."""
    if isinstance(outputs, dict):
        return {k: outputs_to_numpy(v) for k, v in outputs.items()}
    return outputs.detach().cpu().numpy()
