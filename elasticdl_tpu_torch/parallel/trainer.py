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
``restore_template`` and ``adopt_restored``).  Host-tier tables and the
fused scan variants are later slices of the port.

Data parallelism over a process group (``mesh``: ``parallel/mesh.py``):
each rank owns one device and holds the whole state; every rank feeds the
same global batch and ``shard_batch`` takes its contiguous slice of the
examples (dim 0, over every axis for a data-parallel model and over the
outer axes for a sequence-parallel one, the reference's
``_batch_spec_for``).  A step weighs the loss by ``count / psum(count)``
(or ``w / |G'|`` without a mask: this rank's contributor weight over the
mask's sum), sums the gradients, the loss and the metrics over the group
through ``collectives`` in one reduction, then steps the optimizer, so a
failed collective leaves the module and the optimizer as they were
(``CollectiveError``).  Eval reduces the same way.  The state stays
replicated, so checkpoints stay topology-agnostic.  A mesh whose inner
axis is larger than one rank (the sequence ring, sharded tables) is a
later slice and raises.

The canonical state is a flat ``{path: numpy array}`` dict:

- ``params/<p>``: each parameter, ``<p>`` its module path with ``/`` for
  ``.`` — the JAX parameter-tree path (``params/blocks/b0/wqkv``), as
  ``transformer_lm.params_to_jax`` gives it;
- ``opt_state/mu/<p>`` and ``opt_state/nu/<p>``: the Adam(W) moments (optax's
  ``ScaleByAdamState`` ``mu``/``nu``; torch's ``exp_avg``/``exp_avg_sq``);
- ``opt_state/count``: the optimizer's update count; ``step``: the step.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from elasticdl_tpu_torch.common.device import resolve_device, set_matmul_precision
from elasticdl_tpu_torch.common.metrics import HIST_PREFIX
from elasticdl_tpu_torch.models.spec import ModelSpec
from elasticdl_tpu_torch.parallel import collectives as coll
from elasticdl_tpu_torch.parallel.mesh import Mesh

#: The padding mask of a batch: real examples 1.0, padding 0.0.  The loss
#: weighs by it; the model never sees it (the reference pops it too).
MASK_KEY = "__mask__"

#: Canonical-state path prefixes and keys (see the module docstring).
PARAMS, MU, NU = "params/", "opt_state/mu/", "opt_state/nu/"
COUNT_KEY, STEP_KEY = "opt_state/count", "step"


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
    group timed out).  Every collective of a step runs before the
    optimizer's update, so the module and the optimizer are as they were
    before the step."""


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
        self._loss_takes_mask = spec.loss is not None and (
            "mask" in inspect.signature(spec.loss).parameters
        )
        self._metrics_take_mask = spec.metrics is not None and (
            "mask" in inspect.signature(spec.metrics).parameters
        )
        self._adopt_mesh_axes(mesh or Mesh({"dp": 1}))

    # ---- the mesh ----

    def _adopt_mesh_axes(self, mesh: Mesh) -> None:
        """Axis roles (the reference's ``_adopt_mesh_axes``): reductions
        over every axis; contributors are the EXAMPLE shards, every axis
        for a data-parallel model and the outer axes for a
        sequence-parallel one (its inner-axis slices hold pieces of the
        same examples).  The collective topology resolves here and the
        contributor mask resets to all-active."""
        names = mesh.axis_names
        inner = mesh.shape[names[-1]]
        if inner > 1 and (len(names) > 1 or self.spec.batch_shard_dim == 1):
            if self.spec.batch_shard_dim == 1:
                raise NotImplementedError(
                    f"sequence parallelism over a mesh axis of {inner} ranks (the "
                    "ring) is not ported yet (ROADMAP, PyTorch port queue: ring "
                    "and tensor-parallel attention); set --dcn_data_parallelism "
                    "to the world size"
                )
            raise NotImplementedError(
                f"embedding tables sharded over an ep axis of {inner} ranks are not "
                "ported yet (ROADMAP, PyTorch port queue: sharded embedding "
                "lookups); set --dcn_data_parallelism to the world size"
            )
        self.mesh = mesh
        self.reduce_axes = names
        self.contributor_axes = names if self.spec.batch_shard_dim == 0 else names[:-1]
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

    def _weight(self) -> Tuple[float, float]:
        """This rank's contributor weight and the mask's sum |G'| (the
        mask is replicated, so the sum is known here without a collective;
        a sum of 0/1 floats is exact)."""
        w = (coll.contributor_weight(self._active_np, self.mesh, self.contributor_axes)
             if self.contributor_axes else float(self._active_np[0]))
        return w, max(float(self._active_np.sum()), 1.0)

    def _psum(self, tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        try:
            return self.reducer.psum(tree, self.reduce_axes)
        except Exception as e:
            raise CollectiveError(f"collective over {self.reduce_axes} failed: {e}") from e

    # ---- state ----

    def init_state(self, seed: Optional[int]) -> TrainState:
        """Step 0: fresh weights from ``seed`` (None: uninitialised storage,
        for a restore to fill) on this trainer's device and, when the spec
        trains, their optimizer."""
        model = self.spec.init(seed=seed, device=self.device)
        optimizer = self.spec.optimizer(model.parameters()) if self.spec.optimizer else None
        return TrainState(step=0, model=model, optimizer=optimizer)

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
        tensors), on the device: the contiguous slice of the examples
        (dim 0) at its contributor index, every rank feeding the same
        global batch (the reference's ``_place_global``).  One rank:
        placing is all it comes to."""
        n = self.num_contributors()
        if n > 1:
            i = coll.contributor_index(self.mesh, self.contributor_axes)
            parts = {}
            for k, v in batch.items():
                if np.ndim(v) == 0:
                    parts[k] = v
                    continue
                if v.shape[0] % n:
                    raise ValueError(
                        f"batch dimension 0 of {k!r} (size {v.shape[0]}) not divisible "
                        f"by its mesh axes {self.contributor_axes} (size {n})"
                    )
                size = v.shape[0] // n
                parts[k] = v[i * size:(i + 1) * size]
            batch = parts
        return {k: self._to_device(v) for k, v in batch.items()}

    # ---- training ----

    def train_step(
        self, state: TrainState, batch: Dict[str, torch.Tensor]
    ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One step on a device batch: the loss (weighted by ``__mask__``
        when the loss takes one), its gradients, the optimizer update.
        Metrics stay on the device: ``loss`` is the weighted loss the step
        minimised; the others come from ``spec.metrics``, over real rows
        when both it and the loss take the mask, as in the reference.
        Histogram metrics (``HIST_PREFIX``, the AUC's) are evaluation
        machinery and dropped here, as the reference's train step does."""
        spec = self.spec
        if spec.loss is None or state.optimizer is None:
            raise ValueError(f"model {spec.name!r} declares no loss or optimizer: it cannot train")
        if self._group is not None:
            return self._group_train_step(state, batch)
        batch = dict(batch)
        mask = batch.pop(MASK_KEY, None)
        model, optimizer = state.model, state.optimizer
        optimizer.zero_grad(set_to_none=True)
        out = spec.apply(model, batch, train=True)
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
        return TrainState(state.step + 1, model, optimizer), metrics

    def _group_train_step(
        self, state: TrainState, batch: Dict[str, torch.Tensor]
    ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """The data-parallel step over the process group (the reference's
        ``local_step``): this rank's loss weighed by ``count / total``
        (``total = psum(count)``, each count times this rank's contributor
        weight) or by ``w / |G'|``, its gradients; then ONE reduction of the
        gradients, the loss and the metrics (``psum(v * count) / total``
        or ``psum(v * w) / |G'|``) before the optimizer's update."""
        spec = self.spec
        batch = dict(batch)
        mask = batch.pop(MASK_KEY, None)
        model, optimizer = state.model, state.optimizer
        w, n_active = self._weight()
        optimizer.zero_grad(set_to_none=True)
        out = spec.apply(model, batch, train=True)
        masked = mask is not None and self._loss_takes_mask
        if masked:
            # The real examples of the active ranks: one scalar reduction
            # before the backward, which weighs by it.
            count = mask.float().sum() * w
            total = self._psum({"count": count})["count"].clamp_min(1e-12)
            loss = spec.loss(out, batch, mask=mask) * count / total
        else:
            loss = spec.loss(out, batch) * w / n_active
        loss.backward()
        tree: Dict[str, torch.Tensor] = {}
        params = [p for p in model.parameters() if p.grad is not None]
        for i, p in enumerate(params):
            tree[f"grad/{i}"] = p.grad
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
        summed = self._psum(tree)
        for i, p in enumerate(params):
            p.grad = summed[f"grad/{i}"]
        optimizer.step()
        by_count = masked and self._metrics_take_mask
        metrics = {
            key[len("metric/"):]: v / total if by_count else v / n_active
            for key, v in summed.items() if key.startswith("metric/")
        }
        metrics["loss"] = summed["loss"]
        return TrainState(state.step + 1, model, optimizer), metrics

    def run_train_step(self, state: TrainState, batch: Dict[str, Any]):
        """A training step from a HOST batch: place, then step."""
        return self.train_step(state, self.shard_batch(batch))

    def run_train_steps(
        self,
        state: TrainState,
        batches: Iterable[Dict[str, Any]],
        pre_sharded: bool = False,
    ) -> Tuple[TrainState, List[Dict[str, torch.Tensor]]]:
        """Train over an iterable of host batches (``pre_sharded``: already
        on the device), synchronously: the reference's loop without
        host-tier tables, whose async pull pipeline is not ported yet.
        Returns (state, [metrics per batch]); a failure raises
        ``TrainLoopError``."""
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
                state, metrics = self.train_step(state, batch)
            except CollectiveError as e:
                # The failed step never reached the update: the state
                # before it is intact.
                raise TrainLoopError(state, e) from e
            except Exception as e:
                raise TrainLoopError(None, e) from e
            metrics_out.append(metrics)
            last_good = state

    # ---- evaluation ----

    def eval_step(
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
                out = spec.apply(model, batch, train=False)
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
        """An eval step from a HOST batch: place, then evaluate."""
        return self.eval_step(state, self.shard_batch(batch))

    # ---- the canonical state ----

    @staticmethod
    def _param_paths(model: torch.nn.Module) -> List[Tuple[str, torch.nn.Parameter]]:
        return [(name.replace(".", "/"), p) for name, p in model.named_parameters()]

    def snapshot_state(self, state: TrainState, copy: bool = True) -> "Snapshot":
        """The canonical state as fresh DEVICE copies (one clone per array,
        enqueued on the current stream): no later step's in-place update
        reaches them, so the host copy and the write can run off the task
        loop while training continues.  Never waits for the device; on the
        card, ``ready`` marks the clones' end on the stream.  ``copy=False``:
        the live tensors themselves, valid until the next step."""
        def take(t: torch.Tensor) -> torch.Tensor:
            return t.detach().clone() if copy else t.detach()

        snap = Snapshot({STEP_KEY: np.asarray(state.step, np.int64)})
        count = 0
        opt_state = state.optimizer.state if state.optimizer is not None else {}
        for path, p in self._param_paths(state.model):
            snap[PARAMS + path] = take(p)
            if state.optimizer is None:
                continue
            st = opt_state.get(p)
            if st:
                snap[MU + path] = take(st["exp_avg"])
                snap[NU + path] = take(st["exp_avg_sq"])
                count = st["step"]
            else:
                snap[MU + path] = torch.zeros_like(p, memory_format=torch.contiguous_format)
                snap[NU + path] = torch.zeros_like(p, memory_format=torch.contiguous_format)
        if state.optimizer is not None:
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

    def adopt_restored(
        self, arrays: Dict[str, Any], state: Optional[TrainState] = None
    ) -> TrainState:
        """Load a canonical state into ``state`` (default: a new one from
        ``init_state(None)``) on this trainer's device: parameters copied in
        place, AdamW moments and count set, the step taken.  The paths
        must match the model's exactly; a state without an optimizer (a
        serving replica's) takes the parameters and the step only."""
        if state is None:
            state = self.init_state(None)
        model, optimizer = state.model, state.optimizer
        paths = self._param_paths(model)
        params = {STEP_KEY} | {PARAMS + path for path, _ in paths}
        opt = {COUNT_KEY} | {MU + path for path, _ in paths} | {NU + path for path, _ in paths}
        required = params | opt if optimizer is not None else params
        missing = required - set(arrays)
        unexpected = set(arrays) - params - opt
        if missing or unexpected:
            raise ValueError(
                "canonical state does not match the model: missing "
                f"{sorted(missing)[:8]}, unexpected {sorted(unexpected)[:8]}"
            )

        def load(value: Any, dst: torch.Tensor) -> torch.Tensor:
            arr = np.asarray(value, np.float32)
            if tuple(arr.shape) != tuple(dst.shape):
                raise ValueError(f"shape {arr.shape} does not match {tuple(dst.shape)}")
            # On the card from pinned memory on the current stream, as
            # _to_device places a batch (a replica's reload runs on its own
            # stream while steps or flushes run on another).
            host = torch.from_numpy(np.ascontiguousarray(arr))
            dst.copy_(host.pin_memory() if dst.is_cuda else host, non_blocking=True)
            return dst

        def moment(value: Any, p: torch.Tensor) -> torch.Tensor:
            return load(value, torch.empty_like(p, memory_format=torch.contiguous_format))

        with torch.no_grad():
            for path, p in paths:
                load(arrays[PARAMS + path], p)
            if optimizer is not None:
                count = int(np.asarray(arrays[COUNT_KEY]))
                optimizer.state.clear()
                if count > 0:
                    for path, p in paths:
                        optimizer.state[p] = {
                            "step": torch.tensor(float(count), dtype=torch.float32),
                            "exp_avg": moment(arrays[MU + path], p),
                            "exp_avg_sq": moment(arrays[NU + path], p),
                        }
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
        return TrainState(int(np.asarray(arrays[STEP_KEY])), model, optimizer)

    # ---- prediction ----

    def run_predict_step(self, state: torch.nn.Module, batch: Dict[str, Any]) -> Any:
        """Per-example outputs of the module ``state`` on ``batch`` (numpy
        arrays or tensors; ``__mask__`` is dropped), as tensors on the
        device."""
        batch = dict(batch)
        batch.pop(MASK_KEY, None)
        # The whole batch on every rank: prediction is per example and
        # needs no collective.
        tensors = {k: self._to_device(v) for k, v in batch.items()}
        with torch.inference_mode():
            if self.spec.predict is not None:
                return self.spec.predict(state, tensors)
            return self.spec.apply(state, tensors, train=False)


def outputs_to_numpy(outputs: Any) -> Any:
    """Device outputs -> host numpy, leaf-wise for dict-shaped outputs (the
    reference's ``jax.device_get``)."""
    if isinstance(outputs, dict):
        return {k: outputs_to_numpy(v) for k, v in outputs.items()}
    return outputs.detach().cpu().numpy()
