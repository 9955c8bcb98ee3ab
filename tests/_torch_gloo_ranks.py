"""Run a function in a gloo world of spawned processes on the CPU.

The helper of the port's gang tests (tests/test_torch_collectives.py,
tests/test_torch_distributed.py, tests/test_torch_gang.py).  It imports
torch and the port only, so the spawned processes start without JAX.
``run_ranks(fn, world, *args)`` starts ``world`` processes, each joining
one world through ``parallel/distributed.initialize`` on a free localhost
port, calls ``fn(rank, world, *args)`` (``fn`` a module-level function of
a module the children can import, such as this one) and returns the
results in rank order; an exception in a rank fails the call with that
rank's traceback.
"""

from __future__ import annotations

import os
import queue
import socket
import traceback

import torch.multiprocessing as mp

#: Each spawned world must finish within this many seconds.
RANKS_TIMEOUT_S = 120.0


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _entry(rank, world, port, fn, args, out):
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    import torch

    torch.set_num_threads(1)
    from elasticdl_tpu_torch.common.device import resolve_device
    from elasticdl_tpu_torch.parallel import distributed

    try:
        spec = distributed.DistributedSpec(f"127.0.0.1:{port}", world, rank, heartbeat_timeout_s=60.0)
        # The worker processes' device variable; these worlds are the CPU's.
        distributed.initialize(spec, resolve_device(os.environ.get("ELASTICDL_TORCH_DEVICE", "cpu")))
        try:
            out.put((rank, True, fn(rank, world, *args)))
        finally:
            distributed.shutdown()
    except BaseException:
        out.put((rank, False, traceback.format_exc()))


def run_ranks(fn, world: int, *args, timeout_s: float = RANKS_TIMEOUT_S) -> list:
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_entry, args=(r, world, port, fn, args, out), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    results = {}
    try:
        for _ in range(world):
            rank, ok, value = out.get(timeout=timeout_s)
            if not ok:
                raise AssertionError(f"rank {rank} failed:\n{value}")
            results[rank] = value
    except queue.Empty:
        raise AssertionError(f"the world of {world} did not finish in {timeout_s:.0f}s "
                             f"(ranks done: {sorted(results)})")
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
    return [results[r] for r in range(world)]


# ---- functions the ranks run --------------------------------------------------------


def collectives_cases(rank, world, trees, active, local_size):
    """psum and pmean of ``trees[rank]`` in flat and hierarchical mode,
    the masked psum (each leaf times this rank's weight in ``active``) and
    the plain all-ones-mask psum, as numpy; the topology's description."""
    import numpy as np
    import torch

    from elasticdl_tpu_torch.parallel import collectives as coll
    from elasticdl_tpu_torch.parallel.mesh import create_mesh

    mesh = create_mesh()
    tree = {k: torch.from_numpy(np.asarray(v)) for k, v in trees[rank].items()}
    out = {}
    topo = coll.resolve_topology(mesh, ("dp",), mode="hierarchical", local_size=local_size)
    for name, t in (("flat", None), ("hier", topo)):
        red = coll.Reducer(mesh, t)
        out[name + "_psum"] = {k: v.numpy().copy() for k, v in red.psum(tree, "dp").items()}
        out[name + "_pmean"] = {k: v.numpy().copy() for k, v in red.pmean(tree, "dp").items()}
        w = coll.contributor_weight(active, mesh, ("dp",))
        masked = red.psum({k: v * w for k, v in tree.items()}, "dp")
        n_active = float(np.asarray(active).sum())
        out[name + "_masked"] = {k: (v / n_active).numpy().copy() for k, v in masked.items()}
        ones = red.psum({k: v * 1.0 for k, v in tree.items()}, "dp")
        out[name + "_ones"] = {k: (v / float(world)).numpy().copy() for k, v in ones.items()}
    out["describe"] = topo.describe() if topo is not None else None
    out["auto"] = coll.resolve_topology(mesh, ("dp",), mode="auto")
    return out


def all_reduce_one(rank, world):
    """One all_reduce of the rank's id over the world, and the backend."""
    import torch
    import torch.distributed as dist

    x = torch.tensor([float(rank + 1)])
    dist.all_reduce(x)
    return float(x[0]), dist.get_backend(), dist.get_world_size()


def data_parallel_steps(rank, world, kind, model_kw, jax_params, batches):
    """Train ``batches`` (global host batches) on this rank's slice over a
    ``(dp=world, ep=1)`` mesh, from the carried JAX weights; return each
    step's metrics, the parameters as the JAX tree and one eval step's
    metrics on the first batch."""
    import numpy as np

    from elasticdl_tpu_torch.parallel.mesh import create_mesh
    from elasticdl_tpu_torch.parallel.trainer import Trainer

    if kind == "transformer_lm":
        from elasticdl_tpu_torch.models import transformer_lm as mod
    else:
        from elasticdl_tpu_torch.models import deepfm as mod
    trainer = Trainer(mod.model_spec(**model_kw), device="cpu",
                      mesh=create_mesh(dcn_parallelism=world))
    state = trainer.init_state(0)
    state.model.load_jax_params(jax_params)
    metrics = []
    for batch in batches:
        state, m = trainer.run_train_step(state, batch)
        metrics.append({k: np.asarray(v.detach()).copy() for k, v in m.items()})
    ev = trainer.run_eval_step(state, batches[0])
    return {
        "metrics": metrics,
        "params": mod.params_to_jax(state.model),
        "eval": {k: np.asarray(v).copy() for k, v in ev.items()},
    }


def card_reduce_and_steps(rank, world, model_kw, batches):
    """On the card, under the world's backend: the psum of one card tensor
    a rank, then ``batches`` through a data-parallel ``transformer_lm``
    trainer; returns the sum, each step's loss and the state as host arrays."""
    import numpy as np
    import torch

    from elasticdl_tpu_torch.models import transformer_lm
    from elasticdl_tpu_torch.parallel import collectives as coll
    from elasticdl_tpu_torch.parallel.mesh import create_mesh
    from elasticdl_tpu_torch.parallel.trainer import Trainer

    mesh = create_mesh(dcn_parallelism=world)
    x = torch.full((5,), float(rank + 1), device="cuda")
    summed = coll.Reducer(mesh).psum({"x": x}, "dp")["x"].cpu().numpy()
    trainer = Trainer(transformer_lm.model_spec(**model_kw), device="cuda", mesh=mesh)
    state = trainer.init_state(0)
    losses = []
    for batch in batches:
        state, m = trainer.run_train_step(state, batch)
        losses.append(float(m["loss"]))
    host = {k: np.asarray(v) for k, v in trainer.host_state(state).items()}
    return summed, losses, host


def sharded_lookup_cases(rank, world, cases):
    """Each case (``dict``: ``impl``, the global ``table`` in its layout,
    ``dim``, the global ``ids`` and cotangents ``cot``) through the port's
    sharded lookup: this rank holds rows ``[rank*P/n, (rank+1)*P/n)`` of
    the table and slice ``rank`` of the ids (dim 0).  Returns, per case,
    this rank's output, the gradient of ``sum(where(isnan(out), 0, out *
    cot))`` with respect to its rows, and the collective calls of the
    forward and backward as ``(op, rows of the input)`` (rows of the flat
    input for the gathers)."""
    import numpy as np
    import torch

    from elasticdl_tpu_torch.ops.embedding import ParallelContext, embedding_lookup
    from elasticdl_tpu_torch.parallel import collectives as coll
    from elasticdl_tpu_torch.parallel.mesh import create_mesh

    class RecordingReducer(coll.Reducer):
        def all_gather(self, x, group, tag="grads"):
            self.recorded.append(("all_gather", x.numel()))
            return super().all_gather(x, group, tag)

        def reduce_scatter(self, flat, group, tag="grads"):
            self.recorded.append(("reduce_scatter", flat.numel()))
            return super().reduce_scatter(flat, group, tag)

        def all_to_all(self, out, x, group, tag="lookup"):
            self.recorded.append(("all_to_all", x.shape[0]))
            return super().all_to_all(out, x, group, tag)

    mesh = create_mesh()
    reducer = RecordingReducer(mesh)
    out = []
    for case in cases:
        ctx = ParallelContext(axis_name="dp", sharded_embeddings=True,
                              embedding_impl=case["impl"], axis_size=world,
                              axis_index=rank, group=mesh.group(("dp",)), reducer=reducer)
        table, ids, cot = case["table"], case["ids"], case["cot"]
        k, b = table.shape[0] // world, ids.shape[0] // world
        local = torch.tensor(table[rank * k:(rank + 1) * k], requires_grad=True)
        my_ids = torch.from_numpy(ids[rank * b:(rank + 1) * b].copy())
        my_cot = torch.from_numpy(cot[rank * b:(rank + 1) * b].copy())
        reducer.recorded = []
        vec = embedding_lookup(local, my_ids, ctx, dim=case["dim"])
        torch.where(torch.isnan(vec), 0.0, vec * my_cot).sum().backward()
        out.append((vec.detach().numpy().copy(), local.grad.numpy().copy(), reducer.recorded))
    return {"cases": out, "by_op": dict(reducer.by_op), "calls_by_op": dict(reducer.calls_by_op)}


def sharded_lookup_cases_one_rank_group(rank, world, cases):
    """``sharded_lookup_cases`` in a world of one over a one-rank gloo
    group, which ``distributed.initialize`` does not make for one process."""
    import datetime

    import torch.distributed as dist

    t = datetime.timedelta(seconds=60)
    store = dist.TCPStore("127.0.0.1", free_port(), 1, True, timeout=t)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1, timeout=t)
    try:
        return sharded_lookup_cases(rank, world, cases)
    finally:
        dist.destroy_process_group()


def _canonical_from(trainer, state, params_tree):
    """A canonical state holding ``params_tree`` (a JAX params tree of
    numpy arrays, whole tables) with zero moments: what a checkpoint of
    those weights before any step holds."""
    import numpy as np

    from elasticdl_tpu_torch.parallel.trainer import COUNT_KEY, MU, NU, PARAMS, STEP_KEY

    def flat(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, prefix + k + "/")
            else:
                yield prefix + k, np.asarray(v, np.float32)

    arrays = {STEP_KEY: np.asarray(0, np.int64), COUNT_KEY: np.asarray(0, np.int32)}
    for path, v in flat(params_tree):
        arrays[PARAMS + path] = v
        arrays[MU + path] = np.zeros_like(v)
        arrays[NU + path] = np.zeros_like(v)
    return arrays


def ps_steps(rank, world, dcn, variants, model_kw, jax_params, batches):
    """DeepFM under ``--distribution_strategy=ParameterServer`` over the
    ``create_mesh(dcn_parallelism=dcn)`` mesh of this world, from the
    carried JAX weights, once per variant ``(impl, optimizer_sharding)``:
    each step's metrics, the gathered canonical parameters after the
    steps, one eval step's metrics, this rank's table rows and optimizer
    bytes, and the lookup's collective seconds by op."""
    import numpy as np

    from elasticdl_tpu_torch.common.config import JobConfig
    from elasticdl_tpu_torch.models import deepfm
    from elasticdl_tpu_torch.parallel.mesh import create_mesh
    from elasticdl_tpu_torch.parallel.trainer import Trainer

    mesh = create_mesh(dcn_parallelism=dcn)
    out = {}
    for impl, opt in variants:
        config = JobConfig(distribution_strategy="ParameterServer", embedding_lookup_impl=impl,
                           optimizer_sharding=opt, dcn_data_parallelism=dcn)
        trainer = Trainer(deepfm.model_spec(**model_kw), device="cpu", mesh=mesh, config=config)
        state = trainer.adopt_restored(_canonical_from(trainer, trainer.init_state(0), jax_params))
        metrics = []
        for batch in batches:
            state, m = trainer.run_train_step(state, batch)
            metrics.append({k: np.asarray(v.detach()).copy() for k, v in m.items()})
        ev = trainer.run_eval_step(state, batches[0])
        host = trainer.host_state(state)
        out[(impl, opt)] = {
            "metrics": metrics,
            "params": {k[len("params/"):]: np.asarray(v) for k, v in host.items()
                       if k.startswith("params/")},
            "eval": {k: np.asarray(v).copy() for k, v in ev.items()},
            "table_rows": int(state.model.fm_table.shape[0]),
            "impl": trainer.ctx.embedding_impl,
            "sharded_opt": trainer._opt_plan is not None,
            "by_op": dict(trainer.reducer.by_op),
        }
    return out


def opt_shard_steps(rank, world, model_kw, batches, canonical=None):
    """``transformer_lm`` over ``(dp=world, ep=1)``: the replicated and the
    sharded optimizer from the same seed on the same global batches (each
    step's loss, the canonical state after, this rank's optimizer bytes);
    with ``canonical``, the sharded trainer first restores it and reports
    what it gathers back before and after one more step."""
    import numpy as np

    from elasticdl_tpu_torch.common.config import JobConfig
    from elasticdl_tpu_torch.models import transformer_lm
    from elasticdl_tpu_torch.parallel.mesh import create_mesh
    from elasticdl_tpu_torch.parallel.trainer import Trainer

    mesh = create_mesh(dcn_parallelism=world)
    spec = transformer_lm.model_spec(**model_kw)

    def host(trainer, state):
        return {k: np.asarray(v).copy() for k, v in trainer.host_state(state).items()}

    sharded = Trainer(spec, device="cpu", mesh=mesh,
                      config=JobConfig(optimizer_sharding="sharded"))
    if canonical is not None:
        state = sharded.adopt_restored(canonical)
        restored = host(sharded, state)
        state, m = sharded.run_train_step(state, batches[0])
        return {"restored": restored, "after": host(sharded, state), "loss": float(m["loss"]),
                "opt_bytes": sharded.opt_state_bytes_per_device(state)}
    out = {}
    for name, trainer in (("sharded", sharded),
                          ("replicated", Trainer(spec, device="cpu", mesh=mesh,
                                                 config=JobConfig()))):
        state = trainer.init_state(0)
        losses = []
        for batch in batches:
            state, m = trainer.run_train_step(state, batch)
            losses.append(float(m["loss"]))
        out[name] = {"losses": losses, "state": host(trainer, state),
                     "opt_bytes": sum(trainer.opt_state_bytes_per_device(state).values()),
                     "plan": trainer._opt_plan is not None,
                     "by_op": dict(trainer.reducer.by_op)}
    return out


def host_tier_steps(rank, world, model_kw, jax_params, ps_addresses, batches):
    """Host-tier DeepFM over a ``{dp: world}`` mesh against the PS fleet at
    ``ps_addresses``, from the carried JAX weights: each step's loss and
    the ids this rank pushed, step by step."""
    import numpy as np

    from elasticdl_tpu_torch.common.config import JobConfig
    from elasticdl_tpu_torch.models import deepfm
    from elasticdl_tpu_torch.parallel.mesh import create_mesh
    from elasticdl_tpu_torch.parallel.trainer import Trainer

    trainer = Trainer(deepfm.model_spec(**model_kw), device="cpu",
                      mesh=create_mesh(dcn_parallelism=world),
                      config=JobConfig(ps_addresses=ps_addresses))
    store = trainer._host_stores[deepfm.HOST_FM_KEY]
    pushed = []
    push = store.push_grad
    store.push_grad = lambda ids, grads: (pushed.append(np.array(ids)), push(ids, grads))[1]
    state = trainer.init_state(0)
    state.model.load_jax_params(jax_params)
    losses = []
    for batch in batches:
        state, m = trainer.run_train_step(state, batch)
        losses.append(float(m["loss"]))
    return {"losses": losses, "pushed": pushed, "remote": trainer._remote_ps}


def wide_deep_steps(rank, world, variants, model_kw, jax_params, batches):
    """Wide&Deep (two row-shardable tables: ``wide`` of dim 1, packed 128
    rows to a physical row, and ``deep_embedding``) from the carried JAX
    weights on the flat ``{dp: world}`` mesh, once per variant
    ``(strategy, impl)``: each step's loss, the gathered canonical
    parameters after the steps, and this rank's rows of each table."""
    import numpy as np

    from elasticdl_tpu_torch.common.config import JobConfig
    from elasticdl_tpu_torch.models import wide_deep
    from elasticdl_tpu_torch.parallel.mesh import create_mesh
    from elasticdl_tpu_torch.parallel.trainer import Trainer

    mesh = create_mesh(dcn_parallelism=1)
    out = {}
    for strategy, impl in variants:
        config = JobConfig(distribution_strategy=strategy, embedding_lookup_impl=impl)
        trainer = Trainer(wide_deep.model_spec(**model_kw), device="cpu", mesh=mesh,
                          config=config)
        state = trainer.adopt_restored(_canonical_from(trainer, trainer.init_state(0), jax_params))
        losses = []
        for batch in batches:
            state, m = trainer.run_train_step(state, batch)
            losses.append(float(m["loss"]))
        host = trainer.host_state(state)
        out[(strategy, impl)] = {
            "losses": losses,
            "params": {k[len("params/"):]: np.asarray(v) for k, v in host.items()
                       if k.startswith("params/")},
            "rows": (int(state.model.wide.shape[0]), int(state.model.deep_embedding.shape[0])),
            "impl": trainer.ctx.embedding_impl,
        }
    return out


def ring_tp_cases(rank, world, q, k, v, cot, tp_x, tp_cot, device="cpu"):
    """The port's ring over the flat ``{dp: world}`` mesh on this rank's
    sequence shard of ``q``, ``k``, ``v`` (``[B, L, H, D]``, global):
    the output causal and not, and the gradients of ``sum(ring * cot)``
    (causal); then the tensor-parallel pair over the same line, with
    ``tp_x[rank]`` in and ``tp_cot[rank]`` as the cotangent: each one's
    output and input gradient.  Tensors on ``device``; everything back as
    numpy."""
    import torch

    from elasticdl_tpu_torch.ops.embedding import ParallelContext
    from elasticdl_tpu_torch.ops.ring_attention import ring_attention
    from elasticdl_tpu_torch.parallel import collectives as coll
    from elasticdl_tpu_torch.parallel.mesh import create_mesh

    mesh = create_mesh()
    reducer = coll.Reducer(mesh)
    group = mesh.group(("dp",))
    ctx = ParallelContext(axis_name="dp", axis_size=world, axis_index=rank, group=group,
                          reducer=reducer)
    s = q.shape[1] // world
    local = [torch.from_numpy(a[:, rank * s:(rank + 1) * s].copy()).to(device)
             for a in (q, k, v, cot)]
    out = {}
    for causal in (False, True):
        out[f"out_causal={causal}"] = ring_attention(
            *local[:3], axis_name="dp", causal=causal, ctx=ctx).cpu().numpy()
    leaves = [t.clone().requires_grad_() for t in local[:3]]
    (ring_attention(*leaves, axis_name="dp", causal=True, ctx=ctx) * local[3]).sum().backward()
    out["grads"] = [t.grad.cpu().numpy() for t in leaves]
    for name, fn in (("all_reduce", coll.tp_all_reduce), ("grad_sync", coll.tp_grad_sync)):
        x = torch.from_numpy(tp_x[rank].copy()).to(device).requires_grad_()
        y = fn(x, reducer, group)
        (y * torch.from_numpy(tp_cot[rank]).to(device)).sum().backward()
        out[name] = (y.detach().cpu().numpy(), x.grad.cpu().numpy())
    out["by_op"], out["calls"] = dict(reducer.by_op), reducer.calls
    return out


def lm_mesh_runs(rank, world, runs, device="cpu"):
    """``transformer_lm`` runs over meshes of this world, one after another
    (every rank makes the same meshes in the same order).  Each run (a
    dict): ``model`` (``model_spec`` kwargs), ``mesh``
    (``create_mesh`` kwargs; ``manager`` instead: ``MeshManager`` kwargs),
    ``config`` (``JobConfig`` kwargs), ``params`` (a JAX params tree, whole)
    or ``canonical`` (a canonical state), ``batches`` (global host
    batches) and ``save`` (a directory rank 0 checkpoints the final state
    in).  Returns per run: each step's metrics, one eval step's metrics on
    the first batch, the canonical state gathered after adopting the
    weights and after the steps, the mesh's shape, and this rank's bytes of
    the matmul weights.  The trainers run on ``device``."""
    import numpy as np

    from elasticdl_tpu_torch.common.checkpoint import CheckpointManager
    from elasticdl_tpu_torch.common.config import JobConfig
    from elasticdl_tpu_torch.models import transformer_lm
    from elasticdl_tpu_torch.parallel.mesh import MeshManager, create_mesh
    from elasticdl_tpu_torch.parallel.trainer import Trainer

    results = []
    for run in runs:
        mesh = (MeshManager(**run["manager"]).mesh if "manager" in run
                else create_mesh(**run.get("mesh", {})))
        trainer = Trainer(transformer_lm.model_spec(**run["model"]), device=device, mesh=mesh,
                          config=JobConfig(**run.get("config", {})))
        canonical = run.get("canonical")
        if canonical is None:
            canonical = _canonical_from(trainer, trainer.init_state(0), run["params"])
        state = trainer.adopt_restored(canonical)
        restored = {k: np.asarray(v).copy() for k, v in trainer.host_state(state).items()}
        metrics = []
        for batch in run["batches"]:
            state, m = trainer.run_train_step(state, batch)
            metrics.append({k: v.detach().cpu().numpy() for k, v in m.items()})
        ev = trainer.run_eval_step(state, run["batches"][0])
        host = {k: np.asarray(v).copy() for k, v in trainer.host_state(state).items()}
        if run.get("save") and rank == 0:
            CheckpointManager(run["save"]).save(state.step, host, wait=True)
        results.append({
            "metrics": metrics,
            "eval": {k: v.cpu().numpy() for k, v in ev.items()},
            "restored": restored,
            "host": host,
            "step": state.step,
            "shape": dict(mesh.shape),
            "matmul_bytes": sum(int(p.nbytes) for name, p in state.model.named_parameters()
                                if name.rsplit(".", 1)[-1] in ("wqkv", "wo", "w1", "w2")),
            "by_op": dict(trainer.reducer.by_op),
        })
    return results


# ---- the fused dispatch in a gang -------------------------------------------------


def _model_module(kind):
    if kind == "transformer_lm":
        from elasticdl_tpu_torch.models import transformer_lm as mod
    else:
        from elasticdl_tpu_torch.models import deepfm as mod
    return mod


def _run_plan(trainer, state, plan, fused):
    """Walk ``plan`` on ``trainer``: ``("scan", stacked)`` (a stacked GLOBAL
    host batch: one ``train_scan`` when ``fused``, else the per-step loop
    over its steps), ``("step", batch)`` (one ``run_train_step``) and
    ``("mask", active)`` (``set_active_contributors``).  Returns the state
    and each scan's or step's metrics as numpy, ``{name: [n_steps]}``."""
    import numpy as np
    import torch

    out = []
    for kind, value in plan:
        if kind == "mask":
            trainer.set_active_contributors(value)
            continue
        if kind == "step":
            state, m = trainer.run_train_step(state, value)
            m = {k: v[None] for k, v in m.items()}
        elif fused:
            state, m = trainer.train_scan(state, trainer.shard_stacked_batch(value))
        else:
            n = next(iter(value.values())).shape[0]
            state, per_step = trainer.run_train_steps(
                state, [{k: v[i] for k, v in value.items()} for i in range(n)])
            m = {k: torch.stack([s[k] for s in per_step]) for k in per_step[0]}
        out.append({k: np.asarray(v.detach().cpu()).copy() for k, v in m.items()})
    return state, out


def gang_scans(rank, world, kind, model_kw, jax_params, plan):
    """``kind`` over a ``(dp=world, ep=1)`` mesh from the carried JAX
    weights through the fused dispatch (``_run_plan``): each scan's or
    step's metrics, and the parameters after as the JAX tree."""
    from elasticdl_tpu_torch.parallel.mesh import create_mesh
    from elasticdl_tpu_torch.parallel.trainer import Trainer

    mod = _model_module(kind)
    trainer = Trainer(mod.model_spec(**model_kw), device="cpu",
                      mesh=create_mesh(dcn_parallelism=world))
    state = trainer.init_state(0)
    state.model.load_jax_params(jax_params)
    state, metrics = _run_plan(trainer, state, plan, fused=True)
    return {"metrics": metrics, "params": mod.params_to_jax(state.model),
            "captures": trainer._scan_captures(), "unsupported": trainer.scan_unsupported()}


def gang_scan_against_loop(rank, world, kind, model_kw, dcn, config_kw, plan):
    """Two trainers of ``kind`` over ``create_mesh(dcn_parallelism=dcn)``
    with ``JobConfig(**config_kw)``, from one seed: one walks ``plan``
    through ``train_scan``, the other through the per-step loop, in turns
    (every rank in the same order).  Returns both runs' metrics and
    canonical states, and the first trainer's sharded-state facts."""
    import numpy as np

    from elasticdl_tpu_torch.common.config import JobConfig
    from elasticdl_tpu_torch.parallel.mesh import create_mesh
    from elasticdl_tpu_torch.parallel.trainer import Trainer

    mesh = create_mesh(dcn_parallelism=dcn)
    spec = _model_module(kind).model_spec(**model_kw)
    out = {}
    for fused in (True, False):
        trainer = Trainer(spec, device="cpu", mesh=mesh, config=JobConfig(**config_kw))
        state, metrics = _run_plan(trainer, trainer.init_state(0), plan, fused)
        out["fused" if fused else "per_step"] = {
            "metrics": metrics, "step": state.step,
            "state": {k: np.asarray(v).copy() for k, v in trainer.host_state(state).items()},
        }
        out["facts"] = {"impl": trainer.ctx.embedding_impl, "axis_size": trainer.ctx.axis_size,
                        "sharded_opt": trainer._opt_plan is not None,
                        "unsupported": trainer.scan_unsupported()}
    return out


def _host_float_weight(trainer):
    """The contributor weights as host floats, as the step read them
    before they moved to the device (``Trainer._weight``)."""
    from elasticdl_tpu_torch.parallel import collectives as coll

    active = trainer._active_np
    w = (coll.contributor_weight(active, trainer.mesh, trainer.contributor_axes)
         if trainer.contributor_axes else float(active[0]))
    return w, max(float(active.sum()) * trainer._ranks_per_contributor, 1.0)


def gang_steps_device_and_host_weights(rank, world, kind, model_kw, plan):
    """``plan`` (``_run_plan``, per step) on two trainers of ``kind`` over
    ``(dp=world, ep=1)`` from one seed: one with the device weights, one
    whose step reads the host floats (``_host_float_weight``).  Returns
    both runs' metrics and canonical states."""
    import numpy as np

    from elasticdl_tpu_torch.parallel.mesh import create_mesh
    from elasticdl_tpu_torch.parallel.trainer import Trainer

    mesh = create_mesh(dcn_parallelism=world)
    spec = _model_module(kind).model_spec(**model_kw)
    out = {}
    for name in ("device", "host"):
        trainer = Trainer(spec, device="cpu", mesh=mesh)
        if name == "host":
            trainer._weight = lambda t=trainer: _host_float_weight(t)
        state, metrics = _run_plan(trainer, trainer.init_state(0), plan, fused=False)
        out[name] = {"metrics": metrics, "state": {
            k: np.asarray(v).copy() for k, v in trainer.host_state(state).items()}}
    return out
