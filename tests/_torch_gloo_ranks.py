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
