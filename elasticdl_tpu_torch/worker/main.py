"""Worker pod entry point of the PyTorch port.

Port of ``elasticdl_tpu/worker/main.py``: the master renders worker pods
whose command is this module and whose environment carries the job config
(``ELASTICDL_JOB_CONFIG``, set by the PodManager) with CLI flags as a
fallback; the worker id comes from ``ELASTICDL_WORKER_ID`` (the pod name).
The process registers once (with its incarnation nonce), runs a liveness
heartbeat thread beside the task loop, snapshots and exits
``RESTART_EXIT_CODE`` on SIGTERM, and with ``ELASTICDL_STANDBY_GO_FILE``
parks as a warm standby with its imports paid.

The device comes from ``ELASTICDL_TORCH_DEVICE`` (the counterpart of the
JAX package's ``JAX_PLATFORMS``): unset means the card, ``cpu`` the CPU
only when asked for, and anything else, or the card on a machine without
one, raises (``common/device.resolve_device``).  The kernels' libraries are
built once into ``elasticdl_tpu_torch/csrc/build/`` and loaded by every
worker process.

Gang mode (``--multihost``): the process registers with its advertised
address, waits for the gang to form (``settle_membership``: the master's
desired size, every member confirming the version), joins the
``torch.distributed`` world of that membership
(``parallel/distributed.initialize``; rank 0's address and
``--coordinator_port`` seed the store) and builds the ``Worker`` over its
mesh.  A membership change raises ``WorkerRestartRequired`` out of the task
loop and the process exits ``RESTART_EXIT_CODE``; the beat thread's death
push exits it the same way when the task loop is blocked in a collective
on a departed peer.  The process group is destroyed at a normal exit.
With ``ELASTICDL_STATE_DIGEST=1`` every rank logs a digest of its state at
each periodic checkpoint (``checkpoint`` events), so a run can show that
the ranks hold identical states.

The process logs ``[worker-event] {json}`` lines as it goes: ``ready``
(the step it joined from; the seconds of its boot, of the CUDA context and
of its restore, the last split into the seeded init, the read and the
load),
``first_step`` (the wall time its first training step finished on the
device, its loss), ``first_steps`` (the losses of its first
``FIRST_STEPS`` steps), in gang mode ``gang`` (the seconds of the settle and of
``init_process_group``, the rank and world, the mesh, the sharded state's
flags as the trainer resolved them) and, at its end, ``summary`` (the
steps and eval steps it ran, its step times on the device, its kernel
launch counts, the task ids it ran, the seconds inside its collectives,
in all and by tag and op, its state's bytes: tables, parameters,
optimizer, the card's peak allocation).

Run as ``python -m elasticdl_tpu_torch.worker.main``.
"""

from __future__ import annotations

import time

_T_START = time.time()  # before the heavy imports: the boot clock's zero

import collections  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
from typing import List, Optional  # noqa: E402

from elasticdl_tpu_torch.common.config import JobConfig, parse_args  # noqa: E402
from elasticdl_tpu_torch.common.log_utils import get_logger  # noqa: E402
from elasticdl_tpu_torch.common.rpc import PROTOCOL_VERSION  # noqa: E402
from elasticdl_tpu_torch.data.reader import (  # noqa: E402
    AbstractDataReader,
    CompositeDataReader,
    create_data_reader,
)
from elasticdl_tpu_torch.worker.worker import (  # noqa: E402
    RESTART_EXIT_CODE,
    RpcMasterProxy,
    Worker,
    WorkerRestartRequired,
)

logger = get_logger("worker.main")

# Gang formation (settle_membership): poll every SETTLE_POLL_S; without a
# published target size, form once the version held still SETTLE_STABLE_S;
# form with whoever is present after SETTLE_MAX_S either way.
SETTLE_STABLE_S = 1.0
SETTLE_POLL_S = 0.25
SETTLE_MAX_S = 15.0

#: Set to ``1`` to log a digest of the state at each periodic checkpoint.
DIGEST_ENV = "ELASTICDL_STATE_DIGEST"

#: The environment variable naming the worker's device (``JAX_PLATFORMS``'s
#: counterpart): unset = ``cuda``.
DEVICE_ENV = "ELASTICDL_TORCH_DEVICE"

#: Step-end events kept for the summary line (a bounded window: a long
#: job keeps its newest steps).
STEP_WINDOW = 4096

#: The training steps whose losses the ``first_steps`` event carries.
FIRST_STEPS = 4

#: What a worker imports before it touches the card: the boot, which a
#: warm standby pays before it parks.  ``torch._dynamo`` is imported by the
#: first ``torch.optim`` optimizer a process builds (seconds on the card's
#: host); importing it here keeps it out of the restore's clock.
WARM_IMPORTS = (
    "torch", "torch._dynamo", "elasticdl_tpu_torch.parallel.trainer",
    "elasticdl_tpu_torch.models.transformer_lm",
    "elasticdl_tpu_torch.ops.flash_attention",
)


def _warm_imports() -> None:
    import importlib

    for mod in WARM_IMPORTS:
        importlib.import_module(mod)


def _event(kind: str, **fields) -> None:
    print("[worker-event] " + json.dumps(dict(fields, event=kind)), flush=True)


def build_job_reader(config: JobConfig) -> AbstractDataReader:
    """One reader serving every dataset the job's tasks may name."""
    params = config.parsed_data_reader_params()
    paths = [
        p
        for p in (
            config.training_data,
            config.validation_data,
            config.prediction_data,
        )
        if p
    ]
    if not paths:
        raise ValueError("job config names no data paths")
    readers = [create_data_reader(p, params) for p in dict.fromkeys(paths)]
    return readers[0] if len(readers) == 1 else CompositeDataReader(readers)


def _park_as_standby(go_file: str) -> str:
    """Warm-standby mode (``ELASTICDL_STANDBY_GO_FILE``): pay the boot tail
    (python, torch and framework imports) first, then park until the pod
    manager writes the go file naming the worker id this process should
    become.  Nothing here touches the card: the device is chosen after
    adoption.  Returns the assigned worker id."""
    _warm_imports()
    logger.info("standby warmed (pid %d); parking on %s", os.getpid(), go_file)
    # Readiness marker (atomic publish, like the go file itself): only a
    # warmed spare is worth adopting (ProcessPodBackend._adopt_standby).
    from elasticdl_tpu_torch.common import durable

    durable.atomic_publish(go_file + ".ready", str(os.getpid()))
    parent0 = os.getppid()
    while not os.path.exists(go_file):
        if os.getppid() != parent0:
            # The master died without close(): nothing will ever write the
            # go file.
            logger.info("standby orphaned (parent gone); exiting")
            raise SystemExit(0)
        time.sleep(0.05)
    with open(go_file) as f:
        payload = json.loads(f.read())
    for k, v in payload.get("env", {}).items():
        os.environ[k] = v
    worker_id = payload["worker_id"]
    logger.info("standby adopted as %s", worker_id)
    return worker_id


def settle_membership(
    master,
    worker_id: str,
    membership: dict,
    *,
    stable_s: Optional[float] = None,
    poll_s: Optional[float] = None,
    max_s: Optional[float] = None,
    clock=time.time,
    sleep=time.sleep,
) -> dict:
    """The gang-formation wait: the membership view to form the world on.

    When the master publishes the fleet's desired size (``expected``), form
    once the full gang is registered AND every member has confirmed the
    current version (registration or the versioned heartbeat this loop
    sends): without the size gate staggered relaunches form worlds one
    member at a time, without the confirmation gate a fresh relaunch forms
    a world with a stale incarnation that is about to restart.  Without a
    target (hand-spawned workers), form once the version has held still
    ``stable_s``.  At ``max_s`` form with whoever is present: a
    crash-looping peer degrades the world instead of wedging it."""
    stable_s = SETTLE_STABLE_S if stable_s is None else stable_s
    poll_s = SETTLE_POLL_S if poll_s is None else poll_s
    max_s = SETTLE_MAX_S if max_s is None else max_s
    deadline = clock() + max_s
    stable_since = clock()
    while clock() < deadline:
        expected = membership.get("expected") or 0
        confirmed = membership.get("confirmed") or {}
        version = membership["version"]
        if (
            expected
            and membership["world_size"] == expected
            and all(confirmed.get(w) == version for w in membership["workers"])
        ):
            # EXACT size: during a scale-down the doomed members stay
            # registered through their grace; an oversized world would
            # collapse again as they exit.
            break
        sleep(poll_s)
        try:
            # The versioned heartbeat IS this worker's confirmation.
            master.call("Heartbeat", {"worker_id": worker_id, "version": version})
            current = master.call("GetMembership", {})
        except Exception:
            continue  # master briefly unreachable: retry next poll
        if current["version"] != membership["version"]:
            stable_since = clock()
        elif not expected and clock() - stable_since >= stable_s:
            membership = current
            break
        # Adopt unconditionally: confirmations advance without a version
        # bump.
        membership = current
    return membership


def _state_digest(snapshot) -> str:
    """A digest of every array of a canonical snapshot (device or host
    tensors): per array, the int64 sum of its 32-bit words and the sum of
    the words times their index modulo 2**31-1, in the snapshot's key
    order."""
    import hashlib

    import numpy as np
    import torch

    keys, pairs = sorted(snapshot), []
    for key in keys:
        value = snapshot[key]
        t = value if isinstance(value, torch.Tensor) else torch.from_numpy(np.asarray(value))
        words = t.detach().contiguous().reshape(-1).view(torch.uint8)
        words = torch.nn.functional.pad(words, (0, (-words.numel()) % 4)).view(torch.int32)
        w64 = words.to(torch.int64)
        idx = torch.arange(w64.numel(), device=w64.device, dtype=torch.int64) % 2147483647
        pairs.append(torch.stack([w64.sum(), ((w64 % 2147483647) * idx).sum()]))
    # One copy to the host for every array on the card.
    on_card = [i for i, pair in enumerate(pairs) if pair.is_cuda]
    if on_card:
        host = torch.stack([pairs[i] for i in on_card]).cpu()
        for j, i in enumerate(on_card):
            pairs[i] = host[j]
    h = hashlib.sha256()
    for key, pair in zip(keys, pairs):
        total, weighted = pair.tolist()
        h.update(f"{key}:{total}:{weighted};".encode())
    return h.hexdigest()


#: Hard-exit bound after SIGTERM: k8s preemption grants a grace window
#: (default 30 s) before SIGKILL; the snapshot must not gamble on using
#: all of it.
PREEMPTION_EXIT_S = 15.0


def _install_preemption_handler(worker_holder: dict) -> None:
    """SIGTERM = preemption notice (k8s eviction, spot reclaim, pod
    delete): snapshot if safe, then exit RESTART so the pod manager
    relaunches without charging the failure budget.  The handler only
    SPAWNS the graceful thread (the signal frame may be inside a torch
    call), while a hard timer bounds the whole exit."""
    import signal

    def _graceful() -> None:
        try:
            w = worker_holder.get("worker")
            if w is not None:
                w.preemption_snapshot()
        except Exception:
            logger.exception("preemption snapshot failed; exiting anyway")
        finally:
            sys.stderr.flush()
            sys.stdout.flush()
            os._exit(RESTART_EXIT_CODE)

    def _on_term(signum, frame):
        logger.info("SIGTERM: preemption notice; snapshot + RESTART exit")
        threading.Thread(target=_graceful, name="preemption", daemon=True).start()
        t = threading.Timer(PREEMPTION_EXIT_S, lambda: os._exit(RESTART_EXIT_CODE))
        t.daemon = True
        t.start()

    signal.signal(signal.SIGTERM, _on_term)


class _StepClock:
    """What the event lines report of this process's steps: the wall time
    its first training step finished on the device (one synchronisation,
    once), the losses of its first ``FIRST_STEPS`` steps (one more), an
    event on the stream after every step or fused task (the last
    ``STEP_WINDOW``), and the eval steps with their seconds inside
    collectives.  Wraps the trainer's ``train_step``, ``train_scan``,
    ``eval_step`` and ``eval_scan`` (a scan runs its steps through the
    trainer's unwrapped ones, so it is one call here, its T steps counted
    when it returns)."""

    def __init__(self, trainer):
        import torch

        self._cuda = trainer.device.type == "cuda"
        self.steps = 0
        self.eval_steps = 0
        self.eval_collective_s = 0.0  # the eval steps' share of the collectives
        self.eval_by_op: dict = {}  # ... by tag and op (``Reducer.by_op``)
        # (event before a fused task or None, event after the step or task,
        # its steps)
        self._events: collections.deque = collections.deque(maxlen=STEP_WINDOW)
        losses = []
        train_step, eval_step = trainer.train_step, trainer.eval_step
        train_scan, eval_scan = trainer.train_scan, trainer.eval_scan

        def event():
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e

        def took(state, step_losses, start) -> None:
            """``len(step_losses)`` steps ended, the last leaving ``state``."""
            for loss in step_losses:
                self.steps += 1
                if self.steps == 1:
                    if self._cuda:
                        torch.cuda.synchronize(trainer.device)
                    _event("first_step", at=time.time(), step=state.step - len(step_losses) + 1,
                           loss=float(loss))
                if self.steps <= FIRST_STEPS:
                    losses.append(loss.detach())
                    if self.steps == FIRST_STEPS:
                        _event("first_steps", step=state.step - len(step_losses) + len(losses),
                               losses=[float(x) for x in losses])
            if self._cuda:
                self._events.append((start, event(), len(step_losses)))

        def timed_train_step(state, batch):
            result = train_step(state, batch)
            took(result[0], [result[1]["loss"]], None)
            return result

        def timed_train_scan(state, stacked):
            start = event() if self._cuda else None
            state, metrics = train_scan(state, stacked)
            took(state, list(metrics["loss"]), start)
            return state, metrics

        def counted_eval(fn, n_steps):
            def run(state, batch):
                self.eval_steps += n_steps(batch)
                before, by_op = trainer.reducer.seconds, dict(trainer.reducer.by_op)
                try:
                    return fn(state, batch)
                finally:
                    self.eval_collective_s += trainer.reducer.seconds - before
                    for k, v in trainer.reducer.by_op.items():
                        self.eval_by_op[k] = self.eval_by_op.get(k, 0.0) + v - by_op.get(k, 0.0)

            return run

        trainer.train_step = timed_train_step
        trainer.train_scan = timed_train_scan
        trainer.eval_step = counted_eval(eval_step, lambda batch: 1)
        trainer.eval_scan = counted_eval(eval_scan,
                                         lambda batch: int(next(iter(batch.values())).shape[0]))

    def step_ms(self) -> List[float]:
        """Device time between consecutive step ends (gaps included).  A
        fused task's n steps end evenly over its span: n - 1 intervals of
        span / n, and the one into its first step end from the previous
        end."""
        if not self._events:
            return []
        self._events[-1][1].synchronize()
        out, prev = [], None
        for start, end, n in list(self._events):
            span = start.elapsed_time(end) / n if start is not None else 0.0
            if prev is not None:
                out.append(prev.elapsed_time(end) - (n - 1) * span)
            out += [span] * (n - 1)
            prev = end
        return out


def main(argv: Optional[List[str]] = None) -> int:
    try:
        config = JobConfig.from_env()
    except KeyError:
        config = parse_args(argv)
    if not config.master_addr:
        raise SystemExit("worker needs --master_addr (or config via env)")
    from elasticdl_tpu_torch.common.log_utils import set_level

    set_level(config.log_level)
    go_file = os.environ.get("ELASTICDL_STANDBY_GO_FILE", "")
    if go_file:
        worker_id = _park_as_standby(go_file)
    else:
        worker_id = os.environ.get("ELASTICDL_WORKER_ID", f"worker-{os.getpid()}")
    logger.info("worker %s booting (pid %d)", worker_id, os.getpid())
    device = os.environ.get(DEVICE_ENV) or None

    master = RpcMasterProxy(
        config.master_addr,
        call_timeout_s=config.master_call_timeout_s,
        outage_tolerance_s=config.master_outage_tolerance_s,
    )
    # Register EXACTLY ONCE; the view goes to Worker.run verbatim.  The
    # incarnation nonce makes the master reset this id's report-seq dedup
    # ledger (a fresh process restarts its seq at 1), and held_tasks=[]
    # requeues any lease a previous incarnation of this id still held.
    from elasticdl_tpu_torch.parallel import distributed

    incarnation = f"{os.getpid()}-{int(time.time() * 1e3)}"
    membership = master.call(
        "RegisterWorker",
        {
            "worker_id": worker_id,
            "address": (distributed.advertised_address(config.master_addr)
                        if config.multihost else ""),
            "proto": PROTOCOL_VERSION,
            "incarnation": incarnation,
            "held_tasks": [],
        },
    )
    # Liveness is a background thread, decoupled from the task loop: the
    # startup window (the device, the kernels' load) and long steps must
    # not look like death to the master's reaper.  It is also the
    # death-push receiver (Worker.death_watch_tick).
    hb_stop = threading.Event()
    worker_holder: dict = {}

    def _beat() -> None:
        dw_state: dict = {"pending_since": None}
        while not hb_stop.wait(0.25 if dw_state["pending_since"] else 1.0):
            master_version = None
            w = worker_holder.get("worker")
            try:
                hb = {"worker_id": worker_id}
                if w is not None:
                    # Gang-boundary progress: the only RPC leaving a process
                    # whose task loop is blocked in a collective.
                    hb.update(w.gang_beat_fields())
                    gp = w.gauge_payload()
                    if gp is not None:
                        hb["gauge"] = gp
                master_version = master.call("Heartbeat", hb).get("version")
            except Exception:  # master briefly unreachable: retry next beat
                pass
            if w is None:
                continue
            try:
                if w.death_watch_tick(dw_state, time.time(), master_version=master_version):
                    sys.stderr.flush()
                    sys.stdout.flush()
                    os._exit(RESTART_EXIT_CODE)
            except Exception:
                logger.exception("death watch tick failed; will retry")

    threading.Thread(target=_beat, daemon=True, name="heartbeat").start()
    _install_preemption_handler(worker_holder)
    logger.info(
        "worker %s registered (membership v%s, world %s)",
        worker_id, membership.get("version"), membership.get("world_size"),
    )
    import torch

    from elasticdl_tpu_torch.common import gauge
    from elasticdl_tpu_torch.common.device import resolve_device
    from elasticdl_tpu_torch.common.metrics_http import maybe_start
    from elasticdl_tpu_torch.ops import kernels

    mesh = None
    if config.multihost:
        from elasticdl_tpu_torch.parallel.mesh import MeshManager

        t0 = time.time()
        membership = settle_membership(master, worker_id, membership)
        settle_s = time.time() - t0
        spec = distributed.spec_from_membership(
            membership, worker_id, config.coordinator_port,
            heartbeat_timeout_s=config.distributed_heartbeat_timeout_s,
        )
        t0 = time.time()
        dev = resolve_device(device)
        if dev.type == "cuda":
            if dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
            torch.cuda.set_device(dev)
        distributed.initialize(spec, dev)
        ranks = dict(membership["ranks"])
        addresses = membership.get("addresses") or {}
        hosts = [addresses.get(w, "") for w in sorted(ranks, key=ranks.get)]
        mesh = MeshManager(config.dcn_data_parallelism,
                           hosts if all(hosts) and spec.enabled else (),
                           tensor_parallelism=config.tensor_parallelism).mesh
        gang_event = dict(worker_id=worker_id, settle_s=settle_s,
                          init_process_group_s=time.time() - t0, rank=spec.process_id,
                          world=spec.num_processes, version=membership["version"],
                          mesh=dict(mesh.shape))

    # The job config reaches the trainer whole: --distribution_strategy,
    # --optimizer_sharding(_auto_mb) and --embedding_lookup_impl with it.
    worker = Worker(
        config, master, build_job_reader(config), worker_id=worker_id,
        device=device, gauges=gauge.default(), incarnation=incarnation,
        mesh=mesh,
    )
    if mesh is not None:
        tr = worker.trainer
        _event("gang", **gang_event, distribution_strategy=tr.strategy,
               optimizer_sharding=tr.optimizer_sharding,
               embedding_lookup_impl=tr.ctx.embedding_impl,
               sharded_embeddings=tr.sharded_embeddings)
    if os.environ.get(DIGEST_ENV) == "1":
        worker.checkpoint_hook = lambda step, snap: _event(
            "checkpoint", worker_id=worker_id, step=step, digest=_state_digest(snap))
    clock = _StepClock(worker.trainer)
    _warm_imports()
    boot_s = time.time() - _T_START
    t0 = time.time()
    if worker.trainer.device.type == "cuda":
        # The CUDA context, on its own clock (the restore would pay it).
        torch.zeros(1, device=worker.trainer.device)
        torch.cuda.synchronize(worker.trainer.device)
    device_init_s = time.time() - t0
    t0 = time.time()
    worker._restore_at_start()
    restore_s = time.time() - t0
    _event("ready", worker_id=worker_id, pid=os.getpid(), device=str(worker.trainer.device),
           started_at=_T_START, boot_s=boot_s, device_init_s=device_init_s,
           restore_s=restore_s, joined_step=worker.state.step, **worker.restore_times)
    worker_holder["worker"] = worker
    metrics_server = maybe_start(
        config.gauge_port,
        worker.gauges.render_prometheus,
        health_fn=lambda: {
            "role": "worker",
            "worker_id": worker_id,
            "membership_version": worker._membership_version,
        },
        registry=worker.gauges,
    )
    try:
        result = worker.run(membership=membership)
    except WorkerRestartRequired as e:
        logger.info("worker %s restarting: %s", worker_id, e)
        hb_stop.set()
        # No interpreter teardown: the process group's and gRPC's exit hooks
        # can block on peers that are gone.  The relaunch replaces the
        # process anyway.
        sys.stderr.flush()
        sys.stdout.flush()
        os._exit(RESTART_EXIT_CODE)
    finally:
        hb_stop.set()
        if metrics_server is not None:
            metrics_server.stop()
    logger.info("worker %s finished: %s", worker_id, result)
    tr = worker.trainer
    table_keys = {"params/" + k for k in tr._table_keys}
    state_bytes = {
        "tables": sum(int(p.nbytes) for name, p in tr._param_paths(worker.state.model)
                      if "params/" + name in table_keys),
        "params": sum(int(p.nbytes) for p in worker.state.model.parameters()),
        "opt": sum(tr.opt_state_bytes_per_device(worker.state).values()),
        "sharded_state": tr.sharded_state(),
    }
    if tr.device.type == "cuda":
        state_bytes["max_memory_allocated"] = int(torch.cuda.max_memory_allocated(tr.device))
    _event("summary", worker_id=worker_id, step=result["step"], steps=clock.steps,
           eval_steps=clock.eval_steps, step_ms=clock.step_ms(), launches=kernels.counts(),
           phase_times=result["phase_times"], tasks=result["tasks"],
           collective_s=tr.reducer.seconds, collective_calls=tr.reducer.calls,
           collective_by_op=tr.reducer.by_op, eval_collective_s=clock.eval_collective_s,
           eval_collective_by_op=clock.eval_by_op, state_bytes=state_bytes)
    distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
