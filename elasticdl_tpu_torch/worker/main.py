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
worker process.  Gang formation (``settle_membership``) is not ported.

The process logs ``[worker-event] {json}`` lines as it goes: ``ready``
(the step it joined from; the seconds of its boot, of the CUDA context and
of its restore, the last split into the seeded init, the read and the
load),
``first_step`` (the wall time its first training step finished on the
device) and, at its end, ``summary`` (the steps and eval steps it ran, its
step times on the device, its kernel launch counts).

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
    _not_ported,
)

logger = get_logger("worker.main")

#: The environment variable naming the worker's device (``JAX_PLATFORMS``'s
#: counterpart): unset = ``cuda``.
DEVICE_ENV = "ELASTICDL_TORCH_DEVICE"

#: Step-end events kept for the summary line (a bounded window: a long
#: job keeps its newest steps).
STEP_WINDOW = 4096

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


def settle_membership(master, worker_id: str, membership: dict, **_) -> dict:
    """The gang-formation wait of multihost mode: not ported."""
    raise _not_ported("gang formation (settle_membership)", "collectives and elastic reform")


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
    once), an event on the stream after every step (the last
    ``STEP_WINDOW``), and the eval steps.  Wraps the trainer's
    ``train_step`` and ``eval_step``."""

    def __init__(self, trainer):
        import torch

        self._cuda = trainer.device.type == "cuda"
        self.steps = 0
        self.eval_steps = 0
        self._events: collections.deque = collections.deque(maxlen=STEP_WINDOW)
        train_step, eval_step = trainer.train_step, trainer.eval_step

        def timed_train_step(state, batch):
            result = train_step(state, batch)
            self.steps += 1
            if self.steps == 1:
                if self._cuda:
                    torch.cuda.synchronize(trainer.device)
                _event("first_step", at=time.time(), step=result[0].step)
            if self._cuda:
                event = torch.cuda.Event(enable_timing=True)
                event.record()
                self._events.append(event)
            return result

        def counted_eval_step(state, batch):
            self.eval_steps += 1
            return eval_step(state, batch)

        trainer.train_step = timed_train_step
        trainer.eval_step = counted_eval_step

    def step_ms(self) -> List[float]:
        """Device time between consecutive step ends (gaps included)."""
        if not self._events:
            return []
        self._events[-1].synchronize()
        events = list(self._events)
        return [a.elapsed_time(b) for a, b in zip(events, events[1:])]


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
    incarnation = f"{os.getpid()}-{int(time.time() * 1e3)}"
    membership = master.call(
        "RegisterWorker",
        {
            "worker_id": worker_id,
            "address": "",
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
    if config.multihost:
        membership = settle_membership(master, worker_id, membership)

    import torch

    from elasticdl_tpu_torch.common import gauge
    from elasticdl_tpu_torch.common.metrics_http import maybe_start
    from elasticdl_tpu_torch.ops import kernels

    worker = Worker(
        config, master, build_job_reader(config), worker_id=worker_id,
        device=device, gauges=gauge.default(), incarnation=incarnation,
    )
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
    finally:
        hb_stop.set()
        if metrics_server is not None:
            metrics_server.stop()
    logger.info("worker %s finished: %s", worker_id, result)
    _event("summary", worker_id=worker_id, step=result["step"], steps=clock.steps,
           eval_steps=clock.eval_steps, step_ms=clock.step_ms(), launches=kernels.counts(),
           phase_times=result["phase_times"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
