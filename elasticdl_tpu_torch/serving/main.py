"""Serving replica entrypoint: ``python -m elasticdl_tpu_torch.serving.main``.

Port of ``elasticdl_tpu/serving/main.py`` under the same environment
contract:

- ``ELASTICDL_SERVING_CONFIG``: one JSON blob (model zoo/def/params,
  batcher and bucket knobs, base ports, and ``device``: ``"cuda"`` unless
  it says ``"cpu"``).  The same string for every slot.
- ``ELASTICDL_WORKER_SLOT``: this replica's slot N.  gRPC binds
  ``base_port + N``, /metrics ``metrics_base_port + N``.
- ``ELASTICDL_STANDBY_GO_FILE``: warm-standby mode: pre-pay the python,
  torch and framework imports, publish the ``.ready`` marker, park until
  the pod manager's go file names the replica this process becomes.

Boot order is bind -> WARMUP ALL BUCKETS -> serve: the gRPC port accepts
only after every batch bucket has run once (kernel build, library handles,
allocator growth), so a replica that answers its readiness probe serves
its first request at forward speed.  With ``checkpoint_dir`` the replica
serves the newest published step and hot-reloads every later publish
(polling every ``poll_interval_s``, default 0.5 s).

Exit contract: SIGTERM drains within the grace window and exits 0.
"""

from __future__ import annotations

import json
import os
import signal
import sys
import threading
import time

from elasticdl_tpu_torch.common.log_utils import get_logger

logger = get_logger("serving.main")


def _atomic_write(path: str, text: str) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _park_as_standby(go_file: str) -> str:
    """Warm-standby parking: pre-pay the boot tail (python + torch +
    framework + serving imports), then park until the pod manager writes
    the go file naming the replica id this process should become.  Nothing
    here touches the card: the spare must stay adoptable into any slot.
    Returns the assigned replica id."""
    import importlib

    for mod in (
        "numpy", "torch", "grpc",
        "elasticdl_tpu_torch.parallel.trainer",
        "elasticdl_tpu_torch.models.spec",
        "elasticdl_tpu_torch.models.transformer_lm",
        "elasticdl_tpu_torch.serving.server",
        "elasticdl_tpu_torch.serving.micro_batcher",
    ):
        importlib.import_module(mod)
    logger.info(
        "serving standby warmed (pid %d); parking on %s", os.getpid(), go_file
    )
    _atomic_write(go_file + ".ready", str(os.getpid()))
    parent0 = os.getppid()
    while not os.path.exists(go_file):
        if os.getppid() != parent0:
            # Controller died without close(): nothing will ever write the
            # go file — exit instead of parking forever.
            logger.info("serving standby orphaned (parent gone); exiting")
            raise SystemExit(0)
        time.sleep(0.05)
    with open(go_file) as f:
        payload = json.loads(f.read())
    for k, v in payload.get("env", {}).items():
        os.environ[k] = v
    replica_id = payload["worker_id"]
    logger.info("serving standby adopted as %s", replica_id)
    return replica_id


def main() -> int:
    go_file = os.environ.get("ELASTICDL_STANDBY_GO_FILE", "")
    if go_file:
        _park_as_standby(go_file)

    cfg = json.loads(os.environ["ELASTICDL_SERVING_CONFIG"])
    slot = int(os.environ.get("ELASTICDL_WORKER_SLOT", "0"))
    replica_id = os.environ.get("ELASTICDL_WORKER_ID", f"serve-{slot}")
    port = int(cfg.get("base_port", 8700)) + slot
    gauge_port = int(cfg.get("metrics_base_port", 8800)) + slot

    from elasticdl_tpu_torch.models.spec import load_model_spec
    from elasticdl_tpu_torch.serving.server import ServingServer

    spec = load_model_spec(
        cfg.get("model_zoo", "elasticdl_tpu_torch.models"),
        cfg["model_def"],
        **(cfg.get("model_params") or {}),
    )
    server = ServingServer(
        spec,
        checkpoint_dir=cfg.get("checkpoint_dir", ""),
        ps_addresses=cfg.get("ps_addresses", ""),
        max_batch=int(cfg.get("max_batch", 64)),
        max_delay_ms=float(cfg.get("max_delay_ms", 5.0)),
        poll_interval_s=float(cfg.get("poll_interval_s", 0.5)),
        port=port,
        gauge_port=gauge_port,
        seed=int(cfg.get("seed", 0)),
        target_p99_ms=float(cfg.get("target_p99_ms", 100.0)),
        batch_buckets=cfg.get("batch_buckets"),
        bulk_weight=float(cfg.get("bulk_weight", 0.25)),
        # Fleet sizing contract: the handler pool rides ABOVE the queue
        # bound so overload lands in the micro-batcher's measured, shedding
        # queue — never invisibly in the gRPC executor.
        max_workers=int(cfg.get("max_workers", 16)),
        max_queue_rows=(
            int(cfg["max_queue_rows"])
            if cfg.get("max_queue_rows") is not None else None
        ),
        device=cfg.get("device", "cuda"),
    )
    warm_s = server.warmup()
    logger.info(
        "replica %s (slot %d): warmed %d bucket(s) in %.2fs; serving on "
        "port %d, /metrics on %d",
        replica_id, slot, len(server._shape_buckets), warm_s, port, gauge_port,
    )
    server.start()

    done = threading.Event()

    def _terminate(signum, frame) -> None:
        logger.info("replica %s: signal %d, draining", replica_id, signum)
        done.set()

    signal.signal(signal.SIGTERM, _terminate)
    signal.signal(signal.SIGINT, _terminate)
    done.wait()
    server.stop(grace=1.0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
