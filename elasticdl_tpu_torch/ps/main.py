"""PS pod entry point of the PyTorch port: ``python -m
elasticdl_tpu_torch.ps.main``.

Port of ``elasticdl_tpu/ps/main.py``.  The master launches
``--num_ps_pods`` of these (``master/main.py``) as it launches worker pods;
each serves one ``id mod n`` shard of every host-tier table
(``ps/service.py``) and, at (re)start, restores its slice from the newest
complete snapshot under the job's checkpoint directory.

Environment (set by the master's pod env, the workers' bus):

- ``ELASTICDL_JOB_CONFIG``  — the job config JSON (model spec -> host_io).
- ``ELASTICDL_WORKER_SLOT`` — this pod's slot = its PS shard index.
- ``ELASTICDL_PS_PORTS``    — comma list; this shard binds its slot's port.

A PS pod is a host process: it loads the model spec only for its
``host_io`` table descriptors (``model_spec`` builds no module and
allocates nothing) and never initialises CUDA.
"""

from __future__ import annotations

import os
import signal
import sys
import threading
from typing import List, Optional

from elasticdl_tpu_torch.common.config import JobConfig
from elasticdl_tpu_torch.common.log_utils import get_logger, set_level

logger = get_logger("ps.main")


def main(argv: Optional[List[str]] = None) -> int:
    config = JobConfig.from_env()
    set_level(config.log_level)
    if config.trace:
        # The shard's spans (the server halves of ps:pull / ps:push_grad)
        # record in this process's buffer.
        from elasticdl_tpu_torch.common import trace as _trace

        _trace.configure(enabled=True, capacity=config.trace_buffer_events)
    if config.chaos:
        # delay_ps faults arm in the shard process itself.
        from elasticdl_tpu_torch import chaos as _chaos

        _chaos.configure(config.chaos)

    slot = int(os.environ.get("ELASTICDL_WORKER_SLOT", "0"))
    ports = [
        int(p) for p in os.environ.get("ELASTICDL_PS_PORTS", "0").split(",")
    ]
    num_shards = max(config.num_ps_pods, 1)
    port = ports[slot] if slot < len(ports) else 0

    from elasticdl_tpu_torch.models.spec import load_model_spec_for_job

    spec = load_model_spec_for_job(config)
    if not spec.host_io:
        logger.warning(
            "model %s declares no host-tier tables; PS shard %d idles",
            spec.name, slot,
        )

    from elasticdl_tpu_torch.ps.service import PSServer

    server = PSServer(
        spec.host_io, shard=slot, num_shards=num_shards, port=port
    )
    if config.checkpoint_dir:
        server.restore_latest(config.checkpoint_dir)

    # The shard's live /metrics endpoint: pull/push rates, latency
    # histograms and per-table row counts (PSServer records into the
    # process-default registry), on daemon threads of their own, so a shard
    # busy in a Save still answers the scrape.
    from elasticdl_tpu_torch.common.metrics_http import maybe_start

    metrics_server = maybe_start(
        config.gauge_port,
        server.gauges.render_prometheus,
        health_fn=lambda: {
            "role": "ps",
            "shard": slot,
            "num_shards": num_shards,
        },
        registry=server.gauges,
    )

    stop = threading.Event()

    def _terminate(signum, frame):
        logger.info("PS shard %d: signal %d, shutting down", slot, signum)
        stop.set()

    signal.signal(signal.SIGTERM, _terminate)
    signal.signal(signal.SIGINT, _terminate)

    server.start()
    try:
        while not stop.is_set():
            stop.wait(1.0)
    finally:
        server.stop(grace=5.0)
        if metrics_server is not None:
            metrics_server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
