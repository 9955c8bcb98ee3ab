"""The multi-process world of the PyTorch port: one ``torch.distributed``
process group over the gang's worker processes.

Port of ``elasticdl_tpu/parallel/distributed.py``.  The control plane
stays the master's gRPC service (task dispatch, rendezvous versions); the
data plane is the process group: NCCL between cards, gloo on the CPU (and
wherever it is asked for with ``ELASTICDL_TORCH_DIST_BACKEND``).  Each
worker process owns one device, and rank 0's advertised address with
``coordinator_port`` seeds the group's ``TCPStore``.

Elasticity is the reference's: a world is fixed per process.  A membership
change snapshots, exits with ``RESTART_EXIT_CODE`` and the relaunch
settles the new membership (``worker/main.settle_membership``) before it
calls ``initialize`` with the new spec.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import socket
from typing import Optional

import torch

from elasticdl_tpu_torch.common.log_utils import get_logger

logger = get_logger("parallel.distributed")

#: The environment variable naming the process group's backend (``nccl``
#: or ``gloo``), the counterpart of ``ELASTICDL_TORCH_DEVICE``.  Unset: the
#: device's own backend, ``nccl`` for the card and ``gloo`` for the CPU.
BACKEND_ENV = "ELASTICDL_TORCH_DIST_BACKEND"
BACKENDS = ("nccl", "gloo")


@dataclasses.dataclass(frozen=True)
class DistributedSpec:
    """Topology of one process-group world."""

    coordinator_address: str  # host:port of rank 0's TCPStore
    num_processes: int
    process_id: int
    # The group's timeout: how long a collective (or the store's
    # rendezvous) waits on a peer before it raises.  A survivor blocked on
    # a dead peer waits at most this long, unless the death push
    # (worker/main.py) exits it first.
    heartbeat_timeout_s: float = 30.0

    @property
    def enabled(self) -> bool:
        return self.num_processes > 1


_ACTIVE: Optional[DistributedSpec] = None


def backend_for(device: torch.device) -> str:
    """The process group's backend: ``ELASTICDL_TORCH_DIST_BACKEND`` when
    set, else ``nccl`` for the card and ``gloo`` for the CPU.  Nothing
    switches to another backend when the chosen one fails."""
    name = os.environ.get(BACKEND_ENV, "").strip().lower()
    if name:
        if name not in BACKENDS:
            raise ValueError(f"{BACKEND_ENV}={name!r}; expected one of {BACKENDS}")
        return name
    return "nccl" if device.type == "cuda" else "gloo"


def initialize(spec: DistributedSpec, device: torch.device) -> None:
    """Join this process to the world ``spec`` describes, over the process
    group whose backend ``backend_for(device)`` names.

    A single-process spec is a no-op, so the same worker code runs alone
    and in a gang.  A second call with the same spec is a no-op; with
    another spec it raises: a world is fixed per process."""
    global _ACTIVE
    if not spec.enabled:
        return
    if _ACTIVE == spec:
        return
    if _ACTIVE is not None:
        raise RuntimeError(
            "a process group is already initialized with another topology; "
            "an elastic change requires a worker process restart"
        )
    import torch.distributed as dist

    backend = backend_for(device)
    host, port = spec.coordinator_address.rsplit(":", 1)
    timeout = datetime.timedelta(seconds=max(spec.heartbeat_timeout_s, 1.0))
    logger.info(
        "init_process_group(%s, store=%s, world_size=%d, rank=%d)",
        backend, spec.coordinator_address, spec.num_processes, spec.process_id,
    )
    store = dist.TCPStore(
        host, int(port), spec.num_processes, is_master=spec.process_id == 0,
        timeout=timeout,
    )
    kwargs = {}
    if backend == "nccl":
        # Bind the communicator to this process's card at once (a lazy
        # binding would pick device 0 on a multi-card host).
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        kwargs["device_id"] = device
    dist.init_process_group(
        backend, store=store, rank=spec.process_id,
        world_size=spec.num_processes, timeout=timeout, **kwargs,
    )
    _ACTIVE = spec


def shutdown() -> None:
    """Destroy this process's group (no-op when none was initialized)."""
    global _ACTIVE
    if _ACTIVE is None:
        return
    import torch.distributed as dist

    try:
        if dist.is_initialized():
            dist.destroy_process_group()
    except Exception:  # the peers may already be gone
        logger.exception("destroy_process_group failed")
    _ACTIVE = None


def advertised_address(master_addr: str = "") -> str:
    """The host other workers can dial: the pod IP (downward API), else
    the loopback address when the master is on this host's loopback (a
    local job: every worker process runs here), else the FQDN."""
    if os.environ.get("MY_POD_IP"):
        return os.environ["MY_POD_IP"]
    host = master_addr.rsplit(":", 1)[0].strip("[]")
    if host in ("localhost", "127.0.0.1", "::1"):
        return "127.0.0.1"
    return socket.getfqdn()


def active_spec() -> Optional[DistributedSpec]:
    return _ACTIVE


def spec_from_membership(
    membership: dict,
    worker_id: str,
    coordinator_port: int = 8476,
    heartbeat_timeout_s: float = 30.0,
) -> DistributedSpec:
    """This worker's DistributedSpec from the master's membership view:
    ``ranks`` (worker_id -> rank) and ``addresses`` (worker_id -> host);
    rank 0's host seeds the store.  No addresses, one rank or no address
    for rank 0 yield a disabled spec."""
    ranks = membership.get("ranks", {})
    addresses = membership.get("addresses", {})
    if not addresses or len(ranks) <= 1:
        return DistributedSpec("", 1, 0)
    rank0 = next((w for w, r in ranks.items() if r == 0), None)
    host0 = addresses.get(rank0)
    if host0 is None:
        return DistributedSpec("", 1, 0)
    return DistributedSpec(
        coordinator_address=f"{host0}:{coordinator_port}",
        num_processes=len(ranks),
        process_id=ranks.get(worker_id, 0),
        heartbeat_timeout_s=heartbeat_timeout_s,
    )
