"""Master control plane.

Reference parity (SURVEY.md §1-§3 [U/D]): one master per job owning
- dynamic data sharding (``TaskDispatcher``: todo/doing/done queues, requeue
  on worker death — the fault-tolerance core),
- elastic membership (``RendezvousServer``: versioned worker list; in the TPU
  rebuild a version bump triggers mesh re-formation instead of a Horovod
  communicator rebuild),
- an RPC service workers poll between shards (``MasterServicer`` over gRPC),
- evaluation scheduling/aggregation (``EvaluationService``),
- pod lifecycle (``PodManager``, pluggable backend).
"""

from elasticdl_tpu_torch.master.task_dispatcher import Task, TaskDispatcher  # noqa: F401
from elasticdl_tpu_torch.master.rendezvous import RendezvousServer  # noqa: F401
from elasticdl_tpu_torch.master.evaluation_service import EvaluationService  # noqa: F401
