"""The native host tier of the PyTorch port: the C++ embedding store and
ingest functions (ctypes) and the PS service over the store (gRPC)."""

from elasticdl_tpu_torch.ps.host_store import (  # noqa: F401
    HostEmbeddingStore,
    native_lib_available,
)
from elasticdl_tpu_torch.ps.service import (  # noqa: F401
    PSClient,
    PSServer,
    RemoteEmbeddingStore,
)
