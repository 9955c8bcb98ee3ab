"""Client layer — the PyTorch port's ``python -m
elasticdl_tpu_torch.client.main`` (the JAX package's ``elasticdl`` command).

Reference parity (SURVEY.md §2 #1 [U — mount empty at survey time; the
``elasticdl`` CLI name and its train/evaluate/predict + zoo verbs are [D]
via BASELINE.json): the reference's ``elasticdl_client`` package is the
user-facing console command that bakes model-zoo docker images
(``zoo init/build/push``) and submits jobs (``train/evaluate/predict``) by
rendering a master pod spec and creating it through the Kubernetes API.

Same verbs, two deployment modes:

- **local** (default when no cluster flags given): run the master
  in-process; workers are subprocesses via ``ProcessPodBackend``, each on
  the card (``ELASTICDL_TORCH_DEVICE=cpu`` in their environment for the
  CPU).
- **cluster**: render the master pod manifest (its workers request
  ``nvidia.com/gpu``) and submit it with the kubernetes client if
  installed, else write the manifest for ``kubectl apply``.
"""

from elasticdl_tpu_torch.client.api import (
    evaluate,
    predict,
    render_master_pod_manifest,
    submit,
    train,
)
from elasticdl_tpu_torch.client.zoo import zoo_build, zoo_init, zoo_push

__all__ = [
    "train",
    "evaluate",
    "predict",
    "submit",
    "render_master_pod_manifest",
    "zoo_init",
    "zoo_build",
    "zoo_push",
]
