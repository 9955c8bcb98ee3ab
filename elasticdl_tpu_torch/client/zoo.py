"""``zoo init/build/push`` of the PyTorch port's CLI — model-zoo
scaffolding and packaging.

Port of ``elasticdl_tpu/client/zoo.py``: the zoo verbs bake the user's
model directory into a docker image (init writes a template + Dockerfile,
build runs docker build, push pushes to a registry); ``build`` also
*validates* the zoo — imports every module and checks each ``*model_spec*``
function returns a well-formed ``ModelSpec`` whose module builds on
PyTorch's ``meta`` device (shapes only, no memory).  The template is a
PyTorch ``model_spec`` of the same shape as the JAX package's.  Docker
steps degrade gracefully when docker is unavailable (validation still
runs).
"""

from __future__ import annotations

import importlib
import os
import shutil
import subprocess
import sys
from typing import Callable, Dict, List, Tuple

from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.models.spec import ModelSpec

logger = get_logger("client.zoo")

_TEMPLATE_MODEL = '''\
"""Template model-zoo entry of the PyTorch port.

Train with:
    python -m elasticdl_tpu_torch.client.main train --model_zoo={zoo_pkg} \\
        --model_def=template.model_spec --training_data=... --minibatch_size=64
"""

import numpy as np
import torch
import torch.nn.functional as F

from elasticdl_tpu_torch.models.spec import ModelSpec


def model_spec(hidden: int = 64, num_classes: int = 10, lr: float = 1e-3):
    def init(seed, device):
        model = torch.nn.Sequential(
            torch.nn.Flatten(),
            torch.nn.Linear(28 * 28, hidden),
            torch.nn.ReLU(),
            torch.nn.Linear(hidden, num_classes),
        )
        if seed is not None:
            gen = torch.Generator().manual_seed(seed)
            with torch.no_grad():
                for p in model.parameters():
                    if p.dim() > 1:
                        p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
                    else:
                        p.zero_()
        return model.to(device)

    def apply(model, batch, train=False):
        return model(batch["images"].float())

    def loss(logits, batch):
        return F.cross_entropy(logits, batch["labels"].long())

    def metrics(logits, batch):
        hit = logits.argmax(-1) == batch["labels"].long()
        return {{"accuracy": hit.float().mean()}}

    def example_batch(n):
        return {{
            "images": np.zeros((n, 28, 28), np.float32),
            "labels": np.zeros((n,), np.int32),
        }}

    return ModelSpec(
        name="template",
        init=init,
        apply=apply,
        loss=loss,
        metrics=metrics,
        optimizer=lambda parameters: torch.optim.Adam(parameters, lr=lr),
        example_batch=example_batch,
    )
'''

_TEMPLATE_DOCKERFILE = """\
# Model-zoo image: framework + user models, run on NVIDIA GPU nodes.
FROM {base_image}
COPY . /model_zoo
ENV PYTHONPATH=/model_zoo:$PYTHONPATH
"""

_TEMPLATE_REQUIREMENTS = """\
# Extra python deps for your models (installed into the zoo image).
"""


def zoo_init(directory: str, base_image: str = "elasticdl-tpu:latest") -> None:
    """Scaffold a model-zoo directory: template model, Dockerfile, requirements."""
    os.makedirs(directory, exist_ok=True)
    pkg = os.path.basename(os.path.abspath(directory))
    wrote = []
    for name, content in (
        ("__init__.py", ""),
        ("template.py", _TEMPLATE_MODEL.format(zoo_pkg=pkg)),
        ("Dockerfile", _TEMPLATE_DOCKERFILE.format(base_image=base_image)),
        ("requirements.txt", _TEMPLATE_REQUIREMENTS),
    ):
        path = os.path.join(directory, name)
        if os.path.exists(path):
            logger.info("keeping existing %s", path)
            continue
        with open(path, "w") as f:
            f.write(content)
        wrote.append(name)
    logger.info("initialized model zoo %s (wrote %s)", directory, wrote)


def discover_model_specs(
    directory: str,
) -> Tuple[Dict[str, Callable[..., ModelSpec]], List[Tuple[str, str]]]:
    """Import every module in the zoo dir; collect ``*model_spec*`` callables.

    Returns (specs, import_failures) — a broken module (syntax error, missing
    dependency) is reported per-module instead of aborting discovery.
    """
    directory = os.path.abspath(directory)
    parent, pkg = os.path.split(directory)
    specs: Dict[str, Callable[..., ModelSpec]] = {}
    failures: List[Tuple[str, str]] = []
    sys.path.insert(0, parent)
    try:
        for fname in sorted(os.listdir(directory)):
            if not fname.endswith(".py") or fname.startswith("_"):
                continue
            try:
                module = importlib.import_module(f"{pkg}.{fname[:-3]}")
            except Exception as e:  # noqa: BLE001 - report, keep discovering
                failures.append((fname, f"import failed: {e}"))
                continue
            for attr in dir(module):
                if "model_spec" in attr and callable(getattr(module, attr)):
                    specs[f"{fname[:-3]}.{attr}"] = getattr(module, attr)
    finally:
        sys.path.remove(parent)
    return specs, failures


def validate_zoo(directory: str) -> List[Tuple[str, str]]:
    """Build every spec and its module on the ``meta`` device; returns
    (name, error)s."""
    import torch

    specs, failures = discover_model_specs(directory)
    if not specs and not failures:
        return [(directory, "no *model_spec* functions found")]
    for name, fn in specs.items():
        try:
            spec = fn()
            if not isinstance(spec, ModelSpec):
                raise TypeError(f"returned {type(spec).__name__}, not ModelSpec")
            # Shape-level init: catches most wiring bugs without device work.
            spec.init(seed=None, device=torch.device("meta"))
            logger.info("validated %s (%s)", name, spec.name)
        except Exception as e:  # noqa: BLE001 - report all validation errors
            failures.append((name, str(e)))
    return failures


def zoo_build(
    directory: str, image: str = "", validate_only: bool = False
) -> int:
    """Validate the zoo; then (if requested and possible) docker-build it."""
    failures = validate_zoo(directory)
    for name, err in failures:
        logger.error("zoo validation failed: %s: %s", name, err)
    if failures:
        return 1
    if validate_only or not image:
        return 0
    if shutil.which("docker") is None:
        logger.error("docker not found; ran validation only")
        return 1
    return subprocess.call(["docker", "build", "-t", image, directory])


def zoo_push(image: str) -> int:
    """``docker push`` the built zoo image to its registry."""
    if shutil.which("docker") is None:
        logger.error("docker not found; cannot push %s", image)
        return 1
    return subprocess.call(["docker", "push", image])
