"""MNIST — the PyTorch port of ``elasticdl_tpu/models/mnist.py``
(BASELINE config 1, "MNIST Keras functional model, AllReduce").

A small CNN: conv 3x3x32 -> relu -> conv 3x3x64 -> relu -> 2x2 max-pool
-> dense 9216 -> 128 -> relu -> dense 10 (1.20M parameters).  f32
parameters, compute in ``compute_dtype`` (bfloat16 by default), f32
logits and loss; ``optax.sgd(lr, momentum=0.9)`` as ``torch.optim.SGD``.

The parameters carry the JAX tree's names (``conv1.w``, ``dense1.b``,
...), so the canonical state's paths are the reference's.  Conv kernels
are OIHW here, HWIO there (``params_from_jax`` transposes them).  The
reference flattens the pooled NHWC activation, so ``dense1``'s 9216 rows
are in (h, w, c) order; this forward permutes the pooled NCHW activation
to NHWC before the flatten, so ``dense1.w`` is the reference's array as it
is.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from elasticdl_tpu_torch.common.device import resolve_device
from elasticdl_tpu_torch.data.codecs import mnist_feed
from elasticdl_tpu_torch.models import common
from elasticdl_tpu_torch.models.spec import ModelSpec

IMAGE_SHAPE = (28, 28, 1)
NUM_CLASSES = 10
_CONVS = ("conv1/w", "conv2/w")


class _Conv(nn.Module):
    def __init__(self, c_in: int, c_out: int, device: torch.device):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(c_out, c_in, 3, 3, device=device))
        self.b = nn.Parameter(torch.zeros(c_out, device=device))


class _Dense(nn.Module):
    """``x @ w + b`` with the reference's ``[in, out]`` weight."""

    def __init__(self, n_in: int, n_out: int, device: torch.device):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(n_in, n_out, device=device))
        self.b = nn.Parameter(torch.zeros(n_out, device=device))


class MNIST(nn.Module):
    def __init__(self, compute_dtype: torch.dtype, device: torch.device):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.conv1 = _Conv(1, 32, device)
        self.conv2 = _Conv(32, 64, device)
        self.dense1 = _Dense(12 * 12 * 64, 128, device)
        self.dense2 = _Dense(128, NUM_CLASSES, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The reference's init: he_normal kernels and weights, zero biases."""
        for conv in (self.conv1, self.conv2):
            common.he_normal_conv_(conv.w, generator)
        for dense in (self.dense1, self.dense2):
            common.he_normal_dense_(dense.w, generator)
        with torch.no_grad():
            for m in (self.conv1, self.conv2, self.dense1, self.dense2):
                m.b.zero_()

    def named_tree(self):
        return [(n.replace(".", "/"), p) for n, p in self.named_parameters()]

    def load_jax_params(self, tree: Dict[str, Any]) -> "MNIST":
        """Copy a JAX ``mnist`` params tree (numpy arrays) into this module,
        the HWIO kernels transposed to OIHW."""
        common.load_tree(self.named_tree(), tree, _CONVS)
        return self

    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        cd = self.compute_dtype
        x = common.nhwc_images(batch, cd)
        x = torch.relu(F.conv2d(x, self.conv1.w.to(cd), self.conv1.b.to(cd)))
        x = torch.relu(F.conv2d(x, self.conv2.w.to(cd), self.conv2.b.to(cd)))
        x = F.max_pool2d(x, 2, 2)
        # NHWC before the flatten: dense1's rows are in (h, w, c) order.
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = torch.relu(x @ self.dense1.w.to(cd) + self.dense1.b.to(cd))
        return (x @ self.dense2.w.to(cd) + self.dense2.b.to(cd)).float()


def _apply(model: MNIST, batch: Dict[str, torch.Tensor], train: bool = False) -> torch.Tensor:
    return model(batch)


def _predict(model: MNIST, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Inference entry: class probabilities [b, 10], not logits."""
    return torch.softmax(model(batch), dim=-1)


def _example_batch(batch_size: int) -> Dict[str, np.ndarray]:
    return {
        "images": np.zeros((batch_size,) + IMAGE_SHAPE, np.float32),
        "labels": np.zeros((batch_size,), np.int32),
    }


def _init(seed: Optional[int], device: Any = None,
          compute_dtype: torch.dtype = torch.bfloat16) -> MNIST:
    dev = resolve_device(device)
    model = MNIST(compute_dtype, dev)
    if seed is not None:
        model.reset_parameters(torch.Generator(device=dev).manual_seed(seed))
    return model


def params_from_jax(tree: Dict[str, Any], compute_dtype: str = "bfloat16",
                    device: Any = None) -> MNIST:
    """The port's model holding a JAX ``mnist`` params tree (numpy arrays);
    the HWIO kernels are transposed to OIHW."""
    return _init(None, device, common.compute_dtype(compute_dtype)).load_jax_params(tree)


def params_to_jax(model: MNIST) -> Dict[str, Any]:
    """The reverse of :func:`params_from_jax`: a JAX ``mnist`` params tree
    of f32 numpy copies."""
    return common.dump_tree(model.named_tree(), _CONVS)


def model_spec(learning_rate: float = 1e-3, compute_dtype: str = "bfloat16") -> ModelSpec:
    dtype = common.compute_dtype(compute_dtype)
    return ModelSpec(
        name="mnist",
        init=functools.partial(_init, compute_dtype=dtype),
        apply=_apply,
        predict=_predict,
        loss=common.classification_loss,
        metrics=common.classification_metrics,
        optimizer=functools.partial(common.sgd, learning_rate=learning_rate),
        feed=mnist_feed,
        example_batch=_example_batch,
    )
