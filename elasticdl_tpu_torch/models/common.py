"""Shared pieces of the port's zoo models (``models/mnist.py``,
``models/cifar10_resnet.py``, ``models/wide_deep.py``): the reference's
initializers drawn from a ``torch.Generator``, the carry of JAX params
trees, XLA's ``"SAME"`` padding rule, and the softmax cross-entropy loss,
metrics and SGD of the image models.

Layouts: the JAX image models run NHWC activations and HWIO kernels; the
port's run NCHW (the feed's NHWC images are permuted on the device, which
leaves them channels-last in memory) and OIHW kernels.  A carried JAX
kernel is transposed by ``(3, 2, 0, 1)`` (``hwio_to_oihw``).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from elasticdl_tpu_torch.models.metrics import masked_mean

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

# jax.nn.initializers' truncated normal: a standard normal cut at two
# standard deviations has this standard deviation, so the draws are
# rescaled by its inverse.
_TRUNC_STD = 0.87962566103423978


def compute_dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"compute_dtype must be one of {sorted(_DTYPES)}, got {name!r}")
    return _DTYPES[name]


def variance_scaling_(w: torch.Tensor, scale: float, fan: float,
                      generator: torch.Generator) -> torch.Tensor:
    """``jax.nn.initializers.variance_scaling(scale, mode, "truncated_normal")``
    in place, ``fan`` the mode's fan (fan_in, or the fan average)."""
    std = math.sqrt(scale / fan) / _TRUNC_STD
    with torch.no_grad():
        return torch.nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)


def he_normal_conv_(w: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """``he_normal`` of an OIHW kernel: fan_in = I * H * W."""
    return variance_scaling_(w, 2.0, w.shape[1] * w.shape[2] * w.shape[3], generator)


def he_normal_dense_(w: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """``he_normal`` of an ``[in, out]`` weight."""
    return variance_scaling_(w, 2.0, w.shape[0], generator)


def glorot_normal_dense_(w: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """``glorot_normal`` of an ``[in, out]`` weight: the fan average."""
    return variance_scaling_(w, 1.0, (w.shape[0] + w.shape[1]) / 2.0, generator)


def hwio_to_oihw(kernel) -> torch.Tensor:
    """A JAX HWIO conv kernel (numpy) as a torch OIHW one."""
    return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(kernel, np.float32),
                                                              (3, 2, 0, 1))))


def oihw_to_hwio(w: torch.Tensor) -> np.ndarray:
    """The reverse of :func:`hwio_to_oihw` (a copy)."""
    return np.ascontiguousarray(
        w.detach().to("cpu", torch.float32, copy=True).permute(2, 3, 1, 0).numpy())


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """XLA's ``"SAME"`` padding of one spatial dim: the output is
    ``ceil(size / stride)``, the padding ``total = max((out - 1) * stride +
    kernel - size, 0)``, ``total // 2`` before and the rest after.  With
    stride 2 on an even size that is asymmetric: a 3x3 kernel pads 0
    before and 1 after (32 -> 16), a 7x7 one 2 and 3 (224 -> 112)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def conv2d_same(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """``lax.conv_general_dilated(..., "SAME")`` on NCHW / OIHW: symmetric
    padding goes to the convolution, an asymmetric one to ``F.pad`` first."""
    (top, bottom), (left, right) = (same_pads(x.shape[2], w.shape[2], stride),
                                    same_pads(x.shape[3], w.shape[3], stride))
    if top == bottom and left == right:
        return F.conv2d(x, w, stride=stride, padding=(top, left))
    return F.conv2d(F.pad(x, (left, right, top, bottom)), w, stride=stride)


def max_pool_same(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """``lax.reduce_window(x, -inf, max, ..., "SAME")``: the padding is -inf,
    so it never wins a window."""
    (top, bottom), (left, right) = (same_pads(x.shape[2], kernel, stride),
                                    same_pads(x.shape[3], kernel, stride))
    x = F.pad(x, (left, right, top, bottom), value=float("-inf"))
    return F.max_pool2d(x, kernel, stride)


def nhwc_images(batch: Dict[str, torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
    """The batch's ``images`` (NHWC, or NHW for one channel) as NCHW in
    ``dtype``: a permuted view, channels-last in memory."""
    x = batch["images"].to(dtype)
    if x.dim() == 3:
        x = x[..., None]
    return x.permute(0, 3, 1, 2)


def _ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-example softmax cross-entropy with integer labels (optax's
    ``softmax_cross_entropy_with_integer_labels``), in f32."""
    return F.cross_entropy(logits.float(), labels.long(), reduction="none")


def classification_loss(logits: torch.Tensor, batch: Dict[str, torch.Tensor],
                        mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    return masked_mean(_ce(logits, batch["labels"]), mask)


def classification_metrics(logits: torch.Tensor, batch: Dict[str, torch.Tensor],
                           mask: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    labels = batch["labels"]
    return {
        "accuracy": masked_mean(logits.argmax(dim=-1) == labels.long(), mask),
        "loss": masked_mean(_ce(logits, labels), mask),
    }


def sgd(parameters, learning_rate: float, nesterov: bool = False) -> torch.optim.SGD:
    """``optax.sgd(learning_rate, momentum=0.9, nesterov=...)``: the trace
    starts at the first gradient (torch's momentum buffer too, with no
    dampening), nesterov steps by ``g + 0.9 * trace`` in both."""
    return torch.optim.SGD(parameters, lr=learning_rate, momentum=0.9, dampening=0.0,
                           nesterov=nesterov)


def load_tree(named: Sequence[Tuple[str, torch.Tensor]], tree: Dict, convs: Sequence[str]) -> None:
    """Copy a JAX params tree (numpy arrays) into the named tensors, by
    their ``/``-joined paths; the paths in ``convs`` are HWIO kernels."""

    def leaf(path: str):
        node = tree
        for part in path.split("/"):
            node = node[part]
        return node

    with torch.no_grad():
        for path, p in named:
            value = leaf(path)
            t = hwio_to_oihw(value) if path in convs else torch.from_numpy(
                np.array(value, np.float32))
            if tuple(t.shape) != tuple(p.shape):
                raise ValueError(f"{path}: shape {tuple(t.shape)} does not match "
                                 f"{tuple(p.shape)}")
            p.copy_(t)


def dump_tree(named: Sequence[Tuple[str, torch.Tensor]], convs: Sequence[str]) -> Dict:
    """The reverse of :func:`load_tree`: a nested JAX params tree of f32
    numpy copies (HWIO kernels for the paths in ``convs``)."""
    tree: Dict = {}
    for path, p in named:
        *parents, name = path.split("/")
        node = tree
        for part in parents:
            node = node.setdefault(part, {})
        node[name] = (oihw_to_hwio(p) if path in convs
                      else p.detach().to("cpu", torch.float32, copy=True).numpy())
    return tree
