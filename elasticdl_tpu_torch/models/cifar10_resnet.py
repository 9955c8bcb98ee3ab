"""ResNet on CIFAR-10 — the PyTorch port of
``elasticdl_tpu/models/cifar10_resnet.py`` (BASELINE config 2, "ResNet-50
on CIFAR-10, AllReduce mode").

A bottleneck ResNet (depth 50: stages of 3, 4, 6 and 3 blocks; 26: 2 each;
14: 1 each) at ``width`` channels in the stem, with GroupNorm(8) in place
of BatchNorm (no running statistics, so ``apply`` stays a function of the
parameters) and the 3x3 stride-1 CIFAR stem; ``imagenet_stem=True`` is the
7x7/s2 stem with a 3x3/s2 max-pool.  f32 parameters, compute in
``compute_dtype`` (bfloat16 by default), f32 statistics, logits and loss;
``optax.sgd(lr, momentum=0.9, nesterov=True)`` as ``torch.optim.SGD``.

The parameters carry the JAX tree's names (``stem.conv``,
``stages.stage0.block0.conv1``, ``...gn1.scale``, ``head.w``), conv
kernels OIHW (HWIO in the reference; ``params_from_jax`` transposes).
Convolutions pad by XLA's ``"SAME"`` rule (``models/common.same_pads``),
which is asymmetric at stride 2.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from elasticdl_tpu_torch.common.device import resolve_device
from elasticdl_tpu_torch.data.codecs import cifar10_feed
from elasticdl_tpu_torch.models import common
from elasticdl_tpu_torch.models.spec import ModelSpec

NUM_CLASSES = 10
STAGES = {50: (3, 4, 6, 3), 26: (2, 2, 2, 2), 14: (1, 1, 1, 1)}


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               groups: int = 8, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm in the reference's folded one-pass form, on NCHW.

    - The sums of x and x² in f32 straight from x (the cast happens in the
      reduction kernels; no f32 copy of x is made), per (batch, channel),
      then per group.
    - The statistics and the affine fold into per-(batch, channel) ``a``
      and ``off`` in f32, CAST TO x's dtype.
    - One ``x * a + off`` over the activation.

    At f32 this equals ``F.group_norm`` up to summation order; at bf16 the
    product and the pre-added offset round to 8 bits as the reference's
    do, which the unfolded form would not.
    """
    b, c = x.shape[0], x.shape[1]
    g = min(groups, c)
    cg = c // g
    n = x.shape[2] * x.shape[3] * cg
    s = x.sum(dim=(2, 3), dtype=torch.float32).view(b, g, cg).sum(-1)  # [b, g]
    ss = torch.linalg.vector_norm(x, 2, dim=(2, 3), dtype=torch.float32).square()
    ss = ss.view(b, g, cg).sum(-1)
    mean = s / n
    # One-pass variance, clamped: activations are O(1) after a norm and a
    # relu, so the cancellation of E[x^2] - E[x]^2 is benign in f32.
    var = torch.clamp_min(ss / n - mean.square(), 0.0)
    inv = torch.rsqrt(var + eps)
    a = inv[:, :, None] * scale.view(g, cg)  # [b, g, cg]
    off = bias.view(g, cg) - mean[:, :, None] * a
    a = a.reshape(b, c, 1, 1).to(x.dtype)
    off = off.reshape(b, c, 1, 1).to(x.dtype)
    return x * a + off


class _Norm(nn.Module):
    def __init__(self, c: int, device: torch.device, zero_scale: bool = False):
        super().__init__()
        self.zero_scale = zero_scale
        self.scale = nn.Parameter(torch.zeros(c, device=device))
        self.bias = nn.Parameter(torch.zeros(c, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm(x, self.scale, self.bias)


def _kernel(c_out: int, c_in: int, k: int, device: torch.device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(c_out, c_in, k, k, device=device))


class _Block(nn.Module):
    def __init__(self, in_ch: int, mid_ch: int, stride: int, device: torch.device):
        super().__init__()
        out_ch = mid_ch * 4
        self.stride = stride
        self.conv1 = _kernel(mid_ch, in_ch, 1, device)
        self.gn1 = _Norm(mid_ch, device)
        self.conv2 = _kernel(mid_ch, mid_ch, 3, device)
        self.gn2 = _Norm(mid_ch, device)
        self.conv3 = _kernel(out_ch, mid_ch, 1, device)
        # Zero-init the last norm's scale: each residual branch starts as
        # the identity (the large-batch trick).
        self.gn3 = _Norm(out_ch, device, zero_scale=True)
        if stride != 1 or in_ch != out_ch:
            self.proj = _kernel(out_ch, in_ch, 1, device)
            self.gn_proj = _Norm(out_ch, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = x.dtype
        y = torch.relu(self.gn1(common.conv2d_same(x, self.conv1.to(cd))))
        y = torch.relu(self.gn2(common.conv2d_same(y, self.conv2.to(cd), self.stride)))
        y = self.gn3(common.conv2d_same(y, self.conv3.to(cd)))
        if hasattr(self, "proj"):
            x = self.gn_proj(common.conv2d_same(x, self.proj.to(cd), self.stride))
        return torch.relu(x + y)


class _Stem(nn.Module):
    def __init__(self, width: int, k: int, device: torch.device):
        super().__init__()
        self.conv = _kernel(width, 3, k, device)
        self.gn = _Norm(width, device)


class _Head(nn.Module):
    def __init__(self, n_in: int, n_out: int, device: torch.device):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(n_in, n_out, device=device))
        self.b = nn.Parameter(torch.zeros(n_out, device=device))


class ResNet(nn.Module):
    def __init__(self, stages: Tuple[int, ...], width: int, num_classes: int,
                 imagenet_stem: bool, compute_dtype: torch.dtype, device: torch.device):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.imagenet_stem = imagenet_stem
        self.stem = _Stem(width, 7 if imagenet_stem else 3, device)
        in_ch = width
        stage_modules = {}
        for s, n_blocks in enumerate(stages):
            mid = width * (2 ** s)
            blocks = {}
            for i in range(n_blocks):
                stride = 2 if (s > 0 and i == 0) else 1
                blocks[f"block{i}"] = _Block(in_ch, mid, stride, device)
                in_ch = mid * 4
            stage_modules[f"stage{s}"] = nn.ModuleDict(blocks)
        self.stages = nn.ModuleDict(stage_modules)
        self.head = _Head(in_ch, num_classes, device)

    def conv_paths(self) -> Tuple[str, ...]:
        return tuple(path for path, p in self.named_tree() if p.dim() == 4)

    def named_tree(self):
        return [(n.replace(".", "/"), p) for n, p in self.named_parameters()]

    def load_jax_params(self, tree: Dict[str, Any]) -> "ResNet":
        """Copy a JAX ``cifar10_resnet`` params tree (numpy arrays) into this
        module, the HWIO kernels transposed to OIHW."""
        common.load_tree(self.named_tree(), tree, self.conv_paths())
        return self

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The reference's init: he_normal kernels, glorot_normal head,
        norms at scale 1 (gn3 at 0) and bias 0, zero head bias."""
        for _, p in self.named_tree():
            if p.dim() == 4:
                common.he_normal_conv_(p, generator)
        common.glorot_normal_dense_(self.head.w, generator)
        with torch.no_grad():
            self.head.b.zero_()
            for m in self.modules():
                if isinstance(m, _Norm):
                    m.scale.fill_(0.0 if m.zero_scale else 1.0)
                    m.bias.zero_()

    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        cd = self.compute_dtype
        x = common.nhwc_images(batch, cd)
        x = common.conv2d_same(x, self.stem.conv.to(cd), 2 if self.imagenet_stem else 1)
        x = torch.relu(self.stem.gn(x))
        if self.imagenet_stem:
            x = common.max_pool_same(x, 3, 2)
        for stage in self.stages.values():
            for block in stage.values():
                x = block(x)
        x = x.mean(dim=(2, 3), dtype=torch.float32)
        return x @ self.head.w + self.head.b


def _apply(model: ResNet, batch: Dict[str, torch.Tensor], train: bool = False) -> torch.Tensor:
    return model(batch)


def _example_batch(batch_size: int, image_size: int = 32) -> Dict[str, np.ndarray]:
    return {
        "images": np.zeros((batch_size, image_size, image_size, 3), np.float32),
        "labels": np.zeros((batch_size,), np.int32),
    }


def _init(seed: Optional[int], device: Any = None, stages: Tuple[int, ...] = STAGES[50],
          width: int = 64, num_classes: int = NUM_CLASSES, imagenet_stem: bool = False,
          compute_dtype: torch.dtype = torch.bfloat16) -> ResNet:
    dev = resolve_device(device)
    model = ResNet(stages, width, num_classes, imagenet_stem, compute_dtype, dev)
    if seed is not None:
        model.reset_parameters(torch.Generator(device=dev).manual_seed(seed))
    return model


def params_from_jax(tree: Dict[str, Any], depth: int = 50, compute_dtype: str = "bfloat16",
                    device: Any = None) -> ResNet:
    """The port's model holding a JAX ``cifar10_resnet`` params tree (numpy
    arrays): widths, class count and stem read from the tree's shapes, the
    HWIO kernels transposed to OIHW."""
    stem = np.shape(tree["stem"]["conv"])
    model = _init(None, device, STAGES[depth], width=stem[3],
                  num_classes=np.shape(tree["head"]["w"])[1], imagenet_stem=stem[0] == 7,
                  compute_dtype=common.compute_dtype(compute_dtype))
    return model.load_jax_params(tree)


def params_to_jax(model: ResNet) -> Dict[str, Any]:
    """The reverse of :func:`params_from_jax`: a JAX ``cifar10_resnet``
    params tree of f32 numpy copies."""
    return common.dump_tree(model.named_tree(), model.conv_paths())


def model_spec(
    learning_rate: float = 0.1,
    compute_dtype: str = "bfloat16",
    depth: int = 50,
    width: int = 64,
    image_size: int = 32,
    num_classes: int = NUM_CLASSES,
    imagenet_stem: bool = False,
) -> ModelSpec:
    """depth 50 -> bottleneck stages (3, 4, 6, 3); 26 -> (2, 2, 2, 2); 14
    (the tests') -> (1, 1, 1, 1).  ``image_size=224, num_classes=1000,
    imagenet_stem=True`` is the ImageNet ResNet-50; the CIFAR default is
    BASELINE config 2."""
    if depth not in STAGES:
        raise ValueError(f"unsupported depth {depth}, pick from {sorted(STAGES)}")
    dtype = common.compute_dtype(compute_dtype)
    if image_size != 32 or num_classes != NUM_CLASSES:
        # No dataset codec has these shapes: a job that fed cifar10 records
        # into this variant would train against 32x32, 10-class batches.
        def feed(records):
            raise RuntimeError(
                f"resnet image_size={image_size}/num_classes={num_classes} has no "
                "dataset codec: this variant takes synthetic batches or a custom "
                "feed, not cifar10 records"
            )
    else:
        feed = cifar10_feed
    return ModelSpec(
        name=f"cifar10_resnet{depth}",
        init=functools.partial(_init, stages=STAGES[depth], width=width,
                               num_classes=num_classes, imagenet_stem=imagenet_stem,
                               compute_dtype=dtype),
        apply=_apply,
        loss=common.classification_loss,
        metrics=common.classification_metrics,
        optimizer=functools.partial(common.sgd, learning_rate=learning_rate, nesterov=True),
        feed=feed,
        example_batch=functools.partial(_example_batch, image_size=image_size),
    )
