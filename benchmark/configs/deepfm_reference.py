"""Plain PyTorch reference of the DeepFM the program trains
(``elasticdl_tpu_torch/models/deepfm.py``), for the configurations whose
``family`` is ``deepfm``.

Equations (the port's, which are the JAX reference's): the categorical
ids hash into one fused table (``field * buckets + hash(raw) % buckets``,
the multiplicative uint32 hash with Knuth's constant and a fold of the
high half); each id's row holds an ``embedding_dim`` FM vector and a
first-order weight. The logit is the first-order term (the weights of the
row ids, plus ``log1p(max(x, 0)) @ w + b`` of the integers, the log1p
rounded to float16 as the port's preprocessed feed carries it), plus the FM's
``0.5 * sum_d((sum_f v)^2 - sum_f v^2)``, plus an MLP (ReLU hidden
layers, one output) over the concatenated vectors and the log1p
integers. The loss is the mean binary cross-entropy; the update Adam (b1
0.9, b2 0.999, eps 1e-8) over every parameter, the whole table included.

Everything is float32 with TF32 off. ``matmul_format="fp8"`` is the
control, one precision below the configuration's bfloat16 compute of the
FM and the MLP: every tensor the program holds in bfloat16 there (the FM
vectors and the integer features as they enter, each FM intermediate,
the weights and biases as the MLP takes them, each layer's output) is
rounded to float8 e4m3 going forward and its gradient coming back, and
every MLP product takes e4m3 operands (``fp8_control``). Imports numpy
and torch only.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from configs import fp8_control

_HASH_MULT = 2654435761


def fused_ids(cats: np.ndarray, buckets: int) -> np.ndarray:
    """``[n, F]`` uint32 raw ids -> int64 rows of the fused table."""
    h = (cats.astype(np.uint64) * _HASH_MULT) & 0xFFFFFFFF
    h ^= h >> 16
    return (h % buckets).astype(np.int64) + np.arange(cats.shape[1], dtype=np.int64) * buckets


def dense_features(dense: np.ndarray) -> np.ndarray:
    """``[n, 13]`` int64 counts (-1 missing, read as 0) -> ``log1p``, in
    float16 as the program's preprocessed feed carries them (its wire
    format), widened to float32."""
    return np.log1p(np.maximum(dense, 0).astype(np.float64)).astype(np.float16).astype(np.float32)


class Reference:
    """Weights keyed by the program's parameter names, the table as its
    logical ``[rows, embedding_dim + 1]`` rows (``fm_table``)."""

    def __init__(self, weights: Dict[str, torch.Tensor], embedding_dim: int,
                 learning_rate: float, matmul_format: str = "fp32"):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.params = {k: v.detach().clone().float().requires_grad_() for k, v in weights.items()}
        self.exp_avg = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.exp_avg_sq = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.dim = embedding_dim
        self.hidden = sorted((k[len("mlp."):-len(".w")] for k in weights
                              if k.startswith("mlp.layer") and k.endswith(".w")),
                             key=lambda name: int(name[len("layer"):]))
        self.lr = learning_rate
        fp8 = matmul_format == "fp8"
        self.cast = fp8_control.cast if fp8 else (lambda x: x)
        self.mm = fp8_control.matmul if fp8 else torch.matmul
        self.count = 0

    def logits(self, ids: torch.Tensor, dense: torch.Tensor) -> torch.Tensor:
        p, mm, low = self.params, self.mm, self.cast
        vecs = p["fm_table"][ids]  # [b, F, dim + 1]
        emb, lin = low(vecs[..., :self.dim]), vecs[..., self.dim]
        first = lin.sum(dim=-1) + (dense @ p["dense_linear.w"])[:, 0] + p["dense_linear.b"][0]
        sum_v = low(emb.sum(dim=1))
        sum_v2 = low(low(emb * emb).sum(dim=1))
        fm = 0.5 * low(low(low(sum_v * sum_v) - sum_v2).sum(dim=-1))
        x = torch.cat([emb.reshape(emb.shape[0], -1), low(dense)], dim=-1)
        for name in self.hidden:
            x = low(torch.relu(low(low(mm(x, low(p[f"mlp.{name}.w"]))) + low(p[f"mlp.{name}.b"]))))
        deep = low(low(mm(x, low(p["mlp.out.w"]))) + low(p["mlp.out.b"]))[:, 0]
        return first + fm + deep

    @staticmethod
    def loss_of(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        return (logits.clamp_min(0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))).mean()

    def step(self, ids: torch.Tensor, dense: torch.Tensor, labels: torch.Tensor) -> float:
        """One training step; returns the loss before the update."""
        for g in self.params.values():
            g.grad = None
        loss = self.loss_of(self.logits(ids, dense), labels)
        loss.backward()
        self._adam()
        return float(loss.detach())

    @torch.no_grad()
    def eval_loss(self, ids: torch.Tensor, dense: torch.Tensor, labels: torch.Tensor) -> float:
        return float(self.loss_of(self.logits(ids, dense), labels))

    @torch.no_grad()
    def _adam(self) -> None:
        self.count += 1
        b1, b2, eps = 0.9, 0.999, 1e-8
        c1, c2 = 1 - b1**self.count, 1 - b2**self.count
        for k, p in self.params.items():
            g = p.grad
            self.exp_avg[k].mul_(b1).add_(g, alpha=1 - b1)
            self.exp_avg_sq[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            p.sub_(self.lr * (self.exp_avg[k] / c1) / ((self.exp_avg_sq[k] / c2).sqrt() + eps))

    def state(self) -> Dict[str, Dict[str, torch.Tensor]]:
        return {"params": {k: v.detach() for k, v in self.params.items()},
                "exp_avg": self.exp_avg}
