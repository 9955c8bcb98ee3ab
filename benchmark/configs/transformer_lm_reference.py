"""Plain PyTorch reference of the decoder-only transformer LM that the
program trains (``elasticdl_tpu_torch/models/transformer_lm.py``), for
the configurations whose ``family`` is ``transformer_lm``.

Equations (the port's, which are the JAX reference's): token plus learned
position embedding; per block, in the order of the blocks' sorted names,
``x += attn(rms(x) * ln1) @ wo`` with causal multi-head attention over
``qkv = h @ wqkv`` split ``[all q | all k | all v]`` and scores scaled by
``head_dim ** -0.5``, then ``x += gelu_tanh(rms(x) * ln2 @ w1) @ w2``;
``rms(x) = x / sqrt(mean(x^2) + 1e-6)``; a final ``rms(x) * ln_f``; the
head tied to the token embedding; the mean token cross-entropy; AdamW
(b1 0.9, b2 0.999, eps 1e-8, decoupled weight decay on every parameter).

Everything is float32 with TF32 off. ``matmul_format="fp8"`` is the
control, one precision below the configuration's bfloat16 compute: every
tensor the program holds in bfloat16 (the residual stream, the normed
inputs, the weights as the products take them, each product's output,
the attention's operands and output, the activations) is rounded to
float8 e4m3 going forward and its gradient coming back, and every
product takes e4m3 operands (``fp8_control``). Imports torch only.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from configs import fp8_control


class Reference:
    """Model state and AdamW moments as f32 tensors keyed by the program's
    parameter names (``tok_emb``, ``pos_emb``, ``ln_f``,
    ``blocks.<name>.{ln1, wqkv, wo, ln2, w1, w2}``)."""

    def __init__(self, weights: Dict[str, torch.Tensor], n_heads: int, learning_rate: float,
                 weight_decay: float, matmul_format: str = "fp32", row_block: int = 4):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.params = {k: v.detach().clone().float().requires_grad_() for k, v in weights.items()}
        self.exp_avg = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.exp_avg_sq = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.blocks = sorted({k.split(".")[1] for k in weights if k.startswith("blocks.")})
        self.n_heads = n_heads
        self.lr, self.wd = learning_rate, weight_decay
        fp8 = matmul_format == "fp8"
        self.lowp = fp8_control.cast if fp8 else (lambda x: x)
        self.mm = fp8_control.matmul if fp8 else torch.matmul
        self.row_block = row_block
        self.count = 0

    def _matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """A product as the program's compute dtype has it: its output
        rounded too."""
        return self.lowp(self.mm(a, b))

    @staticmethod
    def _rms(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + 1e-6) * scale

    def _logits(self, tokens: torch.Tensor) -> torch.Tensor:
        p, low = self.params, self.lowp
        b, l = tokens.shape
        x = low(p["tok_emb"][tokens] + p["pos_emb"][:l][None])
        dim = x.shape[-1]
        hd = dim // self.n_heads
        causal = torch.ones(l, l, dtype=torch.bool, device=x.device).tril()
        for name in self.blocks:
            w = {k: p[f"blocks.{name}.{k}"] for k in ("ln1", "wqkv", "wo", "ln2", "w1", "w2")}
            qkv = self._matmul(low(self._rms(x, w["ln1"])), low(w["wqkv"]))
            q, k, v = (t.reshape(b, l, self.n_heads, hd).transpose(1, 2)
                       for t in qkv.split(dim, dim=-1))
            s = self.mm(q, k.transpose(-1, -2)) * hd**-0.5
            att = self._matmul(torch.softmax(s.masked_fill(~causal, -math.inf), dim=-1), v)
            x = low(x + self._matmul(att.transpose(1, 2).reshape(b, l, dim), low(w["wo"])))
            h = low(F.gelu(self._matmul(low(self._rms(x, w["ln2"])), low(w["w1"])),
                           approximate="tanh"))
            x = low(x + self._matmul(h, low(w["w2"])))
        return self._matmul(low(self._rms(x, p["ln_f"])), low(p["tok_emb"]).T)

    def step(self, rows: torch.Tensor) -> float:
        """One training step on ``rows`` ``[B, L + 1]`` int64 (tokens, then
        the next-token labels), in blocks of ``row_block`` rows: the
        gradient of the mean loss over every token, then the update.
        Returns the loss before the update."""
        tokens, labels = rows[:, :-1], rows[:, 1:]
        total = labels.numel()
        for g in self.params.values():
            g.grad = None
        loss_sum = 0.0
        for at in range(0, len(rows), self.row_block):
            logits = self._logits(tokens[at:at + self.row_block])
            loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                   labels[at:at + self.row_block].reshape(-1), reduction="sum")
            (loss / total).backward()
            loss_sum += float(loss.detach())
            del logits, loss
        self._adamw()
        return loss_sum / total

    @torch.no_grad()
    def loss(self, rows: torch.Tensor) -> float:
        """The mean loss on ``rows`` without a step."""
        total = 0.0
        for at in range(0, len(rows), self.row_block):
            logits = self._logits(rows[at:at + self.row_block, :-1])
            total += float(F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                           rows[at:at + self.row_block, 1:].reshape(-1),
                                           reduction="sum"))
        return total / rows[:, 1:].numel()

    @torch.no_grad()
    def _adamw(self) -> None:
        self.count += 1
        b1, b2, eps = 0.9, 0.999, 1e-8
        c1, c2 = 1 - b1**self.count, 1 - b2**self.count
        for k, p in self.params.items():
            g = p.grad
            self.exp_avg[k].mul_(b1).add_(g, alpha=1 - b1)
            self.exp_avg_sq[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            update = (self.exp_avg[k] / c1) / ((self.exp_avg_sq[k] / c2).sqrt() + eps)
            p.sub_(self.lr * (update + self.wd * p))

    def state(self) -> Dict[str, Dict[str, torch.Tensor]]:
        return {"params": {k: v.detach() for k, v in self.params.items()},
                "exp_avg": self.exp_avg}


def leaf_names(n_layers: int) -> List[str]:
    """The program's parameter names at ``n_layers`` blocks."""
    names = ["tok_emb", "pos_emb", "ln_f"]
    for i in range(n_layers):
        names += [f"blocks.b{i}.{k}" for k in ("ln1", "wqkv", "wo", "ln2", "w1", "w2")]
    return names
