"""Decoder-only transformer LM — the PyTorch port of
``elasticdl_tpu/models/transformer_lm.py`` (``parallelism="sequence"`` on
one device: serving and training).

Architecture, as in the reference: pre-RMSNorm blocks, causal multi-head
attention, GELU MLP (4x), learned positional embedding, weight-tied LM
head.  f32 parameters, bfloat16 compute by default.  Weights keep the
reference's ``[in, out]`` orientation (``x @ W``), so weights carried over
from the JAX package (:func:`params_from_jax`) copy across untransposed.

Details kept from the reference because carried weights only compute the
same function with them:

- blocks run in ``sorted()`` name order (``b0, b1, b10, b11, b2, ...`` at
  12 layers), not numeric order;
- ``wqkv``'s output splits ``[all-q | all-k | all-v]``, not head-major;
- GELU is the tanh approximation (``jax.nn.gelu``'s default);
- RMSNorm takes its statistics and applies its f32 scale in f32 and
  downcasts once;
- the embedding sum is taken in f32 and then cast to the compute dtype;
- the logits are the compute-dtype product with ``tok_emb.T``, cast to f32
  after the matmul (so they carry its rounding);
- training rematerializes each block (``remat=True``, the default) and
  the loss is the mean token cross-entropy over real (unmasked) sequences,
  AdamW with optax's defaults.

Weights in the compute dtype: a forward under autograd casts the f32
parameters on every call, inside each (checkpointed) block, so gradients
reach them; a forward without autograd (serving) reuses casts kept until
a parameter changes.

Tensor parallelism (``_tp_block``/``_tp_apply``) and the sequence ring are
later slices of the port.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from elasticdl_tpu_torch.common.device import resolve_device
from elasticdl_tpu_torch.data.codecs import lm_feed
from elasticdl_tpu_torch.models.metrics import masked_mean
from elasticdl_tpu_torch.models.spec import ModelSpec
from elasticdl_tpu_torch.ops.ring_attention import ring_attention

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
_MATMUL_WEIGHTS = ("wqkv", "wo", "w1", "w2")


def _rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


class Block(nn.Module):
    """One pre-norm transformer block (attention + MLP residual)."""

    def __init__(self, dim: int, device: torch.device):
        super().__init__()
        f32 = {"device": device, "dtype": torch.float32}
        self.ln1 = nn.Parameter(torch.ones(dim, **f32))
        self.wqkv = nn.Parameter(torch.empty(dim, 3 * dim, **f32))
        self.wo = nn.Parameter(torch.empty(dim, dim, **f32))
        self.ln2 = nn.Parameter(torch.ones(dim, **f32))
        self.w1 = nn.Parameter(torch.empty(dim, 4 * dim, **f32))
        self.w2 = nn.Parameter(torch.empty(4 * dim, dim, **f32))

    def forward(
        self,
        x: torch.Tensor,
        w: Optional[Dict[str, torch.Tensor]],
        n_heads: int,
        attention: Callable[..., torch.Tensor],
    ) -> torch.Tensor:
        """``w``: the matmul weights in ``x``'s dtype; None casts them here,
        inside autograd (and inside the checkpoint under remat)."""
        b, l, dim = x.shape
        head_dim = dim // n_heads
        if w is None:
            w = {key: getattr(self, key).to(x.dtype) for key in _MATMUL_WEIGHTS}
        h = _rms_norm(x, self.ln1)
        qkv = h @ w["wqkv"]  # [B, L, 3*dim]
        # Views, not copies: the kernel reads them with qkv's row stride.
        q, k, v = qkv.view(b, l, 3 * n_heads, head_dim).split(n_heads, dim=2)
        att = attention(q, k, v, causal=True)
        x = x + att.reshape(b, l, dim) @ w["wo"]
        h = _rms_norm(x, self.ln2)
        h = F.gelu(h @ w["w1"], approximate="tanh")
        return x + h @ w["w2"]


class TransformerLM(nn.Module):
    def __init__(
        self,
        vocab: int,
        dim: int,
        n_heads: int,
        n_layers: int,
        max_seq: int,
        compute_dtype: torch.dtype = torch.bfloat16,
        device: Optional[torch.device] = None,
    ):
        super().__init__()
        if dim % n_heads:
            raise ValueError(f"n_heads {n_heads} does not divide dim {dim}")
        device = resolve_device(device)
        self.n_heads = n_heads
        self.compute_dtype = compute_dtype
        f32 = {"device": device, "dtype": torch.float32}
        self.tok_emb = nn.Parameter(torch.empty(vocab, dim, **f32))
        self.pos_emb = nn.Parameter(torch.empty(max_seq, dim, **f32))
        self.ln_f = nn.Parameter(torch.ones(dim, **f32))
        self.blocks = nn.ModuleDict({f"b{i}": Block(dim, device) for i in range(n_layers)})
        self._cast: Optional[tuple] = None  # (parameter versions, casts)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The reference's init distributions, drawn from ``generator``
        (JAX's PRNG gives other numbers from the same seed: tests carry
        weights across with :func:`params_from_jax` instead)."""
        dim = self.tok_emb.shape[1]
        scale = dim**-0.5

        def normal(p: torch.Tensor, std: float) -> None:
            p.copy_(torch.randn(p.shape, generator=generator, device=p.device) * std)

        normal(self.tok_emb, scale)
        normal(self.pos_emb, 0.01)
        self.ln_f.fill_(1.0)
        for blk in self.blocks.values():
            normal(blk.wqkv, scale)
            normal(blk.wo, scale)
            normal(blk.w1, scale)
            normal(blk.w2, 0.5 * scale)
            blk.ln1.fill_(1.0)
            blk.ln2.fill_(1.0)

    @torch.no_grad()
    def load_jax_params(self, tree: Dict[str, Any]) -> "TransformerLM":
        """Copy a JAX params pytree (nested dict of arrays) into this
        module.  Same names, same ``[in, out]`` orientation: no transposes."""
        names = sorted(tree["blocks"])
        if names != sorted(self.blocks):
            raise ValueError(f"block names {names} do not match {sorted(self.blocks)}")

        def put(p: torch.Tensor, value: Any) -> None:
            arr = np.array(value, dtype=np.float32)  # a writable copy
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"shape {arr.shape} does not match {tuple(p.shape)}")
            p.copy_(torch.from_numpy(arr))

        for key in ("tok_emb", "pos_emb", "ln_f"):
            put(getattr(self, key), tree[key])
        for name in names:
            blk = self.blocks[name]
            for key in ("ln1", "ln2") + _MATMUL_WEIGHTS:
                put(getattr(blk, key), tree["blocks"][name][key])
        return self

    def _weights(self) -> Dict[str, Any]:
        """The matmul weights in the compute dtype, for forwards without
        autograd.  The reference casts the f32 weights on every call
        (``.astype(compute_dtype)``); these casts are made once and kept
        while the parameters are unchanged: the cache is keyed on their
        version counters, which every in-place update (a load, an
        optimizer step) bumps."""
        versions = tuple(p._version for p in self.parameters())
        if self._cast is None or self._cast[0] != versions:
            dt = self.compute_dtype
            with torch.inference_mode(False), torch.no_grad():
                casts = {
                    "head": self.tok_emb.to(dt),
                    "blocks": {
                        name: {key: getattr(blk, key).to(dt) for key in _MATMUL_WEIGHTS}
                        for name, blk in self.blocks.items()
                    },
                }
            self._cast = (versions, casts)
        return self._cast[1]

    def forward(
        self,
        tokens: torch.Tensor,
        attention: Callable[..., torch.Tensor] = ring_attention,
        remat: bool = False,
    ) -> torch.Tensor:
        """Logits f32 ``[B, L, vocab]`` for int tokens ``[B, L]``.
        ``attention(q, k, v, causal=True)`` over ``[B, L, H, D]``: the
        kernel routing by default; a plain version for comparisons.
        ``remat``: under autograd, recompute each block's activations in
        the backward instead of keeping them (the reference's per-block
        ``jax.checkpoint``)."""
        l = tokens.shape[1]
        max_seq = self.pos_emb.shape[0]
        # Fail loud on over-long sequences: positions past max_seq would
        # index past pos_emb.
        if l > max_seq:
            raise ValueError(
                f"global sequence length {l} exceeds max_seq "
                f"{max_seq}; raise max_seq in the model spec"
            )
        grad = torch.is_grad_enabled()
        cast = None if grad else self._weights()
        pos = torch.arange(l, device=tokens.device)
        x = self.tok_emb[tokens.long()] + self.pos_emb[pos][None]
        x = x.to(self.compute_dtype)
        for name in sorted(self.blocks):  # the reference's order: b0, b1, b10, ...
            blk = self.blocks[name]
            w = None if cast is None else cast["blocks"][name]
            if remat and grad:
                x = checkpoint(blk, x, w, self.n_heads, attention,
                               use_reentrant=False, preserve_rng_state=False)
            else:
                x = blk(x, w, self.n_heads, attention)
        x = _rms_norm(x, self.ln_f)
        # Weight-tied head; logits in f32 after the compute-dtype product.
        head = self.tok_emb.to(self.compute_dtype) if cast is None else cast["head"]
        return (x @ head.T).float()


def _apply(
    model: TransformerLM,
    batch: Dict[str, torch.Tensor],
    train: bool = False,
    remat: bool = True,
    **_,
):
    # Rematerialization per block in training only, as in the reference:
    # eval and predict have no backward to save memory for.
    return model(batch["tokens"], remat=remat and train)


def _loss(logits: torch.Tensor, batch: Dict[str, torch.Tensor], mask=None) -> torch.Tensor:
    """Mean token cross-entropy (f32 logits, integer labels) over real
    sequences: ``mask`` gives whole padded sequences zero weight."""
    ce = F.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), batch["labels"].reshape(-1).long(),
        reduction="none",
    ).reshape(logits.shape[:-1])
    return masked_mean(ce, mask)


def _metrics(logits: torch.Tensor, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Loss and accuracy without the mask, as the reference: a padded
    batch's accuracy counts its padded rows."""
    acc = (logits.argmax(dim=-1) == batch["labels"].long()).float().mean()
    return {"loss": _loss(logits, batch), "accuracy": acc}


def _adamw(parameters, learning_rate: float) -> torch.optim.AdamW:
    """``optax.adamw(learning_rate)`` with optax's defaults (b1 0.9, b2
    0.999, eps 1e-8, weight decay 1e-4, not torch's 0.01), decaying every
    parameter as optax does with no mask (norms and embeddings too)."""
    return torch.optim.AdamW(
        parameters, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4,
    )


def _check_batch(model: TransformerLM, batch: Dict[str, Any]) -> None:
    """Host-side check of a request's tokens, before they reach the
    device: an id outside the vocabulary would index past ``tok_emb`` on
    the card, where it is a device assert rather than an error."""
    tokens = batch["tokens"]
    if isinstance(tokens, torch.Tensor):
        tokens = tokens.cpu()
    tokens = np.asarray(tokens)
    vocab = model.tok_emb.shape[0]
    if tokens.size and (tokens.min() < 0 or tokens.max() >= vocab):
        raise ValueError(f"token ids must lie in [0, {vocab})")


def _init(
    seed: Optional[int],
    device: Any = None,
    vocab: int = 8192,
    dim: int = 256,
    n_heads: int = 4,
    n_layers: int = 2,
    max_seq: int = 4096,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> TransformerLM:
    dev = resolve_device(device)
    model = TransformerLM(vocab, dim, n_heads, n_layers, max_seq, compute_dtype, dev)
    if seed is not None:
        model.reset_parameters(torch.Generator(device=dev).manual_seed(seed))
    return model


def params_from_jax(
    tree: Dict[str, Any],
    n_heads: int,
    compute_dtype: str = "bfloat16",
    device: Any = None,
) -> TransformerLM:
    """The port's model holding a JAX ``transformer_lm`` params pytree
    (numpy arrays, as ``jax.device_get`` returns them)."""
    dev = resolve_device(device)
    vocab, dim = np.shape(tree["tok_emb"])
    model = TransformerLM(
        vocab, dim, n_heads, len(tree["blocks"]), np.shape(tree["pos_emb"])[0],
        _DTYPES[compute_dtype], dev,
    )
    return model.load_jax_params(tree)


def params_to_jax(model: TransformerLM) -> Dict[str, Any]:
    """The reverse of :func:`params_from_jax`: the model's parameters as a
    JAX ``transformer_lm`` params tree of f32 numpy arrays."""

    def get(p: torch.Tensor) -> np.ndarray:
        return p.detach().float().cpu().numpy()

    tree: Dict[str, Any] = {key: get(getattr(model, key)) for key in ("tok_emb", "pos_emb", "ln_f")}
    tree["blocks"] = {
        name: {key: get(getattr(blk, key)) for key in ("ln1", "ln2") + _MATMUL_WEIGHTS}
        for name, blk in model.blocks.items()
    }
    return tree


def _example_batch(batch_size: int, seq_len: int = 256) -> Dict[str, np.ndarray]:
    return {
        "tokens": np.zeros((batch_size, seq_len), np.int32),
        "labels": np.zeros((batch_size, seq_len), np.int32),
    }


def model_spec(
    learning_rate: float = 3e-4,
    compute_dtype: str = "bfloat16",
    vocab: int = 8192,
    dim: int = 256,
    n_heads: int = 4,
    n_layers: int = 2,
    max_seq: int = 4096,
    seq_len: int = 256,
    remat: bool = True,
    parallelism: str = "sequence",
) -> ModelSpec:
    """``parallelism="sequence"`` on one device is the ported variant;
    ``"tensor"`` (Megatron weight shards) is a later slice."""
    if parallelism == "tensor":
        raise NotImplementedError(
            "transformer_lm parallelism='tensor' is not ported yet (ROADMAP, "
            "PyTorch port queue: ring and tensor-parallel attention)"
        )
    if parallelism != "sequence":
        raise ValueError(
            f"parallelism must be 'sequence' or 'tensor', got {parallelism!r}"
        )
    if compute_dtype not in _DTYPES:
        raise ValueError(f"compute_dtype must be one of {sorted(_DTYPES)}, got {compute_dtype!r}")
    return ModelSpec(
        name="transformer_lm",
        init=functools.partial(
            _init, vocab=vocab, dim=dim, n_heads=n_heads, n_layers=n_layers,
            max_seq=max_seq, compute_dtype=_DTYPES[compute_dtype],
        ),
        apply=functools.partial(_apply, remat=remat),
        check_batch=_check_batch,
        example_batch=functools.partial(_example_batch, seq_len=seq_len),
        batch_shard_dim=1,
        loss=_loss,
        metrics=_metrics,
        optimizer=functools.partial(_adamw, learning_rate=learning_rate),
        feed=lm_feed,
    )
