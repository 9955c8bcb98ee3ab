"""How the harness drives a ``transformer_lm`` configuration: its job
parameters, its data, its weights, and its reference run.

A configuration file of this family holds ``vocab``, ``dim``,
``n_heads``, ``n_layers``, ``seq_len``, ``learning_rate`` and
``compute_dtype``; a traffic file holds the rows of its training file
(``rows``) and the noise of the next-token rule (``noise``).
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np
import torch

import generators
import records
import seeds
from configs.transformer_lm_reference import Reference, leaf_names
from yardstick import lm_step_flops

#: AdamW's decoupled weight decay in the program (``optax.adamw``'s default).
WEIGHT_DECAY = 1e-4


def model_params(cfg: dict) -> str:
    return (f"vocab={cfg['vocab']};dim={cfg['dim']};n_heads={cfg['n_heads']};"
            f"n_layers={cfg['n_layers']};max_seq={cfg['seq_len']};seq_len={cfg['seq_len']};"
            f"remat={'true' if cfg['remat'] else 'false'}")


def units_per_record(cfg: dict) -> int:
    return int(cfg["seq_len"])


def step_flops(cfg: dict, minibatch: int) -> float:
    return lm_step_flops(minibatch, cfg["seq_len"], cfg["dim"], cfg["n_layers"], cfg["vocab"],
                         cfg["n_heads"])


def attention_shape(cfg: dict, minibatch: int) -> tuple:
    """(B, L, H, D) of the flash kernels' launches in a training step."""
    return minibatch, cfg["seq_len"], cfg["n_heads"], cfg["dim"] // cfg["n_heads"]


def make_data(cfg: dict, traffic: dict, seed: int, directory: str, pool) -> dict:
    rows = generators.lm_tokens(generators.rng_for(seed, "train"), int(traffic["rows"]),
                                int(cfg["seq_len"]), int(cfg["vocab"]), float(traffic["noise"]))
    path = os.path.join(directory, "train.rio")
    records.write_fixed(path, rows)
    return {"train_path": path, "train": rows}


def _shapes(cfg: dict) -> Dict[str, tuple]:
    d, v, l = cfg["dim"], cfg["vocab"], cfg["seq_len"]
    block = {"ln1": (d,), "wqkv": (d, 3 * d), "wo": (d, d), "ln2": (d,), "w1": (d, 4 * d),
             "w2": (4 * d, d)}
    shapes = {"tok_emb": (v, d), "pos_emb": (l, d), "ln_f": (d,)}
    for name in leaf_names(cfg["n_layers"])[3:]:
        shapes[name] = block[name.rsplit(".", 1)[1]]
    return shapes


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The initial weights from ``seed``, f32 on ``device``, in the
    program's init distributions: norms' gains 1, the token embedding and
    the qkv, output and first MLP matrices normal with std ``dim^-1/2``,
    the second MLP matrix half that, positions std 0.01. One normal draw
    for every matrix together."""
    shapes = _shapes(cfg)
    scale = cfg["dim"] ** -0.5
    std = {"tok_emb": scale, "pos_emb": 0.01, "wqkv": scale, "wo": scale, "w1": scale,
           "w2": 0.5 * scale}
    drawn = [k for k in shapes if k.rsplit(".", 1)[-1] in std]
    sizes = [int(np.prod(shapes[k])) for k in drawn]
    gen = torch.Generator(device=device).manual_seed(seeds.derive(seed, "weights"))
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    out = {}
    for k, part in zip(drawn, flat.split(sizes)):
        out[k] = part.view(shapes[k]).mul_(std[k.rsplit(".", 1)[-1]])
    for k, shape in shapes.items():
        if k not in out:
            out[k] = torch.ones(shape, device=device, dtype=torch.float32)
    return {k: out[k] for k in shapes}


def load_into(model: torch.nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(weights[name])


def read_state(cfg: dict, model: torch.nn.Module, optimizer) -> Dict[str, Dict[str, torch.Tensor]]:
    """The parameters and AdamW first moments, by parameter name (views of
    the live tensors; the caller copies them). A parameter the optimizer
    never stepped has a zero moment."""
    params = dict(model.named_parameters())
    return {"params": {k: p.detach() for k, p in params.items()},
            "exp_avg": {k: optimizer.state.get(p, {}).get("exp_avg", torch.zeros_like(p))
                        for k, p in params.items()}}


def reference(cfg: dict, weights: Dict[str, torch.Tensor], matmul_format: str) -> Reference:
    return Reference(weights, cfg["n_heads"], cfg["learning_rate"], WEIGHT_DECAY, matmul_format)


def logical(cfg: dict, name: str, t: torch.Tensor) -> torch.Tensor:
    """A leaf as the reference holds it (the program's layout is the same)."""
    return t


def device_rows(data: dict, device) -> dict:
    """The reference's copy of the training rows on the device."""
    return {"train": torch.from_numpy(data["train"]).to(device, torch.int64)}


def run_reference(ref: Reference, rows: dict, batches: List[tuple], device,
                  fraction: float = 1.0, frozen: bool = False) -> List[float]:
    """Step ``ref`` over ``batches`` (``(start, end)`` rows of the training
    file, in the order the program ran them). Planted faults: ``fraction``
    < 1 keeps only the first rows of each batch, ``frozen`` leaves the
    state as it was. Returns the losses."""
    losses = []
    for start, end in batches:
        batch = rows["train"][start:start + max(1, int((end - start) * fraction))]
        losses.append(ref.loss(batch) if frozen else ref.step(batch))
    return losses


def eval_loss(ref: Reference, rows: dict) -> float:
    raise NotImplementedError("the transformer_lm cells run no evaluation rounds")
