"""How the harness drives a ``deepfm`` configuration: its job parameters,
its data, its weights, and its reference run.

A configuration file of this family holds ``buckets_per_feature``,
``embedding_dim``, ``hidden``, ``num_dense``, ``num_categorical``,
``learning_rate`` and ``compute_dtype``; a traffic file holds the rows of
the training file (``rows``), those of the validation file (``val_rows``,
0 for none) and the parameters of ``generators.criteo_rows``
(``generator``, the fields' ``cardinalities`` among them).

The program keeps the table packed (``elasticdl_tpu_torch/ops/embedding.py``):
``embedding_dim + 1`` values an id at a pitch of the next power of two,
so a contiguous table viewed as ``[-1, pitch]`` holds the logical rows
first. The harness reads and writes the table and its moments through
that view; the reference holds the logical ``[rows, embedding_dim + 1]``.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List

import numpy as np
import torch

import generators
import records
import seeds
from configs.deepfm_reference import Reference, dense_features, fused_ids
from yardstick import deepfm_step_flops

TABLE = "fm_table"


def model_params(cfg: dict) -> str:
    return (f"buckets_per_feature={cfg['buckets_per_feature']};"
            f"embedding_dim={cfg['embedding_dim']};"
            f"hidden={','.join(str(h) for h in cfg['hidden'])};host_tier=false")


def units_per_record(cfg: dict) -> int:
    return 1


def step_flops(cfg: dict, minibatch: int) -> float:
    return deepfm_step_flops(minibatch, cfg["num_dense"], cfg["num_categorical"],
                             cfg["embedding_dim"], tuple(cfg["hidden"]))


def attention_shape(cfg: dict, minibatch: int) -> None:
    return None


def make_data(cfg: dict, traffic: dict, seed: int, directory: str, pool) -> dict:
    params = dict(traffic["generator"], num_dense=cfg["num_dense"])
    if len(params["cardinalities"]) != cfg["num_categorical"]:
        raise ValueError(f"the traffic has {len(params['cardinalities'])} categorical fields, "
                         f"the model {cfg['num_categorical']}")
    data = {}
    for split, n in (("train", traffic["rows"]), ("val", traffic.get("val_rows", 0))):
        if not n:
            continue
        rows = generators.criteo_rows(seed, split, int(n), params, pool)
        path = os.path.join(directory, f"{split}.rio")
        records.write_criteo(path, **rows, pool=pool)
        data[f"{split}_path"] = path
        data[split] = {"ids": fused_ids(rows["cats"], cfg["buckets_per_feature"]),
                       "dense": dense_features(rows["dense"]),
                       "labels": rows["labels"].astype(np.float32)}
    return data


def _pitch(dim: int) -> int:
    return 1 << (dim - 1).bit_length()


def _shapes(cfg: dict) -> Dict[str, tuple]:
    widths = [cfg["num_categorical"] * cfg["embedding_dim"] + cfg["num_dense"]]
    widths += list(cfg["hidden"])
    shapes = {TABLE: (cfg["num_categorical"] * cfg["buckets_per_feature"],
                      cfg["embedding_dim"] + 1),
              "dense_linear.w": (cfg["num_dense"], 1), "dense_linear.b": (1,)}
    for i, (a, b) in enumerate(zip(widths[:-1], widths[1:])):
        shapes[f"mlp.layer{i}.w"], shapes[f"mlp.layer{i}.b"] = (a, b), (b,)
    shapes["mlp.out.w"], shapes["mlp.out.b"] = (widths[-1], 1), (1,)
    return shapes


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The initial weights from ``seed``, f32 on ``device``, in the
    program's init distributions: the FM vectors normal x 0.01, the
    first-order weights, the integer features' weights and every bias
    zero, the MLP matrices truncated-normal Glorot (std ``sqrt(2 / (in +
    out)) / 0.8796``, cut at two of them, by the inverse CDF). One normal
    draw for the table, one uniform draw for the matrices."""
    shapes = _shapes(cfg)
    dim = cfg["embedding_dim"]
    gen = torch.Generator(device=device).manual_seed(seeds.derive(seed, "weights"))
    out = {k: torch.zeros(s, device=device) for k, s in shapes.items()}
    out[TABLE][:, :dim] = torch.randn((shapes[TABLE][0], dim), generator=gen, device=device) * 0.01
    mats = [k for k in shapes if k.startswith("mlp.") and k.endswith(".w")]
    sizes = [int(np.prod(shapes[k])) for k in mats]
    lo = 0.5 * (1 + math.erf(-2 / math.sqrt(2)))
    u = torch.rand(sum(sizes), generator=gen, device=device, dtype=torch.float64)
    z = (math.sqrt(2) * torch.erfinv(2 * (lo + u * (1 - 2 * lo)) - 1)).float()
    for k, part in zip(mats, z.split(sizes)):
        fan_in, fan_out = shapes[k]
        out[k] = part.view(shapes[k]) * (math.sqrt(2.0 / (fan_in + fan_out)) / 0.87962566103423978)
    return out


def _logical(packed: torch.Tensor, shape: tuple) -> torch.Tensor:
    return packed.view(-1, _pitch(shape[1]))[:shape[0], :shape[1]]


def logical(cfg: dict, name: str, t: torch.Tensor) -> torch.Tensor:
    """A leaf as the reference holds it: the table's logical rows."""
    return _logical(t, _shapes(cfg)[TABLE]) if name == TABLE else t


def load_into(model: torch.nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name == TABLE:
                p.zero_()
                _logical(p, weights[name].shape).copy_(weights[name])
            else:
                p.copy_(weights[name])


def read_state(cfg: dict, model: torch.nn.Module, optimizer) -> Dict[str, Dict[str, torch.Tensor]]:
    """The parameters and Adam first moments by parameter name, the table's
    as logical rows (views of the live tensors; the caller copies them). A
    parameter the optimizer never stepped has a zero moment."""
    params = dict(model.named_parameters())
    return {"params": {k: logical(cfg, k, p.detach()) for k, p in params.items()},
            "exp_avg": {k: logical(cfg, k, optimizer.state.get(p, {}).get(
                "exp_avg", torch.zeros_like(p))) for k, p in params.items()}}


def reference(cfg: dict, weights: Dict[str, torch.Tensor], matmul_format: str) -> Reference:
    return Reference(weights, cfg["embedding_dim"], cfg["learning_rate"], matmul_format)


def device_rows(data: dict, device) -> dict:
    """The reference's copy of the training (and validation) rows on the
    device."""
    return {split: {k: torch.from_numpy(v).to(device) for k, v in data[split].items()}
            for split in ("train", "val") if split in data}


def run_reference(ref: Reference, rows: dict, batches: List[tuple], device,
                  fraction: float = 1.0, frozen: bool = False) -> List[float]:
    """As ``transformer_lm.run_reference``."""
    losses = []
    train = rows["train"]
    for start, end in batches:
        sl = slice(start, start + max(1, int((end - start) * fraction)))
        args = (train["ids"][sl], train["dense"][sl], train["labels"][sl])
        losses.append(ref.eval_loss(*args) if frozen else ref.step(*args))
    return losses


def eval_loss(ref: Reference, rows: dict) -> float:
    """The mean loss over the validation rows (what an evaluation round
    reports as ``loss``)."""
    val = rows["val"]
    return ref.eval_loss(val["ids"], val["dense"], val["labels"])
