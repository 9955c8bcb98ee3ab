"""The comparison that decides ``correct``: what the timed path produced
against the plain reference, run from the same initial weights over the
same rows in the order the program trained them.

Both sides are reduced to one record: each step's loss over the first
recorded tasks; per leaf, the norm of the Adam first moment (the
gradients as the optimizer took them) and of the change of the
parameters since the start, after those tasks; the loss of each
evaluation round at the step it scored; and, where the cell checks its
checkpoints, the change of each leaf in the first checkpoint written.

Numbers compared, each against the limit in the configuration file:

- ``first_loss_gap``: the gap between the two losses of the first step,
  from the same weights (the forward's precision alone);
- ``loss_gap``: the largest gap between the two losses of a step;
- ``grad_gap``, ``update_gap``: the worst leaf's gap between the program's
  norm and the reference's, over the larger of the reference's norm of
  that leaf and of the median leaf;
- ``ckpt_update_gap``: the same gap of the checkpoint's change, at the
  median leaf (thousands of steps in, where the two trajectories have
  parted, the worst leaf swings from seed to seed);
- ``eval_gap``: the largest gap between the two losses of a round.

Leaves whose reference first moment is under ``LEAF_FLOOR`` of the median
leaf's are left out of the leaf gaps: they move by round-off alone.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

LEAF_FLOOR = 1e-3


def _norm(t: torch.Tensor, device) -> float:
    return float(torch.linalg.vector_norm(t.to(device, torch.float64)))


def leaf_norms(state: Dict[str, Dict[str, torch.Tensor]], start: Dict[str, torch.Tensor],
               device) -> Dict[str, Dict[str, float]]:
    """Per leaf: the first moment's norm and the norm of the change since
    ``start``."""
    m = {k: _norm(v, device) for k, v in state["exp_avg"].items()}
    dp = {k: _norm(v.to(device, torch.float64) - start[k].to(torch.float64), device)
          for k, v in state["params"].items()}
    return {"m": m, "dp": dp}


def reference_record(family, cfg: dict, rows: dict, weights: Dict[str, torch.Tensor],
                     steps: List[tuple], needs: dict, device, matmul_format: str = "fp32",
                     fraction: float = 1.0, frozen: bool = False) -> dict:
    """The reference's record over the program's ``steps`` (``(start,
    end)`` rows, in order): ``needs`` names the state step, the evaluation
    steps and the checkpoint step to record. ``matmul_format``,
    ``fraction`` and ``frozen`` (every step leaves the state as it was)
    put a lower precision or a planted fault in the reference's place, for
    the control and the fault readings."""
    ref = family.reference(cfg, weights, matmul_format)
    evals = sorted(needs.get("eval_steps", []))
    last = max([needs["state_step"], needs.get("ckpt_step") or 0] + evals)
    record = {"losses": [], "evals": [], "ckpt": None}
    for i in range(last + 1):
        while evals and evals[0] == i:
            record["evals"].append((i, family.eval_loss(ref, rows)))
            evals.pop(0)
        if i == needs["state_step"]:
            record.update(leaf_norms(ref.state(), weights, device))
        if i == needs.get("ckpt_step"):
            record["ckpt"] = leaf_norms(ref.state(), weights, device)
        if i == last:
            break
        loss = family.run_reference(ref, rows, [steps[i]], device, fraction, frozen)[0]
        if i < needs["state_step"]:
            record["losses"].append(loss)
    del ref
    return record


def read_checkpoint(family, cfg: dict, directory: str) -> Dict[str, Dict[str, torch.Tensor]]:
    """A checkpoint's parameters and first moments, as logical leaves by
    parameter name (its files: ``params.<name>.npy`` and
    ``opt_state.mu.<name>.npy``, names with ``/`` as ``.``)."""
    state = {"params": {}, "exp_avg": {}}
    for name in os.listdir(directory):
        for prefix, group in (("params.", "params"), ("opt_state.mu.", "exp_avg")):
            if name.startswith(prefix) and name.endswith(".npy"):
                leaf = name[len(prefix):-len(".npy")]
                arr = torch.from_numpy(np.load(os.path.join(directory, name), allow_pickle=False))
                state[group][leaf] = family.logical(cfg, leaf, arr)
    return state


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], ref_m: Dict[str, float]
              ) -> Dict[str, float]:
    """Each counted leaf's gap: the program's norm against the reference's,
    over the larger of the reference's norm of the leaf and of the median
    counted leaf."""
    median_m = float(np.median(list(ref_m.values())))
    counted = [k for k in ref if ref_m[k] >= LEAF_FLOOR * median_m]
    median = float(np.median([ref[k] for k in counted]))
    return {k: abs(prog[k] - ref[k]) / max(ref[k], median) for k in counted}


def _leaf_gap(prog: Dict[str, float], ref: Dict[str, float], ref_m: Dict[str, float]) -> float:
    return max(leaf_gaps(prog, ref, ref_m).values())


#: Numbers every training cell compares; a cell that evaluates adds
#: ``eval_gap``, one that checks its checkpoints ``ckpt_update_gap``.
TRAINING_NUMBERS = ("first_loss_gap", "loss_gap", "grad_gap", "update_gap")


def compare(prog: dict, ref: dict, limits: Dict[str, float], applicable
            ) -> List[Tuple[str, float, Optional[float]]]:
    """(name, value, limit) of each ``applicable`` number (the cell's) that
    the configuration's ``limits`` name; without limits (while they are
    being set), every number with a limit of None, which fails."""
    same = len(prog["losses"]) == len(ref["losses"])
    numbers = [
        ("first_loss_gap", abs(prog["losses"][0] - ref["losses"][0]) if same else float("inf")),
        ("loss_gap", max(abs(a - b) for a, b in zip(prog["losses"], ref["losses"]))
         if same else float("inf")),
        ("grad_gap", _leaf_gap(prog["m"], ref["m"], ref["m"])),
        ("update_gap", _leaf_gap(prog["dp"], ref["dp"], ref["m"])),
    ]
    if ref["evals"]:
        gaps = [abs(a[1] - b[1]) for a, b in zip(prog["evals"], ref["evals"]) if a[0] == b[0]]
        numbers.append(("eval_gap", max(gaps) if len(gaps) == len(ref["evals"]) else float("inf")))
    if ref["ckpt"] is not None:
        numbers.append(("ckpt_update_gap", float(np.median(list(leaf_gaps(
            prog["ckpt"]["dp"], ref["ckpt"]["dp"], ref["ckpt"]["m"]).values())))
                        if prog.get("ckpt") else float("inf")))
    if limits:
        # The configuration names the numbers it compares; one the cell
        # has that the run could not produce fails.
        got = dict(numbers)
        return [(name, got.get(name, float("inf")), limit) for name, limit in limits.items()
                if name in applicable]
    return [(name, value, None) for name, value in numbers]


def worst_leaves(prog: dict, ref: dict, n: int = 3) -> Dict[str, list]:
    """The ``n`` largest leaf gaps of each leaf number, by leaf (a look at
    what a reading is made of)."""
    pairs = {"grad_gap": (prog["m"], ref["m"], ref["m"]),
             "update_gap": (prog["dp"], ref["dp"], ref["m"])}
    if ref["ckpt"] is not None and prog.get("ckpt"):
        pairs["ckpt_update_gap"] = (prog["ckpt"]["dp"], ref["ckpt"]["dp"], ref["ckpt"]["m"])
    out = {}
    for name, (p, r, m) in pairs.items():
        gaps = leaf_gaps(p, r, m)
        out[name] = sorted(([k, g] for k, g in gaps.items()), key=lambda kv: -kv[1])[:n]
        out[name].append(["median", float(np.median(list(gaps.values())))])
    out["loss_steps"] = [abs(a - b) for a, b in zip(prog["losses"], ref["losses"])]
    return out
