"""A whole run of a cell on the CPU at a tiny size, the card's check
skipped: the job through the master's gRPC, the window, and the check
that decides ``correct``; then the same run with the timed path broken
underneath, and with the reference in a lower precision in the
program's place, each of which must come out not correct."""

import pytest
import torch

import harness
from conftest import tiny_cell, tiny_deepfm_cell
from elasticdl_tpu_torch.parallel.trainer import Trainer


def _correct(result) -> bool:
    return all(limit is not None and value <= limit for _, value, limit in result)


def _run(cell, **kwargs):
    return harness.run_cell(cell, 2**31 + 7, 1.5, False, "cpu", log=lambda msg: None, **kwargs)


CELLS = {"gpt2s-train": lambda: tiny_cell("gpt2s-train"),
         "deepfm": tiny_deepfm_cell,
         "deepfm-ckpt-eval": lambda: tiny_deepfm_cell(checkpointed=True)}


@pytest.mark.parametrize("name", ["gpt2s-train", "deepfm-ckpt-eval"])
def test_a_sound_run_is_correct_and_the_control_is_not(name):
    result = _run(CELLS[name](), sides=({"matmul_format": "fp8"},))
    assert _correct(result["numbers"]), result["numbers"]
    names = {n for n, _, _ in result["numbers"]}
    assert {"loss_gap", "grad_gap", "update_gap"} <= names
    if name.startswith("deepfm"):
        assert {"eval_gap", "ckpt_update_gap"} <= names
    assert not _correct(result["sides"][0]), result["sides"][0]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert all(m["value"] > 0 for m in result["metrics"].values())


def _unchanged(original):
    def step(self, state, batch):
        # The update is skipped: the step returns the state as it was.
        optimizer_step = state.optimizer.step
        state.optimizer.step = lambda *args, **kwargs: None
        try:
            return original(self, state, batch)
        finally:
            state.optimizer.step = optimizer_step
    return step


def _half_batch(original):
    def step(self, state, batch):
        # Half of the batch left out, the mean taken over the rest.
        half = {k: v[: max(1, v.shape[0] // 2)] if v.dim() else v for k, v in batch.items()}
        return original(self, state, half)
    return step


@pytest.mark.parametrize("fault", [_unchanged, _half_batch], ids=["unchanged", "half_batch"])
@pytest.mark.parametrize("name", ["gpt2s-train", "deepfm"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault, name):
    monkeypatch.setattr(Trainer, "_train_step", fault(Trainer._train_step))
    result = _run(CELLS[name]())
    assert not _correct(result["numbers"]), result["numbers"]


def test_the_run_fails_when_the_cell_has_no_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = harness.main(["--workload", "gpt2s-train", "--seed", "5", "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "needs 1 CUDA card" in out.err


def test_an_unknown_workload_is_refused():
    with pytest.raises(SystemExit):
        harness.load_cell("no-such-cell")
