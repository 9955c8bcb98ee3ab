"""Arithmetic the metric readers under ``metrics/`` share. A reader takes
the run's ``harness.Window`` and returns a number, or None where the run
has nothing for it to read (the harness then leaves the metric out)."""

from __future__ import annotations

from typing import Optional

import numpy as np

import yardstick


def records_per_s(w) -> Optional[float]:
    """Records trained in the window, over the window. Work counts as done
    when its task reports; between two reports the records of the later
    task count as done at a steady pace, so that a task that straddles an
    edge of the window counts for the part of it inside (a bare count of
    tasks moves by a whole task, ~1% of an LM window, with the window's
    phase)."""
    done = sorted((r[0], r[4]) for r in w.reports if r[2] == "training" and r[3])
    if not any(w.t0 < t <= w.t1 for t, _ in done):
        return None
    times = [t for t, _ in done]
    total = np.cumsum([n for _, n in done])
    trained = np.interp([w.t0, w.t1], times, total, left=0.0, right=float(total[-1]))
    return float(trained[1] - trained[0]) / w.seconds


def rate(w) -> Optional[float]:
    """Units (tokens, examples) trained in the window, over the window."""
    records = records_per_s(w)
    return None if records is None else records * w.units_per_record


def task_ms(w, q: float) -> Optional[float]:
    """The ``q``-th percentile of the training tasks' walls, lease granted
    to report returned, over the tasks completed in the window."""
    walls = [(r[0] - r[5]) * 1e3 for r in w.training()]
    return float(np.percentile(walls, q)) if walls else None


def phase_ms_per_task(w, phase: str) -> Optional[float]:
    """The task loop's time in ``phase`` during the window, per training
    task completed in it."""
    tasks = len(w.training())
    return w.phase_s(phase) * 1e3 / tasks if tasks else None


def mfu(w) -> Optional[float]:
    """Model FLOPs of the training steps done in the window (as
    ``records_per_s`` counts them) over the window at the card's bf16
    peak, in %."""
    records = records_per_s(w)
    if records is None:
        return None
    return 100.0 * records / w.minibatch * w.step_flops / yardstick.MFU_PEAK_FLOPS


def device_idle(w) -> Optional[float]:
    """The share of the traced stretch in which no operation ran on the
    device, in %."""
    if not w.trace or w.trace["window_s"] <= 0 or not w.trace.get("kernels"):
        return None
    return 100.0 * (1.0 - w.trace["busy_s"] / w.trace["window_s"])


def kernel_roofline(w, kernels: tuple) -> Optional[float]:
    """The flash kernels ``kernels`` (``"fwd"``, ``"dq"``, ``"dkv"``) of the
    traced stretch against their bound at the cell's attention shape: the
    bound of one launch of each, times its launches, over their device
    time, in %."""
    if not w.trace or not w.attention_shape:
        return None
    b, l, h, d = w.attention_shape
    bound_s = device_s = 0.0
    for kernel in kernels:
        group = "flash_fwd" if kernel == "fwd" else f"flash_{kernel}"
        found = [(n, s) for name, (n, s) in w.trace["kernels"].items()
                 if yardstick.kernel_group(name) == group]
        if not found:
            return None
        launches = sum(n for n, _ in found)
        device_s += sum(s for _, s in found)
        dtype = w.cfg["compute_dtype"]
        bound_s += launches * yardstick.attention_bound_ms(b, l, h, d, dtype, True, kernel)[0] / 1e3
    return 100.0 * bound_s / device_s
