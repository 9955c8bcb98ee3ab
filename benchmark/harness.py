"""One run of one benchmark cell: set-up, the measured window, the check,
and the result line.

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration (its file under ``configs/``, whose ``family`` names the
module under ``families/`` that drives it) and a traffic mix (its file
``traffic/<name>.json``). Each metric the cell reports is read by
``metrics/<name>.py``. A new cell, configuration, mix or metric is a new
file; nothing here names one.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import math
import os
import shutil
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

#: Training tasks reported before the window opens: the variant's eager
#: first task and its captured second, then steady ones.
WARM_TASKS = 6
#: Tasks whose per-step losses and end state the check compares.
CHECKED_TASKS = 2
#: Evaluation rounds the set-up runs (eager, then captured) where the
#: traffic evaluates.
WARM_EVAL_ROUNDS = 2
#: The longest a set-up may take (a fresh checkout builds the kernels).
SETUP_TIMEOUT_S = 1100.0
#: Longest stretch of the window the traced run profiles, at its end.
TRACE_SECONDS = 5.0
#: Modules that may not be loaded in the process that prints a result,
#: compared by their whole top-level name.
FORBIDDEN = ("jax", "jaxlib", "flax", "elasticdl_tpu")


def process_start() -> float:
    """This process's start on the ``time.monotonic`` clock (from
    ``/proc/self/stat``; the interpreter's own start-up included)."""
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    age = uptime - ticks / os.sysconf("SC_CLK_TCK")
    return time.monotonic() - age


def _load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_cell(name: str, root: str = ROOT) -> dict:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its configuration,
    traffic and metrics resolved."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    cell = cells[name]
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(os.path.join(root, config["file"])) as f:
        cfg = json.load(f)
    with open(os.path.join(HERE, "traffic", f"{cell['traffic']}.json")) as f:
        traffic = json.load(f)
    end_to_end = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    moved = {m["name"] for m in end_to_end}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in moved)]
    return {"name": name, "chips": cell["chips"], "cfg": cfg, "traffic": traffic,
            "end_to_end": end_to_end, "per_layer": per_layer}


def family_of(cfg: dict):
    return importlib.import_module(f"families.{cfg['family']}")


def read_metric(name: str, window) -> Optional[float]:
    """``metrics/<name>.py``'s reading of the window (None: nothing to
    read)."""
    module = _load_module(os.path.join(HERE, "metrics", f"{name}.py"),
                          "bench_metric_" + name.replace(".", "_").replace("-", "_"))
    return module.read(window)


class Window:
    """What the metric readers see of one run's measured window."""

    def __init__(self, **fields):
        self.__dict__.update(fields)

    def training(self) -> List[tuple]:
        """The training tasks whose report returned inside the window:
        (report time, task id, type, success, records, lease time)."""
        return [r for r in self.reports if r[2] == "training" and self.t0 < r[0] <= self.t1]

    def phase_s(self, phase: str) -> float:
        return self.phases1.get(phase, 0.0) - self.phases0.get(phase, 0.0)

    def phase_n(self, phase: str) -> int:
        return self.counts1.get(phase, 0) - self.counts0.get(phase, 0)


def _hold_checkpoint(held: dict, run_dir: str, method: str, request: dict) -> None:
    """Hard-link the first reported checkpoint's files aside, so the
    program's pruning of old steps leaves them for the check."""
    if method != "ReportCheckpoint" or held:
        return
    src = os.path.join(request["path"], str(request["step"]))
    dst = os.path.join(run_dir, "held")
    os.makedirs(dst)
    for name in os.listdir(src):
        os.link(os.path.join(src, name), os.path.join(dst, name))
    held.update(step=int(request["step"]), path=dst)


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device: Any = "cuda",
             t_start: Optional[float] = None, sides: tuple = (),
             log=lambda msg: print(msg, file=sys.stderr, flush=True)) -> dict:
    """Run ``cell`` once: its set-up, ``seconds`` of measured window, and
    the comparison with the reference. Returns the result line's fields
    and, under ``"numbers"``, what was compared; under ``"sides"`` the
    same numbers with the reference put in the program's place as each of
    ``sides`` says (see ``check_run``); under ``"detail"`` the worst leaves
    of each."""
    import torch

    from job import Job, Profiling, job_config

    t_start = time.monotonic() if t_start is None else t_start
    cfg, traffic = cell["cfg"], cell["traffic"]
    family = family_of(cfg)
    run_dir = tempfile.mkdtemp(prefix="edl-bench-")
    pool = ThreadPoolExecutor(min(8, os.cpu_count() or 1), thread_name_prefix="bench-data")
    job = None
    try:
        per_task = traffic["minibatch_size"] * traffic["num_minibatches_per_task"]
        if traffic["rows"] % per_task:
            raise ValueError(f"traffic rows {traffic['rows']} are not whole tasks of {per_task}")
        data = family.make_data(cfg, traffic, seed, run_dir, pool)
        log(f"[bench] data made in {time.monotonic() - t_start:.2f} s since start")
        jc = job_config(cfg, traffic, family, data, run_dir)
        job = Job(jc, family, cfg, device, CHECKED_TASKS, log)
        worker = job.worker
        log(f"[bench] master and worker built at {time.monotonic() - t_start:.2f} s")
        worker.state = worker.trainer.init_state(None)
        family.load_into(worker.state.model, family.make_weights(cfg, seed, worker.trainer.device))
        log(f"[bench] weights made at {time.monotonic() - t_start:.2f} s")
        held: dict = {}
        if traffic.get("check_checkpoint"):
            job.on_event(lambda m, r: _hold_checkpoint(held, run_dir, m, r))
        rounds = WARM_EVAL_ROUNDS if job.evaluation is not None else 0
        if rounds:
            def warm_evals(method: str, request: dict) -> None:
                # Evaluation rounds right after the checked tasks: the
                # first runs eagerly, the second captures its graph.
                if method != "ReportTaskResult" or not request.get("success", True):
                    return
                done = job.log.count("evaluation")
                if done >= rounds:
                    return
                trained = job.log.count("training")
                if trained >= CHECKED_TASKS and done < rounds and not job.evaluation.round_in_flight():
                    job.evaluation.trigger(int(request.get("model_version", 0) or worker.state.step))

            job.on_event(warm_evals)
        if trace:
            worker.profiling = Profiling(math.inf, math.inf)
        job.start()
        job.wait_for(lambda: job.log.count("training") >= WARM_TASKS
                     and job.log.count("evaluation") >= rounds, SETUP_TIMEOUT_S)
        t0 = time.perf_counter()
        setup_s = time.monotonic() - t_start
        phases0, counts0 = worker.phases.snapshot(), worker.phases.counts()
        t1 = t0 + seconds
        if trace:
            worker.profiling.start_at = max(t0, t1 - TRACE_SECONDS)
            worker.profiling.stop_at = t1
        log(f"[bench] window opens after {setup_s:.2f} s of set-up")
        time.sleep(max(0.0, t1 - time.perf_counter()))
        phases1, counts1 = worker.phases.snapshot(), worker.phases.counts()
        job.stop(timeout=300.0)
        worker.finish_profiling()
        torch_device = worker.trainer.device
        memory_peak = (torch.cuda.max_memory_allocated(torch_device)
                       if torch_device.type == "cuda" else 0)
        summary = None
        if trace and worker.profiling.result is not None:
            from trace_reader import summarize

            path = os.path.join(run_dir, "trace.json")
            worker.profiling.result.export_chrome_trace(path)
            start, stop = worker.profiling.window
            summary = dict(summarize(path), window_s=stop - start)
            os.remove(path)
        window = Window(
            t0=t0, t1=t1, seconds=seconds, setup_s=setup_s, reports=list(job.log.reports),
            phases0=phases0, phases1=phases1, counts0=counts0, counts1=counts1,
            cfg=cfg, units_per_record=family.units_per_record(cfg),
            step_flops=family.step_flops(cfg, traffic["minibatch_size"]),
            minibatch=traffic["minibatch_size"],
            attention_shape=family.attention_shape(cfg, traffic["minibatch_size"]),
            trace=summary)
        names = cell["per_layer"] if trace else cell["end_to_end"]
        metrics = {}
        for m in names:
            value = read_metric(m["name"], window)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        training = window.training()
        result = {
            "attempted": len(training),
            "failed": sum(1 for r in training if not r[3]),
            "metrics": metrics,
            "device": {"platform": "gpu" if torch_device.type == "cuda" else torch_device.type,
                       "kind": (torch.cuda.get_device_name(torch_device)
                                if torch_device.type == "cuda" else "cpu"),
                       "count": cell["chips"], "memory_peak_bytes": int(memory_peak)},
        }
        if summary is not None:
            result["device"].update(busy_s=summary.get("busy_s", 0.0), window_s=summary["window_s"])
            result["breakdown"] = {"device_ops": summary.get("device_ops", []),
                                   "idle_gaps": summary.get("idle_gaps", [])}
        # The program's state goes before the reference runs, so that the
        # peak above is the program's and the reference has the card.
        prog = {"losses": list(worker.first_losses), "evals": [
            (step, m["loss"]) for step, m in worker.evals[:rounds]], "ckpt": None}
        first_state, state_step = worker.first_state, worker.first_state_step
        steps = list(worker.steps)
        eval_steps = [step for step, _ in prog["evals"]]
        job = worker = None
        gc.collect()
        if torch_device.type == "cuda":
            torch.cuda.synchronize(torch_device)
            torch.cuda.empty_cache()
        result["numbers"], result["sides"], result["detail"] = check_run(
            family, cfg, data, seed, torch_device, prog, first_state, state_step, steps,
            eval_steps, held, rounds > 0, bool(traffic.get("check_checkpoint")), sides)
        return result
    finally:
        pool.shutdown(wait=True)
        if job is not None:
            try:
                job.stop(timeout=60.0)
            except Exception as e:  # the run already failed; say why the stop did too
                log(f"[bench] stopping the job after a failure: {e!r}")
        shutil.rmtree(run_dir, ignore_errors=True)


def check_run(family, cfg, data, seed, device, prog, first_state, state_step, steps, eval_steps,
              held, evaluates: bool, checkpointed: bool, sides: tuple = ()) -> tuple:
    """The program's record against the reference's: (numbers, the same
    with the reference put in the program's place as each of ``sides``
    says (``{"matmul_format", "fraction"}``: a lower precision or a
    planted fault), the worst leaves of each). ``evaluates``: the cell runs
    evaluation rounds; ``checkpointed``: it checks a checkpoint, and a run
    that wrote none fails."""
    import check

    limits = cfg.get("limits", {})
    applicable = set(check.TRAINING_NUMBERS) | ({"eval_gap"} if evaluates else set()) | (
        {"ckpt_update_gap"} if checkpointed else set())
    if checkpointed and not held:
        return [("ckpt_update_gap", float("inf"), limits.get("ckpt_update_gap"))], [], []
    weights = family.make_weights(cfg, seed, device)
    rows = family.device_rows(data, device)
    needs = {"state_step": state_step, "eval_steps": eval_steps, "ckpt_step": held.get("step")}
    ref = check.reference_record(family, cfg, rows, weights, steps, needs, device)
    prog = dict(prog, **check.leaf_norms(first_state, weights, device))
    if held:
        prog["ckpt"] = check.leaf_norms(check.read_checkpoint(family, cfg, held["path"]),
                                        weights, device)
    others = [check.reference_record(family, cfg, rows, weights, steps, needs, device, **side)
              for side in sides]
    records = [prog] + others
    return (check.compare(prog, ref, limits, applicable),
            [check.compare(o, ref, limits, applicable) for o in others],
            [check.worst_leaves(r, ref) for r in records])


def forbidden_modules() -> List[str]:
    return sorted({name.split(".", 1)[0] for name in sys.modules} & set(FORBIDDEN))


def main(argv: Optional[List[str]] = None) -> int:
    t_start = process_start()
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    if args.seed < 0:
        parser.error("--seed must be a non-negative integer")
    cell = load_cell(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"[bench] {args.workload} needs {cell['chips']} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", t_start)
    numbers = result.pop("numbers")
    bad = forbidden_modules()
    if bad:
        print(f"[bench] the process loaded {bad}: the benchmark runs the port alone",
              file=sys.stderr)
        return 3
    result["correct"] = all(limit is not None and value <= limit for _, value, limit in numbers)
    for name, value, limit in numbers:
        print(f"[bench] {name} {value!r} limit {limit!r}", file=sys.stderr)
    line = {"correct": result["correct"], "attempted": result["attempted"],
            "failed": result["failed"], "metrics": result["metrics"], "device": result["device"]}
    if "breakdown" in result:
        line["breakdown"] = result["breakdown"]
    line["compared"] = {name: {"value": value, "limit": limit} for name, value, limit in numbers}
    print(json.dumps(line), flush=True)
    return 0
