"""The port's tracing: its spans and ranges on the ``torch.profiler``
trace (``common/trace.py``), the device's own
clock over a worker's training tasks (``common/metrics.DeviceTaskClock``)
and what the CPU records of them, and the master's gauges without the JAX
package's device ceiling.

The card's half (timing events, captures counted in ``PhaseTimers``) is in
``tests/test_torch_cuda.py``.
"""

import json
import os
import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from elasticdl_tpu_torch.common import trace
from elasticdl_tpu_torch.common.config import JobConfig
from elasticdl_tpu_torch.common.metrics import (
    CRITICAL_PATH_PHASES,
    DEVICE_PHASES,
    DeviceTaskClock,
    PhaseTimers,
    critical_path_seconds,
)
from elasticdl_tpu_torch.data.reader import create_data_reader
from elasticdl_tpu_torch.data.synthetic import generate
from elasticdl_tpu_torch.master.servicer import MasterServicer
from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
from elasticdl_tpu_torch.models import transformer_lm as tlm
from elasticdl_tpu_torch.ops.embedding import ParallelContext, embedding_lookup
from elasticdl_tpu_torch.worker.worker import DirectMasterProxy, Worker

SEQ, VOCAB, MB = 16, 256, 4
_LM = dict(vocab=VOCAB, dim=32, n_heads=4, n_layers=2, max_seq=SEQ, seq_len=SEQ,
           compute_dtype="float32")


@pytest.fixture
def recorder():
    """The process recorder, emptied, and left as it was found."""
    rec = trace.default()
    was = rec.enabled
    rec.clear()
    yield rec
    trace.configure(enabled=was)
    rec.clear()


def _annotations(prof):
    """(name, start, end) of every ``user_annotation`` of a stopped profile."""
    out = []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CPU and e.is_user_annotation:
            out.append((e.name, e.time_range.start, e.time_range.end))
    return out


def _phases_and_spans():
    """Two nested phases of ``PhaseTimers`` with a span inside the inner one."""
    phases = PhaseTimers()
    with phases.phase("dispatch"):
        with phases.phase("prep_wait"):
            with trace.span("replay"):
                torch.ones(4).add_(1)
    return phases


def _ring(rec):
    """The ring's events without their times and ids."""
    keep = ("ph", "name", "cat")
    return [({k: e[k] for k in keep}, sorted(set(e.get("args", {})) - {"span_id", "parent"}))
            for e in rec.export()]


@pytest.mark.parametrize("ring", [False, True], ids=["ring_off", "ring_on"])
def test_phases_and_spans_are_nested_profiler_ranges(recorder, ring):
    """Under a profiler every phase and span opens ``edl:<name>``, nested as
    the blocks are, whether or not the ring records; the ring's events are
    the ones it records without a profiler."""
    trace.configure(enabled=ring)
    _phases_and_spans()
    plain = _ring(recorder)
    recorder.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        phases = _phases_and_spans()
    assert _ring(recorder) == plain
    assert len(plain) == (3 if ring else 0)
    got = {name: (a, b) for name, a, b in _annotations(prof) if name.startswith("edl:")}
    assert set(got) == {"edl:dispatch", "edl:prep_wait", "edl:replay"}
    outer, inner, span = got["edl:dispatch"], got["edl:prep_wait"], got["edl:replay"]
    assert outer[0] <= inner[0] <= span[0] <= span[1] <= inner[1] <= outer[1]
    assert phases.counts() == {"dispatch": 1, "prep_wait": 1}


def test_without_a_profiler_a_span_is_the_rings_own(recorder):
    """No profiler: ``span`` hands back the recorder's own object (its
    shared no-op when the ring is off), so no range opens anywhere."""
    assert trace._profiler() is None
    trace.configure(enabled=False)
    assert trace.span("dispatch") is trace._NULL_SPAN
    assert trace.profiler_range("lm:head_loss") is trace._NULL_RANGE
    trace.configure(enabled=True)
    sp = trace.span("dispatch")
    assert type(sp) is trace._Span
    with sp:
        assert sp.span_id > 0


def test_a_process_without_torch_opens_no_range(recorder, monkeypatch):
    """The master imports ``trace`` without torch: a span there is the
    ring's own even while (here) a profiler records."""
    trace.configure(enabled=False)
    with profile(activities=[ProfilerActivity.CPU]):
        assert type(trace.span("dispatch")) is trace._RangedSpan
        monkeypatch.setitem(sys.modules, "torch", None)
        assert trace.span("dispatch") is trace._NULL_SPAN
        assert trace.profiler_range("optim:step") is trace._NULL_RANGE


def test_a_ranged_span_forwards_its_span_id(recorder):
    """The RPC client reads ``span_id`` off the object ``span`` returns."""
    trace.configure(enabled=True)
    with profile(activities=[ProfilerActivity.CPU]):
        sp = trace.span("rpc:GetTask", cat="rpc.client")
        with sp:
            assert isinstance(sp, trace._RangedSpan) and sp.span_id > 0


def test_a_range_open_when_the_profiler_stops_closes_cleanly(recorder):
    """A phase entered under a profiler that stops inside it (the benchmark
    stops its profile inside the loop's ``control`` phase)."""
    phases = PhaseTimers()
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    with phases.phase("control"):
        prof.stop()
    assert phases.counts() == {"control": 1}


def _lm_step_under_profiler():
    from elasticdl_tpu_torch.parallel.trainer import Trainer

    trainer = Trainer(tlm.model_spec(**_LM), device="cpu")
    state = trainer.init_state(0)
    rng = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, VOCAB, (2, MB, SEQ + 1), generator=rng, dtype=torch.int32)
    stacked = {"tokens": tokens[..., :-1].numpy(), "labels": tokens[..., 1:].numpy()}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.train_scan(state, trainer.shard_stacked_batch(stacked))
    return prof


def _lookup_under_profiler():
    table = torch.randn(64, 8, requires_grad=True)
    ids = torch.tensor([[1, 5, 9], [0, 63, 7]])
    # An explicit ragged lookup on a one-rank axis without a group keeps
    # its rows: the route's forward and backward, no exchange.
    ctx = ParallelContext(axis_name="ep", sharded_embeddings=True, embedding_impl="ragged")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        embedding_lookup(table, ids, ctx).sum().backward()
    return prof


@pytest.mark.parametrize("run,names", [
    (_lm_step_under_profiler,
     {"lm:head_loss", "optim:step", "edl:upload", "edl:eager_scan"}),
    (_lookup_under_profiler, {"lookup:forward", "lookup:backward"}),
], ids=["lm_scan", "ragged_lookup"])
def test_model_ranges_appear_under_a_profiler(run, names):
    got = {name for name, _, _ in _annotations(run())}
    assert names <= got


# ---- the device's own clock -----------------------------------------------


class _Event:
    """A stand-in for a timing ``torch.cuda.Event`` completed at ``t`` s."""

    def __init__(self, t):
        self.t = t

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


class _Phases:
    def __init__(self):
        self.entries = []

    def add(self, name, seconds):
        self.entries.append((name, round(seconds, 9)))


def _play(script):
    """Run ``script`` (``("d", start, end)`` dispatches a task with events
    completing at those times, ``("s", i)`` settles the i-th event pair's
    end, ``("x", t)`` settles an unknown event) on a ``DeviceTaskClock``."""
    phases = _Phases()
    clock = DeviceTaskClock(phases)
    pairs = []
    for op in script:
        if op[0] == "d":
            pairs.append((_Event(op[1]), _Event(op[2])))
            clock.dispatched(*pairs[-1])
        elif op[0] == "s":
            clock.settled(pairs[op[1]][1])
        else:
            clock.settled(_Event(op[1]))
    return phases.entries


@pytest.mark.parametrize("script,entries", [
    # The first task has a device time and no gap.
    ([("d", 1.0, 1.5), ("s", 0)], [("device_task", 0.5)]),
    # Pipelined: the second task is dispatched before the first settles;
    # its gap runs from the first task's end to its start.
    ([("d", 1.0, 1.5), ("d", 1.6, 2.0), ("s", 0), ("s", 1)],
     [("device_task", 0.5), ("device_task", 0.4), ("device_gap", 0.1)]),
    # A non-training fetch settled between them leaves the chain as it was.
    ([("d", 1.0, 1.5), ("s", 0), ("x", 1.7), ("d", 2.0, 2.2), ("s", 1)],
     [("device_task", 0.5), ("device_task", 0.2), ("device_gap", 0.5)]),
    # A task whose fetch failed never settles: dropped when a later one does.
    ([("d", 1.0, 1.5), ("s", 0), ("d", 1.5, 1.8), ("d", 1.9, 2.0), ("s", 2)],
     [("device_task", 0.5), ("device_task", 0.1), ("device_gap", 0.4)]),
], ids=["first", "pipelined", "non_training", "failed_fetch"])
def test_device_clock_arithmetic(script, entries):
    assert _play(script) == entries


def test_device_clock_spans_the_tasks_end_to_end():
    """Task times and gaps add up to the first start to the last end."""
    script = [("d", 0.0, 0.3), ("d", 0.31, 0.6), ("s", 0), ("d", 0.65, 0.9), ("s", 1), ("s", 2)]
    assert sum(s for _, s in _play(script)) == pytest.approx(0.9)


@pytest.mark.parametrize("name", DEVICE_PHASES + ("capture",))
def test_critical_path_seconds_ignores_entries_outside_the_partition(name):
    """Device-clock entries and the capture count are no part of the loop's
    wall partition."""
    assert name not in CRITICAL_PATH_PHASES
    assert critical_path_seconds({"dispatch": 1.5, "step_wait": 0.5, name: 7.0}) == 2.0


def test_a_cpu_worker_records_no_device_entries_and_no_capture(tmp_path):
    """On the CPU the scans run eagerly and there are no timing events: the
    worker's timers hold neither ``device_task``/``device_gap`` nor
    ``capture``, and its trainer counts into those same timers."""
    path = str(tmp_path / "train.rio")
    generate("lm", path, 4 * 2 * MB, seed=0, seq_len=SEQ, vocab=VOCAB)
    reader = create_data_reader(path)
    servicer = MasterServicer(TaskDispatcher(reader.create_shards(2 * MB), num_epochs=1))
    config = JobConfig(model_def="transformer_lm.model_spec", training_data=path,
                       minibatch_size=MB, num_minibatches_per_task=2)
    worker = Worker(config, DirectMasterProxy(servicer), reader, spec=tlm.model_spec(**_LM),
                    device="cpu")
    assert worker.trainer.phases is worker.phases
    result = worker.run()
    assert worker.trainer.task_start is None
    assert result["tasks_done"] == 4
    counts = worker.phases.counts()
    assert counts["dispatch"] >= 4 and counts["step_wait"] >= 4
    assert not {"device_task", "device_gap", "capture"} & (set(counts) | set(result["phase_times"]))


def test_the_operators_profile_holds_the_ports_ranges_and_shapes(tmp_path):
    """``profile_dir``: the profiled task's trace carries the loop's
    ``edl:`` phases, the model's ranges and the operators' input shapes."""
    path = str(tmp_path / "train.rio")
    generate("lm", path, 3 * 2 * MB, seed=0, seq_len=SEQ, vocab=VOCAB)
    reader = create_data_reader(path)
    servicer = MasterServicer(TaskDispatcher(reader.create_shards(2 * MB), num_epochs=1))
    prof_dir = tmp_path / "prof"
    config = JobConfig(model_def="transformer_lm.model_spec", training_data=path,
                       minibatch_size=MB, num_minibatches_per_task=2, profile_dir=str(prof_dir))
    Worker(config, DirectMasterProxy(servicer), reader, spec=tlm.model_spec(**_LM),
           device="cpu", worker_id="w0").run()
    with open(prof_dir / "w0-task-1.pt.trace.json") as f:
        events = json.load(f)["traceEvents"]
    annotations = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"edl:dispatch", "edl:prep_wait", "edl:upload", "edl:eager_scan",
            "lm:head_loss", "optim:step"} <= annotations
    mm = [e for e in events if e.get("name") == "aten::mm"]
    assert mm and all(e["args"].get("Input Dims") for e in mm)


# ---- the master's gauges ----------------------------------------------------


def test_the_master_serves_no_device_ceiling_gauges():
    """The port reads nothing of the JAX package's records under
    ``artifacts/`` and serves neither gauge that divided by them."""
    from elasticdl_tpu_torch.master import fleet_metrics

    assert not hasattr(fleet_metrics, "read_device_ceiling")
    assert not hasattr(fleet_metrics, "ARTIFACTS_DIR")
    text = MasterServicer(TaskDispatcher([])).fleet.render()
    assert "edl_goodput_under_churn" in text
    assert "ceiling" not in text


# ---- the benchmark's readers of these entries -------------------------------


def _window(monkeypatch, phases1, counts1, counts0=None, tasks=4):
    monkeypatch.syspath_prepend(
        os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmark"))
    import harness

    reports = [(1.0 + i, i, "training", True, 8, 0.5 + i) for i in range(tasks)]
    return harness, harness.Window(t0=0.0, t1=10.0, reports=reports, phases0={},
                                   counts0=counts0 or {}, phases1=phases1, counts1=counts1)


@pytest.mark.parametrize("name,value", [
    ("device_task_ms.lm", 360.0), ("device_gap_ms.lm", 2.0), ("captures.lm", 0.0),
])
def test_the_benchmark_reads_the_entries_and_nothing_where_the_program_has_none(
        monkeypatch, name, value):
    """A program without the entries (one older than them) gives no
    reading; one with them gives the window's."""
    harness, bare = _window(monkeypatch, {"dispatch": 1.0}, {"dispatch": 4})
    assert harness.read_metric(name, bare) is None
    # The set-up took the one capture; the window none.
    _, window = _window(monkeypatch, {"device_task": 1.44, "device_gap": 0.008, "capture": 0.9},
                        {"device_task": 4, "device_gap": 4, "capture": 1}, {"capture": 1})
    assert harness.read_metric(name, window) == pytest.approx(value)
