"""Fleet-wide live metrics: the master's aggregated view + the
goodput/SLO computer.

Workers and PS shards ship their ``gauge.Registry.snapshot()`` on the
heartbeat/report channel (the additive ``gauge`` envelope, common/rpc.py
— same carrier as the r12 trace slices).  This module banks those
snapshots per worker and turns them, at SCRAPE time, into the numbers
the paper's elastic design is judged on while the job still runs:

- **fleet examples/sec** — summed per-worker rate over a sliding window
  of each worker's cumulative ``edl_examples_trained_total`` (restart-
  tolerant: a counter that went backwards re-anchors its worker);
- **goodput-under-churn** — the live twin of ``chaos_bench``'s stamped
  ratio.  The bench divides a faulted run's examples/sec by a
  shape-matched fault-free baseline; a live job has no parallel
  baseline, so the stand-in denominator is the PEAK windowed rate this
  very job has sustained (``edl_fleet_examples_per_sec_peak``) — during
  a kill/stall the ratio dips exactly as the bench's does, and a healthy
  steady state reads ~1.0.  When a committed device-ceiling record is
  readable (``bench.py``'s artifact), ``edl_goodput_vs_ceiling`` is
  stamped beside it — the "live examples/sec vs the device-ceiling
  record" view;
- **per-rank gang-arrival lag** — seconds each rank trails the gang
  head's lockstep arrival (the r13 deadline's own signal, read live
  instead of post-hoc from a skip event);
- **gang-wait share** — each worker's ``lease_wait`` share of its
  critical-path seconds (from the banked PhaseTimers snapshots): the
  straggler-report skew input, as a live gauge.

Everything here is PULL-model: ``record_envelope`` (the hot-path side)
is a dict assignment + one RateWindow append; all aggregation runs in
the registry collector at scrape/snapshot time — the split the
``gauge-discipline`` lint rule enforces.

jax-free (the master control plane contract).
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, Optional

from elasticdl_tpu_torch.common import gauge, locksan
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.common.metrics import critical_path_seconds

logger = get_logger("master.fleet_metrics")

#: Where the committed bench records live (best-effort; absent on a
#: deployed master, present in the repo checkout the benches run from).
#: ``device_step_examples_per_sec_per_chip`` is bench.py's measured
#: device ceiling — the denominator of the e2e-vs-ceiling story in
#: docs/perf.md.
ARTIFACTS_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "artifacts",
)

_BENCH_REV = re.compile(r"^bench_r(\d+)(?:_latest)?\.json$")


def read_device_ceiling(artifacts_dir: str = ARTIFACTS_DIR) -> Optional[float]:
    """The NEWEST committed device-step ceiling (examples/sec/chip), or
    None.  Scans ``bench_r<NN>[_latest].json`` and takes the highest
    revision carrying the key — pinning a filename would silently keep
    dividing by an old record after the next bench round moves the
    ceiling.  Best-effort by design: a live job without the repo's
    artifacts still serves every other family."""
    try:
        names = os.listdir(artifacts_dir)
    except OSError:
        return None
    best: Optional[float] = None
    best_rev = -1
    for name in names:
        m = _BENCH_REV.match(name)
        if not m or int(m.group(1)) < best_rev:
            continue
        try:
            with open(os.path.join(artifacts_dir, name)) as f:
                record = json.load(f)
        except (OSError, ValueError):
            continue
        v = record.get("device_step_examples_per_sec_per_chip")
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            rev = int(m.group(1))
            if rev > best_rev or (rev == best_rev and float(v) > best):
                best, best_rev = float(v), rev
    return best


class FleetMetrics:
    """Per-worker envelope bank + the master's scrape-time aggregator.

    ``servicer`` supplies the master-side state (dispatcher counts, gang
    arrivals, phase snapshots, standby depth); the registry the
    collector writes into is ``self.registry`` and the full exposition —
    master families THEN the merged per-worker view — comes from
    ``render()``.
    """

    def __init__(
        self,
        servicer,
        registry: Optional[gauge.Registry] = None,
        window_s: float = 30.0,
        ceiling: Optional[float] = None,
    ):
        self._servicer = servicer
        self.registry = registry or gauge.Registry()
        self.registry.add_collector(self._collect)
        self._lock = locksan.lock("FleetMetrics._lock", leaf=True)  # lock-order: leaf
        # worker_id -> latest families snapshot (remote input: shape-
        # checked at render, never trusted).  Insertion order tracks
        # most-recently-updated (move-to-end on every envelope), which is
        # what the departed-worker bound prunes on.
        self._envelopes: Dict[str, dict] = {}  # guarded-by: _lock
        self._rates = gauge.RateWindow(window_s=window_s)
        self._peak_rate = 0.0  # guarded-by: _lock
        self._ceiling = (
            ceiling if ceiling is not None else read_device_ceiling()
        )

    # -- hot-path side (rides every Heartbeat/Report: bank, never walk) --

    def record_envelope(self, worker_id: str, payload) -> None:
        """Bank one gauge envelope.  Shape-checked and never coerced —
        telemetry riding a heartbeat must not be able to crash the
        heartbeat (the r12 ``_record_trace`` stance)."""
        if not worker_id or not isinstance(payload, dict):
            return
        families = payload.get("families")
        if not isinstance(families, dict):
            return
        with self._lock:
            # Move-to-end so dict order is update recency (the
            # departed-worker bound in fleet_snapshot prunes oldest).
            self._envelopes.pop(worker_id, None)
            self._envelopes[worker_id] = families
        total = _unlabeled_scalar(families, gauge.EXAMPLES_TRAINED)
        if total is not None:
            self._rates.update(worker_id, total)

    def jsonl_mirror(self, worker_id: str, payload) -> Optional[dict]:
        """The JSONL coexistence fix: the scalar families of ``payload``
        restricted to the one naming table (``JSONL_GAUGE_FAMILIES``),
        keyed by the SAME family names the live scrape serves — so the
        offline stream and the live endpoint cannot drift.  None when the
        envelope carries none of them."""
        if not isinstance(payload, dict):
            return None
        families = payload.get("families")
        if not isinstance(families, dict):
            return None
        out: Dict[str, float] = {}
        for name in gauge.JSONL_GAUGE_FAMILIES:
            v = _unlabeled_scalar(families, name)
            if v is not None:
                out[name] = v
        return out or None

    # -- scrape side --

    def _collect(self) -> None:
        """Registry collector: refresh every master family from the
        servicer's live state and the banked envelopes.  Runs per scrape
        / snapshot — never on the hot path (gauge-discipline)."""
        reg = self.registry
        s = self._servicer
        # Per-ENTITY labeled families are rebuilt from scratch each
        # scrape: workers die and gangs dissolve, and a series that is
        # no longer set must disappear rather than serve its last value
        # forever (a dead worker's frozen rate beside a live fleet total
        # would make the page disagree with itself).
        for name in (
            "edl_worker_examples_per_sec",
            "edl_gang_arrival_lag_seconds",
            "edl_gang_wait_share",
            "edl_skipped_ranks_total",
        ):
            reg.clear_family(name)
        counts = s.dispatcher.counts()
        for key in ("todo", "doing", "done", "abandoned", "skipped",
                    "duplicate_done", "epoch"):
            reg.gauge(
                f"edl_dispatcher_{key}",
                "task dispatcher state (see TaskDispatcher.counts)",
            ).set(float(counts.get(key, 0)))
        membership = s.rendezvous.membership()
        reg.gauge("edl_world_size", "registered worker count").set(
            float(membership.get("world_size", 0))
        )
        reg.gauge("edl_membership_version", "rendezvous version").set(
            float(membership.get("version", 0))
        )
        state = s.fleet_state_snapshot()
        phase_times = state["phase_times"]
        reg.gauge("edl_model_version", "max reported model version").set(
            float(state["model_version"])
        )
        for worker, n in state["skipped_ranks"].items():
            reg.gauge(
                "edl_skipped_ranks_total",
                "gang-deadline skips charged per rank (r13)",
                labels={"worker": worker},
            ).set(float(n))
        if state["standby_depth"] is not None:
            reg.gauge(
                "edl_standby_depth", "warm-standby pool depth"
            ).set(float(state["standby_depth"]))
        # Per-rank gang-arrival lag: seconds behind the gang head's
        # lockstep arrival — the deadline's own signal, live.
        for worker, lag in s.gang_lag_snapshot().items():
            reg.gauge(
                "edl_gang_arrival_lag_seconds",
                "seconds each rank trails the gang head's lockstep "
                "arrival (r13 deadline signal)",
                labels={"worker": worker},
            ).set(lag)
        # Gang-wait share per worker, from the banked phase snapshots.
        for worker, phases in phase_times.items():
            critical = critical_path_seconds(phases)
            if critical <= 0:
                continue
            share = float(phases.get("lease_wait", 0.0)) / critical
            reg.gauge(
                "edl_gang_wait_share",
                "lease_wait share of critical-path seconds per worker "
                "(the straggler-report skew input, live)",
                labels={"worker": worker},
            ).set(share)
        # The goodput computer.
        per_worker = self._rates.rates()
        fleet_rate = sum(per_worker.values())
        for worker, r in per_worker.items():
            reg.gauge(
                "edl_worker_examples_per_sec",
                "windowed examples/sec per worker",
                labels={"worker": worker},
            ).set(r)
        reg.gauge(
            "edl_fleet_examples_per_sec",
            "windowed fleet examples/sec (summed per-worker rates)",
        ).set(fleet_rate)
        with self._lock:
            self._peak_rate = max(self._peak_rate, fleet_rate)
            peak = self._peak_rate
        reg.gauge(
            "edl_fleet_examples_per_sec_peak",
            "peak windowed fleet rate this job (the live goodput "
            "denominator)",
        ).set(peak)
        reg.gauge(
            "edl_goodput_under_churn",
            "live fleet rate / peak fleet rate — the live twin of "
            "chaos_bench's faulted-over-baseline ratio (1.0 = healthy)",
        ).set(fleet_rate / peak if peak > 0 else 0.0)
        if self._ceiling:
            reg.gauge(
                "edl_device_ceiling_examples_per_sec",
                "committed device-step record (bench.py artifact)",
            ).set(self._ceiling)
            reg.gauge(
                "edl_goodput_vs_ceiling",
                "live fleet examples/sec over the committed device-step "
                "ceiling",
            ).set(fleet_rate / self._ceiling)

    #: Most-recently-updated DEPARTED workers whose envelopes stay
    #: servable (the r12 TRACE_DEPARTED_KEEP stance): a job-end or
    #: just-killed worker's final numbers remain readable, but memory and
    #: the fleet page track the current world size, not historical churn
    #: — every r13 kill-churn incarnation banking a full snapshot forever
    #: would be exactly the frozen-series lie the plane must not tell.
    DEPARTED_KEEP = 8

    def fleet_snapshot(self) -> Dict[str, dict]:
        """Merged per-worker families (``worker`` label per series):
        every CURRENT member's envelope plus the ``DEPARTED_KEEP``
        most-recently-updated departed workers'."""
        live = set(
            self._servicer.rendezvous.membership().get("workers") or []
        )
        with self._lock:
            departed = [w for w in self._envelopes if w not in live]
            for w in departed[: max(len(departed) - self.DEPARTED_KEEP, 0)]:
                del self._envelopes[w]
            envelopes = dict(self._envelopes)
        return gauge.merge_snapshots(envelopes)

    def render(self) -> str:
        """The master endpoint's /metrics body: the master's own
        families (collector-refreshed) and the merged per-worker view in
        ONE exposition.  Folded into one family dict before rendering —
        a family present on both sides (edl_membership_version lives on
        the master AND in every worker envelope) must render under ONE
        HELP/TYPE block, or a spec-strict Prometheus parser rejects the
        whole scrape on the duplicate TYPE line."""
        families = self.registry.snapshot()
        for name, fam in self.fleet_snapshot().items():
            slot = families.setdefault(
                name,
                {"type": fam.get("type", "gauge"),
                 "help": fam.get("help", ""), "samples": []},
            )
            slot["samples"].extend(fam.get("samples") or [])
        return gauge.render_families(families)

    def health(self) -> dict:
        """/healthz payload: identity + the headline numbers."""
        counts = self._servicer.dispatcher.counts()
        with self._lock:
            workers = sorted(self._envelopes)
        return {
            "role": "master",
            "workers_reporting": workers,
            "tasks": {k: counts.get(k) for k in ("todo", "doing", "done")},
            "fleet_examples_per_sec": round(self._rates.rate(), 1),
        }


def _unlabeled_scalar(families: dict, name: str) -> Optional[float]:
    """The unlabeled series value of a scalar family in a snapshot-shaped
    dict, or None (absent / malformed / labeled-only / histogram)."""
    fam = families.get(name)
    if not isinstance(fam, dict):
        return None
    for s in fam.get("samples") or []:
        if not isinstance(s, dict) or s.get("labels"):
            continue
        v = s.get("value")
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            return float(v)
    return None
