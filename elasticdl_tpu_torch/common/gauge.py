# The PyTorch port's own copy of elasticdl_tpu/common/gauge.py: the port imports
# nothing of the JAX package.
"""graftgauge — the live metrics plane's recording half.

Everything this repo measured before r14 was post-hoc: the JSONL
``MetricsWriter`` stream, ``DumpTrace`` merges, and ``artifacts/*.json``
stamped after a run ends.  A wedged gang or a serving p99 blowout was
invisible until the job was over.  This module is the process-local
registry — counters, gauges, histograms — cheap enough to update from
``# hot-path`` functions, and ``common/metrics_http.py`` is the reading
half (a ``/metrics`` + ``/healthz`` scrape server on its own daemon
thread, so a wedged task loop still answers).

Design constraints, in the grafttrace/graftchaos order:

- **Hot-path safe.**  An update is one attribute check when the registry
  is disabled, and one leaf-lock add when enabled — the exact cost
  profile of ``PhaseTimers.add``, which has lived inside the task loop
  since r6.  The lock (one shared locksan-leaf name per metric) exists
  for the MULTI-FIELD ops: a histogram observe touches a bucket counter,
  the sum and the count together, and a torn pair would render a
  histogram whose ``_sum`` disagrees with its buckets.  Single-field
  counter adds ride the same lock so the concurrency tests can assert
  EXACT totals — an approximate examples-trained counter would make the
  goodput computer lie.
- **Stdlib only.**  The master control plane, the PS shards and the
  lint/bench tools are jax-free by contract (graftlint import-hygiene);
  the registry rides in all of them.
- **Scrape work stays off the hot path.**  ``snapshot()`` /
  ``render_prometheus()`` walk every family and run the registered
  collectors — that is scrape-side work, and the ``gauge-discipline``
  lint rule forbids it inside ``# hot-path`` functions, exactly as
  ``trace-discipline`` forbids ring exports there.

Histograms use the ONE shared log-spaced millisecond grid
(``DEFAULT_BUCKET_EDGES_MS`` — canonical here since r14;
``tools/artifact.latency_stats`` imports it), with identical bucket
semantics: ``counts[i]`` holds samples in ``(edges[i-1], edges[i]]``,
``counts[0]`` the under-first-edge bin, ``counts[-1]`` the overflow —
pinned against ``latency_stats`` by test, so a live scrape and a stamped
artifact bucket the same sample identically.

Registries are INSTANCES, not a process singleton: an in-process test
fleet runs several workers in one process, and each worker's families
must stay its own (the master's fleet aggregation is exactly the sum of
per-worker views).  ``default()`` exists for cross-cutting client-side
consumers constructed deep inside the trainer — the PS client's retry
counter — and the worker/PS/serving mains hand the same registry to
their server objects so one scrape endpoint serves everything the
process recorded.
"""

from __future__ import annotations

import bisect
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from elasticdl_tpu_torch.common import locksan

#: Shared log-spaced histogram bucket edges (MILLISECONDS).  One FIXED
#: grid across every consumer — live registry histograms here, stamped
#: artifact histograms via ``tools/artifact.latency_stats`` (which
#: imports this constant) — so a tail shape read off a live scrape is
#: comparable bucket-for-bucket with a committed artifact.
DEFAULT_BUCKET_EDGES_MS = (
    0.1, 0.2, 0.5, 1.0, 2.0, 5.0, 10.0, 20.0, 50.0,
    100.0, 200.0, 500.0, 1000.0, 2000.0, 5000.0, 10000.0,
)

# ---------------------------------------------------------------------------
# The one naming table.
#
# The master mirrors worker gauge envelopes into the JSONL metrics stream
# (kind="gauge" records) under EXACTLY these family names, and the live
# scrape serves the same names — one table, asserted by test, so offline
# JSONL analysis and live scrapes cannot drift apart.  Scalar families
# only (histograms stay scrape-side; a JSONL line per bucket would flood
# the stream without adding an offline signal the seconds/counts lack).

#: Worker hot-path families (the JSONL mirror set).
EXAMPLES_TRAINED = "edl_examples_trained_total"
STEPS_DISPATCHED = "edl_steps_dispatched_total"
TASKS_DONE = "edl_tasks_done_total"
LEASE_DEPTH = "edl_lease_depth"
PREP_QUEUE_DEPTH = "edl_prep_queue_depth"

#: The families the master's JSONL "gauge" records mirror, in stream
#: order.  ``MasterServicer._record_gauges`` writes these keys and no
#: others; ``tests/test_gauge.py`` asserts the table matches both the
#: JSONL records and the registry families a worker actually publishes.
JSONL_GAUGE_FAMILIES = (
    EXAMPLES_TRAINED,
    STEPS_DISPATCHED,
    TASKS_DONE,
    LEASE_DEPTH,
    PREP_QUEUE_DEPTH,
)


def _labels_key(labels: Optional[Dict[str, str]]) -> Tuple[Tuple[str, str], ...]:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _render_labels(key: Tuple[Tuple[str, str], ...]) -> str:
    if not key:
        return ""
    body = ",".join(f'{k}="{v}"' for k, v in key)
    return "{" + body + "}"


class _Metric:
    """One (family, labelset) series.  ``enabled`` is synced from the
    owning registry so a disabled registry costs one attribute check per
    update call — the grafttrace stance."""

    __slots__ = ("_lock", "enabled", "labels_key")

    def __init__(self, enabled: bool, labels_key):
        # One shared leaf name for every metric instance (peer instances
        # of one locksan name are exempt from pairwise order — the
        # class-level contract): nothing is ever acquired under it.
        self._lock = locksan.lock("_Metric._lock", leaf=True)  # lock-order: leaf
        self.enabled = enabled
        self.labels_key = labels_key


class Counter(_Metric):
    """Monotonic float counter (``*_total`` families)."""

    __slots__ = ("_v",)

    def __init__(self, enabled: bool = True, labels_key=()):
        super().__init__(enabled, labels_key)
        self._v = 0.0  # guarded-by: _lock

    def inc(self, v: float = 1.0) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._v += v

    def set_total(self, v: float) -> None:
        """Scrape-side mirror of an EXTERNAL monotonic aggregate (the
        locksan acquire counts): a collector overwrites the cumulative
        total it reads elsewhere.  Hot-path update sites keep using
        ``inc`` — mixing the two on one series would lose counts."""
        if not self.enabled:
            return
        with self._lock:
            self._v = float(v)

    def value(self) -> float:
        with self._lock:
            return self._v


class Gauge(_Metric):
    """Point-in-time value (depths, versions, ratios)."""

    __slots__ = ("_v",)

    def __init__(self, enabled: bool = True, labels_key=()):
        super().__init__(enabled, labels_key)
        self._v = 0.0  # guarded-by: _lock

    def set(self, v: float) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._v = float(v)

    def add(self, v: float) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._v += v

    def value(self) -> float:
        with self._lock:
            return self._v


class Histogram(_Metric):
    """Fixed-edge histogram on the shared millisecond grid.

    Bucket semantics match ``tools/artifact.latency_stats(buckets=True)``
    exactly (``bisect_left`` = numpy ``searchsorted(side="left")``):
    ``counts[i]`` holds samples in ``(edges[i-1], edges[i]]`` with
    ``counts[0]`` the under-first-edge bin and ``counts[-1]`` the
    overflow — one more bin than edges.
    """

    __slots__ = ("edges", "_counts", "_sum", "_count")

    def __init__(self, enabled: bool = True, labels_key=(),
                 edges: Optional[Sequence[float]] = None):
        super().__init__(enabled, labels_key)
        self.edges = tuple(
            float(e) for e in (edges or DEFAULT_BUCKET_EDGES_MS)
        )
        self._counts = [0] * (len(self.edges) + 1)  # guarded-by: _lock
        self._sum = 0.0  # guarded-by: _lock
        self._count = 0  # guarded-by: _lock

    def observe(self, v: float) -> None:
        if not self.enabled:
            return
        idx = bisect.bisect_left(self.edges, v)
        with self._lock:
            self._counts[idx] += 1
            self._sum += v
            self._count += 1

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "edges": list(self.edges),
                "counts": list(self._counts),
                "sum": self._sum,
                "count": self._count,
            }

    def load_snapshot(self, snap: dict) -> None:
        """Scrape-side mirror of an EXTERNAL histogram aggregate (the
        locksan wait-time buckets): a collector overwrites this series
        with the cumulative state it reads elsewhere.  The edge grid must
        match bucket-for-bucket — a silent re-bucketing would render a
        histogram whose counts mean nothing."""
        if not self.enabled:
            return
        edges = tuple(float(e) for e in snap.get("edges") or ())
        counts = list(snap.get("counts") or ())
        if edges != self.edges or len(counts) != len(self.edges) + 1:
            raise ValueError(
                "load_snapshot edge grid does not match this histogram's"
            )
        with self._lock:
            self._counts = counts
            self._sum = float(snap.get("sum", 0.0))
            self._count = int(snap.get("count", 0))

    def quantile(self, q: float) -> Optional[float]:
        """Approximate quantile by linear interpolation inside the owning
        bucket (the live p99 estimator behind the serving SLO gauge).
        Grid-resolution approximate BY DESIGN — the same fidelity the
        stamped artifact histograms have; overflow-bucket hits return the
        last edge (a lower bound, which is the honest direction for an
        SLO ratio).  None when empty."""
        with self._lock:
            total = self._count
            counts = list(self._counts)
        if total <= 0:
            return None
        target = q * total
        seen = 0.0
        for i, c in enumerate(counts):
            if c <= 0:
                continue
            if seen + c >= target:
                lo = self.edges[i - 1] if i >= 1 else 0.0
                hi = self.edges[i] if i < len(self.edges) else self.edges[-1]
                frac = (target - seen) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
            seen += c
        return self.edges[-1]


_TYPES = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class Registry:
    """Named metric families -> labeled series, plus scrape-time
    collectors.

    ``counter``/``gauge``/``histogram`` are get-or-create (idempotent —
    instrumentation sites may be constructed more than once); a name
    re-registered under a different TYPE raises, because one family
    serving two types would render self-contradictory scrape output.

    ``add_collector(fn)`` registers a callable run at ``snapshot()`` /
    ``render_prometheus()`` time — the pull-model half: state that is
    cheap to READ but lives elsewhere (dispatcher counts, batcher stats,
    gang arrival lags) is collected fresh per scrape instead of being
    pushed on the hot path.  Collectors run OUTSIDE every registry lock
    (they call back into ``gauge(...).set``).
    """

    def __init__(self, enabled: bool = True):
        self.enabled = bool(enabled)
        self._lock = locksan.lock("Registry._lock", leaf=True)  # lock-order: leaf
        # family name -> {"type", "help", "series": {labels_key: metric}}
        self._families: Dict[str, dict] = {}  # guarded-by: _lock
        self._collectors: List[Callable[[], None]] = []  # guarded-by: _lock

    # -- registration (hot-path legal: dict lookup + rare creation) --

    def _metric(self, kind: str, name: str, help_: str,
                labels: Optional[Dict[str, str]], **kw):
        key = _labels_key(labels)
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = self._families[name] = {
                    "type": kind, "help": help_, "series": {},
                }
            elif fam["type"] != kind:
                raise ValueError(
                    f"metric family {name!r} is a {fam['type']}, not a "
                    f"{kind} — one family cannot serve two types"
                )
            metric = fam["series"].get(key)
            if metric is None:
                metric = fam["series"][key] = _TYPES[kind](
                    enabled=self.enabled, labels_key=key, **kw
                )
            return metric

    def counter(self, name: str, help_: str = "",
                labels: Optional[Dict[str, str]] = None) -> Counter:
        return self._metric("counter", name, help_, labels)

    def gauge(self, name: str, help_: str = "",
              labels: Optional[Dict[str, str]] = None) -> Gauge:
        return self._metric("gauge", name, help_, labels)

    def histogram(self, name: str, help_: str = "",
                  labels: Optional[Dict[str, str]] = None,
                  edges: Optional[Sequence[float]] = None) -> Histogram:
        return self._metric("histogram", name, help_, labels, edges=edges)

    def add_collector(self, fn: Callable[[], None]) -> None:
        with self._lock:
            self._collectors.append(fn)

    def remove_collector(self, fn: Callable[[], None]) -> None:
        """Unregister a collector (no-op if absent).  A stopped server
        whose collector stays registered would keep re-publishing its
        frozen stats over a successor's live families — and the registry
        reference would pin the dead server in memory for the process's
        life."""
        with self._lock:
            try:
                self._collectors.remove(fn)
            except ValueError:
                pass

    def clear_family(self, name: str) -> None:
        """Drop every series of ``name`` (type/help stay registered).
        Collectors that re-publish a per-ENTITY labeled family call this
        before repopulating: entities come and go (a killed worker, a
        dissolved gang), and a series that stops being set would
        otherwise serve its last value forever — a dead worker's frozen
        rate beside a live fleet total is exactly the lie a metrics
        plane must not tell."""
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                fam["series"] = {}

    def configure(self, enabled: bool) -> None:
        """Flip the registry (and every existing metric) on or off —
        disabled update sites cost one attribute check."""
        with self._lock:
            self.enabled = bool(enabled)
            metrics = [
                m for fam in self._families.values()
                for m in fam["series"].values()
            ]
        for m in metrics:
            m.enabled = self.enabled

    # -- scrape side (forbidden in # hot-path functions: gauge-discipline) --

    def _collect(self) -> None:
        with self._lock:
            collectors = list(self._collectors)
        for fn in collectors:
            try:
                fn()
            except Exception:
                # A broken collector must not take the whole scrape down:
                # the other families are exactly what the operator needs
                # to diagnose it.
                import logging

                logging.getLogger("gauge").exception("collector failed")

    def snapshot(self, collect: bool = True) -> Dict[str, dict]:
        """Plain-JSON view of every family: the heartbeat envelope / the
        /healthz payload / the aggregation input.  Scalar series render
        as floats, histograms as their edges/counts/sum/count dict."""
        if collect:
            self._collect()
        with self._lock:
            fams = {
                name: (fam["type"], fam["help"], list(fam["series"].items()))
                for name, fam in self._families.items()
            }
        out: Dict[str, dict] = {}
        for name, (kind, help_, series) in sorted(fams.items()):
            samples = []
            for key, metric in series:
                value = (
                    metric.snapshot() if kind == "histogram"
                    else metric.value()
                )
                samples.append({"labels": dict(key), "value": value})
            out[name] = {"type": kind, "help": help_, "samples": samples}
        return out

    def render_prometheus(self, collect: bool = True) -> str:
        """Prometheus text exposition (version 0.0.4): HELP/TYPE headers,
        one line per series; histograms expand to cumulative
        ``_bucket{le=...}`` lines plus ``_sum``/``_count``."""
        return render_families(self.snapshot(collect=collect))

    def scalar_values(self, families: Sequence[str]) -> Dict[str, float]:
        """Unlabeled scalar series of ``families`` that exist — the JSONL
        mirror's input (the one naming table, ``JSONL_GAUGE_FAMILIES``)."""
        out: Dict[str, float] = {}
        with self._lock:
            for name in families:
                fam = self._families.get(name)
                if fam is None or fam["type"] == "histogram":
                    continue
                metric = fam["series"].get(())
                if metric is not None:
                    out[name] = metric
        return {k: m.value() for k, m in out.items()}


def _fmt(v: float) -> str:
    f = float(v)
    return str(int(f)) if f == int(f) else repr(f)


def render_families(families: Dict[str, dict]) -> str:
    """Prometheus text from a ``Registry.snapshot()``-shaped family dict.

    Malformed samples are skipped, never a scrape 500."""
    lines: List[str] = []
    for name, fam in families.items():
        if not isinstance(fam, dict):
            continue
        if fam.get("help"):
            lines.append(f"# HELP {name} {fam['help']}")
        kind = fam.get("type", "gauge")
        lines.append(f"# TYPE {name} {kind}")
        for s in fam.get("samples") or []:
            if not isinstance(s, dict):
                continue
            key = _labels_key(s.get("labels"))
            value = s.get("value")
            if kind != "histogram":
                if isinstance(value, (int, float)) and not isinstance(
                    value, bool
                ):
                    lines.append(
                        f"{name}{_render_labels(key)} {_fmt(value)}"
                    )
                continue
            if not isinstance(value, dict):
                continue
            edges = value.get("edges") or []
            counts = value.get("counts") or []
            if len(counts) != len(edges) + 1:
                continue
            cum = 0
            for edge, c in zip(edges, counts):
                cum += c
                le = key + (("le", _fmt(edge)),)
                lines.append(f"{name}_bucket{_render_labels(le)} {cum}")
            cum += counts[-1]
            inf = key + (("le", "+Inf"),)
            lines.append(f"{name}_bucket{_render_labels(inf)} {cum}")
            lines.append(
                f"{name}_sum{_render_labels(key)} {_fmt(value.get('sum', 0.0))}"
            )
            lines.append(
                f"{name}_count{_render_labels(key)} {value.get('count', 0)}"
            )
    return "\n".join(lines) + ("\n" if lines else "")


# -- the process-default registry ------------------------------------------
#
# Cross-cutting client-side instrumentation (the PS client's retry
# counter rides inside RemoteEmbeddingStore, constructed deep in the
# trainer) records here; worker/PS/serving mains hand this registry to
# their Worker/PSServer/ServingServer so the one scrape endpoint serves
# everything the process recorded.  In-process test fleets pass explicit
# instances instead and never touch this.

_DEFAULT = Registry()


def default() -> Registry:
    return _DEFAULT


# -- locksan contention bridge (r16) ---------------------------------------


def install_lock_collector(registry: Registry) -> Callable[[], None]:
    """Expose locksan's per-lock-name contention aggregates as
    ``edl_lock_acquire_total`` / ``edl_lock_wait_ms{lock=...}`` on
    ``registry`` — a scrape-side collector (the pull model: lock waits
    are cheap to READ in aggregate but must cost the acquire path
    nothing when nobody scrapes).  Recording in locksan starts at
    install time; with the sanitizer off (``GRAFT_LOCKSAN`` unset) locks
    are plain and the families simply stay empty.  Returns the collector
    (for ``remove_collector`` in tests)."""
    locksan.enable_contention_stats(DEFAULT_BUCKET_EDGES_MS)

    def _collect() -> None:
        for name, rec in locksan.contention_snapshot().items():
            labels = {"lock": name}
            registry.counter(
                "edl_lock_acquire_total",
                "sanitized-lock acquisitions by lock name",
                labels=labels,
            ).set_total(rec["acquires"])
            registry.histogram(
                "edl_lock_wait_ms",
                "wall waited inside sanitized-lock acquire, by lock name",
                labels=labels,
            ).load_snapshot(rec["wait_ms"])

    registry.add_collector(_collect)
    return _collect


# -- wiresan unknown-field bridge (v8) -------------------------------------


def install_wire_collector(registry: Registry) -> Callable[[], None]:
    """Expose wiresan's per-method unknown-field counts as
    ``edl_wire_unknown_fields_total{method=...}`` on ``registry`` —
    scrape-side, like the locksan bridge: the counting rides the
    rpc boundary hooks (common/wiresan.py), this only mirrors the
    aggregates.  With ``GRAFT_WIRESAN`` unset the hooks are skipped and
    the family simply stays empty.  A non-zero count is the version-skew
    dashboard signal: a NEWER peer is sending fields this process's
    schema predates — legal (additive-compat), but the operator should
    know the fleet is mixed-version before debugging anything else.
    Returns the collector (for ``remove_collector`` in tests)."""
    from elasticdl_tpu_torch.common import wiresan

    def _collect() -> None:
        for method, n in wiresan.stats()["unknown_fields"].items():
            registry.counter(
                "edl_wire_unknown_fields_total",
                "unknown wire fields seen per method (wiresan; non-zero "
                "means a newer peer is talking to this process)",
                labels={"method": method},
            ).set_total(n)

    registry.add_collector(_collect)
    return _collect
