"""The PyTorch port's serving fleet against the JAX package's.

``elasticdl_tpu_torch/serving/fleet.py`` and ``serving/client.py``'s
``FleetServingClient`` are control plane: the same inputs must give the
reference's outputs exactly (no tolerance: no float work beyond the
quantile interpolation, which runs the same expression in both).

- ``_delta_quantile`` on seeded random cumulative histograms (empty
  windows, an ``+Inf`` top, counters that go backwards);
- the control law poll by poll: one scripted scrape sequence (low,
  deadband, high, online and bulk sheds, cooldowns, an unreachable
  replica, drains under a fake clock, an un-drain on ``up``) through the
  reference's controller over its ``FakePodBackend`` and the port's over
  its own: every decision record, membership, gauge and event equal;
- p2c: the same ``random.Random(seed)`` and inflight/suspect states pick
  the same addresses, and the retry path calls the same replicas;
- counterparts of each test in ``tests/test_serving_fleet.py``, with
  ``ServingServer(device="cpu")`` replicas of a small ``transformer_lm``
  and of the tiny Wide&Deep;
- the fleet's answers against the JAX ``ServingServer`` on carried
  weights, f32, tolerance 1e-4 (``tests/test_torch_serving.py``'s).
"""

import copy
import random
import threading

import grpc
import numpy as np
import pytest

from elasticdl_tpu.common import gauge as jgauge
from elasticdl_tpu.common import trace as jtrace
from elasticdl_tpu.common.config import JobConfig as JJobConfig
from elasticdl_tpu.master.pod_manager import FakePodBackend as JFakePodBackend
from elasticdl_tpu.serving import client as jclient
from elasticdl_tpu.serving import fleet as jfleet
from elasticdl_tpu_torch.common import gauge as gaugelib
from elasticdl_tpu_torch.common import trace as ttrace
from elasticdl_tpu_torch.common.config import JobConfig
from elasticdl_tpu_torch.common.metrics_http import fetch
from elasticdl_tpu_torch.master.pod_manager import FakePodBackend
from elasticdl_tpu_torch.serving import client as tclient
from elasticdl_tpu_torch.serving import fleet as tfleet
from elasticdl_tpu_torch.serving.client import FleetServingClient
from elasticdl_tpu_torch.serving.fleet import (
    AutoscaleConfig,
    InProcessServingBackend,
    ServingFleetController,
    _delta_quantile,
)

INF = float("inf")

# --------------------------------------------------- control-law units


def test_delta_quantile_windows_between_scrapes():
    cur = {10.0: 100.0, 40.0: 200.0, INF: 200.0}
    # No previous scrape: the quantile of the whole cumulative history.
    assert _delta_quantile(cur, None, 0.5) == pytest.approx(10.0)
    # Window = the 100 observations that landed in (10, 40] since prev.
    prev = {10.0: 100.0, 40.0: 100.0, INF: 100.0}
    q = _delta_quantile(cur, prev, 0.99)
    assert 10.0 < q <= 40.0
    # Empty window reads as NO SIGNAL, never as "p99 = 0".
    assert _delta_quantile(cur, cur, 0.99) is None
    assert _delta_quantile({}, None, 0.99) is None


def _random_histograms(rng):
    """A cumulative histogram and a previous scrape of it: random edges
    (sometimes ending in +Inf), sometimes an empty window, sometimes
    counters that went backwards (a relaunched replica), sometimes no
    previous scrape, and sometimes a previous scrape missing edges."""
    n = int(rng.integers(1, 8))
    edges = sorted(set(np.round(rng.uniform(0.5, 500.0, n), 3).tolist()))
    if rng.random() < 0.7:
        edges.append(INF)
    counts = np.cumsum(rng.integers(0, 50, len(edges))).astype(float)
    cur = dict(zip(edges, counts.tolist()))
    kind = rng.integers(0, 5)
    if kind == 0:
        prev = None
    elif kind == 1:
        prev = dict(cur)  # empty window
    elif kind == 2:  # backwards: prev above cur on some edges
        prev = {e: c + float(rng.integers(0, 30)) for e, c in cur.items()}
    elif kind == 3:  # a previous scrape without some edges
        prev = {e: c * 0.5 for e, c in cur.items() if rng.random() < 0.5}
    else:
        prev = {e: max(c - float(rng.integers(0, 40)), 0.0) for e, c in cur.items()}
    return cur, prev


@pytest.mark.parametrize("seed", range(6))
def test_delta_quantile_matches_the_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(200):
        cur, prev = _random_histograms(rng)
        for q in (0.5, 0.9, 0.99, 1.0):
            got = tfleet._delta_quantile(cur, prev, q)
            want = jfleet._delta_quantile(cur, prev, q)
            assert got == want, (cur, prev, q, got, want)


#: Synthetic-histogram grid: an edge inside each regime of the law under
#: target 50 ms — low (p99 ~9.9 -> slo 0.2), deadband (p99 ~39.7 -> slo
#: 0.79, between down_slo 0.6 and up_slo 1.0), high (p99 ~99.4 -> slo 2).
_EDGES = (10.0, 40.0, 100.0, INF)


class _SyntheticSignal:
    """Injectable scrape_fn: per-address CUMULATIVE families, 100 new
    online-lane observations per scrape in the current mode's bucket (none
    in mode "idle"), so the controller's windowed differencing sees a
    steady rate.  Addresses in ``unreachable`` raise OSError."""

    def __init__(self):
        self.mode = "low"  # idle | low | mid | high
        self.shed_online = 0.0
        self.shed_bulk = 0.0
        self.unreachable = set()
        self._cum = {}

    def __call__(self, addr):
        if addr in self.unreachable:
            raise OSError(f"{addr} refused")
        cum = self._cum.setdefault(addr, {e: 0.0 for e in _EDGES})
        if self.mode != "idle":
            fill_from = {"low": 10.0, "mid": 40.0, "high": 100.0}[self.mode]
            for e in _EDGES:
                if e >= fill_from:
                    cum[e] += 100.0
        hist = [
            {"name": "edl_serving_request_ms_bucket",
             "labels": {"lane": "online",
                        "le": "+Inf" if e == INF else str(e)},
             "value": c}
            for e, c in cum.items()
        ]
        sheds = [
            {"name": "edl_serving_shed_total",
             "labels": {"lane": "online"}, "value": self.shed_online},
            {"name": "edl_serving_shed_total",
             "labels": {"lane": "bulk"}, "value": self.shed_bulk},
        ]
        return {
            "edl_serving_request_ms": {
                "type": "histogram", "help": "", "samples": hist},
            "edl_serving_shed_total": {
                "type": "counter", "help": "", "samples": sheds},
        }


_UNIT_AUTO = dict(
    min_replicas=1, max_replicas=3, poll_s=0.01, target_p99_ms=50.0,
    up_slo=1.0, down_slo=0.6, up_consecutive=2, down_consecutive=3,
    cooldown_polls=2,
)


def _unit_controller(sig, pkg="port", clock=None, **auto_overrides):
    auto = dict(_UNIT_AUTO)
    auto.update(auto_overrides)
    if pkg == "port":
        fleet, backend, config, registry = tfleet, FakePodBackend(), JobConfig, gaugelib
    else:
        fleet, backend, config, registry = jfleet, JFakePodBackend(), JJobConfig, jgauge
    kwargs = {} if clock is None else {"clock": clock}
    return fleet.ServingFleetController(
        backend, config(job_name="fleet-unit"),
        autoscale=fleet.AutoscaleConfig(**auto),
        autoscale_enabled=False,  # polls driven deterministically
        gauges=registry.Registry(),
        scrape_fn=sig,
        **kwargs,
    )


def test_autoscaler_hysteresis_converges_up_then_down():
    sig = _SyntheticSignal()
    ctl = _unit_controller(sig)
    ctl.start(1)
    try:
        # UP: pressure must persist up_consecutive polls before acting.
        sig.mode = "high"
        d = ctl.poll_once()
        assert d["action"] == "" and d["up_streak"] == 1
        assert d["slo"] == pytest.approx(1.988, abs=0.01)
        d = ctl.poll_once()
        assert d["action"] == "up" and d["desired"] == 2
        # Cooldown: pressured polls right after an action do not act.
        assert ctl.poll_once()["action"] == ""
        assert ctl.poll_once()["action"] == ""
        d = ctl.poll_once()
        assert d["action"] == "up" and d["desired"] == 3
        # At max: sustained pressure never overshoots.
        for _ in range(4):
            assert ctl.poll_once()["action"] == ""
        assert ctl.pods.desired() == 3

        # DEADBAND: a borderline signal resets BOTH streaks.
        sig.mode = "mid"
        for _ in range(6):
            d = ctl.poll_once()
            assert (d["action"], d["up_streak"], d["down_streak"]) == ("", 0, 0)

        # DOWN: slower on purpose (down_consecutive > up_consecutive).
        sig.mode = "low"
        acts = [ctl.poll_once()["action"] for _ in range(3)]
        assert acts == ["", "", "down"] and ctl.pods.desired() == 2
        acts = [ctl.poll_once()["action"] for _ in range(5)]
        assert acts.count("down") == 1 and ctl.pods.desired() == 1
        # At min: sustained quiet never undershoots.
        for _ in range(4):
            assert ctl.poll_once()["action"] == ""
        assert ctl.pods.desired() == 1

        assert [(e["from"], e["to"]) for e in ctl.events()] == [
            (1, 2), (2, 3), (3, 2), (2, 1)
        ]
    finally:
        ctl.stop()


def test_autoscaler_shed_signals():
    """Online sheds are scale-up pressure even at low latency; bulk sheds
    only VETO scale-down."""
    sig = _SyntheticSignal()
    ctl = _unit_controller(sig)
    ctl.start(1)
    try:
        sig.mode = "low"
        d = ctl.poll_once()  # first scrape = shed baseline
        assert d["shed_online"] == 0 and d["down_streak"] == 1
        sig.shed_online += 5
        d = ctl.poll_once()
        assert d["shed_online"] == 5
        assert d["up_streak"] == 1 and d["down_streak"] == 0
        sig.shed_bulk += 3
        d = ctl.poll_once()
        assert d["shed_total"] == 3 and d["shed_online"] == 0
        # Neither up (online is fine) nor down (the window saw sheds).
        assert d["up_streak"] == 0 and d["down_streak"] == 0
        d = ctl.poll_once()  # quiet window: down pressure resumes
        assert d["down_streak"] == 1
    finally:
        ctl.stop()


def test_scale_down_drains_before_delete_and_up_cancels_drain():
    """A scale-down victim leaves the membership IMMEDIATELY but its pod
    is deleted only after drain_s; pressure returning mid-drain folds the
    still-warm victim back in instead of spawning."""
    sig = _SyntheticSignal()
    t = [0.0]
    ctl = _unit_controller(
        sig, clock=lambda: t[0], max_replicas=2, up_consecutive=1,
        down_consecutive=1, cooldown_polls=0, drain_s=5.0,
    )
    ctl.start(2)
    try:
        sig.mode = "low"
        d = ctl.poll_once()
        assert d["action"] == "down"
        assert len(ctl.replicas()) == 1 and ctl.pods.desired() == 2

        sig.mode = "high"
        d = ctl.poll_once()
        assert d["action"] == "up"
        # Un-drained, not respawned: same two pods, both in membership.
        assert len(ctl.replicas()) == 2 and ctl.pods.desired() == 2

        sig.mode = "low"
        d = ctl.poll_once()
        assert d["action"] == "down" and ctl.pods.desired() == 2
        t[0] = 6.0  # past the drain deadline
        ctl.poll_once()
        assert ctl.pods.desired() == 1 and len(ctl.replicas()) == 1

        assert [(e["from"], e["to"]) for e in ctl.events()] == [
            (2, 1), (1, 2), (2, 1)
        ]
    finally:
        ctl.stop()


#: The scripted scrape sequence: (mode, online sheds added, bulk sheds
#: added, replicas unreachable (by slot), seconds the fake clock moves
#: before the poll).  It starts at 2 replicas and visits every branch of
#: the law: the baseline poll, deadband resets, up streaks, an up, the
#: cooldown, an online shed at low latency, a bulk shed vetoing down, an
#: unreachable replica, a down with a drain, an un-drain on up, a drain
#: that completes under the clock, the floor and the ceiling.
_SCRIPT = (
    [("low", 0, 0, (), 0.5)]
    + [("mid", 0, 0, (), 0.5)] * 2
    + [("high", 0, 0, (), 0.5)] * 2           # up 2 -> 3
    + [("high", 0, 0, (), 0.5)] * 3           # cooldown, then pressure
    + [("low", 5, 0, (), 0.5)]                # online shed at low p99
    + [("low", 0, 3, (), 0.5)]                # bulk shed: neither
    + [("low", 0, 0, (1,), 0.5)]              # one replica unreachable
    + [("low", 0, 0, (), 0.5)] * 4            # down 3 -> 2 (drain)
    + [("high", 0, 0, (), 0.5)] * 3           # up: un-drain
    + [("idle", 0, 0, (), 0.5)] * 6           # no signal: down (drain)
    + [("idle", 0, 0, (), 3.0)] * 3           # the drain completes
    + [("low", 0, 0, (), 0.5)] * 8            # down to the floor
    + [("mid", 0, 2, (), 0.5)] * 2
    + [("high", 2, 0, (), 0.5)] * 10          # up to the ceiling
    + [("low", 0, 0, (0,), 0.5)] * 2
)


def _gauge_values(registry):
    snap = registry.snapshot()
    return {k: v for k, v in snap.items() if "edl_serving_fleet" in str(k)}


@pytest.mark.parametrize("auto,undrains", [
    (dict(drain_s=2.0), True),
    (dict(drain_s=0.0), False),
    (dict(drain_s=1.5, up_consecutive=1, down_consecutive=2, cooldown_polls=0), True),
    # The cooldown outlasts the pressure after the down: no un-drain.
    (dict(drain_s=4.0, cooldown_polls=5, min_replicas=2, max_replicas=4), False),
], ids=["drain", "no-drain", "eager", "slow-cooldown"])
def test_control_law_matches_the_reference_poll_by_poll(auto, undrains):
    runs = {}
    for pkg in ("ref", "port"):
        tracer = jtrace if pkg == "ref" else ttrace
        was_on = tracer.enabled()
        tracer.configure(enabled=True)
        tracer.default().clear()
        sig = _SyntheticSignal()
        t = [0.0]
        ctl = _unit_controller(sig, pkg=pkg, clock=lambda t=t: t[0], **auto)
        ctl.start(2)
        records = []
        try:
            for mode, shed_on, shed_bulk, down_slots, dt in _SCRIPT:
                t[0] += dt
                sig.mode = mode
                sig.shed_online += shed_on
                sig.shed_bulk += shed_bulk
                sig.unreachable = {
                    f"localhost:{ctl._metrics_base_port + s}" for s in down_slots
                }
                d = ctl.poll_once()
                records.append((d, ctl.replicas(), dict(ctl._draining),
                                ctl.pods.counts(), _gauge_values(ctl.gauges)))
            # The serving:scale instants, one per scale event.
            scale_marks = [e["args"] for e in tracer.default().export()
                           if e["name"] == "serving:scale"]
            runs[pkg] = (records, ctl.events(), scale_marks)
        finally:
            ctl.stop()
            tracer.configure(enabled=was_on)
    ref, port = runs["ref"], runs["port"]
    for i, (r, p) in enumerate(zip(ref[0], port[0])):
        assert set(p[0]) == set(r[0]) and p == r, (i, _SCRIPT[i], r, p)
    assert port[1] == ref[1]
    assert port[2] == ref[2] and len(port[2]) == len(port[1])
    actions = [r[0]["action"] for r in ref[0]]
    # The script reaches every branch it claims to.
    assert "up" in actions and "down" in actions
    assert any(r[0]["unreachable"] for r in ref[0])
    assert any(r[0]["slo"] is None for r in ref[0])
    pairs = list(zip(ref[0], ref[0][1:]))
    if auto["drain_s"] > 0:
        # A drain seen in membership and one that completed under the
        # clock (the pod count falls on a poll that takes no action).
        assert any(r[2] for r in ref[0])
        assert any(r[0]["desired"] < prev[0]["desired"] and not r[0]["action"]
                   for prev, r in pairs)
    # An un-drain: an up that spawns nothing (the pod count stays).
    assert undrains == any(r[0]["action"] == "up" and r[0]["desired"] == prev[0]["desired"]
                           for prev, r in pairs)


# ------------------------------------------------------- p2c client


class _FakeRpcError(grpc.RpcError):
    def __init__(self, code):
        self._code = code

    def code(self):
        return self._code

    def details(self):
        return "stub failure"


class _StubReplica:
    def __init__(self, name, fail=None, log=None):
        self.name = name
        self.fail = fail
        self.calls = 0
        self.log = log

    def predict(self, features, timeout_s=30.0, lane="online"):
        self.calls += 1
        if self.log is not None:
            self.log.append(self.name)
        if self.fail is not None:
            raise self.fail
        return {"outputs": [0.5], "model": "stub", "step": 0}

    def close(self):
        pass


def _stub_fleet(names, rng_seed=7, module=tclient, log=None):
    fc = module.FleetServingClient(list(names), rng=random.Random(rng_seed))
    with fc._lock:
        for c in fc._clients.values():
            c.close()
        fc._clients = {n: _StubReplica(n, log=log) for n in names}
    return fc


@pytest.mark.parametrize("code", list(grpc.StatusCode), ids=lambda c: c.name)
def test_transient_fleet_errors_match_the_reference(code):
    """Only UNAVAILABLE is retried on another replica, in both packages."""
    err = _FakeRpcError(code)
    assert tclient._is_transient_fleet_error(err) == jclient._is_transient_fleet_error(err)
    assert tclient._is_transient_fleet_error(err) == (code == grpc.StatusCode.UNAVAILABLE)
    assert not tclient._is_transient_fleet_error(ValueError("not an rpc error"))
    assert tclient.FLEET_RETRY_POLICY == tclient.BackoffPolicy(**vars(jclient.FLEET_RETRY_POLICY))
    assert tclient.SUSPECT_S == jclient.SUSPECT_S


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_p2c_picks_the_reference_addresses(seed):
    names = [f"r{i}:1" for i in range(int(3 + seed))]
    port = _stub_fleet(names, rng_seed=seed)
    ref = _stub_fleet(names, rng_seed=seed, module=jclient)
    drive = np.random.default_rng(100 + seed)
    picks = {"port": [], "ref": []}
    try:
        for _ in range(300):
            inflight = {n: int(drive.integers(0, 4)) for n in names}
            # Suspects at random; now and then the whole fleet.
            if drive.random() < 0.1:
                suspect = {n: 10.0 for n in names}
            else:
                suspect = {n: 10.0 for n in names if drive.random() < 0.3}
            for key, fc in (("port", port), ("ref", ref)):
                with fc._lock:
                    fc._inflight = dict(inflight)
                    fc._suspect_until = dict(suspect)
                    picks[key].append(fc._pick_locked(5.0))
        assert picks["port"] == picks["ref"]
        assert len(set(picks["port"])) == len(names)
        # Suspects are skipped unless every replica is suspect.
    finally:
        port.close()
        ref.close()


def test_p2c_predict_routes_and_retries_like_the_reference():
    """Through ``predict``: the same rng and a replica answering
    UNAVAILABLE give the same sequence of replicas called (re-picks
    included) and the same suspect marks."""
    names = ["a:1", "b:1", "c:1"]
    logs = {}
    for key, module in (("port", tclient), ("ref", jclient)):
        log = []
        fc = _stub_fleet(names, rng_seed=11, module=module, log=log)
        fc._clients["b:1"].fail = _FakeRpcError(grpc.StatusCode.UNAVAILABLE)
        try:
            for _ in range(12):
                assert fc.predict({"x": [1]})["model"] == "stub"
            logs[key] = (log, sorted(fc._suspect_until), fc.inflight())
        finally:
            fc.close()
    assert logs["port"] == logs["ref"]
    assert "b:1" in logs["port"][0] and logs["port"][1] == ["b:1"]


def test_fleet_client_p2c_spreads_and_retries_transient_elsewhere():
    fc = _stub_fleet(["a:1", "b:1"])
    for _ in range(40):
        assert fc.predict({"x": [1]})["model"] == "stub"
    a, b = fc._clients["a:1"], fc._clients["b:1"]
    assert a.calls > 0 and b.calls > 0  # p2c routed to both
    assert fc.inflight() == {"a:1": 0, "b:1": 0}  # counts balanced back out

    # One replica turns UNAVAILABLE (mid-retirement or killed): the
    # predict still succeeds via a re-pick, and the failed replica sits
    # out as suspect.
    a.fail = _FakeRpcError(grpc.StatusCode.UNAVAILABLE)
    a.calls = b.calls = 0
    for _ in range(10):
        assert fc.predict({"x": [1]})["model"] == "stub"
    assert b.calls >= 10
    assert fc._suspect_until.get("a:1", 0.0) > 0.0
    fc.close()


@pytest.mark.parametrize("code", [
    grpc.StatusCode.INVALID_ARGUMENT,
    grpc.StatusCode.DEADLINE_EXCEEDED,
    grpc.StatusCode.RESOURCE_EXHAUSTED,
    grpc.StatusCode.FAILED_PRECONDITION,
], ids=lambda c: c.name)
def test_fleet_client_non_transient_errors_surface_immediately(code):
    fc = _stub_fleet(["a:1"])
    stub = fc._clients["a:1"]
    stub.fail = _FakeRpcError(code)
    with pytest.raises(grpc.RpcError) as err:
        fc.predict({"x": [1]})
    assert err.value.code() == code
    assert stub.calls == 1  # no retry: a deadline, a shed or a schema error
    assert fc._suspect_until.get("a:1", 0.0) == 0.0  # and no health signal
    fc.close()


def test_fleet_client_membership_refresh():
    fc = FleetServingClient(["x:1", "y:1"])
    assert fc.addresses() == ["x:1", "y:1"]
    fc.set_replicas(["y:1", "z:1"])  # x retired, z joined
    assert fc.addresses() == ["y:1", "z:1"]
    fc.close()
    assert fc.addresses() == []
    with pytest.raises(ValueError):
        FleetServingClient([])


def test_fleet_client_lingers_retired_channel_until_inflight_drains():
    """A removed replica's channel must NOT close under a request still
    riding it, and a retired replica that rejoins before draining is
    revived warm instead of redialed."""
    fc = _stub_fleet(["a:1", "b:1"])
    stub_a = fc._clients["a:1"]
    closed = []
    stub_a.close = lambda: closed.append("a:1")

    started = threading.Event()
    release = threading.Event()

    def slow_predict(features, timeout_s=30.0, lane="online"):
        started.set()
        release.wait(5.0)
        return {"outputs": [0.5], "model": "stub", "step": 0}

    stub_a.predict = slow_predict
    # Pin the pick: only a:1 is in the client map when the call starts.
    fc.set_replicas(["a:1"])
    t = threading.Thread(target=fc.predict, args=({"x": [1]},))
    t.start()
    assert started.wait(5.0)
    fc.set_replicas(["b:1"])  # a:1 retired mid-flight
    assert closed == []  # linger: close deferred, request unharmed
    assert fc.addresses() == ["b:1"]

    # Rejoin while lingering: same object back in the pick set, no redial.
    fc.set_replicas(["a:1", "b:1"])
    assert fc._clients["a:1"] is stub_a and fc._retired == {}

    # Retire again and let the request finish: LAST RIDER closes it.
    fc.set_replicas(["b:1"])
    release.set()
    t.join(5.0)
    assert closed == ["a:1"]
    assert "a:1" not in fc._inflight and "a:1" not in fc._retired
    fc.close()


# ---------------------------------------- in-process fleet (the port on the CPU)

_LM = dict(vocab=128, dim=64, n_heads=2, n_layers=2, max_seq=32, seq_len=32)


def _spec(model):
    from elasticdl_tpu_torch.models.spec import load_model_spec

    if model == "wide_deep":
        return load_model_spec(
            "elasticdl_tpu_torch.models", "wide_deep.model_spec",
            buckets=64, embedding_dim=4, hidden=(8,),
        )
    return load_model_spec(
        "elasticdl_tpu_torch.models", "transformer_lm.model_spec",
        compute_dtype="float32", **_LM,
    )


def _features(model, n=1, seed=0):
    rng = np.random.RandomState(seed)
    if model == "wide_deep":
        return {
            "dense": rng.rand(n, 5).astype(np.float32) * 50,
            "cat": rng.randint(0, 1 << 20, size=(n, 9)),
        }
    return {"tokens": rng.randint(0, _LM["vocab"], size=(n, _LM["seq_len"])).astype(np.int32)}


def _out_shape(model, n):
    return (n,) if model == "wide_deep" else (n, _LM["seq_len"], _LM["vocab"])


def _replica_factory(spec, spawned, target_p99_ms=100.0, state=None):
    from elasticdl_tpu_torch.serving.server import ServingServer

    def factory(slot):
        server = ServingServer(
            spec, max_batch=8, max_delay_ms=3, batch_buckets=(1, 2, 4),
            gauges=gaugelib.Registry(),  # own registry: per-replica scrapes
            gauge_port=0, target_p99_ms=target_p99_ms, device="cpu",
            state=None if state is None else copy.deepcopy(state),
        )
        server.warmup()  # readiness implies warmed, like serving/main.py
        spawned.append(slot)
        return server.start()

    return factory


@pytest.mark.parametrize("model", ["wide_deep", "transformer_lm"])
def test_fleet_smoke_scale_up_then_down(tmp_path, model):
    """2 real replicas on the CPU; a short live ramp blows a deliberately
    tight SLO -> scale to 3; idle windows -> scale back to 2.  p2c spreads
    traffic over every replica and flushes land in declared buckets only."""
    spec = _spec(model)
    spawned = []
    # SLO target below one batcher deadline: real traffic MUST blow it.
    backend = InProcessServingBackend(
        _replica_factory(spec, spawned, target_p99_ms=1.0)
    )
    ctl = ServingFleetController(
        backend, JobConfig(job_name="fleet-smoke"),
        state_path=str(tmp_path / "fleet-pods.json"),
        autoscale=AutoscaleConfig(
            min_replicas=2, max_replicas=3, poll_s=0.05, target_p99_ms=1.0,
            up_consecutive=2, down_consecutive=3, cooldown_polls=1,
        ),
        autoscale_enabled=False,  # poll_once-driven: deterministic
        gauges=gaugelib.Registry(),
    )
    fc = None
    try:
        ctl.start(2)
        addrs = ctl.wait_ready(2, timeout_s=60.0)
        assert len(addrs) == 2 and spawned == [0, 1]
        fc = FleetServingClient(addrs, rng=random.Random(3))

        def burst(n=20):
            for i in range(n):
                r = fc.predict(_features(model, 1, seed=i))
                assert r["model"] == model
                assert np.asarray(r["outputs"]).shape == _out_shape(model, 1)

        # Real request latency (>= one 3 ms batcher deadline) vs the 1 ms
        # target -> up pressure two polls running -> scale 2->3.
        burst()
        d = ctl.poll_once()
        assert d["slo"] is not None and d["slo"] >= 1.0
        assert d["action"] == "" and d["up_streak"] == 1
        burst()
        d = ctl.poll_once()
        assert d["action"] == "up"
        assert ctl.pods.counts()["live"] == 3 and spawned == [0, 1, 2]
        addrs3 = ctl.wait_ready(3, timeout_s=60.0)
        fc.set_replicas(addrs3)
        burst()

        # Both lanes serve through the fleet front.
        out = fc.predict_outputs(_features(model, 2, seed=99), lane="bulk")
        assert out.shape == _out_shape(model, 2)
        # Unknown lane: structured schema error at the boundary, no retry.
        with pytest.raises(grpc.RpcError) as err:
            fc.predict(_features(model, 1), lane="vip")
        assert err.value.code() == grpc.StatusCode.FAILED_PRECONDITION

        # Every replica answered (p2c spread), each on its own endpoint;
        # flushes landed in the declared buckets only.
        for _name, _saddr, maddr in ctl.replicas():
            fams = fetch(maddr)
            served = sum(
                s["value"]
                for s in fams["edl_serving_requests_total"]["samples"]
            )
            assert served > 0, maddr
            buckets = {
                s["labels"]["bucket"]
                for s in fams["edl_serving_bucket_flushes_total"]["samples"]
                if s["value"] > 0
            }
            assert buckets and buckets <= {"1", "2", "4", "8"}, buckets

        # Idle windows read as no-signal -> down pressure -> retire back
        # to min after down_consecutive quiet polls.
        acts = [ctl.poll_once()["action"] for _ in range(8)]
        assert "down" in acts
        assert ctl.pods.counts()["live"] == 2
        fc.set_replicas(ctl.wait_ready(2, timeout_s=30.0))
        assert fc.predict(_features(model, 1))["model"] == model

        # Exactly one up and one down: the loop converged.
        assert [(e["from"], e["to"]) for e in ctl.events()] == [
            (2, 3), (3, 2)
        ]
        g = ctl.gauges.snapshot()
        assert any("edl_serving_fleet_scale_events_total" in str(k) for k in g)
    finally:
        if fc is not None:
            fc.close()
        ctl.stop()
        backend.close()


def test_fleet_controller_restart_adopts_live_replicas(tmp_path):
    """A controller that dies WITHOUT stop() leaves replicas serving and
    the registry on disk; its replacement adopts the live fleet instead
    of spawning duplicates."""
    spec = _spec("wide_deep")
    spawned = []
    backend = InProcessServingBackend(_replica_factory(spec, spawned))
    state = str(tmp_path / "fleet-pods.json")

    def controller():
        return ServingFleetController(
            backend, JobConfig(job_name="fleet-adopt"),
            state_path=state,
            autoscale=AutoscaleConfig(min_replicas=2, max_replicas=2),
            autoscale_enabled=False,
            gauges=gaugelib.Registry(),
        )

    ctl1 = controller()
    ctl2 = None
    try:
        ctl1.start(2)
        addrs1 = sorted(ctl1.wait_ready(2, timeout_s=60.0))
        assert len(spawned) == 2

        # Controller "crash": no stop(), no registry removal.
        ctl2 = controller()
        ctl2.start(2)
        addrs2 = sorted(ctl2.wait_ready(2, timeout_s=30.0))
        assert addrs2 == addrs1      # the SAME live servers, same ports
        assert len(spawned) == 2     # adopted, not respawned
        assert ctl2.pods.counts()["live"] == 2

        fc = FleetServingClient(addrs2)
        try:
            assert fc.predict(_features("wide_deep", 1))["model"] == "wide_deep"
        finally:
            fc.close()
    finally:
        if ctl2 is not None:
            ctl2.stop()
        else:
            ctl1.stop()
        backend.close()


def test_autoscale_thread_scales_on_its_own(tmp_path):
    """``autoscale_enabled`` runs ``poll_once`` on the controller's own
    thread every ``poll_s``: idle replicas scale down to the floor with
    no caller driving the polls, and ``stop()`` joins the thread."""
    sig = _SyntheticSignal()
    sig.mode = "idle"
    ctl = ServingFleetController(
        FakePodBackend(), JobConfig(job_name="fleet-thread"),
        autoscale=AutoscaleConfig(
            min_replicas=1, max_replicas=3, poll_s=0.01,
            down_consecutive=2, cooldown_polls=0,
        ),
        gauges=gaugelib.Registry(), scrape_fn=sig,
    )
    ctl.start(3)
    try:
        import time

        deadline = time.monotonic() + 10.0
        while ctl.pods.desired() > 1 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert ctl.pods.desired() == 1
        assert [(e["from"], e["to"]) for e in ctl.events()] == [(3, 2), (2, 1)]
    finally:
        ctl.stop()
    assert ctl._thread is None


def test_fleet_answers_match_the_jax_serving_server():
    """Two port replicas on weights carried from the JAX model answer
    through the fleet client as the JAX ``ServingServer`` does (f32, 1e-4),
    and every replica gives the same answer."""
    import jax

    import elasticdl_tpu.parallel.trainer  # noqa: F401  (resolves the ops <-> parallel import cycle)
    from elasticdl_tpu.models import transformer_lm as jlm
    from elasticdl_tpu.serving.server import ServingServer as JaxServingServer
    from elasticdl_tpu_torch.models import transformer_lm as tlm

    jserver = JaxServingServer(jlm.model_spec(compute_dtype="float32", **_LM),
                               max_batch=4, batch_buckets=[2, 4])
    params = jax.device_get(jserver._template.params)
    state = tlm.params_from_jax(params, _LM["n_heads"], "float32", device="cpu")
    spawned = []
    backend = InProcessServingBackend(_replica_factory(_spec("transformer_lm"), spawned, state=state))
    ctl = ServingFleetController(
        backend, JobConfig(job_name="fleet-parity"),
        autoscale=AutoscaleConfig(min_replicas=2, max_replicas=2),
        autoscale_enabled=False, gauges=gaugelib.Registry(),
    )
    fc = None
    try:
        ctl.start(2)
        addrs = ctl.wait_ready(2, timeout_s=60.0)
        fc = FleetServingClient(addrs, rng=random.Random(5))
        tokens = _features("transformer_lm", 2, seed=4)["tokens"]
        batch = {"tokens": np.zeros((2, _LM["seq_len"]), np.int32),
                 "__mask__": np.ones((2,), np.float32)}
        batch["tokens"][:] = tokens
        ref = np.asarray(jserver._run_batch(batch, 2)[0])
        answers = []
        for _ in range(12):
            answers.append(fc.predict_outputs({"tokens": tokens}))
        served = [
            sum(s["value"] for s in fetch(m)["edl_serving_requests_total"]["samples"])
            for _n, _s, m in ctl.replicas()
        ]
        assert all(n > 0 for n in served), served  # both replicas answered
        for out in answers:
            np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)
            np.testing.assert_array_equal(out, answers[0])
    finally:
        if fc is not None:
            fc.close()
        ctl.stop()
        backend.close()
        jserver.stop()
