"""The PyTorch port's serving replica against the JAX package's.

The port's ``ServingServer(device="cpu")`` answers gRPC Predict and
ModelInfo under the reference's wire contract, its logits match the JAX
``ServingServer._run_batch`` on the same (carried) weights, and its
micro-batcher pads to buckets and drains lanes as the reference's does.
f32 compute, tolerance 1e-4 (the model test's f32 bound: summation order
only).
"""

import json
import os
import signal
import socket
import subprocess
import sys

import grpc
import jax
import numpy as np
import pytest

import elasticdl_tpu.parallel.trainer  # noqa: F401  (resolves the ops <-> parallel import cycle)
from _torch_reference_native import reference_native  # noqa: F401  (a fixture)
from elasticdl_tpu.models import transformer_lm as jlm
from elasticdl_tpu.serving.server import ServingServer as JaxServingServer
from elasticdl_tpu_torch.common import rpc as trpc
from elasticdl_tpu_torch.common.metrics_http import fetch
from elasticdl_tpu_torch.models import transformer_lm as tlm
from elasticdl_tpu_torch.serving.client import ServingClient
from elasticdl_tpu_torch.serving.server import ServingServer

_MODEL = dict(vocab=128, dim=64, n_heads=2, n_layers=2, max_seq=128, seq_len=128)
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tokens(n, seed=0):
    return np.random.default_rng(seed).integers(0, _MODEL["vocab"], (n, _MODEL["seq_len"])).astype(np.int32)


@pytest.fixture(scope="module")
def servers():
    jspec = jlm.model_spec(compute_dtype="float32", **_MODEL)
    jserver = JaxServingServer(jspec, max_batch=4, batch_buckets=[2, 4])
    params = jax.device_get(jserver._template.params)
    tspec = tlm.model_spec(compute_dtype="float32", **_MODEL)
    state = tlm.params_from_jax(params, _MODEL["n_heads"], "float32", device="cpu")
    tserver = ServingServer(
        tspec, max_batch=4, batch_buckets=[2, 4], max_delay_ms=2, state=state,
        device="cpu",
    ).start()
    client = ServingClient(tserver.address)
    try:
        tserver.warmup()
        client.wait_ready(10.0)
        yield jserver, tserver, client
    finally:
        client.close()
        tserver.stop()
        jserver.stop()


def test_grpc_predict_matches_jax_run_batch(servers):
    jserver, _, client = servers
    tokens = _tokens(3, seed=1)
    r = client.predict({"tokens": tokens})
    assert r["model"] == "transformer_lm" and r["step"] == -1
    out = np.asarray(r["outputs"], np.float32)
    assert out.shape == (3, _MODEL["seq_len"], _MODEL["vocab"])
    batch = {"tokens": np.zeros((4, _MODEL["seq_len"]), np.int32),
             "__mask__": np.zeros((4,), np.float32)}
    batch["tokens"][:3] = tokens
    batch["__mask__"][:3] = 1.0
    ref, _ = jserver._run_batch(batch, 3)
    np.testing.assert_allclose(out, np.asarray(ref)[:3], atol=1e-4, rtol=1e-4)
    # A single example may omit the batch dim.
    one = client.predict_outputs({"tokens": tokens[0]})
    np.testing.assert_allclose(one[0], out[0], atol=1e-4, rtol=1e-4)


def test_model_info_and_schema_errors(servers):
    _, _, client = servers
    info = client.model_info()
    assert info["model"] == "transformer_lm"
    assert info["batch_buckets"] == [2, 4] and info["max_batch"] == 4
    assert info["features"] == {
        "tokens": {"dtype": "int32", "example_shape": [_MODEL["seq_len"]]}
    }
    with pytest.raises(grpc.RpcError) as err:
        client.predict({"tokenz": [[0] * _MODEL["seq_len"]]})
    assert err.value.code() == grpc.StatusCode.FAILED_PRECONDITION
    assert "tokens" in err.value.details()
    with pytest.raises(grpc.RpcError) as err:
        client.predict({"tokens": [[0] * 5]})
    assert err.value.code() == grpc.StatusCode.FAILED_PRECONDITION


def test_out_of_range_token_fails_its_request_alone(servers):
    _, tserver, client = servers
    flushes = sum(tserver._batcher.stats()["flushes_by_bucket"].values())
    bad = _tokens(1, seed=2)
    bad[0, 5] = _MODEL["vocab"]
    with pytest.raises(grpc.RpcError) as err:
        client.predict({"tokens": bad})
    assert err.value.code() == grpc.StatusCode.FAILED_PRECONDITION
    assert "token ids must lie in [0, 128)" in err.value.details()
    # Refused at the boundary: it never reached a flush.
    assert sum(tserver._batcher.stats()["flushes_by_bucket"].values()) == flushes
    assert client.predict_outputs({"tokens": _tokens(1, seed=3)}).shape[0] == 1


def test_serving_schemas_match_the_reference_and_the_method_table():
    from elasticdl_tpu.common import rpc as jrpc

    assert trpc.SERVING_SERVICE_NAME == jrpc.SERVING_SERVICE_NAME
    assert trpc.SERVING_SCHEMAS.keys() == {"Predict", "ModelInfo"}
    for table in ("SERVING_SCHEMAS", "SERVING_RESPONSE_SCHEMAS"):
        mine, ref = getattr(trpc, table), getattr(jrpc, table)
        assert mine.keys() == ref.keys()
        for method in ref:
            assert (mine[method].required, mine[method].optional, mine[method].since) == (
                ref[method].required, ref[method].optional, ref[method].since)


def test_buckets_and_lanes_behave_as_in_the_reference(servers):
    """The same request sequence through both micro-batchers, one request
    per flush, gives the same bucket choices and lane attribution."""
    jserver, tserver, _ = servers
    before_j, before_t = jserver._batcher.stats(), tserver._batcher.stats()
    for i, (n, lane) in enumerate([(1, "online"), (2, "bulk"), (3, "online"), (4, "bulk")]):
        feats = {"tokens": _tokens(n, seed=10 + i)}
        jout, _ = jserver._batcher.submit(feats, lane=lane).result(timeout_s=60.0)
        tout, _ = tserver._batcher.submit(feats, lane=lane).result(timeout_s=60.0)
        assert np.asarray(tout).shape == np.asarray(jout).shape == (n, _MODEL["seq_len"], _MODEL["vocab"])
        np.testing.assert_allclose(tout, jout, atol=1e-4, rtol=1e-4)
    after_j, after_t = jserver._batcher.stats(), tserver._batcher.stats()

    def delta(after, before):
        return {
            "buckets": {b: after["flushes_by_bucket"][b] - before["flushes_by_bucket"][b]
                        for b in after["flushes_by_bucket"]},
            "padded": after["rows_padded"] - before["rows_padded"],
            "lanes": {ln: after["lanes"][ln]["rows_served"] - before["lanes"][ln]["rows_served"]
                      for ln in after["lanes"]},
        }

    d = delta(after_t, before_t)
    assert d == delta(after_j, before_j)
    assert d == {"buckets": {"2": 2, "4": 2}, "padded": 2, "lanes": {"online": 4, "bulk": 6}}


def test_checkpoint_dir_and_ps_addresses_build_a_replica(tmp_path):
    """Checkpoint restore and hot reload are ported now (held by
    tests/test_torch_checkpoint.py): a checkpoint directory that holds no
    step yet serves fresh weights at step -1 under a watcher.  The PS host
    tier is ported too: ``ps_addresses`` builds a replica, which for a
    model without host-tier tables holds no store and no cache."""
    server = ServingServer(tlm.model_spec(**_MODEL), checkpoint_dir=str(tmp_path), device="cpu")
    try:
        assert server.live_step == -1 and server._watcher is not None
        assert server._watcher.poke() is False  # nothing published
    finally:
        server.stop(grace=0)
    server = ServingServer(tlm.model_spec(**_MODEL), ps_addresses="localhost:1", device="cpu")
    try:
        assert server._caches == {} and server._model_info({})["cache"] == {}
    finally:
        server.stop(grace=0)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_replica_main_serves_grpc_on_the_cpu():
    """The replica entry point, as a fleet spawns it, under the
    environment contract; SIGTERM drains and exits 0."""
    port, mport = _free_port(), _free_port()
    cfg = {
        "model_def": "transformer_lm.model_spec",
        "model_params": dict(_MODEL, compute_dtype="float32"),
        "max_batch": 2, "batch_buckets": [1, 2], "device": "cpu",
        "base_port": port, "metrics_base_port": mport,
    }
    env = dict(os.environ, ELASTICDL_SERVING_CONFIG=json.dumps(cfg),
               ELASTICDL_WORKER_SLOT="0", GRAFT_WIRESAN="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "elasticdl_tpu_torch.serving.main"],
        cwd=_REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
    )
    client = ServingClient(f"localhost:{port}")
    try:
        client.wait_ready(120.0)
        out = client.predict_outputs({"tokens": _tokens(2, seed=3)})
        assert out.shape == (2, _MODEL["seq_len"], _MODEL["vocab"])
        assert np.isfinite(out).all()
        info = client.model_info()
        assert info["requests"] == 1 and info["batcher"]["rows_served"] == 2
        fams = fetch(f"localhost:{mport}", timeout_s=10.0)
        assert [x["value"] for x in fams["edl_serving_requests_total"]["samples"]] == [1.0]
        assert "edl_kernel_launches_total" not in fams  # the CPU runs no kernel
    finally:
        client.close()
        proc.send_signal(signal.SIGTERM)
        try:
            log = proc.communicate(timeout=60)[0].decode()
        except subprocess.TimeoutExpired:
            proc.kill()
            raise
    assert proc.returncode == 0, log


# ---- the host tier: the hot-id cache and a replica over a PS fleet ----
#
# Tolerances: the cache's rows and stats equal the reference cache's exactly
# (both front the same C++ store); the replica's outputs against the JAX
# replica's on the same weights and the same fleet rtol 1e-5 / atol 1e-6
# (f32 summation order).

_DFM_HOST = dict(buckets_per_feature=128, embedding_dim=4, hidden=(8,), host_tier=True,
                 compute_dtype="float32")


@pytest.mark.parametrize("capacity", [1 << 20, 40], ids=["roomy", "evicting"])
@pytest.mark.usefixtures("reference_native")
def test_hot_id_cache_matches_the_reference_cache(capacity):
    """The same pulls through both packages' caches (over stores of each
    package) give the same rows and the same LRU book-keeping: hits,
    misses, evictions, invalidations, stale drops and the generation."""
    from elasticdl_tpu.ps.host_store import HostEmbeddingStore as JaxStore
    from elasticdl_tpu.serving.embedding_cache import HotIdEmbeddingCache as JaxCache
    from elasticdl_tpu_torch.ps.host_store import HostEmbeddingStore
    from elasticdl_tpu_torch.serving.embedding_cache import HotIdEmbeddingCache

    ours = HotIdEmbeddingCache(HostEmbeddingStore(dim=3), capacity=capacity, name="t")
    theirs = JaxCache(JaxStore(dim=3), capacity=capacity, name="t")
    rng = np.random.default_rng(2)
    for i in range(12):
        ids = rng.zipf(1.3, (4, 9)).astype(np.int64) % 200
        assert np.array_equal(ours.pull(ids), theirs.pull(ids))
        if i == 6:
            ours.invalidate()
            theirs.invalidate()
        assert ours.stats() == theirs.stats()
    assert len(ours) == len(theirs) <= capacity
    stats = ours.stats()
    assert stats["hits"] > 0 and stats["invalidations"] == 1 and stats["generation"] == 1
    assert (stats["evictions"] > 0) == (capacity == 40)
    with pytest.raises(ValueError, match="capacity"):
        HotIdEmbeddingCache(HostEmbeddingStore(dim=3), capacity=0)


def test_cache_keeps_no_rows_fetched_across_an_invalidation():
    """A miss fetch in flight when a reload invalidates returns its rows to
    its caller but does not insert them (the generation guard)."""
    from elasticdl_tpu_torch.ps.host_store import HostEmbeddingStore
    from elasticdl_tpu_torch.serving.embedding_cache import HotIdEmbeddingCache

    store = HostEmbeddingStore(dim=2)

    class Racing:
        dim = 2

        def pull(self, ids):
            cache.invalidate()  # the reload lands mid-fetch
            return store.pull(ids)

    cache = HotIdEmbeddingCache(Racing(), capacity=16)
    ids = np.arange(5, dtype=np.int64)
    np.testing.assert_array_equal(cache.pull(ids), store.pull(ids))
    assert len(cache) == 0 and cache.stats()["stale_drops"] == 5


def test_replica_over_a_ps_fleet_answers_as_the_jax_replica(tmp_path):
    """A port replica and a JAX replica over the same 2-shard PS fleet and
    the same dense weights give the same outputs; repeats are cache hits
    (rows pushed underneath meanwhile stay unseen), and a published reload
    invalidates the cache, after which the answers are a fresh pull's."""
    from elasticdl_tpu.models import deepfm as jdeepfm
    from elasticdl_tpu_torch.common.checkpoint import CheckpointManager
    from elasticdl_tpu_torch.models import deepfm
    from elasticdl_tpu_torch.parallel.trainer import Trainer
    from elasticdl_tpu_torch.ps.service import PSServer, RemoteEmbeddingStore

    spec = deepfm.model_spec(**_DFM_HOST)
    key = deepfm.HOST_FM_KEY
    from elasticdl_tpu_torch.common import gauge as gaugelib

    fleet = [PSServer(spec.host_io, shard=s, num_shards=2, gauges=gaugelib.Registry()).start()
             for s in range(2)]
    addrs = ",".join(s.address for s in fleet)
    jserver = JaxServingServer(jdeepfm.model_spec(**_DFM_HOST), ps_addresses=addrs,
                               max_batch=4, batch_buckets=[4])
    params = jax.device_get(jserver._template.params)
    # The port replica serves the JAX weights from a published checkpoint.
    ckpt_dir = str(tmp_path / "ckpt")
    writer = Trainer(spec, device="cpu")
    state = writer.init_state(None)
    state.model.load_jax_params(params)
    mgr = CheckpointManager(ckpt_dir)
    mgr.save(0, writer.host_state(state), wait=True)
    mgr.publish(0)
    server = ServingServer(spec, checkpoint_dir=ckpt_dir, ps_addresses=addrs, max_batch=4,
                           batch_buckets=[4], max_delay_ms=2, poll_interval_s=3600,
                           cache_rows=1 << 10, device="cpu").start()
    client = ServingClient(server.address)
    rng = np.random.default_rng(4)
    feats = {"dense": rng.uniform(0, 50, (4, 13)).astype(np.float32),
             "cat": rng.integers(0, 1 << 30, (4, 26)).astype(np.int32)}
    try:
        client.wait_ready(10.0)
        padded = dict(feats, __mask__=np.ones(4, np.float32))
        want = np.asarray(jserver._run_batch(dict(padded), 4)[0])
        got = np.asarray(client.predict(feats)["outputs"])
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        stats = client.model_info()["cache"][key]
        assert stats["misses"] > 0 and stats["size"] > 0
        # Training pushes underneath: the cache still serves the old rows.
        ids = np.unique(spec.host_io[key].ids_fn(feats))
        store = RemoteEmbeddingStore(key, spec.host_io[key].dim, addrs.split(","))
        for _ in range(30):
            store.push_grad(ids, np.ones((ids.size, store.dim), np.float32))
        np.testing.assert_array_equal(np.asarray(client.predict(feats)["outputs"]), got)
        assert client.model_info()["cache"][key]["hits"] >= ids.size
        # A publish reloads and invalidates: the next answer is a fresh pull's.
        invalidations = stats["invalidations"]  # the startup load's
        mgr.save(1, writer.host_state(state), wait=True)
        mgr.publish(1)
        assert server._watcher.poke()
        info = client.model_info()
        assert info["step"] == 1
        assert info["cache"][key]["invalidations"] == invalidations + 1
        assert info["cache"][key]["size"] == 0
        after = np.asarray(client.predict(feats)["outputs"])
        jserver._caches[key].invalidate()  # the JAX replica's cache is warm too
        fresh = np.asarray(jserver._run_batch(dict(padded), 4)[0])
        assert np.abs(after - got).max() > 1e-4
        np.testing.assert_allclose(after, fresh, rtol=1e-5, atol=1e-6)
        text = server.gauges.render_prometheus()
        assert "edl_serving_cache_hit_ratio" in text and "edl_serving_cache_rows" in text
        store.close()
    finally:
        client.close()
        server.stop(grace=0)
        jserver.stop()
        for s in fleet:
            s.stop(grace=0)
