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


def test_checkpoint_dir_is_not_ported_yet():
    with pytest.raises(NotImplementedError, match="checkpoint"):
        ServingServer(tlm.model_spec(**_MODEL), checkpoint_dir="/nonexistent", device="cpu")


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
