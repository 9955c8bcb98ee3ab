"""The port's preprocessing layers (``elasticdl_tpu_torch/preprocessing``)
and census codec against the JAX package's.

- Every layer on numpy input against the reference's layer on the same
  input and state: exact (integer outputs, and floats computed by the same
  numpy code).
- The torch branch against the numpy branch, on CPU tensors here (the
  same code runs on the card; ``tests/test_torch_cuda.py`` holds it
  there): exact for integer outputs (Hashing, IndexLookup, Discretization,
  RoundIdentity, ConcatenateWithOffset), rtol 1e-6 for Normalizer's f32.
  The reference's own device branch (jnp under jit) is the third party of
  the integer comparisons.
- ``get_config``/``from_config`` round trips through JSON, also read by
  the reference's ``from_config``.
- ``census_feed`` (the native decode) against ``census_feed_plain`` (the
  layers) and the reference's ``census_feed``, exact, on the reference's
  edge records (``tests/test_data.py``: blanks, spaces, floats, invalid
  numerics) and on synthetic census lines.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import elasticdl_tpu.preprocessing as jpre
from elasticdl_tpu.data import codecs as jcodecs
from elasticdl_tpu_torch import preprocessing as pre
from elasticdl_tpu_torch.data import codecs, synthetic
from elasticdl_tpu_torch.ps import host_store

_INTS = np.array([[0, 1, 7], [123456789, 2**30, 2**31 - 1], [-1, -(2**31), 2**40]])


def _layers(mod):
    """One fitted instance of each layer, built the same way in ``mod``."""
    rng = np.random.default_rng(0)
    return {
        "hashing": mod.Hashing(97),
        "lookup": mod.IndexLookup(num_oov=2).adapt(np.array([10, 10, 20, 30, 20, 10, -5])),
        "normalizer": mod.Normalizer().adapt([rng.normal(5.0, 3.0, (300, 3)),
                                              rng.normal(4.0, 2.0, (200, 3))]),
        "discretization": mod.Discretization(num_bins=5).adapt(rng.normal(0, 10, 2000)),
        "round": mod.RoundIdentity(10),
        "to_number": mod.ToNumber(out_dtype="float32", default=-1.0),
        "concat": mod.ConcatenateWithOffset([10, 20, 5]),
    }


def _inputs():
    rng = np.random.default_rng(1)
    return {
        "hashing": _INTS,
        "lookup": np.array([[10, 20, 30], [999, -5, 0], [2**31 - 1, -7, 20]]),
        "normalizer": rng.normal(5.0, 3.0, (16, 3)).astype(np.float32),
        "discretization": np.concatenate([rng.normal(0, 10, 20), [-1e9, 1e9, 0.0]]).astype(
            np.float32),
        "round": np.array([0.4, 3.6, 99.0, -1.0, 2.5, 3.5, -0.5]),
        "to_number": np.array(["3.5", "", "junk", b"2", " 4 ", "1e2"], object),
        "concat": [np.array([1, 2]), np.array([[0, 3], [19, 4]]), np.array([4, 0])],
    }


@pytest.mark.parametrize("name", sorted(_inputs()))
def test_each_layer_equals_the_reference_on_numpy_input(name):
    ours, theirs = _layers(pre)[name], _layers(jpre)[name]
    x = _inputs()[name]
    got, want = ours(x), theirs(x)
    assert isinstance(got, np.ndarray) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_string_hashing_and_lookup_equal_the_reference():
    words = np.array(["apple", "banana", "", "apple", "ünï", "a b"], object)
    np.testing.assert_array_equal(pre.Hashing(50)(words), jpre.Hashing(50)(words))
    ours = pre.IndexLookup(num_oov=3).adapt(words[:4])
    theirs = jpre.IndexLookup(num_oov=3).adapt(words[:4])
    assert ours.vocabulary == theirs.vocabulary
    probe = np.array(["banana", "zzz", b"apple", 3.5, 7], object)
    np.testing.assert_array_equal(ours(probe), theirs(probe))


@pytest.mark.parametrize("name", ["hashing", "lookup", "discretization", "round", "concat"])
def test_torch_branch_equals_numpy_for_integer_outputs(name):
    layer = _layers(pre)[name]
    x = _inputs()[name]
    host = layer(x)
    t = ([torch.from_numpy(f) for f in x] if name == "concat"
         else torch.from_numpy(np.asarray(x)))
    dev = layer(t)
    assert isinstance(dev, torch.Tensor) and dev.dtype == torch.int64
    np.testing.assert_array_equal(dev.numpy(), host)


@pytest.mark.parametrize("name", ["hashing", "lookup", "discretization"])
def test_torch_branch_equals_the_references_jit_branch(name):
    ours, theirs = _layers(pre)[name], _layers(jpre)[name]
    x = np.asarray(_inputs()[name])
    if name != "discretization":
        x = x.astype(np.int32)  # jnp under jit is 32-bit
    want = np.asarray(jax.jit(theirs)(jnp.asarray(x)))
    np.testing.assert_array_equal(ours(torch.from_numpy(x)).numpy(), want)


def test_hashing_torch_covers_the_whole_32_bit_range():
    """FNV-1a in int64 with the low 32 bits kept after each multiply: the
    numpy uint32 hash, bit for bit, over int64 ids of any sign."""
    rng = np.random.default_rng(2)
    x = rng.integers(-(1 << 62), 1 << 62, 4096, dtype=np.int64)
    for bins in (1, 7, 1 << 16, 1 << 31, (1 << 32) - 5):
        layer = pre.Hashing(bins)
        np.testing.assert_array_equal(layer(torch.from_numpy(x)).numpy(), layer(x))
        np.testing.assert_array_equal(layer(x), jpre.Hashing(bins)(x))


def test_normalizer_torch_branch_matches_numpy():
    layer = _layers(pre)["normalizer"]
    x = _inputs()["normalizer"]
    np.testing.assert_allclose(layer(torch.from_numpy(x)).numpy(), layer(x), rtol=1e-6,
                               atol=1e-6)


def test_lookup_refusals_match_the_reference():
    no_oov = pre.IndexLookup(vocabulary=[10, 20], num_oov=0)
    with pytest.raises(ValueError, match="num_oov"):
        no_oov(torch.tensor([15]))
    with pytest.raises(KeyError):
        no_oov(np.array([15]))
    strings = pre.IndexLookup().adapt(np.array(["a", "b"]))
    with pytest.raises(TypeError):
        strings(torch.zeros(2, dtype=torch.int32))


@pytest.mark.parametrize("name", sorted(_inputs()))
def test_config_round_trips_through_json_and_the_reference(name):
    layer = _layers(pre)[name]
    cfg = json.loads(json.dumps(layer.get_config()))
    rebuilt = type(layer).from_config(cfg)
    assert rebuilt.get_config() == layer.get_config()
    theirs = getattr(jpre, type(layer).__name__).from_config(cfg)
    x = _inputs()[name]
    np.testing.assert_array_equal(rebuilt(x), theirs(x))


# ---- the census codec -----------------------------------------------------------

_EDGE_RECORDS = [
    codecs.encode_census_example(0, [39, 13, 0, 0, 40], ["private"] * 9),
    codecs.encode_census_example(1, [17.5, 1, 5000, 0, 12.25], ["a b", ""] + ["x"] * 7),
    b"1, 39 ,13,,40,oops, gov,hs,married,tech,husband,white,male,us,a",
    b"0,1e2,2.5,-3,0.0,4,w1,w2,w3,w4,w5,w6,w7,w8,w9",
]


def _census_lines(tmp_path, n=300):
    path = str(tmp_path / "census.csv")
    synthetic.generate("census", path, n, seed=5)
    with open(path, "rb") as f:
        return [line for line in f.read().split(b"\n") if line]


@pytest.mark.parametrize("source", ["edge", "synthetic"])
def test_census_feed_native_equals_the_layers_and_the_reference(tmp_path, source):
    records = _EDGE_RECORDS if source == "edge" else _census_lines(tmp_path)
    native, plain = codecs.census_feed(records), codecs.census_feed_plain(records)
    theirs = jcodecs.census_feed(records)
    for key in ("dense", "cat", "labels"):
        assert native[key].dtype == plain[key].dtype == theirs[key].dtype, key
        np.testing.assert_array_equal(native[key], plain[key], err_msg=key)
        np.testing.assert_array_equal(native[key], theirs[key], err_msg=key)
    assert native["dense"].shape == (len(records), 5) and native["cat"].shape[1] == 9
    assert (native["cat"] >= 0).all()


def test_census_feed_has_no_fallback(monkeypatch):
    """Without the native library ``census_feed`` raises; the layers'
    decode is ``census_feed_plain``'s alone."""
    def unavailable():
        raise RuntimeError("native lib unavailable: test")

    monkeypatch.setattr(host_store, "_load", unavailable)
    with pytest.raises(RuntimeError, match="native lib unavailable"):
        codecs.census_feed(_EDGE_RECORDS)
    assert codecs.census_feed_plain(_EDGE_RECORDS)["cat"].shape == (4, 9)


def test_census_decode_rejects_a_malformed_record():
    with pytest.raises(ValueError, match="malformed census record 1"):
        codecs.census_feed([_EDGE_RECORDS[0], b"x,1,2,3,4,5,a,b,c,d,e,f,g,h,i"])
