"""The port's Criteo ingest against the JAX package's: the native library
(``elasticdl_tpu_torch/ps/host_store.py`` over the port's copy of
``edl_native.cc``), the codecs, the fused-id hash, the RecordIO reads and
the parallel ingest pool.

Everything here is exact: decodes, hashes, file bytes and chunked preps
compare bit for bit (``np.array_equal`` on the raw bytes of each array).
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import elasticdl_tpu.parallel  # noqa: F401  (the JAX package's own import order)
from elasticdl_tpu.data import codecs as jcodecs
from elasticdl_tpu.data import ingest_pool as jingest
from elasticdl_tpu.data.recordio import RecordIOReader as JaxRecordIOReader
from elasticdl_tpu.data.synthetic import synthetic_criteo as jax_synthetic_criteo
from elasticdl_tpu.models import tabular as jtabular
from elasticdl_tpu_torch.common.config import JobConfig
from elasticdl_tpu_torch.data import codecs, ingest_pool
from elasticdl_tpu_torch.data.packed import as_packed
from elasticdl_tpu_torch.data.reader import RecordIODataReader, Shard
from elasticdl_tpu_torch.data.recordio import RecordIOReader, write_records
from elasticdl_tpu_torch.data.synthetic import synthetic_criteo
from elasticdl_tpu_torch.master.task_dispatcher import Task
from elasticdl_tpu_torch.models import deepfm, tabular
from elasticdl_tpu_torch.ps import host_store
from elasticdl_tpu_torch.worker.worker import Worker

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _same(a: np.ndarray, b: np.ndarray) -> bool:
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def _records(n=256, seed=3, lo=-50):
    """tests/test_data.py:96's records: blanks, negatives, full-range hex ids,
    a label-only record, blank dense fields, decimals with an exponent,
    mixed-case hex."""
    rng = np.random.default_rng(seed)
    records = [
        codecs.encode_criteo_example(
            int(rng.integers(0, 2)),
            [None if rng.random() < 0.2 else int(rng.integers(lo, 100000)) for _ in range(13)],
            [int(rng.integers(0, 1 << 32)) for _ in range(26)],
        )
        for _ in range(n)
    ]
    records.append(b"1")
    records.append(b"0\t\t\t")
    records.append(b"1\t3.5\t-2.25\t1e2")
    records.append(b"0" + b"\t7" * 13 + b"\tdeadBEEF")
    return records


@pytest.mark.parametrize("packed", [False, True], ids=["list", "packed"])
def test_native_decode_matches_the_plain_decode_and_the_jax_feed(packed):
    records = _records()
    form = as_packed(records) if packed else records
    native, plain, theirs = (codecs.criteo_feed(form), codecs.criteo_feed_plain(records),
                             jcodecs.criteo_feed(records))
    for key in ("dense", "cat", "labels"):
        assert _same(native[key], plain[key]), key
        assert _same(native[key], theirs[key]), key


@pytest.mark.parametrize("buckets", [512, 4096, 65536])
def test_native_preprocessed_decode_matches_plain_and_jax(buckets):
    records = _records(lo=0)
    native = codecs.criteo_feed_pre(as_packed(records), buckets)
    plain = codecs.criteo_feed_pre_plain(records, buckets)
    theirs = jcodecs.criteo_feed_pre(records, buckets)
    for key in ("dense", "cat", "labels"):
        assert _same(native[key], plain[key]), key
        assert _same(native[key], theirs[key]), key
    assert native["dense"].dtype == np.float16 and native["cat"].dtype == np.uint16
    # 79 bytes an example on the wire.
    assert sum(v[0].nbytes for v in native.values()) == 79


def test_malformed_records_raise_naming_the_record():
    with pytest.raises(ValueError, match="record 1"):
        codecs.criteo_feed([b"1\t2", b"not-a-label\t2"])
    with pytest.raises(ValueError, match="record 0"):
        codecs.criteo_feed([b"1" + b"\t1" * 13 + b"\tzzzz"])
    with pytest.raises(ValueError, match="record 1"):
        codecs.criteo_feed_pre([b"1\t2", b"x\t2"], 512)
    with pytest.raises(ValueError, match="out of range"):
        codecs.criteo_feed_pre([b"1\t2"], 65537)


@pytest.mark.parametrize("buckets", [1, 7, 512, 65536, 1 << 20])
def test_fused_id_hash_is_bit_for_bit_the_reference(buckets):
    rng = np.random.default_rng(buckets)
    ids = rng.integers(-(2**31), 2**31, (64, 26), dtype=np.int64).astype(np.int32)
    ids[0, :8] = [0, 1, -1, 2**31 - 1, -(2**31), 65535, 65536, -65536]
    want = jtabular.fuse_feature_ids_np(ids, buckets)
    assert _same(tabular.fuse_feature_ids_np(ids, buckets), want)
    ours = tabular.fuse_feature_ids(torch.from_numpy(ids), buckets)
    assert ours.dtype == torch.int64 and np.array_equal(ours.numpy(), want)
    theirs = np.asarray(jtabular.fuse_feature_ids(jnp.asarray(ids), buckets))
    assert np.array_equal(theirs, want)
    # The uint32 view of the same ids (what the hex decode yields) hashes alike.
    as_u32 = torch.from_numpy(ids.view(np.uint32).astype(np.int64))
    assert np.array_equal(tabular.fuse_feature_ids(as_u32, buckets).numpy(), want)


@pytest.mark.parametrize("container", ["recordio", "text"])
def test_synthetic_criteo_copies_write_identical_bytes(tmp_path, container):
    ours, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    synthetic_criteo(ours, 300, seed=11, container=container)
    jax_synthetic_criteo(theirs, 300, seed=11, container=container)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()


def test_native_recordio_index_reads_and_crc(tmp_path):
    path = str(tmp_path / "data.rio")
    records = [b"hello", b"", b"x" * 10_000, bytes(range(256))] * 5
    write_records(path, records)
    reader = RecordIOReader(path)
    assert np.array_equal(reader.index(), JaxRecordIOReader(path).index())
    assert list(reader.read_range_packed(0, 20)) == records
    assert list(reader.read_range(3, 9)) == records[3:9]
    assert list(reader.read_range_packed(18, 99)) == records[18:]
    assert len(reader.read_range_packed(2, 2)) == 0
    assert host_store.recordio_verify_native(path, reader.index(), 0, 20) == -1
    raw = bytearray(open(path, "rb").read())
    raw[-3] ^= 0xFF
    open(path, "wb").write(bytes(raw))
    with pytest.raises(IOError, match="CRC"):
        RecordIOReader(path).read_range_packed(0, 20)
    assert host_store.recordio_verify_native(path, reader.index(), 0, 20) == 19


@pytest.mark.parametrize("threads", [0, 1, 2, 3, 4, 7])
def test_plan_chunks_matches_the_reference(threads):
    for start in (0, 5, 8192):
        for n in (0, 1, 7, 8, 9, 16, 31, 64, 100):
            for mb in (1, 4, 8):
                want = jingest.plan_chunks(start, start + n, mb, threads)
                assert ingest_pool.plan_chunks(start, start + n, mb, threads) == want
    assert ingest_pool.AUTO_THREADS_CAP == jingest.AUTO_THREADS_CAP
    assert ingest_pool.resolve_threads(threads) == jingest.resolve_threads(threads)


def _prep(path, threads, shard, mb=8):
    config = JobConfig(minibatch_size=mb, ingest_threads=threads)
    spec = deepfm.model_spec(buckets_per_feature=512, embedding_dim=4, hidden=(16,))
    worker = Worker(config, master=None, reader=RecordIODataReader(path), spec=spec, device="cpu")
    try:
        return worker._prep_fused_host(Task(0, shard)), worker.phases.snapshot()
    finally:
        worker._ingest.shutdown()


@pytest.mark.parametrize("n", [64, 61, 5], ids=["even", "ragged", "tail_only"])
def test_chunked_prep_gives_the_serial_bytes(tmp_path, n):
    path = str(tmp_path / "c.rio")
    synthetic_criteo(path, 80, seed=2, container="recordio")
    shard = Shard(path, 3, 3 + n)
    serial, _ = _prep(path, 1, shard)
    chunked, phases = _prep(path, 4, shard)
    assert (chunked.total, chunked.n_full) == (serial.total, serial.n_full) == (n, n // 8)
    for part in ("stacked", "tail"):
        a, b = getattr(serial, part), getattr(chunked, part)
        assert (a is None) == (b is None), part
        if a is not None:
            assert sorted(a) == sorted(b)
            for k in a:
                assert _same(a[k], b[k]), (part, k)
    if n // 8 >= 2:
        assert phases["decode_parallel"] > 0
    # The tail is the wrap-padded last minibatch with its mask.
    if n % 8:
        assert serial.tail["__mask__"].sum() == n % 8


def test_concurrent_first_builds_share_one_library(tmp_path):
    """Several processes building the library at once (the test runner's
    workers, a master and its workers): one compiles, the others wait on
    the lock and load its result; no temporary file is left behind."""
    build = str(tmp_path / "build")
    code = (
        "import sys\n"
        "from elasticdl_tpu_torch.ps import host_store\n"
        f"host_store.BUILD_DIR = {build!r}\n"
        "host_store._load()\n"
        "print(host_store.library_path())\n"
    )
    env = dict(os.environ, PYTHONPATH=_REPO)
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=_REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    paths = {out.strip() for out, _ in outs}
    assert len(paths) == 1 and os.path.dirname(paths.pop()) == build
    files = sorted(os.listdir(build))
    assert [f for f in files if f.endswith(".so")] == [
        os.path.basename(host_store.library_path())]
    assert not [f for f in files if f.endswith(".tmp")], files


def test_a_failed_build_raises(tmp_path):
    code = (
        "import os\n"
        "from elasticdl_tpu_torch.ps import host_store\n"
        f"host_store.BUILD_DIR = {str(tmp_path)!r}\n"
        "os.environ['CXX'] = 'false'\n"
        "try:\n"
        "    host_store.criteo_decode_native(bytearray(), [0])\n"
        "except RuntimeError as e:\n"
        "    print('RAISED', e)\n"
        "print('AVAILABLE', host_store.native_lib_available())\n"
    )
    env = dict(os.environ, PYTHONPATH=_REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "RAISED native lib unavailable" in proc.stdout
    assert "AVAILABLE False" in proc.stdout
