"""The port's SQLite table reader (``elasticdl_tpu_torch/data/table.py``,
the ODPS-table parity path): the reference's ``tests/test_table_reader.py``
cases against the port's reader, records equal to the reference reader's,
and the census job reading its training data from a table, through the
port and through the JAX package on the same database.

The job: Wide&Deep at ``buckets=64, hidden=8``, f32, under the
ParameterServer strategy (a world of one), 128 census rows in tasks of 2
minibatches of 16, prep-ahead with ``prep_depth=2`` (the table reader
declares no ``thread_safe_ranges``, so both workers prep on one thread),
the port starting from the JAX job's initial weights.  Each task's
reported training loss agrees within 1e-5 absolute, the reference's PS
tolerance (``tests/test_model_zoo.py:127``).
"""

import sqlite3

import jax
import numpy as np
import pytest

import elasticdl_tpu.parallel  # noqa: F401  (the JAX package's own import order)
from elasticdl_tpu.common.config import JobConfig as JaxJobConfig
from elasticdl_tpu.data.reader import create_data_reader as jax_create_data_reader
from elasticdl_tpu.data.table import TableDataReader as JaxTableDataReader
from elasticdl_tpu.master.servicer import MasterServicer as JaxMasterServicer
from elasticdl_tpu.master.task_dispatcher import TaskDispatcher as JaxTaskDispatcher
from elasticdl_tpu.models.spec import load_model_spec as jax_load_model_spec
from elasticdl_tpu.parallel.mesh import create_mesh
from elasticdl_tpu.parallel.trainer import Trainer as JaxTrainer
from elasticdl_tpu.worker.worker import DirectMasterProxy as JaxDirectMasterProxy
from elasticdl_tpu.worker.worker import Worker as JaxWorker
from elasticdl_tpu_torch.common.config import JobConfig
from elasticdl_tpu_torch.data.reader import CompositeDataReader, create_data_reader
from elasticdl_tpu_torch.data.synthetic import generate
from elasticdl_tpu_torch.data.table import TableDataReader, write_table
from elasticdl_tpu_torch.master.servicer import MasterServicer
from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
from elasticdl_tpu_torch.models.spec import load_model_spec
from elasticdl_tpu_torch.parallel import trainer as ttrainer
from elasticdl_tpu_torch.worker.worker import DirectMasterProxy, Worker

CENSUS_COLUMNS = ["label", "age", "education_num", "capital_gain", "capital_loss",
                  "hours_per_week", "workclass", "education", "marital_status", "occupation",
                  "relationship", "race", "sex", "native_country", "extra_cat"]
LOSS_ABS = 1e-5


@pytest.fixture()
def db(tmp_path):
    path = str(tmp_path / "data.db")
    rows = [(i, f"name{i}", i * 0.5) for i in range(25)]
    write_table(path, rows, ["id", "name", "score"])
    return path


def test_shards_and_ranges(db):
    reader = TableDataReader(db)
    shards = reader.create_shards(10)
    assert [(s.start, s.end) for s in shards] == [(0, 10), (10, 20), (20, 25)]
    assert shards[0].name.endswith("#records")
    recs = list(reader.read_records(shards[1]))
    assert len(recs) == 10
    assert recs[0] == b"10,name10,5.0"
    assert reader.thread_safe_ranges is False


def test_records_equal_the_reference_readers(db):
    ours, theirs = TableDataReader(db), JaxTableDataReader(db)
    assert ours.sources() == theirs.sources()
    for a, b in zip(ours.create_shards(7), theirs.create_shards(7)):
        assert (a.name, a.start, a.end) == (b.name, b.start, b.end)
        assert list(ours.read_records(a)) == list(theirs.read_records(b))


def test_column_selection_and_delimiter(db):
    reader = TableDataReader(db, columns=["score", "id"], delimiter="\t")
    [shard] = reader.create_shards(100)
    recs = list(reader.read_records(shard))
    assert recs[3] == b"1.5\t3"


def test_unknown_column_and_table(db):
    with pytest.raises(ValueError, match="unknown columns"):
        TableDataReader(db, columns=["nope"])
    with pytest.raises(ValueError, match="no table"):
        TableDataReader(db, table="nope")


def test_multi_table_requires_selection(tmp_path):
    path = str(tmp_path / "multi.db")
    write_table(path, [(1,)], ["a"], table="t1")
    conn = sqlite3.connect(path)
    conn.execute("CREATE TABLE t2 (b)")
    conn.commit()
    conn.close()
    with pytest.raises(ValueError, match="several tables"):
        TableDataReader(path)
    reader = TableDataReader(path, table="t1")
    assert reader.sources() == [f"{path}#t1"]


def test_create_data_reader_sniffs_sqlite(db):
    reader = create_data_reader(db)
    assert isinstance(reader, TableDataReader)
    # path#table selection through the factory
    reader2 = create_data_reader(f"{db}#records")
    [shard] = reader2.create_shards(1000)
    assert shard.size == 25
    assert isinstance(create_data_reader(db, {"format": "table"}), TableDataReader)


def test_composite_routing_across_table_and_csv(db, tmp_path):
    csv = tmp_path / "extra.csv"
    csv.write_text("x,y\n1,2\n")
    composite = CompositeDataReader([create_data_reader(db), create_data_reader(str(csv))])
    assert composite.thread_safe_ranges is False  # the table reader is not
    shards = composite.create_shards(100)
    by_source = {s.name: s for s in shards}
    assert len(by_source) == 2
    for shard in shards:
        assert list(composite.read_records(shard))


def test_sparse_rowids_after_deletion(tmp_path):
    """Deleted rows break rowid density; the reader falls back to OFFSET
    pagination and still serves every surviving row exactly once."""
    path = str(tmp_path / "holes.db")
    write_table(path, [(i,) for i in range(30)], ["v"])
    conn = sqlite3.connect(path)
    conn.execute("DELETE FROM records WHERE v % 3 = 0")
    conn.commit()
    conn.close()
    reader = TableDataReader(path)
    shards = reader.create_shards(7)
    got = [r for s in shards for r in reader.read_records(s)]
    assert sorted(int(r) for r in got) == [i for i in range(30) if i % 3 != 0]


def test_filename_with_hash_char(tmp_path):
    """'#' in a real filename is not taken for the table-name syntax."""
    weird = tmp_path / "part#1.csv"
    weird.write_text("a,b\nc,d\n")
    reader = create_data_reader(str(weird))
    [shard] = reader.create_shards(10)
    assert list(reader.read_records(shard)) == [b"a,b", b"c,d"]


def test_db_directory_composite(tmp_path):
    d = tmp_path / "dbs"
    d.mkdir()
    write_table(str(d / "a.db"), [(1,), (2,)], ["x"])
    write_table(str(d / "b.db"), [(3,)], ["x"])
    reader = create_data_reader(str(d))
    assert isinstance(reader, CompositeDataReader)
    shards = reader.create_shards(10)
    got = sorted(int(r) for s in shards for r in reader.read_records(s))
    assert got == [1, 2, 3]


def test_null_values_serialize_empty(tmp_path):
    path = str(tmp_path / "nulls.db")
    write_table(path, [(1, None), (None, "b")], ["a", "b"])
    reader = TableDataReader(path)
    [shard] = reader.create_shards(10)
    assert list(reader.read_records(shard)) == [b"1,", b",b"]


def test_reads_from_another_thread_use_their_own_connection(db):
    """One connection a thread: a read on a prep thread does not share the
    constructing thread's connection."""
    from concurrent.futures import ThreadPoolExecutor

    reader = TableDataReader(db)
    [shard] = reader.create_shards(100)
    main = reader._conn()
    with ThreadPoolExecutor(1) as pool:
        other = pool.submit(reader._conn).result()
        recs = pool.submit(lambda: list(reader.read_records(shard))).result()
    assert other is not main and len(recs) == 25


# ---- the census job from a table -------------------------------------------------


class _Recording:
    def __init__(self, proxy):
        self._proxy = proxy
        self.losses = []

    def call(self, method, request):
        if (method == "ReportTaskResult" and request["success"]
                and request.get("task_type") == "training"):
            self.losses.append(request["metrics"]["loss"])
        return self._proxy.call(method, request)


def _census_db(tmp_path, n):
    csv_path = str(tmp_path / "census.csv")
    generate("census", csv_path, n)
    with open(csv_path) as f:
        rows = [line.split(",") for line in f.read().splitlines() if line]
    path = str(tmp_path / "census.db")
    write_table(path, rows, CENSUS_COLUMNS)
    return path


_JOB = dict(model_def="wide_deep.model_spec",
            model_params="compute_dtype=float32;buckets=64;hidden=8",
            minibatch_size=16, num_minibatches_per_task=2,
            distribution_strategy="ParameterServer", task_pipelining=True, prep_depth=2)


def test_census_job_from_table_matches_the_jax_job(tmp_path, monkeypatch):
    path = _census_db(tmp_path, 128)
    per_task = _JOB["minibatch_size"] * _JOB["num_minibatches_per_task"]

    jconfig = JaxJobConfig(training_data=path, **_JOB)
    jspec = jax_load_model_spec("elasticdl_tpu.models", "wide_deep.model_spec",
                                **jconfig.parsed_model_params())
    jreader = jax_create_data_reader(path)
    jservicer = JaxMasterServicer(JaxTaskDispatcher(jreader.create_shards(per_task), num_epochs=1))
    jmaster = _Recording(JaxDirectMasterProxy(jservicer))
    jworker = JaxWorker(jconfig, jmaster, jreader, worker_id="w0", spec=jspec,
                        devices=jax.devices()[:1])
    jresult = jworker.run()

    params = jax.device_get(
        JaxTrainer(jspec, JaxJobConfig(distribution_strategy="ParameterServer"),
                   create_mesh(jax.devices(), num_devices=1))
        .init_state(jax.random.key(0)).params)
    orig = ttrainer.Trainer.init_state

    def init_state(self, seed):
        state = orig(self, seed)
        state.model.load_jax_params(params)
        return state

    monkeypatch.setattr(ttrainer.Trainer, "init_state", init_state)
    config = JobConfig(training_data=path, **_JOB)
    spec = load_model_spec("elasticdl_tpu_torch.models", "wide_deep.model_spec",
                           **config.parsed_model_params())
    reader = create_data_reader(path)
    assert isinstance(reader, TableDataReader)
    servicer = MasterServicer(TaskDispatcher(reader.create_shards(per_task), num_epochs=1))
    master = _Recording(DirectMasterProxy(servicer))
    worker = Worker(config, master, reader, worker_id="w0", spec=spec, device="cpu")
    assert worker.trainer.sharded_embeddings
    result = worker.run()

    assert result["tasks_done"] == jresult["tasks_done"] == 4
    assert result["step"] == int(jworker.state.step) == 8
    assert servicer.job_finished() and jservicer.job_finished()
    assert len(master.losses) == len(jmaster.losses) == 4
    np.testing.assert_allclose(master.losses, jmaster.losses, rtol=0, atol=LOSS_ABS)
