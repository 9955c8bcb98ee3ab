"""Table data reader — the port's copy of ``elasticdl_tpu/data/table.py``,
the ODPS/MaxCompute-table parity path.

The reference ships an ODPS table reader next to RecordIO and CSV: a
columnar source addressed by (table, start row, end row) ranges with
optional column selection, the shape its dynamic sharding needs.  This
keeps the contract against SQLite (stdlib): a local ``.db`` file stands in
for the remote table service, rows are addressed by rank (dense ``rowid``
order), and the selected columns are serialized to CSV bytes, so the
model-zoo feeds parse table records and file records alike.

The reader holds one connection a thread (``threading.local``) and
declares ``thread_safe_ranges = False``: the worker preps its tasks on one
thread and never splits a task's range over the ingest pool
(``worker/worker.py``).
"""

from __future__ import annotations

import os
import sqlite3
import threading
from typing import Iterator, List, Optional, Sequence

from elasticdl_tpu_torch.data.reader import AbstractDataReader, Shard, _range_shards


def _connect(path: str) -> sqlite3.Connection:
    # URI mode=ro keeps workers from ever locking the table for writers.
    return sqlite3.connect(f"file:{path}?mode=ro", uri=True, check_same_thread=False)


class TableDataReader(AbstractDataReader):
    """Range-addressable rows of one SQLite table.

    ``data_path`` is the database file.  ``table`` defaults to the file's
    one table (an error if there are several).  ``columns`` selects and
    orders the fields serialized into each record (default: schema order).
    ``delimiter`` joins the fields (default ``,``, the CSV feeds').

    Shard names are ``<path>#<table>``, so a ``CompositeDataReader`` can
    route between several tables (or tables and files) in one job.
    """

    thread_safe_ranges = False

    def __init__(
        self,
        data_path: str,
        table: str = "",
        columns: Optional[Sequence[str]] = None,
        delimiter: str = ",",
        **_,
    ):
        if not os.path.isfile(data_path):
            raise FileNotFoundError(f"table database not found: {data_path}")
        self._path = data_path
        self._delim = delimiter
        # One connection a thread: a reader's calls may come from a prep
        # thread and the task loop.
        self._local = threading.local()
        conn = self._conn()
        tables = [
            r[0]
            for r in conn.execute(
                "SELECT name FROM sqlite_master WHERE type='table' "
                "AND name NOT LIKE 'sqlite_%' ORDER BY name"
            )
        ]
        if not tables:
            raise ValueError(f"{data_path}: no tables")
        if table:
            if table not in tables:
                raise ValueError(f"{data_path}: no table {table!r} (has {tables})")
            self._table = table
        elif len(tables) == 1:
            self._table = tables[0]
        else:
            raise ValueError(
                f"{data_path} holds several tables {tables}; pass "
                "data_reader_params 'table=...'"
            )
        schema = [r[1] for r in conn.execute(f'PRAGMA table_info("{self._table}")')]
        if columns:
            unknown = [c for c in columns if c not in schema]
            if unknown:
                raise ValueError(f"unknown columns {unknown} (schema: {schema})")
            self._columns = list(columns)
        else:
            self._columns = schema
        count, lo, hi = conn.execute(
            f'SELECT COUNT(*), MIN(rowid), MAX(rowid) FROM "{self._table}"'
        ).fetchone()
        self._count = count
        # Dense rowids (no deletions) let a shard read by an index-backed
        # rowid BETWEEN, O(log n + rows), instead of OFFSET's O(start) skip
        # walk, which would make an epoch quadratic in the table's size.
        self._dense_rowids = count > 0 and (hi - lo + 1 == count)
        self._rowid_base = lo if self._dense_rowids else 0

    def _conn(self) -> sqlite3.Connection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = _connect(self._path)
            self._local.conn = conn
        return conn

    @property
    def source_name(self) -> str:
        return f"{self._path}#{self._table}"

    def create_shards(self, records_per_shard: int) -> List[Shard]:
        return _range_shards({self.source_name: self._count}, records_per_shard)

    def read_records(self, shard: Shard) -> Iterator[bytes]:
        cols = ", ".join(f'"{c}"' for c in self._columns)
        if self._dense_rowids:
            # Index-backed seek: rank r lives at rowid base + r.
            rows = self._conn().execute(
                f'SELECT {cols} FROM "{self._table}" '
                "WHERE rowid BETWEEN ? AND ? ORDER BY rowid",
                (self._rowid_base + shard.start, self._rowid_base + shard.end - 1),
            )
        else:
            # Sparse rowids (the table had deletions): OFFSET pagination,
            # which scans past ``start`` rows.
            rows = self._conn().execute(
                f'SELECT {cols} FROM "{self._table}" ORDER BY rowid LIMIT ? OFFSET ?',
                (shard.end - shard.start, shard.start),
            )
        for row in rows:
            yield self._delim.join("" if v is None else str(v) for v in row).encode()

    def sources(self) -> List[str]:
        return [self.source_name]


def write_table(
    path: str,
    rows: Sequence[Sequence],
    columns: Sequence[str],
    table: str = "records",
) -> None:
    """Create or replace a table from rows: test fixtures and the
    synthetic data's table form."""
    conn = sqlite3.connect(path)
    try:
        cols = ", ".join(f'"{c}"' for c in columns)
        conn.execute(f'DROP TABLE IF EXISTS "{table}"')
        conn.execute(f'CREATE TABLE "{table}" ({cols})')
        marks = ", ".join("?" for _ in columns)
        conn.executemany(f'INSERT INTO "{table}" VALUES ({marks})', rows)
        conn.commit()
    finally:
        conn.close()
