"""Shardable data readers.

Reference parity (SURVEY.md §2 #14 [U — mount empty at survey time]): the
master calls ``create_shards()`` to enumerate (name, start, end) ranges that
become dispatchable tasks; workers call ``read_records(shard)`` for the range
a task names.  Epoch/task logic lives in the master's TaskDispatcher, NOT
here — readers are stateless range servers, which is what makes a preempted
worker's work requeue-able with no data loss.
"""

from __future__ import annotations

import dataclasses
import glob
import os
from typing import Dict, Iterator, List, Optional

from elasticdl_tpu_torch.data.recordio import RecordIOReader


@dataclasses.dataclass(frozen=True)
class Shard:
    """A half-open record range [start, end) within a named source."""

    name: str
    start: int
    end: int

    @property
    def size(self) -> int:
        return self.end - self.start


class AbstractDataReader:
    """Stateless, range-addressable record source."""

    #: True when concurrent ``read_records``/``read_records_packed`` calls
    #: on DISJOINT ranges of one source are safe from multiple threads —
    #: the opt-in the worker's parallel ingest (data/ingest_pool.py)
    #: requires before splitting a task's range across pool threads.
    #: File-backed readers open a fresh handle per read, so they qualify;
    #: readers holding a shared connection (sqlite tables) do not.
    thread_safe_ranges = False

    def create_shards(self, records_per_shard: int) -> List[Shard]:
        raise NotImplementedError

    def read_records(self, shard: Shard) -> Iterator[bytes]:
        raise NotImplementedError

    def sources(self) -> List[str]:
        """The source names this reader can serve shards for."""
        raise NotImplementedError


def _expand(path_spec: str) -> List[str]:
    """A data path may be a file, a directory, or a glob."""
    if os.path.isdir(path_spec):
        files = sorted(
            os.path.join(path_spec, f) for f in os.listdir(path_spec)
        )
    else:
        files = sorted(glob.glob(path_spec)) or [path_spec]
    missing = [f for f in files if not os.path.isfile(f)]
    if missing:
        raise FileNotFoundError(f"data files not found: {missing}")
    return files


def _range_shards(sizes: Dict[str, int], records_per_shard: int) -> List[Shard]:
    shards = []
    for name, total in sizes.items():
        for start in range(0, total, records_per_shard):
            shards.append(Shard(name, start, min(start + records_per_shard, total)))
    return shards


class RecordIODataReader(AbstractDataReader):
    thread_safe_ranges = True  # per-read file handles; shared offsets index

    def __init__(self, data_path: str, **_):
        self._readers = {p: RecordIOReader(p) for p in _expand(data_path)}

    def create_shards(self, records_per_shard: int) -> List[Shard]:
        sizes = {p: len(r) for p, r in self._readers.items()}
        return _range_shards(sizes, records_per_shard)

    def read_records(self, shard: Shard) -> Iterator[bytes]:
        return self._readers[shard.name].read_range(shard.start, shard.end)

    def read_records_packed(self, shard: Shard):
        """Bulk packed read (data/packed.py) — the worker's ingest hot path
        uses this when a reader offers it; others fall back to
        ``read_records``."""
        return self._readers[shard.name].read_range_packed(
            shard.start, shard.end
        )

    def sources(self) -> List[str]:
        return sorted(self._readers)


class CSVDataReader(AbstractDataReader):
    """Text files, one record per line; ranges address line numbers.

    ``skip_header=True`` drops the first line of each file.  Line offsets are
    indexed once per file (same trade as the recordio scan).
    """

    # Per-read file handles; a cold offsets index built concurrently is an
    # idempotent double-compute (both threads assign equal lists), not a
    # correctness hazard.
    thread_safe_ranges = True

    def __init__(self, data_path: str, skip_header: bool = False, **_):
        self._files = _expand(data_path)
        self._skip = 1 if skip_header else 0
        self._index: Dict[str, List[int]] = {}

    def _offsets(self, path: str) -> List[int]:
        if path not in self._index:
            offsets = []
            with open(path, "rb") as f:
                pos = f.tell()
                for line in f:
                    offsets.append(pos)
                    pos += len(line)
            self._index[path] = offsets[self._skip :]
        return self._index[path]

    def create_shards(self, records_per_shard: int) -> List[Shard]:
        sizes = {p: len(self._offsets(p)) for p in self._files}
        return _range_shards(sizes, records_per_shard)

    def read_records(self, shard: Shard) -> Iterator[bytes]:
        offsets = self._offsets(shard.name)
        # Clamp like the recordio reader: an over-long range must not yield
        # phantom empty records past EOF.
        end = min(shard.end, len(offsets))
        if shard.start >= end:
            return
        with open(shard.name, "rb") as f:
            f.seek(offsets[shard.start])
            for _ in range(end - shard.start):
                yield f.readline().rstrip(b"\r\n")

    def read_records_packed(self, shard: Shard):
        """One bulk read + C-level newline split instead of a readline loop
        (data/packed.py: the per-record interpreter overhead rivals the
        device step at recommendation batch sizes)."""
        from elasticdl_tpu_torch.data.packed import PackedRecords

        offsets = self._offsets(shard.name)
        n = min(shard.end, len(offsets)) - shard.start
        if n <= 0:
            import numpy as np

            return PackedRecords(
                np.empty((0,), np.uint8), np.zeros((1,), np.int64)
            )
        with open(shard.name, "rb") as f:
            f.seek(offsets[shard.start])
            end = (
                offsets[shard.end]
                if shard.end < len(offsets)
                else os.path.getsize(shard.name)
            )
            span = f.read(end - offsets[shard.start])
        lines = span.split(b"\n")[:n]
        return PackedRecords.from_records([l.rstrip(b"\r\n") for l in lines])

    def sources(self) -> List[str]:
        return list(self._files)


class CompositeDataReader(AbstractDataReader):
    """Routes shards by source name across several readers.

    A worker serves training AND evaluation (and prediction) tasks from one
    task queue, but those tasks' shards name files from different datasets;
    this reader dispatches each shard to the reader that owns its source.
    """

    def __init__(self, readers: List[AbstractDataReader]):
        self._readers = list(readers)
        self._by_source: Dict[str, AbstractDataReader] = {}
        for reader in self._readers:
            for source in reader.sources():
                self._by_source[source] = reader
        # Parallel range reads are only safe when EVERY routed reader is.
        self.thread_safe_ranges = all(
            getattr(r, "thread_safe_ranges", False) for r in self._readers
        )

    def create_shards(self, records_per_shard: int) -> List[Shard]:
        return [
            s for r in self._readers for s in r.create_shards(records_per_shard)
        ]

    def read_records(self, shard: Shard) -> Iterator[bytes]:
        reader = self._by_source.get(shard.name)
        if reader is None:
            raise KeyError(f"no reader serves source {shard.name!r}")
        return reader.read_records(shard)

    def read_records_packed(self, shard: Shard):
        """Forward the packed fast path when the owning reader has one,
        else None (the worker then uses ``read_records``)."""
        reader = self._by_source.get(shard.name)
        if reader is None:
            raise KeyError(f"no reader serves source {shard.name!r}")
        fast = getattr(reader, "read_records_packed", None)
        return fast(shard) if fast is not None else None

    def sources(self) -> List[str]:
        return sorted(self._by_source)


def _split_table_path(data_path: str) -> tuple:
    """Split ``db.sqlite#tablename`` — but only when the full string isn't
    itself an existing path, so filenames containing '#' keep working."""
    if os.path.exists(data_path):
        return data_path, ""
    path, _, table = data_path.partition("#")
    return path, table


#: The SQLite file header (``elasticdl_tpu/data/table.py``), for sniffing.
SQLITE_MAGIC = b"SQLite format 3\x00"


def _make_table_reader(data_path: str, **params) -> AbstractDataReader:
    raise NotImplementedError(
        f"{data_path}: the SQLite table reader (data/table.py) is not ported "
        "yet (ROADMAP, PyTorch port queue: the other zoo models)"
    )


_READERS = {
    "recordio": RecordIODataReader,
    "csv": CSVDataReader,
    "text": CSVDataReader,
    "table": _make_table_reader,  # ODPS-table parity (SQLite-backed)
    "sqlite": _make_table_reader,
}


def create_data_reader(
    data_path: str, reader_params: Optional[dict] = None
) -> AbstractDataReader:
    """Build a reader for ``data_path``.

    ``reader_params`` (the config's ``--data_reader_params``) may carry
    ``format=recordio|csv|table`` plus reader kwargs; default is sniffed
    from the first file's magic bytes.
    """
    params = dict(reader_params or {})
    fmt = params.pop("format", None)
    if fmt is None:
        first = _expand(_split_table_path(data_path)[0])[0]
        with open(first, "rb") as f:
            from elasticdl_tpu_torch.data.recordio import MAGIC

            head = f.read(max(len(MAGIC), len(SQLITE_MAGIC)))
        if head.startswith(MAGIC):
            fmt = "recordio"
        elif head.startswith(SQLITE_MAGIC):
            fmt = "table"
        else:
            fmt = "csv"
    if fmt not in _READERS:
        raise ValueError(f"unknown data format {fmt!r}, pick from {sorted(_READERS)}")
    return _READERS[fmt](data_path, **params)
