"""A minimal recordio-style container: the reference stores training data in
RecordIO files whose numbered records make range-sharding natural (SURVEY.md
§2 #14 [U]).  Format, per record:

    [uint32 payload_len][uint32 crc32(payload)][payload bytes]

little-endian, no compression.  Files carry a 8-byte magic header.  A sidecar
index is NOT required: ``RecordIOReader.index()`` scans once and caches record
offsets, so shard handout (record ranges) and ranged reads are O(1) after the
first scan.  The scan, the ranged reads and their CRC checks run in the
port's native library (``ps/host_store.py``, built at first use), as the
reference's bulk read does; the writer here is the format's source of truth.
"""

from __future__ import annotations

import os
import struct
import zlib
from collections import OrderedDict
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

from elasticdl_tpu_torch.common import locksan

MAGIC = b"EDLRIO\x00\x01"
_HDR = struct.Struct("<II")

#: Process-level offsets cache, keyed by ``(path, mtime_ns, size)``: the
#: e2e worker re-opens the same file once per task (and, since r9, once
#: per parallel ingest chunk), and every fresh ``RecordIOReader`` used to
#: pay the full index scan again.  Keying on mtime+size means an appended
#: or rewritten file can never serve a stale index — its old entry just
#: ages out.  Bounded LRU; offsets arrays are never written after
#: insertion, so sharing one across reader instances and threads is safe.
_INDEX_CACHE: "OrderedDict[Tuple[str, int, int], np.ndarray]" = OrderedDict()
_INDEX_CACHE_MAX = 64
_index_cache_lock = locksan.lock("_index_cache_lock", leaf=True)  # lock-order: leaf


class RecordIOWriter:
    def __init__(self, path: str):
        self._f = open(path, "wb")
        self._f.write(MAGIC)
        self._count = 0

    def write(self, payload: bytes) -> None:
        self._f.write(_HDR.pack(len(payload), zlib.crc32(payload)))
        self._f.write(payload)
        self._count += 1

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()

    def __enter__(self) -> "RecordIOWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def count(self) -> int:
        return self._count


class RecordIOReader:
    def __init__(self, path: str):
        self.path = path
        self._offsets: Optional[np.ndarray] = None
        with open(path, "rb") as f:
            if f.read(len(MAGIC)) != MAGIC:
                raise ValueError(f"{path}: not a recordio file")

    def index(self) -> np.ndarray:
        """Byte offset of each record (one native scan, shared process-wide
        through the ``(path, mtime, size)``-keyed cache — sub-chunk readers
        and per-task reader instances must not re-scan the same bytes)."""
        if self._offsets is None:
            from elasticdl_tpu_torch.ps.host_store import recordio_index_native

            st = os.stat(self.path)
            key = (self.path, st.st_mtime_ns, st.st_size)
            with _index_cache_lock:
                cached = _INDEX_CACHE.get(key)
                if cached is not None:
                    _INDEX_CACHE.move_to_end(key)
            if cached is not None:
                self._offsets = cached
                return cached
            offsets = recordio_index_native(self.path)
            offsets.flags.writeable = False
            with _index_cache_lock:
                _INDEX_CACHE[key] = offsets
                _INDEX_CACHE.move_to_end(key)
                while len(_INDEX_CACHE) > _INDEX_CACHE_MAX:
                    _INDEX_CACHE.popitem(last=False)
            self._offsets = offsets
        return self._offsets

    def __len__(self) -> int:
        return len(self.index())

    def read_range(self, start: int, end: int) -> Iterator[bytes]:
        """Yield records [start, end) by record index, CRC-checked."""
        return iter(self.read_range_packed(start, end))

    def read_range_packed(self, start: int, end: int):
        """Records [start, end) as one PackedRecords: one native bulk read
        with its CRC checks.  See data/packed.py for why the hot path avoids
        per-record objects."""
        from elasticdl_tpu_torch.data.packed import PackedRecords
        from elasticdl_tpu_torch.ps.host_store import recordio_read_native

        offsets = self.index()
        end = min(end, len(offsets))
        if start >= end:
            return PackedRecords(
                np.empty((0,), np.uint8), np.zeros((1,), np.int64)
            )
        buf, cum = recordio_read_native(
            self.path, offsets, start, end, os.path.getsize(self.path)
        )
        return PackedRecords(buf, cum)


def write_records(path: str, records: Sequence[bytes]) -> int:
    with RecordIOWriter(path) as w:
        for r in records:
            w.write(r)
        return w.count
