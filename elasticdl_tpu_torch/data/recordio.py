"""A minimal recordio-style container: the reference stores training data in
RecordIO files whose numbered records make range-sharding natural (SURVEY.md
§2 #14 [U]).  Format, per record:

    [uint32 payload_len][uint32 crc32(payload)][payload bytes]

little-endian, no compression.  Files carry a 8-byte magic header.  A sidecar
index is NOT required: ``RecordIOReader.index()`` scans once and caches record
offsets, so shard handout (record ranges) and ranged reads are O(1) after the
first scan.  A C++ scanner for the hot ingest path lives in
``elasticdl_tpu/ps/native`` (built lazily; this module is the pure-Python
fallback and the format's source of truth).
"""

from __future__ import annotations

import os
import struct
import zlib
from collections import OrderedDict
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from elasticdl_tpu_torch.common import locksan

MAGIC = b"EDLRIO\x00\x01"
_HDR = struct.Struct("<II")

#: Process-level offsets cache, keyed by ``(path, mtime_ns, size)``: the
#: e2e worker re-opens the same file once per task (and, since r9, once
#: per parallel ingest chunk), and every fresh ``RecordIOReader`` used to
#: pay the full index scan again.  Keying on mtime+size means an appended
#: or rewritten file can never serve a stale index — its old entry just
#: ages out.  Bounded LRU; offsets lists are append-only after insertion
#: (readers treat them as immutable), so sharing one list across reader
#: instances and threads is safe.
_INDEX_CACHE: "OrderedDict[Tuple[str, int, int], List[int]]" = OrderedDict()
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
        self._offsets: Optional[List[int]] = None
        with open(path, "rb") as f:
            if f.read(len(MAGIC)) != MAGIC:
                raise ValueError(f"{path}: not a recordio file")

    def index(self) -> List[int]:
        """Byte offset of each record (one-time scan, shared process-wide
        through the ``(path, mtime, size)``-keyed cache — sub-chunk readers
        and per-task reader instances must not re-scan the same bytes)."""
        if self._offsets is None:
            st = os.stat(self.path)
            key = (self.path, st.st_mtime_ns, st.st_size)
            with _index_cache_lock:
                cached = _INDEX_CACHE.get(key)
                if cached is not None:
                    _INDEX_CACHE.move_to_end(key)
            if cached is not None:
                self._offsets = cached
                return cached
            offsets = []
            size = st.st_size
            with open(self.path, "rb") as f:
                pos = len(MAGIC)
                while pos < size:
                    offsets.append(pos)
                    f.seek(pos)
                    length, _ = _HDR.unpack(f.read(_HDR.size))
                    pos += _HDR.size + length
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
        offsets = self.index()
        end = min(end, len(offsets))
        if start >= end:
            return
        with open(self.path, "rb") as f:
            f.seek(offsets[start])
            for _ in range(end - start):
                length, crc = _HDR.unpack(f.read(_HDR.size))
                payload = f.read(length)
                if zlib.crc32(payload) != crc:
                    raise IOError(f"{self.path}: CRC mismatch")
                yield payload

    def read_range_packed(self, start: int, end: int):
        """Records [start, end) as one PackedRecords (CRC-checked).
        See data/packed.py for why the hot path avoids per-record objects."""
        from elasticdl_tpu_torch.data.packed import PackedRecords

        offsets = self.index()
        end = min(end, len(offsets))
        if start >= end:
            return PackedRecords(
                np.empty((0,), np.uint8), np.zeros((1,), np.int64)
            )
        # The reference's bulk C++ read (ps/host_store.recordio_read_native)
        # comes with the PS host tier's slice of the port; its Python
        # fallback is the read here.
        return PackedRecords.from_records(list(self.read_range(start, end)))


def write_records(path: str, records: Sequence[bytes]) -> int:
    with RecordIOWriter(path) as w:
        for r in records:
            w.write(r)
        return w.count
