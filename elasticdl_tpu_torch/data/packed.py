"""Packed record batches: one contiguous buffer + cumulative offsets.

Copy of ``elasticdl_tpu/data/packed.py`` (numpy only).  A reader that can
returns a ``PackedRecords`` (one bulk read); feeds decode straight from its
buffer.  Everything else treats it as the ``Sequence[bytes]`` it
duck-types, so the packed form is an optimization, never a new contract.
"""

from __future__ import annotations

from typing import Iterator, Sequence, Union

import numpy as np


class PackedRecords(Sequence):
    """Immutable batch of variable-length records over one shared buffer.

    ``offsets`` has n+1 entries; record i is ``buf[offsets[i]:offsets[i+1]]``.
    Slicing returns a zero-copy view (shared buffer, sliced offsets);
    indexing returns ``bytes``.
    """

    __slots__ = ("buf", "offsets")

    def __init__(self, buf: np.ndarray, offsets: np.ndarray):
        self.buf = buf
        self.offsets = offsets

    @classmethod
    def from_records(cls, records: Sequence[bytes]) -> "PackedRecords":
        lens = np.fromiter((len(r) for r in records), np.int64, count=len(records))
        offsets = np.empty((len(records) + 1,), np.int64)
        offsets[0] = 0
        np.cumsum(lens, out=offsets[1:])
        buf = np.frombuffer(b"".join(records), np.uint8)
        return cls(buf, offsets)

    def __len__(self) -> int:
        return len(self.offsets) - 1

    def __getitem__(self, i: Union[int, slice]) -> Union[bytes, "PackedRecords"]:
        if isinstance(i, slice):
            start, stop, step = i.indices(len(self))
            if step != 1:
                raise ValueError("PackedRecords slices must be contiguous")
            return PackedRecords(self.buf, self.offsets[start : stop + 1])
        if i < 0:
            i += len(self)
        return bytes(self.buf[self.offsets[i] : self.offsets[i + 1]])

    def __iter__(self) -> Iterator[bytes]:
        for i in range(len(self)):
            yield self[i]

    def span(self) -> np.ndarray:
        """Zero-copy uint8 view of the concatenated payloads."""
        return self.buf[self.offsets[0] : self.offsets[-1]]


def concat_records(records: Sequence[bytes]) -> np.ndarray:
    """Concatenated payload bytes of any record sequence as a uint8 array —
    zero-copy for PackedRecords, one join otherwise."""
    if isinstance(records, PackedRecords):
        return records.span()
    return np.frombuffer(b"".join(records), np.uint8)
