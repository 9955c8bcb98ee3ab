"""The data files a cell trains on, written in bulk: the RecordIO framing
and the record encoders of the program's formats, as frozen copies.

Framing (``elasticdl_tpu_torch/data/recordio.py``): an 8-byte magic, then
per record ``[uint32 length][uint32 crc32(payload)][payload]``,
little-endian. Encoders (``elasticdl_tpu_torch/data/codecs.py``): a
language-model record is its ``seq_len + 1`` int32 tokens; a Criteo
record is the Kaggle TSV line ``label, 13 integers (blank when missing),
26 categorical ids as 8 hex digits``, tab-separated.
"""

from __future__ import annotations

import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np

MAGIC = b"EDLRIO\x00\x01"
#: Records encoded and framed at a time (bounds the host memory a write
#: takes to about a hundred MB).
CHUNK = 1 << 18


def _frame(chars: np.ndarray, keep: np.ndarray) -> np.ndarray:
    """Frame the records of a character matrix: row ``i`` holds record
    ``i``'s 8 header bytes (columns 0-7, filled here) and then its payload,
    the characters where ``keep`` is true. Returns the framed bytes."""
    out = chars[keep] if not keep.all() else chars.reshape(-1)
    sizes = keep.sum(axis=1) if not keep.all() else np.full(len(chars), chars.shape[1])
    heads = np.cumsum(sizes) - sizes
    view = memoryview(out)
    bounds = zip((heads + 8).tolist(), (heads + sizes).tolist())
    header = np.empty((len(chars), 2), "<u4")
    header[:, 0] = sizes - 8
    header[:, 1] = np.fromiter((zlib.crc32(view[s:e]) for s, e in bounds), np.uint32,
                               count=len(chars))
    out[(heads[:, None] + np.arange(8)).reshape(-1)] = header.view(np.uint8).reshape(-1)
    return out


def write_fixed(path: str, rows: np.ndarray) -> None:
    """One record a row of ``rows`` (any dtype, its bytes as they are)."""
    raw = np.ascontiguousarray(rows).view(np.uint8).reshape(len(rows), -1)
    with open(path, "wb") as f:
        f.write(MAGIC)
        for at in range(0, len(raw), CHUNK):
            part = raw[at:at + CHUNK]
            chars = np.empty((len(part), 8 + part.shape[1]), np.uint8)
            chars[:, 8:] = part
            _frame(chars, np.ones(chars.shape, bool)).tofile(f)


#: Decimal digits kept for an integer feature (values are clipped below
#: 10**DIGITS).
DIGITS = 9
#: The three decimal characters of 0..999, and the two hex characters of a byte.
_DIGITS3 = np.array([list(b"%03d" % i) for i in range(1000)], np.uint8)
_HEX2 = np.array([list(b"%02x" % i) for i in range(256)], np.uint8).view("<u2").reshape(256)


def criteo_tsv(labels: np.ndarray, dense: np.ndarray, cats: np.ndarray) -> tuple:
    """Kaggle TSV lines of ``labels`` [n] (0/1), ``dense`` [n, 13] int64
    (-1: missing, written blank) and ``cats`` [n, 26] uint32 raw ids, one
    row a record after 8 columns for its header: (characters, the mask of
    those that belong to the record)."""
    n, nd = dense.shape
    nc = cats.shape[1]
    num_at, hex_at = 9, 9 + nd * (1 + DIGITS)
    chars = np.empty((n, hex_at + nc * 9), np.uint8)
    keep = np.ones(chars.shape, bool)
    chars[:, 8] = ord("0") + labels.astype(np.uint8)
    num = chars[:, num_at:hex_at].reshape(n, nd, 1 + DIGITS)
    num_keep = keep[:, num_at:hex_at].reshape(n, nd, 1 + DIGITS)
    num[:, :, 0] = ord("\t")
    v = np.clip(dense, 0, 10**DIGITS - 1)
    for group in range(DIGITS // 3):  # three digits at a time, least significant first
        at = 1 + DIGITS - 3 * (group + 1)
        num[:, :, at:at + 3] = _DIGITS3[(v // 1000**group) % 1000]
    ndig = 1 + np.searchsorted(10 ** np.arange(1, DIGITS), v, side="right")
    ndig[dense < 0] = 0
    num_keep[:, :, 1:] = np.arange(DIGITS) >= (DIGITS - ndig)[..., None]
    hexes = chars[:, hex_at:].reshape(n, nc, 9)
    hexes[:, :, 0] = ord("\t")
    big_endian = cats.astype(">u4").view(np.uint8).reshape(n, nc, 4)
    hexes[:, :, 1:] = _HEX2[big_endian].view(np.uint8).reshape(n, nc, 8)
    return chars, keep


def write_criteo(path: str, labels: np.ndarray, dense: np.ndarray, cats: np.ndarray,
                 pool: Optional[ThreadPoolExecutor] = None) -> None:
    """Criteo records, chunks encoded on ``pool``'s threads (numpy drops
    the interpreter lock) and written in order."""
    def framed(at: int) -> np.ndarray:
        sl = slice(at, at + CHUNK)
        return _frame(*criteo_tsv(labels[sl], dense[sl], cats[sl]))

    starts = range(0, len(labels), CHUNK)
    with open(path, "wb") as f:
        f.write(MAGIC)
        for part in (pool.map(framed, starts) if pool else map(framed, starts)):
            part.tofile(f)
