"""Record codecs of the port — the Criteo and language-modeling codecs of
``elasticdl_tpu/data/codecs.py`` (numpy only).  The other models' codecs
come with their slices of the port.

Criteo is the Kaggle TSV, ``label\t13 ints\t26 hex cat ids`` with blanks
allowed (missing values).  Its feeds decode through the native library
(``ps/host_store.py``) and raise when it cannot be built; the Python
decode (``criteo_feed_plain``, ``criteo_feed_pre_plain``) is the format's
source of truth, kept for the tests that hold the native decode to it.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from elasticdl_tpu_torch.data.packed import as_packed, concat_records

# ---------------- criteo (deepfm) ----------------

_CRITEO_DENSE = 13
_CRITEO_CAT = 26


def encode_criteo_example(
    label: int, dense: Sequence[float], cats: Sequence[int]
) -> bytes:
    fields = [str(label)]
    fields += ["" if d is None else str(int(d)) for d in dense]
    fields += ["%08x" % (c & 0xFFFFFFFF) for c in cats]
    return "\t".join(fields).encode()


def criteo_feed(records: Sequence[bytes]) -> dict:
    """Criteo TSV -> batch (dense float32, cat int32 = the hex id's bits,
    labels int32), decoded by the native library."""
    from elasticdl_tpu_torch.ps.host_store import criteo_decode_native

    packed = as_packed(records)
    labels, dense, cat = criteo_decode_native(packed.buf, packed.offsets)
    return {"dense": dense, "cat": cat, "labels": labels}


def criteo_feed_pre(records: Sequence[bytes], buckets: int) -> dict:
    """Criteo TSV -> PREPROCESSED batch: DeepFM's feature transforms
    (``models.tabular.hash_buckets`` and ``log_normalize``) fused into the
    native parse, in compact wire dtypes (labels uint8, dense float16 log1p,
    cat uint16 bucket ids): 79 bytes an example against the raw feed's 160."""
    from elasticdl_tpu_torch.ps.host_store import criteo_decode_pre_native

    packed = as_packed(records)
    labels, dense, cat = criteo_decode_pre_native(packed.buf, packed.offsets, buckets)
    return {"dense": dense, "cat": cat, "labels": labels}


def criteo_feed_plain(records: Sequence[bytes]) -> dict:
    """The Python decode of :func:`criteo_feed`: the format's source of
    truth (the reference measured it at 692 ms per 8192 records)."""
    n = len(records)
    dense = np.zeros((n, _CRITEO_DENSE), np.float32)
    cat = np.zeros((n, _CRITEO_CAT), np.int32)
    labels = np.zeros((n,), np.int32)
    for i, rec in enumerate(records):
        parts = rec.decode().split("\t")
        labels[i] = int(parts[0])
        for j, v in enumerate(parts[1 : 1 + _CRITEO_DENSE]):
            dense[i, j] = float(v) if v else 0.0
        for j, v in enumerate(parts[1 + _CRITEO_DENSE :]):
            cat[i, j] = np.int32(np.uint32(int(v, 16))) if v else 0
    return {"dense": dense, "cat": cat, "labels": labels}


def criteo_feed_pre_plain(records: Sequence[bytes], buckets: int) -> dict:
    """The numpy transforms of :func:`criteo_feed_pre` over the Python
    decode."""
    raw = criteo_feed_plain(records)
    h = raw["cat"].astype(np.uint32) * np.uint32(2654435761)
    h ^= h >> np.uint32(16)
    return {
        "dense": np.log1p(np.maximum(raw["dense"], 0.0)).astype(np.float16),
        "cat": (h % np.uint32(buckets)).astype(np.uint16),
        "labels": raw["labels"].astype(np.uint8),
    }


# ---------------- language modeling (transformer_lm) ----------------


def encode_lm_example(tokens: np.ndarray) -> bytes:
    """One training sequence of S+1 int32 token ids (the +1 supplies the
    next-token labels; the feed splits tokens[:-1] / tokens[1:], so the
    label shift never crosses a sequence-parallel shard boundary)."""
    return np.ascontiguousarray(tokens, np.int32).tobytes()


def lm_feed(records: Sequence[bytes]) -> dict:
    buf = concat_records(records).view(np.int32)
    seq_plus_1 = len(records[0]) // 4
    seqs = buf.reshape(len(records), seq_plus_1)
    return {
        "tokens": np.ascontiguousarray(seqs[:, :-1]),
        "labels": np.ascontiguousarray(seqs[:, 1:]),
    }
