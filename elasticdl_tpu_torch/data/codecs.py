"""Record codecs of the port — ``elasticdl_tpu/data/codecs.py`` (numpy
only): serialized examples <-> host numpy batches, each model's
``ModelSpec.feed``.

- mnist/cifar10: raw bytes, the image's uint8s then one label byte.
- criteo: the Kaggle TSV, ``label\t13 ints\t26 hex cat ids`` with blanks
  allowed (missing values).
- census: CSV, ``label,5 numerics,9 categorical strings``.  The strings
  map to stable int ids on the host by the preprocessing Hashing layer's
  string hash (crc32 into a 31-bit space); the model re-buckets them on
  the device (``models/tabular.py``).

The Criteo and census feeds decode through the native library
(``ps/host_store.py``) and raise when it cannot be built; the Python
decodes (``criteo_feed_plain``, ``criteo_feed_pre_plain``,
``census_feed_plain``) are the formats' source of truth, kept for the
tests that hold the native decode to them.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from elasticdl_tpu_torch.data.packed import as_packed, concat_records

# ---------------- image families ----------------


def encode_image_example(image: np.ndarray, label: int) -> bytes:
    return np.ascontiguousarray(image, dtype=np.uint8).tobytes() + bytes([label])


def _image_feed(records: Sequence[bytes], shape) -> dict:
    n = int(np.prod(shape))
    buf = concat_records(records).reshape(-1, n + 1)
    images = buf[:, :n].reshape((-1,) + shape).astype(np.float32) / 255.0
    labels = buf[:, n].astype(np.int32)
    return {"images": images, "labels": labels}


def mnist_feed(records: Sequence[bytes]) -> dict:
    """MNIST records -> ``images`` float32 [n, 28, 28, 1] in [0, 1] (HWC,
    the reference's layout), ``labels`` int32."""
    return _image_feed(records, (28, 28, 1))


def cifar10_feed(records: Sequence[bytes]) -> dict:
    """CIFAR-10 records -> ``images`` float32 [n, 32, 32, 3] in [0, 1]
    (HWC), ``labels`` int32."""
    return _image_feed(records, (32, 32, 3))


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


# ---------------- census (wide&deep) ----------------

_CENSUS_DENSE = 5
_CENSUS_CAT = 9
#: The string hash's range: a 31-bit id space, re-bucketed on the device.
CENSUS_HASH_BINS = 1 << 31


def encode_census_example(label: int, dense: Sequence[float], cats: Sequence[str]) -> bytes:
    fields = [str(label)] + [str(float(d)) for d in dense] + list(cats)
    return ",".join(fields).encode()


def census_feed(records: Sequence[bytes]) -> dict:
    """Census CSV -> batch (dense float32, cat int32 string hashes, labels
    int32), decoded by the native library with the preprocessing layers'
    semantics (``ToNumber``, ``Hashing``)."""
    from elasticdl_tpu_torch.ps.host_store import census_decode_native

    packed = as_packed(records)
    labels, dense, cat = census_decode_native(packed.buf, packed.offsets, CENSUS_HASH_BINS)
    return {"dense": dense, "cat": cat, "labels": labels}


def census_feed_plain(records: Sequence[bytes]) -> dict:
    """The preprocessing-layer decode of :func:`census_feed` (``ToNumber``
    and ``Hashing``): the format's source of truth."""
    from elasticdl_tpu_torch.preprocessing import Hashing, ToNumber

    to_number = ToNumber(out_dtype="float32", default=0.0)
    hashing = Hashing(CENSUS_HASH_BINS)
    n = len(records)
    dense_raw = np.empty((n, _CENSUS_DENSE), object)
    cat_raw = np.empty((n, _CENSUS_CAT), object)
    labels = np.zeros((n,), np.int32)
    for i, rec in enumerate(records):
        parts = rec.decode().split(",")
        labels[i] = int(parts[0])
        dense_raw[i] = parts[1 : 1 + _CENSUS_DENSE]
        cat_raw[i] = [v.strip() for v in parts[1 + _CENSUS_DENSE :]]
    return {
        "dense": to_number(dense_raw),
        "cat": hashing(cat_raw).astype(np.int32),
        "labels": labels,
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
