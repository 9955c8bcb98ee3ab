"""Preprocessing layer implementations — the port of
``elasticdl_tpu/preprocessing/layers.py``.

Every layer follows the same contract:

- ``adapt(batches)``: an optional fit pass over an iterable of numpy arrays
  (or one array), accumulated incrementally so a dataset of any size
  streams through;
- ``__call__(x)``: a pure transform.  On numpy input (and lists, tuples,
  scalars) it computes in numpy, exactly as the reference's numpy branch;
  on a ``torch.Tensor`` it computes in torch on the tensor's device (the
  reference's jnp branch), wherever dtypes allow.  String input is
  host-only;
- ``get_config()/from_config``: JSON-serialisable state.

Integer outputs of the torch branch are int64 (torch's index dtype; the
reference's jnp branch gives int32) and equal the numpy branch's values.
"""

from __future__ import annotations

import zlib
from typing import Any, Dict, Iterable, List, Optional, Sequence, Union

import numpy as np
import torch

Array = Any  # a numpy array (or list, tuple, scalar) or a torch tensor

_U32 = 0xFFFFFFFF


def _numpy_like(x: Array) -> bool:
    return isinstance(x, np.ndarray) or np.isscalar(x) or isinstance(x, (list, tuple))


def _norm_token(v: Any) -> Any:
    """A vocab token as a JSON-safe Python scalar: numpy scalars unwrap,
    bytes decode (surrogateescape keeps arbitrary bytes reversible).
    Applied at adapt/init AND lookup time, so b'a' and 'a' resolve alike."""
    if isinstance(v, np.generic):
        v = v.item()
    if isinstance(v, bytes):
        return v.decode("utf-8", "surrogateescape")
    return v


def _batches(data: Union[Array, Iterable[Array]]) -> Iterable[np.ndarray]:
    if isinstance(data, np.ndarray):
        yield data
        return
    for batch in data:
        yield np.asarray(batch)


# 32-bit FNV-1a: deterministic across hosts and processes (unlike Python's
# salted hash()) and cheap to vectorise.  Integer ids hash by their low 32
# bits.  numpy computes it in uint32, where the multiply wraps mod 2^32;
# torch has no general uint32 multiply, so its branch computes in int64
# (h < 2^32 and the prime < 2^24, so the product fits) and masks the low 32
# bits after each multiply: the same buckets on the card as on the host.
_FNV_OFFSET32 = 2166136261
_FNV_PRIME32 = 16777619


def _fnv1a_u32(data: np.ndarray) -> np.ndarray:
    """Vectorised FNV-1a of each element's 4 low little-endian bytes."""
    v = (data.astype(np.int64).astype(np.uint64) & np.uint64(_U32)).astype(np.uint32)
    h = np.full(v.shape, _FNV_OFFSET32, np.uint32)
    with np.errstate(over="ignore"):
        for shift in range(0, 32, 8):
            h = (h ^ ((v >> np.uint32(shift)) & np.uint32(0xFF))) * np.uint32(_FNV_PRIME32)
    return h


def _fnv1a_u32_torch(x: torch.Tensor) -> torch.Tensor:
    """:func:`_fnv1a_u32` in int64 on the tensor's device: the uint32
    values, held in int64."""
    v = x.to(torch.int64) & _U32
    h = torch.full_like(v, _FNV_OFFSET32)
    for shift in range(0, 32, 8):
        h = ((h ^ ((v >> shift) & 0xFF)) * _FNV_PRIME32) & _U32
    return h


def _hash_bytes(s: bytes) -> int:
    # Strings stay on the host, so their hash only needs to be stable
    # across processes: zlib.crc32 is one C call, where a per-byte Python
    # FNV loop would dominate the feed's batch assembly.
    return zlib.crc32(s) & _U32


class Hashing:
    """Hash integer or string features into ``[0, num_bins)``.

    The reference's Hashing layer wraps tf.strings.to_hash_bucket_fast;
    here integers use a vectorised 32-bit FNV-1a (the same buckets in numpy
    and in torch, on either device) and strings, host-only, crc32.  Both
    are stable across processes, so the master and every worker agree;
    integer and string inputs hash into unrelated bucket assignments.
    """

    def __init__(self, num_bins: int):
        if num_bins <= 0:
            raise ValueError("num_bins must be positive")
        self.num_bins = num_bins

    def __call__(self, x: Array) -> Array:
        if _numpy_like(x):
            arr = np.asarray(x)
            if arr.dtype.kind in ("U", "S", "O"):
                flat = np.array(
                    [
                        _hash_bytes(s.encode() if isinstance(s, str) else bytes(s))
                        % self.num_bins
                        for s in arr.ravel()
                    ],
                    np.int64,
                )
                return flat.reshape(arr.shape)
            return (_fnv1a_u32(arr) % np.uint32(self.num_bins)).astype(np.int64)
        return _fnv1a_u32_torch(x) % self.num_bins

    def get_config(self) -> Dict:
        return {"num_bins": self.num_bins}

    @classmethod
    def from_config(cls, cfg: Dict) -> "Hashing":
        return cls(**cfg)


class IndexLookup:
    """Map categorical values to dense indices by a fitted vocabulary.

    Out-of-vocabulary values map to ``num_oov`` buckets placed BEFORE the
    vocab (index = hash % num_oov), as the reference's IndexLookup does.
    ``adapt`` builds the vocab by frequency; a fixed vocabulary can be
    passed in.  String lookup is host-only; an integer vocabulary also
    looks up torch tensors, by ``searchsorted`` over the sorted vocab.
    """

    def __init__(
        self,
        vocabulary: Optional[Sequence] = None,
        num_oov: int = 1,
        max_tokens: int = 0,
    ):
        if num_oov < 0:
            raise ValueError("num_oov must be >= 0")
        self.num_oov = num_oov
        self.max_tokens = max_tokens
        self._counts: Dict[Any, int] = {}
        self.vocabulary: List = (
            [_norm_token(v) for v in vocabulary] if vocabulary is not None else []
        )
        self._index: Dict[Any, int] = {}
        self._reindex()

    def _reindex(self) -> None:
        self._index = {tok: i + self.num_oov for i, tok in enumerate(self.vocabulary)}
        # Integer vocabs also support the vectorised tensor lookup.
        self._int_vocab: Optional[np.ndarray] = None
        if self.vocabulary and all(isinstance(t, (int, np.integer)) for t in self.vocabulary):
            order = np.argsort(np.asarray(self.vocabulary, np.int64))
            self._int_sorted = np.asarray(self.vocabulary, np.int64)[order]
            self._int_rank = order.astype(np.int64)  # sorted position -> vocab position
            self._int_vocab = self._int_sorted

    def adapt(self, data: Union[Array, Iterable[Array]]) -> "IndexLookup":
        for batch in _batches(data):
            values, counts = np.unique(batch.ravel(), return_counts=True)
            for v, c in zip(values.tolist(), counts.tolist()):
                v = _norm_token(v)
                self._counts[v] = self._counts.get(v, 0) + c
        ordered = sorted(self._counts.items(), key=lambda kv: (-kv[1], str(kv[0])))
        if self.max_tokens:
            ordered = ordered[: self.max_tokens]
        self.vocabulary = [v for v, _ in ordered]
        self._reindex()
        return self

    @property
    def vocab_size(self) -> int:
        """The whole output index space (OOV buckets and vocab)."""
        return self.num_oov + len(self.vocabulary)

    def _oov_index(self, value: Any) -> int:
        if self.num_oov == 0:
            raise KeyError(f"{value!r} not in vocabulary (num_oov=0)")
        if isinstance(value, (int, np.integer)):
            return int(_fnv1a_u32(np.asarray([value]))[0] % self.num_oov)
        if isinstance(value, bytes):
            data = value
        else:
            # str, float, bool, ...: the canonical string form, so any
            # adapt()-able token type lands in a stable OOV bucket.
            data = str(value).encode("utf-8", "surrogateescape")
        return _hash_bytes(data) % self.num_oov

    def __call__(self, x: Array) -> Array:
        if _numpy_like(x):
            arr = np.asarray(x)
            index = self._index
            flat = np.array(
                [
                    index[v] if (v := _norm_token(raw)) in index else self._oov_index(v)
                    for raw in arr.ravel().tolist()
                ],
                np.int64,
            )
            return flat.reshape(arr.shape)
        if self._int_vocab is None:
            raise TypeError(
                "IndexLookup on a tensor needs an integer vocabulary; string "
                "lookup runs in the feed (host)"
            )
        if self.num_oov == 0:
            # The host path raises KeyError on an OOV value; a tensor lookup
            # cannot branch on data, and a nearest-index answer would map an
            # OOV feature onto another token's row.  Refuse instead.
            raise ValueError(
                "IndexLookup with num_oov=0 cannot look up a tensor (OOV inputs "
                "would silently alias in-vocab indices); use num_oov >= 1"
            )
        x64 = x.to(torch.int64)
        sorted_vocab = torch.as_tensor(self._int_sorted, device=x.device)
        rank = torch.as_tensor(self._int_rank, device=x.device)
        pos = torch.searchsorted(sorted_vocab, x64.contiguous())
        pos_c = pos.clamp(0, len(self._int_sorted) - 1)
        hit = sorted_vocab[pos_c] == x64
        return torch.where(hit, rank[pos_c] + self.num_oov, Hashing(self.num_oov)(x))

    def get_config(self) -> Dict:
        # The vocabulary is normalised to JSON-safe scalars at adapt/init.
        return {
            "vocabulary": list(self.vocabulary),
            "num_oov": self.num_oov,
            "max_tokens": self.max_tokens,
        }

    @classmethod
    def from_config(cls, cfg: Dict) -> "IndexLookup":
        return cls(**cfg)


class Normalizer:
    """Standardise numeric features by an adapted mean and variance
    (Welford-style streaming accumulation, so adapt() takes any dataset
    size)."""

    def __init__(self, mean: Optional[Array] = None, variance: Optional[Array] = None):
        self.mean = None if mean is None else np.asarray(mean, np.float64)
        self.variance = None if variance is None else np.asarray(variance, np.float64)
        self._count = 0.0

    def adapt(self, data: Union[Array, Iterable[Array]]) -> "Normalizer":
        for batch in _batches(data):
            b = batch.astype(np.float64)
            b = b.reshape(-1, b.shape[-1]) if b.ndim > 1 else b.reshape(-1, 1)
            n_b = b.shape[0]
            mean_b = b.mean(0)
            var_b = b.var(0)
            if self._count == 0:
                self.mean, self.variance, self._count = mean_b, var_b, n_b
                continue
            n = self._count + n_b
            delta = mean_b - self.mean
            self.variance = (
                self._count * self.variance + n_b * var_b + (self._count * n_b / n) * delta**2
            ) / n
            self.mean = self.mean + delta * n_b / n
            self._count = n
        return self

    def __call__(self, x: Array) -> Array:
        if self.mean is None:
            raise RuntimeError("Normalizer not adapted and no mean/variance given")
        if _numpy_like(x):
            mean = np.asarray(self.mean, dtype=np.float32)
            std = np.sqrt(np.asarray(self.variance, dtype=np.float32) + 1e-7)
            return (x - mean) / std
        mean = torch.as_tensor(self.mean, dtype=torch.float32, device=x.device)
        var = torch.as_tensor(self.variance, dtype=torch.float32, device=x.device)
        return (x - mean) / torch.sqrt(var + 1e-7)

    def get_config(self) -> Dict:
        return {
            "mean": None if self.mean is None else np.asarray(self.mean).tolist(),
            "variance": None if self.variance is None else np.asarray(self.variance).tolist(),
        }

    @classmethod
    def from_config(cls, cfg: Dict) -> "Normalizer":
        return cls(**cfg)


class Discretization:
    """Bucketise numeric values by boundaries; ``adapt`` picks quantile
    boundaries (``num_bins``-iles) as the reference layer does.  Output ids
    lie in ``[0, num_bins)``; tensors bucketise by ``searchsorted``."""

    def __init__(self, bin_boundaries: Optional[Sequence[float]] = None, num_bins: int = 0):
        self.bin_boundaries = (
            None if bin_boundaries is None else [float(b) for b in bin_boundaries]
        )
        self.num_bins = num_bins
        self._samples: List[np.ndarray] = []

    def adapt(
        self, data: Union[Array, Iterable[Array]], max_samples: int = 1_000_000
    ) -> "Discretization":
        if not self.num_bins:
            raise ValueError("adapt() needs num_bins")
        rng = np.random.default_rng(0)
        for batch in _batches(data):
            flat = batch.astype(np.float64).ravel()
            if len(flat) > max_samples:
                flat = rng.choice(flat, max_samples, replace=False)
            self._samples.append(flat)
        sample = np.concatenate(self._samples)
        if len(sample) > max_samples:  # keep the reservoir bounded
            sample = rng.choice(sample, max_samples, replace=False)
            self._samples = [sample]
        qs = np.linspace(0, 1, self.num_bins + 1)[1:-1]
        self.bin_boundaries = np.quantile(sample, qs).tolist()
        return self

    def __call__(self, x: Array) -> Array:
        if self.bin_boundaries is None:
            raise RuntimeError("Discretization not adapted and no boundaries given")
        if _numpy_like(x):
            bounds = np.asarray(self.bin_boundaries, dtype=np.float32)
            return np.searchsorted(bounds, np.asarray(x, dtype=np.float32)).astype(np.int64)
        bounds = torch.as_tensor(self.bin_boundaries, dtype=torch.float32, device=x.device)
        # torch's default side (right=False) is numpy's "left".
        return torch.searchsorted(bounds, x.to(torch.float32).contiguous())

    def get_config(self) -> Dict:
        return {"bin_boundaries": self.bin_boundaries, "num_bins": self.num_bins}

    @classmethod
    def from_config(cls, cfg: Dict) -> "Discretization":
        return cls(**cfg)


class RoundIdentity:
    """Round a numeric feature to an integer id, clipped to ``[0,
    max_value)`` (the reference's RoundIdentity feeds embedding lookups
    this way).  Both branches round half to even."""

    def __init__(self, max_value: int):
        if max_value <= 0:
            raise ValueError("max_value must be positive")
        self.max_value = max_value

    def __call__(self, x: Array) -> Array:
        if _numpy_like(x):
            rounded = np.round(np.asarray(x, dtype=np.float32))
            return np.clip(rounded, 0, self.max_value - 1).astype(np.int64)
        rounded = torch.round(x.to(torch.float32))
        return rounded.clamp(0, self.max_value - 1).to(torch.int64)

    def get_config(self) -> Dict:
        return {"max_value": self.max_value}

    @classmethod
    def from_config(cls, cfg: Dict) -> "RoundIdentity":
        return cls(**cfg)


class ToNumber:
    """Parse string/bytes features to numbers on the host (feed stage,
    host-only); numeric input passes through, cast.  Empty or invalid
    strings map to ``default``."""

    def __init__(self, out_dtype: str = "float32", default: float = 0.0):
        self.out_dtype = out_dtype
        self.default = default

    def __call__(self, x: Array) -> Array:
        arr = np.asarray(x)
        if arr.dtype.kind not in ("U", "S", "O"):
            return arr.astype(self.out_dtype)

        def parse(s):
            if isinstance(s, bytes):
                s = s.decode()
            s = s.strip()
            if not s:
                return self.default
            try:
                return float(s)
            except ValueError:
                return self.default

        flat = np.array([parse(s) for s in arr.ravel()], np.float64)
        return flat.reshape(arr.shape).astype(self.out_dtype)

    def get_config(self) -> Dict:
        return {"out_dtype": self.out_dtype, "default": self.default}

    @classmethod
    def from_config(cls, cfg: Dict) -> "ToNumber":
        return cls(**cfg)


class ConcatenateWithOffset:
    """Concatenate per-feature id arrays into one id space: feature ``i``'s
    ids shift by the total size of features ``0..i-1``, so one shared
    embedding table serves them all (the reference merges feature columns
    into its PS-sharded Embedding this way)."""

    def __init__(self, sizes: Sequence[int]):
        self.sizes = [int(s) for s in sizes]
        self.offsets = np.concatenate([[0], np.cumsum(self.sizes)[:-1]]).astype(np.int64)
        self.total_size = int(np.sum(self.sizes))

    def __call__(self, features: Sequence[Array]) -> Array:
        if len(features) != len(self.sizes):
            raise ValueError(f"expected {len(self.sizes)} features, got {len(features)}")
        if _numpy_like(features[0]):
            cols = []
            for i, f in enumerate(features):
                f = np.asarray(f)
                cols.append((f if f.ndim > 1 else f[:, None]) + int(self.offsets[i]))
            return np.concatenate(cols, axis=-1)
        cols = [(f if f.dim() > 1 else f[:, None]) + int(self.offsets[i])
                for i, f in enumerate(features)]
        return torch.cat(cols, dim=-1)

    def get_config(self) -> Dict:
        return {"sizes": self.sizes}

    @classmethod
    def from_config(cls, cfg: Dict) -> "ConcatenateWithOffset":
        return cls(**cfg)
