"""ctypes bindings for the port's native host library: the embedding
store of the PS host tier and the ingest functions.

Port of ``elasticdl_tpu/ps/host_store.py`` (``_load``, ``_OPTIMIZERS``,
``HostEmbeddingStore``, ``native_lib_available``, ``recordio_index_native``,
``recordio_verify_native``, ``recordio_read_native``,
``criteo_decode_native``, ``criteo_decode_pre_native``,
``census_decode_native``).  The library is the
port's own copy of the C++ source, ``elasticdl_tpu_torch/csrc/edl_native.cc``,
built at first use with the reference Makefile's flags into
``elasticdl_tpu_torch/csrc/build/`` (git-ignored) under a name that carries a
hash of the source and the flags.  Several processes may build at once (the
test runner's workers, a master and its workers): one holds an ``flock`` on
the build directory's lock file while ``g++`` writes to a temporary name,
which is then renamed into place.

A failed build raises ``RuntimeError``; nothing falls back to a Python
decode or a Python store.  All APIs take and return numpy arrays (ids
int64, rows float32).  A store file written by ``HostEmbeddingStore.save``
is the native format of either package (the C++ source is the same), so
host-tier weights carry across between them.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

from elasticdl_tpu_torch.common.log_utils import get_logger

logger = get_logger("ps.host_store")

CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
BUILD_DIR = os.path.join(CSRC_DIR, "build")
SOURCE = "edl_native.cc"
#: The reference Makefile's ``CXXFLAGS`` plus ``-shared``.
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared")
#: The native store's optimizer codes.
_OPTIMIZERS = {"sgd": 0, "momentum": 1, "adagrad": 2, "adam": 3}

_lib_lock = threading.Lock()  # lock-order: leaf
_lib: Optional[ctypes.CDLL] = None  # guarded-by: _lib_lock
_lib_error: Optional[str] = None  # guarded-by: _lib_lock

_i64 = ctypes.c_int64
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_u16p = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")


def library_path() -> str:
    """Where the library of this exact source and these flags lives."""
    h = hashlib.sha256()
    with open(os.path.join(CSRC_DIR, SOURCE), "rb") as f:
        h.update(f.read())
    h.update(" ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libedl_native-{h.hexdigest()[:16]}.so")


def _build(lib_path: str) -> None:
    """Compile the library unless it exists; one process at a time."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "edl_native.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if os.path.exists(lib_path):  # another process built it meanwhile
            return
        tmp = f"{lib_path}.{os.getpid()}.{threading.get_ident()}.tmp"
        cxx = os.environ.get("CXX", "g++")
        proc = subprocess.run(
            [cxx, *CXX_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, SOURCE)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"{cxx} failed to build {SOURCE}:\n{proc.stdout}{proc.stderr}"
            )
        # graftlint: allow[durable-write-discipline] a build product: a rename lost to a crash rebuilds it
        os.replace(tmp, lib_path)


def _load() -> ctypes.CDLL:
    global _lib, _lib_error
    with _lib_lock:
        if _lib is not None:
            return _lib
        if _lib_error is not None:
            raise RuntimeError(_lib_error)
        try:
            path = library_path()
            if not os.path.exists(path):
                _build(path)
            lib = ctypes.CDLL(path)
        except (OSError, RuntimeError) as e:
            _lib_error = f"native lib unavailable: {e}"
            logger.error("%s", _lib_error)
            raise RuntimeError(_lib_error) from e

        lib.edl_store_create.restype = ctypes.c_void_p
        lib.edl_store_create.argtypes = [
            _i64, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_float, ctypes.c_float,
        ]
        lib.edl_store_destroy.argtypes = [ctypes.c_void_p]
        lib.edl_store_size.restype = _i64
        lib.edl_store_size.argtypes = [ctypes.c_void_p]
        lib.edl_store_pull.argtypes = [ctypes.c_void_p, _i64p, _i64, _f32p]
        lib.edl_store_try_pull.restype = _i64
        lib.edl_store_try_pull.argtypes = [ctypes.c_void_p, _i64p, _i64, _f32p]
        lib.edl_store_push_grad.argtypes = [ctypes.c_void_p, _i64p, _i64, _f32p]
        lib.edl_store_save.restype = _i64
        lib.edl_store_save.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.edl_store_load.restype = _i64
        lib.edl_store_load.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.edl_recordio_index.restype = _i64
        lib.edl_recordio_index.argtypes = [ctypes.c_char_p, _i64p, _i64]
        lib.edl_recordio_verify.restype = _i64
        lib.edl_recordio_verify.argtypes = [ctypes.c_char_p, _i64p, _i64, _i64]
        lib.edl_recordio_read.restype = _i64
        lib.edl_recordio_read.argtypes = [
            ctypes.c_char_p, _i64p, _i64, _i64, _i64, _u8p, _i64, _i64p,
        ]
        lib.edl_criteo_decode.restype = _i64
        lib.edl_criteo_decode.argtypes = [_u8p, _i64p, _i64, _i32p, _f32p, _i32p]
        lib.edl_criteo_decode_pre.restype = _i64
        lib.edl_criteo_decode_pre.argtypes = [
            _u8p, _i64p, _i64, _u8p, _u16p, _u16p, _i64,
        ]
        lib.edl_census_decode.restype = _i64
        lib.edl_census_decode.argtypes = [
            _u8p, _i64p, _i64, _i32p, _f32p, _i32p, _i64,
        ]
        _lib = lib
        return lib


def native_lib_available() -> bool:
    try:
        _load()
        return True
    except RuntimeError:
        return False


class HostEmbeddingStore:
    """Growable id -> row store with server-side sparse optimizers: the
    host tier of the ParameterServer strategy.

    Rows materialise on first pull (a deterministic per-id init, so a row
    is the same whichever store or shard first serves it); ``push_grad``
    applies one optimizer step per distinct id with duplicate contributions
    summed first (IndexedSlices semantics).

    The native store is not safe for concurrent use, so every call but
    ``try_pull`` holds this store's lock (ctypes releases the GIL during
    the call): two threads' pulls, pushes, saves and loads never
    interleave.  ``try_pull`` runs without it, so concurrent readers scale;
    a caller that mixes it with writers keeps its own reader-writer lock,
    as the PS service does.
    """

    def __init__(
        self,
        dim: int,
        optimizer: str = "adagrad",
        learning_rate: float = 0.01,
        momentum: float = 0.9,
        beta1: float = 0.9,
        beta2: float = 0.999,
        eps: float = 1e-8,
        init_scale: float = 0.05,
    ):
        if optimizer not in _OPTIMIZERS:
            raise ValueError(
                f"unknown optimizer {optimizer!r}, pick from {sorted(_OPTIMIZERS)}"
            )
        self._lib = _load()
        self.dim = dim
        self.optimizer = optimizer
        self._lock = threading.Lock()  # lock-order: leaf
        self._ptr = self._lib.edl_store_create(  # guarded-by: _lock
            dim, _OPTIMIZERS[optimizer],
            learning_rate, momentum, beta1, beta2, eps, init_scale,
        )

    def _live(self):  # guarded-by: _lock
        if not self._ptr:
            raise RuntimeError("the host embedding store is closed")
        return self._ptr

    def __len__(self) -> int:
        with self._lock:
            return int(self._lib.edl_store_size(self._live()))

    def pull(self, ids: np.ndarray) -> np.ndarray:
        """Rows for ``ids`` (any shape), shaped ``ids.shape + (dim,)``;
        unseen ids materialise."""
        ids = np.ascontiguousarray(ids, np.int64)
        out = np.empty((ids.size, self.dim), np.float32)
        with self._lock:
            self._lib.edl_store_pull(self._live(), ids.ravel(), ids.size, out)
        return out.reshape(ids.shape + (self.dim,))

    def try_pull(self, ids: np.ndarray):
        """Read-only gather: (rows, number of missing ids), the missing
        ids' rows left as allocated.  It never mutates the store and takes
        no lock: any number of threads may call it while no writer (pull,
        push_grad, load) and no ``close`` runs, the PS service's
        shared-lock fast path."""
        ids = np.ascontiguousarray(ids, np.int64)
        out = np.empty((ids.size, self.dim), np.float32)
        # graftlint: allow[lock-discipline] the lock-free reader: its caller's reader-writer lock (the PS service's per-table lock) keeps writers and close() out
        ptr = self._ptr
        if not ptr:
            raise RuntimeError("the host embedding store is closed")
        missing = int(self._lib.edl_store_try_pull(ptr, ids.ravel(), ids.size, out))
        return out.reshape(ids.shape + (self.dim,)), missing

    def push_grad(self, ids: np.ndarray, grads: np.ndarray) -> None:
        ids = np.ascontiguousarray(ids, np.int64).ravel()
        grads = np.ascontiguousarray(grads, np.float32).reshape(ids.size, self.dim)
        with self._lock:
            self._lib.edl_store_push_grad(self._live(), ids, ids.size, grads)

    def save(self, path: str) -> int:
        with self._lock:
            n = int(self._lib.edl_store_save(self._live(), path.encode()))
        if n < 0:
            raise IOError(f"save to {path} failed")
        return n

    def load(self, path: str) -> int:
        with self._lock:
            n = int(self._lib.edl_store_load(self._live(), path.encode()))
        if n == -2:
            raise ValueError("checkpoint optimizer/dim mismatch")
        if n < 0:
            raise IOError(f"load from {path} failed")
        return n

    def close(self) -> None:
        with self._lock:
            if self._ptr:
                self._lib.edl_store_destroy(self._ptr)
                self._ptr = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def recordio_index_native(path: str) -> np.ndarray:
    """Byte offset of every record of a RecordIO file (one native scan)."""
    lib = _load()
    # Every record costs at least its 8-byte header, so file_size/8 bounds
    # the record count; start from a typical count and grow on the
    # scanner's -2 (capacity) signal rather than allocate the bound.
    hard_bound = max(os.path.getsize(path) // 8, 1)
    cap = min(hard_bound, 1 << 20)
    while True:
        offsets = np.empty((cap,), np.int64)
        n = int(lib.edl_recordio_index(path.encode(), offsets, cap))
        if n == -2:
            if cap >= hard_bound:
                raise IOError(f"{path}: more records than the size bound allows")
            cap = min(cap * 16, hard_bound)
            continue
        if n < 0:
            raise IOError(f"{path}: malformed recordio")
        return offsets[:n].copy()


def recordio_verify_native(path: str, offsets: np.ndarray, start: int, end: int) -> int:
    """CRC check of records [start, end): the index of the first corrupt
    record, or -1 when every one passes."""
    lib = _load()
    offsets = np.ascontiguousarray(offsets, np.int64)
    return int(lib.edl_recordio_verify(path.encode(), offsets, start, end))


def recordio_read_native(
    path: str, offsets: np.ndarray, start: int, end: int, file_size: int
) -> tuple:
    """Bulk CRC-checked range read: one disk read + an in-memory header walk.

    Returns (payloads: uint8[total], cumulative offsets: int64[n+1]), the
    packed form ``data.packed.PackedRecords`` wraps.
    """
    lib = _load()
    offsets = np.ascontiguousarray(offsets, np.int64)
    n = end - start
    if n <= 0:
        return np.empty((0,), np.uint8), np.zeros((1,), np.int64)
    span = (int(offsets[end]) if end < len(offsets) else file_size) - int(
        offsets[start]
    )
    out = np.empty((span - 8 * n,), np.uint8)
    lens = np.empty((n,), np.int64)
    got = int(
        lib.edl_recordio_read(
            path.encode(), offsets, start, end, span, out, len(out), lens
        )
    )
    if got == -2:
        raise IOError(f"{path}: CRC mismatch in records [{start}, {end})")
    if got < 0:
        raise IOError(f"{path}: malformed recordio in records [{start}, {end})")
    cum = np.empty((n + 1,), np.int64)
    cum[0] = 0
    np.cumsum(lens, out=cum[1:])
    return out[:got], cum


def _malformed(buf: np.ndarray, offsets: np.ndarray, rc: int,
               fmt: str = "criteo") -> ValueError:
    i = -rc - 1
    bad = bytes(buf[offsets[i] : offsets[i + 1]])
    return ValueError(f"malformed {fmt} record {i}: {bad[:120]!r}")


def criteo_decode_native(buf: np.ndarray, offsets: np.ndarray) -> tuple:
    """Decode n packed Criteo TSV records -> (labels[n] int32, dense[n,13]
    float32, cat[n,26] int32).

    ``offsets`` is cumulative (n+1 entries) into ``buf``; blanks and missing
    trailing fields decode to 0, as the plain feed
    (``data.codecs.criteo_feed_plain``) does.
    """
    lib = _load()
    buf = np.ascontiguousarray(buf, np.uint8)
    offsets = np.ascontiguousarray(offsets, np.int64)
    n = len(offsets) - 1
    labels = np.zeros((n,), np.int32)
    dense = np.zeros((n, 13), np.float32)
    cat = np.zeros((n, 26), np.int32)
    rc = int(lib.edl_criteo_decode(buf, offsets, n, labels, dense, cat))
    if rc < 0:
        raise _malformed(buf, offsets, rc)
    return labels, dense, cat


def census_decode_native(
    buf: np.ndarray, offsets: np.ndarray, hash_bins: int
) -> tuple:
    """Decode n packed census CSV records -> (labels[n] int32, dense[n,5]
    float32, cat[n,9] int32).

    Numerics follow ``preprocessing.ToNumber`` (stripped; empty or invalid
    -> 0.0), strings ``preprocessing.Hashing`` (crc32 of the stripped bytes
    % ``hash_bins``), as the plain feed (``data.codecs.census_feed_plain``)
    does.  A record whose label does not parse, or with surplus fields,
    raises ``ValueError``.
    """
    lib = _load()
    buf = np.ascontiguousarray(buf, np.uint8)
    offsets = np.ascontiguousarray(offsets, np.int64)
    n = len(offsets) - 1
    labels = np.zeros((n,), np.int32)
    dense = np.zeros((n, 5), np.float32)
    cat = np.zeros((n, 9), np.int32)
    rc = int(lib.edl_census_decode(buf, offsets, n, labels, dense, cat, hash_bins))
    if rc < 0:
        raise _malformed(buf, offsets, rc, "census")
    return labels, dense, cat


def criteo_decode_pre_native(
    buf: np.ndarray, offsets: np.ndarray, buckets: int
) -> tuple:
    """Preprocessed Criteo decode: DeepFM's feature transforms (the
    ``models.tabular`` hash bucketing and log1p) applied during the parse,
    in compact wire dtypes: labels uint8, dense float16 (log1p), cat uint16
    in [0, buckets), 79 bytes an example.  Requires buckets <= 65536."""
    lib = _load()
    buf = np.ascontiguousarray(buf, np.uint8)
    offsets = np.ascontiguousarray(offsets, np.int64)
    n = len(offsets) - 1
    labels = np.zeros((n,), np.uint8)
    dense = np.zeros((n, 13), np.uint16)
    cat = np.zeros((n, 26), np.uint16)
    rc = int(
        lib.edl_criteo_decode_pre(buf, offsets, n, labels, dense, cat, buckets)
    )
    if rc == -(n + 1):
        raise ValueError(f"buckets={buckets} out of range for uint16 decode")
    if rc < 0:
        raise _malformed(buf, offsets, rc)
    return labels, dense.view(np.float16), cat
