"""Building, loading and counting the port's hand-written CUDA kernels.

Each kernel source under ``elasticdl_tpu_torch/csrc/`` is compiled by
``nvcc`` for Hopper (``sm_90a``) into a shared library with a plain C
interface and loaded with ``ctypes``.  The build happens at first use, on
the machine with the card, into ``elasticdl_tpu_torch/csrc/build/`` (listed
in ``.gitignore``); the library's file name carries a hash of its source and
of the shared headers (``csrc/*.cuh``), so an edited source or header
rebuilds and processes sharing a checkout share one build.
Nothing here runs at import time: the CPU tests import every module of the
package on machines with no ``nvcc``.

Every wrapper that launches a kernel calls :func:`count` once per launch,
and nowhere else, so a run can show that its main path went through the
kernels (``chip_smoke.py`` zeroes the counts before the path and reads them
after it).  A launch under CUDA-graph capture does not run: while
:func:`capturing` is open, a launch onto a capturing stream (the capturing
thread's, or the autograd engine's thread running the captured backward)
goes to the capture's own tally instead, and each replay of that graph
adds the tally to the counts (:func:`add_counts`), so the counts stay the
kernels' real runs.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, Iterator, Optional, Tuple

CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
BUILD_DIR = os.path.join(CSRC_DIR, "build")

#: nvcc flags: Hopper's architecture-specific target (the ``a`` keeps
#: wgmma/setmaxnreg available to later kernels), optimised, position-
#: independent shared library; ``-Xptxas -v`` reports registers, shared
#: memory and spills into the build log.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()  # lock-order: leaf
_build_locks: Dict[str, threading.Lock] = {}  # guarded-by: _lock
_libs: Dict[str, ctypes.CDLL] = {}  # guarded-by: _lock
_build_info: Dict[str, Tuple[float, str]] = {}  # guarded-by: _lock
_counts: Dict[str, int] = {}  # guarded-by: _lock
# The open capture's tally (``capturing``), else None.
_capture_tally: Optional[Dict[str, int]] = None  # guarded-by: _lock


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels are built "
        "at first use on a machine with the CUDA toolkit"
    )


def _digest(source: str) -> str:
    """Hash of ``csrc/<source>``, every header under ``csrc/`` (a source
    may include any of them) and the nvcc flags."""
    h = hashlib.sha256()
    headers = sorted(n for n in os.listdir(CSRC_DIR) if n.endswith(".cuh"))
    for name in (source, *headers):
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read() + b"\0")
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _build(source: str) -> Tuple[str, float, str]:
    """Compile ``csrc/<source>`` unless a library of this exact source and
    headers exists.  Returns (library path, build seconds, compiler log)."""
    src_path = os.path.join(CSRC_DIR, source)
    digest = _digest(source)
    stem = os.path.splitext(source)[0]
    lib_path = os.path.join(BUILD_DIR, f"lib{stem}-{digest}.so")
    if os.path.exists(lib_path):
        return lib_path, 0.0, "(cached build)"
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp_path = f"{lib_path}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [nvcc_path(), *NVCC_FLAGS, "-o", tmp_path, src_path],
        capture_output=True, text=True,
    )
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {source}:\n{log}")
    # Atomic publish: a concurrent process either sees no library or a
    # complete one.
    # graftlint: allow[durable-write-discipline] a build product: a rename lost to a crash rebuilds it
    os.replace(tmp_path, lib_path)
    return lib_path, seconds, log


def load(source: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<source>``, built at first use.  Each
    source has its own build lock, taken outside the module lock, so
    threads can build different sources at once (``nvcc`` runs in a
    subprocess)."""
    with _lock:
        lib = _libs.get(source)
        if lib is not None:
            return lib
        build_lock = _build_locks.setdefault(source, threading.Lock())
    with build_lock:  # lock-order: before _lock
        with _lock:
            lib = _libs.get(source)
        if lib is None:
            path, seconds, log = _build(source)
            lib = ctypes.CDLL(path)
            with _lock:
                _libs[source] = lib
                _build_info[source] = (seconds, log)
        return lib


@functools.lru_cache(maxsize=None)
def bind(source: str, name: str, argtypes: Tuple[Any, ...], restype: Any = ctypes.c_int):
    """The C function ``name`` of ``csrc/<source>`` with its signature set,
    looked up once: wrappers call this per launch."""
    fn = getattr(load(source), name)
    fn.argtypes = list(argtypes)
    fn.restype = restype
    return fn


def build_info(source: str) -> Tuple[float, str]:
    """(build seconds, compiler log) of a loaded source; (0.0, "(cached
    build)") when this process found the library already built."""
    with _lock:
        return _build_info[source]


def count(kernel: str) -> None:
    """One launch of ``kernel``: called by its wrapper right where it
    launches, and nowhere else.  Onto a capturing stream while
    :func:`capturing` is open, the launch is recorded into the graph, not
    run: it goes to the capture's tally."""
    with _lock:
        target = _counts
        if _capture_tally is not None and _stream_capturing():
            target = _capture_tally
        target[kernel] = target.get(kernel, 0) + 1


def _stream_capturing() -> bool:
    import torch

    return torch.cuda.is_current_stream_capturing()


@contextmanager
def capturing() -> Iterator[Dict[str, int]]:
    """The launches recorded while a CUDA graph captures: yields the tally
    ``{kernel: launches}`` that each replay of the graph adds with
    :func:`add_counts`.  One capture at a time in a process."""
    global _capture_tally
    tally: Dict[str, int] = {}
    with _lock:
        if _capture_tally is not None:
            raise RuntimeError("a capture is already open")
        _capture_tally = tally
    try:
        yield tally
    finally:
        with _lock:
            _capture_tally = None


def add_counts(tally: Dict[str, int]) -> None:
    """One replay of a captured graph: its recorded launches ran."""
    with _lock:
        for kernel, n in tally.items():
            _counts[kernel] = _counts.get(kernel, 0) + n


def counts() -> Dict[str, int]:
    with _lock:
        return dict(_counts)


def reset_counts() -> None:
    with _lock:
        _counts.clear()


def check_launch(kernel: str, status: int) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` returned by a launch: a
    refused launch never runs, and a later synchronise would not report
    it."""
    if status != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with cudaError {status}")
