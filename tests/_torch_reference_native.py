"""Make the JAX package's native library loadable before a port test
builds one of its stores.

``elasticdl_tpu/ps/host_store._load`` builds ``libedl_native.so`` with
``make`` on first use (the file is not committed) and takes no lock
between processes.  Under ``pytest -n 6`` every worker collects the
reference's test files at once, and their module-level
``native_lib_available()`` probes start six builds of the same file: a
worker that loads it while another rewrites it reads "file too short" and
keeps that error for the life of the process (``_lib_error``).  Every
later use in that worker then fails, though the file is whole by then.

The port's tests that build the reference's ``HostEmbeddingStore`` (its
host tier, its PS shards, its ``HotIdEmbeddingCache``) request the
``reference_native`` fixture.  It clears a cached error (through
``monkeypatch``; a loaded library stays loaded), waits until the file has
stopped changing, loads it, and retries until ``WAIT_S`` runs out; then
the test FAILS with the last error.  It never skips.  The reference
itself is left as it is.
"""

from __future__ import annotations

import os
import time

import pytest

#: The bound on the wait for the racing builds to end and the load to succeed.
WAIT_S = 120.0
#: The library file must keep its size and time this long before a load.
_QUIET_S = 0.5


def _signature(path: str):
    try:
        st = os.stat(path)
    except FileNotFoundError:
        return None
    return st.st_size, st.st_mtime_ns


def load_reference_native(monkeypatch, wait_s: float = WAIT_S):
    """The reference's loaded ``ctypes.CDLL``, loaded in this process if need
    be; fails the test after ``wait_s`` seconds without one."""
    from elasticdl_tpu.ps import host_store as ref

    if ref._lib is not None:
        return ref._lib
    deadline = time.monotonic() + wait_s
    error = None
    seen = _signature(ref._LIB_PATH)
    while True:
        time.sleep(_QUIET_S)
        now = _signature(ref._LIB_PATH)
        if now == seen:  # no build is writing the file (or there is none yet)
            if ref._lib_error is not None:
                monkeypatch.setattr(ref, "_lib_error", None)
            try:
                return ref._load()
            except RuntimeError as e:
                error = e
        seen = now
        if time.monotonic() >= deadline:
            pytest.fail(f"the reference's native library ({ref._LIB_PATH}) did not load "
                        f"within {wait_s:.0f} s: {error}")


@pytest.fixture
def reference_native(monkeypatch):
    return load_reference_native(monkeypatch)
