"""The port's kernel loader: sources build concurrently, each once.

``nvcc`` is not needed: the build and the library load are replaced by
stand-ins that record when they ran.  The loader's locking is what is
under test (one lock per source, taken outside the module lock), so
``chip_smoke.py`` can build every kernel source at once.
"""

import threading
import time

from elasticdl_tpu_torch.ops import kernels


def _fake_build(monkeypatch, seconds=0.3):
    spans, lock = [], threading.Lock()

    def build(source):
        t0 = time.monotonic()
        time.sleep(seconds)
        with lock:
            spans.append((source, t0, time.monotonic()))
        return f"/nonexistent/lib{source}.so", seconds, "(fake build)"

    monkeypatch.setattr(kernels, "_build", build)
    monkeypatch.setattr(kernels.ctypes, "CDLL", lambda path: ("lib", path))
    return spans


def _load_all(sources):
    threads = [threading.Thread(target=kernels.load, args=(s,)) for s in sources]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


def test_two_sources_build_at_once(monkeypatch):
    spans = _fake_build(monkeypatch)
    sources = ("fake_a.cu", "fake_b.cu")
    monkeypatch.setattr(kernels, "_libs", {})
    monkeypatch.setattr(kernels, "_build_locks", {})
    monkeypatch.setattr(kernels, "_build_info", {})
    _load_all(sources)
    assert sorted(s for s, _, _ in spans) == sorted(sources)
    (_, a0, a1), (_, b0, b1) = spans
    assert a0 < b1 and b0 < a1, "the two builds ran one after the other"
    assert kernels.load("fake_a.cu") == ("lib", "/nonexistent/libfake_a.cu.so")
    assert kernels.build_info("fake_b.cu") == (0.3, "(fake build)")


def test_one_source_builds_once_under_concurrent_loads(monkeypatch):
    spans = _fake_build(monkeypatch, seconds=0.1)
    monkeypatch.setattr(kernels, "_libs", {})
    monkeypatch.setattr(kernels, "_build_locks", {})
    monkeypatch.setattr(kernels, "_build_info", {})
    _load_all(["fake_c.cu"] * 4)
    assert [s for s, _, _ in spans] == ["fake_c.cu"]
