"""The port's kernel loader: sources build concurrently, each once.

``nvcc`` is not needed: the build and the library load are replaced by
stand-ins that record when they ran.  The loader's locking is what is
under test (one lock per source, taken outside the module lock), so
``chip_smoke.py`` can build every kernel source at once; and the build's
digest, which must cover the headers a source includes.
"""

import os
import subprocess
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


def _fake_nvcc(monkeypatch, tmp_path):
    """A ``csrc`` tree in ``tmp_path`` with one source and one shared
    header, and an ``nvcc`` stand-in that writes the library it is asked
    for and records each call."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include "shared.cuh"\n')
    (csrc / "shared.cuh").write_text("// v1\n")
    calls = []

    def run(cmd, **kwargs):
        out = cmd[cmd.index("-o") + 1]
        with open(out, "w") as f:
            f.write("lib")
        calls.append(out)
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(kernels, "CSRC_DIR", str(csrc))
    monkeypatch.setattr(kernels, "BUILD_DIR", str(csrc / "build"))
    monkeypatch.setattr(kernels, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(kernels.subprocess, "run", run)
    return csrc, calls


def test_build_digest_covers_the_shared_headers(monkeypatch, tmp_path):
    """An edit to a header alone names (and builds) a new library; an
    unchanged tree reuses the one it built."""
    csrc, calls = _fake_nvcc(monkeypatch, tmp_path)
    first, _, _ = kernels._build("k.cu")
    again, seconds, log = kernels._build("k.cu")
    assert again == first and (seconds, log) == (0.0, "(cached build)") and len(calls) == 1
    (csrc / "shared.cuh").write_text("// v2\n")
    edited, _, _ = kernels._build("k.cu")
    assert edited != first and len(calls) == 2
    assert os.path.exists(first) and os.path.exists(edited)
    (csrc / "other.cuh").write_text("// a header the source may include\n")
    assert kernels._build("k.cu")[0] not in (first, edited) and len(calls) == 3
