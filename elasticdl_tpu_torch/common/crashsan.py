"""crashsan — durable-write crash-point sanitizer (GRAFT_CRASHSAN).

The dynamic twin of graftlint v7's durability rules, in the locksan /
racesan / jitsan stance: the static pass (analysis/durability.py) proves
every durable write ROUTES through ``common/durable.py``; this module
proves each of those routed writes actually RECOVERS.  Every durable op
(append, whole-file publish, external-tmp replace) crosses ``crossing()``
before touching disk; a test arms :func:`crash_at` and the crossing then
deterministically produces ON DISK the exact state a real process death
at that point leaves — a torn final append, a fully-fsync'd temp whose
rename never landed, an fsync that was skipped before the crash — and
raises :class:`CrashPoint`.  The recovery reader under test then runs
against that state and must land inside its documented contract
(docs/robustness.md "Durability contracts"): bit-identical, watermark
fallback, or at-least-once — never silent corruption.

Crash modes, per op kind (the matrix tools/crashsan_matrix.py sweeps):

=============  ==========================================================
``append``     ``torn_append``  the single ``os.write`` was cut short: a
               torn FINAL line lands on disk, unsynced, process dies.
               ``append_lost``  the crash beat the fsync: the appended
               bytes died in the page cache — nothing lands at all.
``publish``    ``tmp_torn``     death mid-write of the temp: a torn temp
               exists, the target is untouched.
               ``rename_lost``  the temp is complete and fsync'd but the
               rename never landed: the target still holds the PREVIOUS
               version.
               ``published_torn``  a non-compliant writer renamed before
               fsync and the data died after the rename: the TARGET
               itself is torn.  atomic_publish makes this impossible;
               the mode exists to prove the reader's tolerance contract
               holds even against it.
``replace``    same three modes over an externally-written temp
               (``durable.atomic_replace``): the temp is truncated to a
               prefix instead of rewritten, since its content is opaque.
=============  ==========================================================

Cost contract: the crossing is called only from ``common/durable.py`` ops
that already pay an fsync (milliseconds), so its disabled cost — one lock
guarded counter bump feeding the per-file op index the chaos grammar's
``torn_write:file=<durable>,op=N`` matches against — is noise.  Crash
injection itself (the state production) only runs when a test armed
:func:`crash_at` or a chaos ``torn_write`` fault requested it.

:class:`CrashPoint` subclasses ``BaseException`` ON PURPOSE: production
recovery code legitimately wraps durable ops in ``except Exception`` /
``except OSError`` handlers, and a simulated process death those handlers
could swallow would test the handler, not the crash.  Only the test
harness catches CrashPoint.
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Any, Dict, List, Optional

APPEND_MODES = ("torn_append", "append_lost")
PUBLISH_MODES = ("tmp_torn", "rename_lost", "published_torn")

#: Every mode a chaos ``torn_write`` fault may name (parse-time check).
ALL_MODES = APPEND_MODES + PUBLISH_MODES


class CrashPoint(BaseException):
    """Simulated process death at a durable-op boundary.

    BaseException, not Exception: recovery code's own ``except Exception``
    handlers must not be able to swallow a crash — a real ``os._exit``
    gives them no such chance, and the simulation must not either."""


class CrashSanError(AssertionError):
    """Misuse of the sanitizer itself (bad mode, bad kind)."""


_lock = threading.Lock()  # lock-order: leaf
_op_count = 0  # guarded-by: _lock
_per_file: Dict[str, int] = {}  # guarded-by: _lock
_recorders: List[List[dict]] = []  # guarded-by: _lock
_armed: Optional[Dict[str, Any]] = None  # guarded-by: _lock
#: The chaos plan's torn_write faults, handed over at chaos.configure()
#: time.  Matching lives HERE, not in the injector's hook: durable ops
#: fire under leaf-declared subsystem locks (the journal appends under
#: TaskDispatcher._lock), and acquiring the locksan-wrapped
#: ChaosInjector._lock there is a lock-order violation — this module's
#: plain lock is a true leaf the sanitizers cannot see or order.
_torn_plan: List[Dict[str, Any]] = []  # guarded-by: _lock

# test seam (the ChaosInjector._exit pattern): a chaos-driven crash must be
# observable without killing the test runner.
_exit = os._exit


def enabled() -> bool:
    return os.environ.get("GRAFT_CRASHSAN") == "1"


def op_count() -> int:
    with _lock:
        return _op_count


def reset() -> None:
    """Forget counters, recorders and the armed crash (test isolation).
    The chaos torn_write plan is NOT cleared — chaos.configure owns it."""
    global _op_count, _armed
    with _lock:
        _op_count = 0
        _per_file.clear()
        _recorders.clear()
        _armed = None


@contextlib.contextmanager
def record():
    """Capture every durable-op crossing in the block: yields a list of
    ``{"index", "kind", "file", "path", "file_op"}`` dicts — the op
    enumeration the matrix driver sweeps crash points over."""
    buf: List[dict] = []
    with _lock:
        _recorders.append(buf)
    try:
        yield buf
    finally:
        with _lock:
            _recorders.remove(buf)


def arm(nth: int, mode: str) -> None:
    """Crash at the ``nth`` durable-op crossing from now (0-based)."""
    if mode not in ALL_MODES:
        raise CrashSanError(
            f"unknown crash mode {mode!r} (known: {', '.join(ALL_MODES)})"
        )
    if not enabled():
        # Fail LOUD: a test that arms a crash point with the sanitizer off
        # would otherwise "pass" by never crashing anything.
        raise CrashSanError("GRAFT_CRASHSAN=1 required to arm crash points")
    global _armed
    with _lock:
        _armed = {"remaining": int(nth), "mode": mode, "fired": None}


def disarm() -> Optional[dict]:
    """Disarm; returns the fired record (or None if it never fired)."""
    global _armed
    with _lock:
        state, _armed = _armed, None
        return state["fired"] if state else None


@contextlib.contextmanager
def crash_at(nth: int, mode: str):
    """Arm a deterministic crash at the nth crossing inside the block.
    The CrashPoint propagates out — wrap in ``pytest.raises(CrashPoint)``."""
    arm(nth, mode)
    try:
        yield
    finally:
        disarm()


def set_torn_plan(faults: List[Dict[str, Any]]) -> None:
    """Install the chaos plan's torn_write faults (called by
    ``chaos.configure`` — empty clears).  Each fault:
    ``{"file": basename, "op": exact-per-file-index-or-None,
    "mode": crash-mode-or-"", "count": max-fires (0=unlimited),
    "skip": ignore-first-N-matches}``.  Firing state resets —
    reconfiguring IS a new experiment (the injector's stance)."""
    global _torn_plan
    plan = [dict(f, seen=0, fired=0) for f in faults]
    with _lock:
        _torn_plan = plan


def note_op(kind: str, path: str) -> tuple:
    """Record one durable-op crossing.  Returns ``(file_op_index,
    armed_mode_or_None, chaos_mode_or_None)``: the per-file 0-based op
    index, the crash mode when a :func:`crash_at` countdown hit zero on
    this crossing, and the chaos mode (possibly ``""`` = kind default)
    when a torn_write fault matched — the caller produces that state and
    dies for real."""
    global _op_count
    if not enabled() and not _torn_plan:
        return 0, None, None
    fname = os.path.basename(path)
    with _lock:
        idx = _op_count
        _op_count += 1
        file_op = _per_file.get(fname, 0)
        _per_file[fname] = file_op + 1
        rec = {
            "index": idx, "kind": kind, "file": fname, "path": path,
            "file_op": file_op,
        }
        for buf in _recorders:
            buf.append(dict(rec, index=len(buf)))
        mode = None
        if _armed is not None and _armed["fired"] is None:
            if _armed["remaining"] <= 0:
                _armed["fired"] = rec
                mode = _armed["mode"]
            else:
                _armed["remaining"] -= 1
        chaos_mode = None
        for fault in _torn_plan:
            if fault["file"] != fname:
                continue
            if fault["op"] is not None and fault["op"] != file_op:
                continue
            fault["seen"] += 1
            if fault["seen"] <= fault.get("skip", 0):
                continue
            count = fault.get("count", 1)
            if count and fault["fired"] >= count:
                continue
            fault["fired"] += 1
            chaos_mode = fault.get("mode", "")
            break
    return file_op, mode, chaos_mode


def simulate(
    kind: str,
    mode: str,
    *,
    path: str,
    fd: Optional[int] = None,
    data: Optional[bytes] = None,
    tmp: Optional[str] = None,
    die: Optional[int] = None,
) -> None:
    """Produce the on-disk state a real crash at this op leaves, then die
    — :class:`CrashPoint` for test-armed crashes, ``os._exit(die)`` for
    chaos-driven ones (the chaos ``kill`` stance: a real crash skips
    interpreter teardown, so the simulated one must too)."""
    if kind == "append":
        if mode not in APPEND_MODES:
            raise CrashSanError(f"mode {mode!r} does not apply to appends")
        if mode == "torn_append" and data:
            # The single os.write was cut short: a torn prefix of the
            # final line lands, never fsync'd (a real torn tail may or
            # may not survive; landing it is the harder case).
            os.write(fd, data[: max(1, len(data) // 2)])
        # append_lost: the bytes died in the page cache — write nothing.
    elif kind == "publish":
        if mode not in PUBLISH_MODES:
            raise CrashSanError(f"mode {mode!r} does not apply to publishes")
        half = (data or b"x")[: max(1, len(data or b"x") // 2)]
        if mode == "tmp_torn":
            with open(tmp, "wb") as f:
                f.write(half)
        elif mode == "rename_lost":
            with open(tmp, "wb") as f:
                f.write(data or b"")
                f.flush()
                os.fsync(f.fileno())
        else:  # published_torn: rename-before-fsync, data died after
            with open(tmp, "wb") as f:
                f.write(half)
            os.replace(tmp, path)
    elif kind == "replace":
        # The temp was written EXTERNALLY (its full content is already on
        # disk, fsync pending): torn = truncate to a prefix.
        if mode not in PUBLISH_MODES:
            raise CrashSanError(f"mode {mode!r} does not apply to replaces")
        if mode == "tmp_torn":
            _truncate_half(tmp)
        elif mode == "published_torn":
            _truncate_half(tmp)
            os.replace(tmp, path)
        # rename_lost: leave the complete temp where it is, no rename.
    else:
        raise CrashSanError(f"unknown durable op kind {kind!r}")
    if die is not None:
        import sys

        print(
            f"[crashsan] chaos torn_write: {mode} at {path} (op kind "
            f"{kind}); dying", file=sys.stderr, flush=True,
        )
        _exit(die)
    raise CrashPoint(f"simulated crash: {mode} during {kind} of {path}")


def _truncate_half(path: str) -> None:
    try:
        size = os.path.getsize(path)
    except OSError:
        return
    with open(path, "rb+") as f:
        f.truncate(max(1, size // 2))
