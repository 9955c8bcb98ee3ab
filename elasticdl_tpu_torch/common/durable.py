"""durable — the ONE home for the repo's durable-write shapes (r21).

r18's master WAL took six review rounds to get crash-consistent — torn
mid-file lines, a membership record that could land in neither base nor
WAL, thread-colliding registry temp names, short ``os.write`` tears — and
every one of those was an instance of two write shapes the repo already
carried in divergent copies (checkpoint manifest, pod registry, journal
rotation, artifact stamps).  This module is the canonical copy; graftlint
v7 (``analysis/durability.py``, rule ``durable-write-discipline``) makes
routing through it mandatory for any path derived from a ``# durable-file``
constant, and ``common/crashsan.py`` (GRAFT_CRASHSAN) proves each shape's
recovery contract by simulating real crashes at every op boundary.

The two write shapes, plus their read-side halves:

- :func:`atomic_publish` — whole-file commit: thread-unique temp
  (``.tmp<pid>.<tid>`` — a pid-only name lets two threads of one process
  interleave writes and rename corruption into place), write, fsync(file),
  ``os.replace``, fsync(directory) (a rename without the directory fsync
  can vanish with the dirent on power loss).  A reader sees the previous
  complete file or the new complete file, never a tear.
  :func:`atomic_replace` is the same commit for a temp some other code
  already wrote (PS host-store snapshots, dataset caches).
- :func:`open_append` + :func:`append_durable` — WAL append: ONE
  ``os.write`` on an O_APPEND fd (atomic at the file level — writers in
  different lock domains cannot interleave partial lines) then fsync; a
  short write raises :class:`ShortWriteError` LOUDLY instead of finishing
  the line (finishing would interleave with other writers; the caller
  fails the mutation and the record commits whole or not at all).
- :func:`read_wal` — the torn-tail-tolerant line reader (the r12
  MetricsWriter / r18 journal stance, one definition): a torn FINAL line
  is a crash tail and is tolerated (the event was never acknowledged);
  garbage MID-file is corruption and raises :class:`CorruptWalError`.
- :func:`read_json_tolerant` — the atomic-publish reader: a missing or
  unparseable file reads as ``default`` ("nothing published"), because a
  compliant publisher can never leave a tear — torn content only means a
  non-compliant writer or pre-publish state, both of which the documented
  fallback (docs/robustness.md "Durability contracts") covers.

Every op crosses :func:`crashsan.note_op` — the op log, test-armed crash
injection, AND the chaos plan's ``torn_write:file=<durable>,op=N`` faults
(synced into crashsan at ``chaos.configure`` time, so a REAL process dies
at a real durable-op boundary without this crossing ever taking the
injector's lock — see ``_crossing``).  Stdlib-only and jax-free: the
master control plane, the bench tools, and graftlint's artifact writer
all import this.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Callable, List, Optional, Tuple, Union

from elasticdl_tpu_torch.chaos import inject as chaos
from elasticdl_tpu_torch.common import crashsan


class ShortWriteError(OSError):
    """A durable append's single ``os.write`` was cut short (signal
    mid-progress, disk full).  The caller must fail the mutation loudly —
    the torn prefix is on disk as a tolerated crash tail, and retrying
    the whole record keeps appends all-or-nothing."""


class CorruptWalError(ValueError):
    """Garbage MID-file in a WAL: corruption, not a crash tail.  Readers
    must fall back loudly (watermark, full replay), never replay a
    partial history as if it were whole."""


def tmp_path(path: str) -> str:
    """The thread-unique temp name for a publish of ``path``: pid AND
    thread id, because two threads of one process (pod-manager watcher vs
    scale(), worker checkpoint vs drain) can publish the same file
    concurrently and a shared temp name would interleave their writes."""
    return f"{path}.tmp{os.getpid()}.{threading.get_ident()}"


def _crossing(
    kind: str,
    path: str,
    *,
    fd: Optional[int] = None,
    data: Optional[bytes] = None,
    tmp: Optional[str] = None,
) -> None:
    """The injection crossing every durable op makes BEFORE touching disk:
    crashsan's op log, the chaos plan's torn_write faults (handed to
    crashsan at configure time — fired ones die for real via os._exit),
    and the test-armed crash_at countdown.  Deliberately NOT a
    ``chaos.hook`` call: durable ops fire under leaf-declared subsystem
    locks (journal appends under TaskDispatcher._lock) and the injector's
    locksan-wrapped lock must not be acquired there; crashsan's plain
    lock is the one leaf this crossing may take."""
    _file_op, armed, chaos_mode = crashsan.note_op(kind, path)
    if chaos_mode is not None:
        mode = chaos_mode or (
            "torn_append" if kind == "append" else "tmp_torn"
        )
        crashsan.simulate(
            kind, mode, path=path, fd=fd, data=data, tmp=tmp,
            die=chaos.CHAOS_KILL_EXIT_CODE,
        )
    if armed is not None:
        crashsan.simulate(kind, armed, path=path, fd=fd, data=data, tmp=tmp)


def atomic_publish(
    path: str, data: Union[bytes, str], *, fsync: bool = True
) -> str:
    """Commit ``data`` as the complete new content of ``path``.

    Thread-unique temp + write + fsync(file) + ``os.replace`` +
    fsync(directory): a concurrent reader (possibly another process) sees
    the previous complete file or this one, never a tear, and the commit
    survives power loss once this returns.  ``fsync=False`` exists for
    tests that measure everything but the disk."""
    if isinstance(data, str):
        data = data.encode("utf-8")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = tmp_path(path)
    _crossing("publish", path, data=data, tmp=tmp)
    fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    try:
        n = os.write(fd, data)
        if n != len(data):
            raise ShortWriteError(
                f"short write ({n}/{len(data)} bytes) publishing {path}"
            )
        if fsync:
            os.fsync(fd)
    finally:
        os.close(fd)
    os.replace(tmp, path)
    if fsync:
        _fsync_dir(path)
    return path


def atomic_replace(tmp: str, path: str, *, fsync: bool = True) -> str:
    """The publish commit for a temp some other code already wrote (PS
    host-store snapshots via ``store.save(tmp)``, dataset caches): fsync
    the temp's content, rename, fsync the directory.  Callers name the
    temp via :func:`tmp_path` — thread-uniqueness is part of the shape."""
    _crossing("replace", path, tmp=tmp)
    if fsync:
        fd = os.open(tmp, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    os.replace(tmp, path)
    if fsync:
        _fsync_dir(path)
    return path


def atomic_publish_json(path: str, obj: Any, **dumps_kw: Any) -> str:
    """:func:`atomic_publish` of ``json.dumps(obj)`` — the shape every
    JSON durable (manifest, registry, watermark, artifacts) shares."""
    return atomic_publish(path, json.dumps(obj, **dumps_kw))


def open_append(path: str) -> int:
    """The WAL fd: O_APPEND so concurrent writers' single-write appends
    are atomic at the file level (no journal-level lock exists — every
    recording site holds its own subsystem lock)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    return os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)


def append_durable(
    fd: int, data: Union[bytes, str], *, fsync: bool = True, path: str = ""
) -> int:
    """Append one record: ONE ``os.write`` then fsync.  A short write
    raises :class:`ShortWriteError` — the caller fails the mutation (the
    worker retries the RPC; the record commits whole or not at all)
    rather than finishing the line and burying a tear mid-file.
    ``path`` labels the op for crashsan/chaos addressing."""
    if isinstance(data, str):
        data = data.encode("utf-8")
    _crossing("append", path or f"fd{fd}", fd=fd, data=data)
    n = os.write(fd, data)
    if n != len(data):
        raise ShortWriteError(
            f"short durable append ({n}/{len(data)} bytes) to "
            f"{path or fd} — failing the mutation rather than burying a "
            "torn line mid-file"
        )
    if fsync:
        os.fsync(fd)
    return n


def read_wal(
    path: str, decode: Optional[Callable[[str], Any]] = json.loads
) -> Tuple[List[Any], bool]:
    """Parse an append-durable WAL into ``(records, torn_tail)``.

    The one torn-tail-tolerance definition (r12 metrics / r18 journal):
    a record that fails to ``decode`` is tolerated ONLY when nothing but
    whitespace follows it — a crash tail, never acknowledged to anyone.
    Anything unparseable earlier raises :class:`CorruptWalError`; callers
    fall back loudly.  ``decode=None`` yields raw ``bytes`` lines."""
    with open(path, "rb") as f:
        raw = f.read()
    lines = raw.split(b"\n")
    records: List[Any] = []
    torn = False
    for i, line in enumerate(lines):
        if not line.strip():
            continue
        try:
            records.append(
                decode(line.decode("utf-8")) if decode is not None else line
            )
        except (ValueError, UnicodeDecodeError) as e:
            if all(not rest.strip() for rest in lines[i + 1:]):
                torn = True
                break
            raise CorruptWalError(
                f"wal {path} corrupt at line {i + 1} (not a crash tail): {e}"
            ) from e
    return records, torn


def read_json_tolerant(path: str, default: Any = None) -> Any:
    """Read an atomically-published JSON file; absent or unparseable
    reads as ``default``.  Tolerant BY CONTRACT, not by sloppiness: a
    compliant :func:`atomic_publish` can never leave a tear, so garbage
    here means pre-publish state or a non-compliant writer — either way
    "nothing published", and the caller's documented fallback (full
    replay, fresh start, previous manifest) covers it."""
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except OSError:
        return default
    try:
        return json.loads(raw.decode("utf-8"))
    except (ValueError, UnicodeDecodeError):
        return default


def _fsync_dir(path: str) -> None:
    """fsync the parent directory so the rename's dirent survives power
    loss.  Best-effort: not every filesystem lets a directory be opened
    (or fsync'd) — degrading beats failing a commit that already renamed."""
    d = os.path.dirname(path) or "."
    try:
        fd = os.open(d, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)
