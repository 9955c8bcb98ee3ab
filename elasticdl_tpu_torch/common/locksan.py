# The PyTorch port's own copy of elasticdl_tpu/common/locksan.py: the port imports
# nothing of the JAX package.
"""Runtime lock-order sanitizer — the dynamic twin of graftlint's
``lock-order`` pass.

The static pass (analysis/lock_order.py) proves the LEXICAL acquisition
graph acyclic, but it is blind to locks reached through object attributes
(``self.dispatcher.get_task()`` crossing into another class's lock) and to
orders established only at runtime.  This wrapper closes that half:

- ``locksan.lock(name, leaf=..., before=...)`` returns a plain
  ``threading.Lock`` when ``GRAFT_LOCKSAN`` != ``1`` (zero overhead in
  production) and a sanitized wrapper when it is set — tests/conftest.py
  turns it on for the whole tier-1 suite, so every threaded test (worker,
  servicer, PS, pod manager) runs with runtime order checking.
- Each thread keeps its held-lock stack; each acquisition records the
  edges ``held -> acquired`` (by lock NAME, so the order is a class-level
  contract, instance-agnostic) together with the acquiring stack site.
- An acquisition raises :class:`LockOrderViolation` when it
  (a) re-acquires a non-reentrant lock this thread already holds,
  (b) acquires anything while holding a lock declared ``leaf=True``,
  (c) acquires a lock declared ``before=(<other>,)`` while ``<other>`` is
      held (the declared order, inverted), or
  (d) inverts an order previously OBSERVED anywhere in the process — the
      classic two-thread A->B / B->A deadlock, caught deterministically on
      the second acquisition order without needing the timing to collide.

The ``leaf``/``before`` declarations mirror the ``# lock-order:``
annotations on the declaring line; graftlint's lock-order pass verifies
the two agree, so the static model and the runtime assertions gate each
other.  Same-name locks of DIFFERENT instances (two workers in one test
process) are exempt from pairwise order checks — the name-level order is a
class contract, and peer instances have no defined order.

Pure stdlib: imported by master-process modules, which must stay jax-free
(graftlint import-hygiene).
"""

from __future__ import annotations

import bisect
import os
import threading
import time
import traceback
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = [
    "LockOrderViolation", "enabled", "lock", "rlock", "observed_edges",
    "reset", "held_names", "enable_contention_stats", "contention_snapshot",
]


class LockOrderViolation(AssertionError):
    """A runtime lock acquisition contradicted the declared or previously
    observed order.  Raised BEFORE the offending acquire, so the process
    fails loudly instead of deadlocking quietly later."""


def enabled() -> bool:
    return os.environ.get("GRAFT_LOCKSAN", "") == "1"


#: (held_name, acquired_name) -> "file:line in func" of the first
#: observation.  Process-global: the order contract spans threads and
#: instances, which is the whole point.
_edges: Dict[Tuple[str, str], str] = {}
_edges_lock = threading.Lock()
_tls = threading.local()


def _held() -> List["_SanLock"]:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def _site() -> str:
    """The acquiring frame, skipping locksan internals."""
    for frame in reversed(traceback.extract_stack()[:-2]):
        if os.path.basename(frame.filename) != "locksan.py":
            return f"{frame.filename}:{frame.lineno} in {frame.name}"
    return "<unknown>"


def reset() -> None:
    """Forget observed edges and contention aggregates (test isolation;
    the per-thread held stacks empty themselves when locks release)."""
    with _edges_lock:
        _edges.clear()
    with _stats_lock:
        _stats.clear()


def observed_edges() -> Dict[Tuple[str, str], str]:
    """Snapshot of the observed acquisition orders with their first
    witness site (debugging / tests)."""
    with _edges_lock:
        return dict(_edges)


def held_names() -> Tuple[str, ...]:
    """Names of the sanitized locks the CURRENT thread holds — the lock
    context common/racesan.py records per shared-state observation."""
    return tuple(h.name for h in _held())


# -- contention stats (r16): per-lock-name acquire count + wait histogram.
#
# Recording is OFF until a scrape-side consumer installs it
# (gauge.install_lock_collector); un-installed, each acquire pays one
# module-global check.  Aggregates are raw (count/sum/bucket counts on a
# caller-supplied edge grid) because this module must stay import-light:
# common/gauge.py imports locksan, so the bridge lives THERE and mirrors
# these aggregates into edl_lock_acquire_total / edl_lock_wait_ms at
# scrape time.

_stats_lock = threading.Lock()
_stats_enabled = False
_stats_edges: Tuple[float, ...] = ()
#: name -> [acquire_count, wait_sum_ms, per-bucket counts (len(edges)+1)]
_stats: Dict[str, list] = {}


def enable_contention_stats(edges_ms: Iterable[float]) -> None:
    """Start aggregating per-lock-name wait times on ``edges_ms`` (the
    shared gauge grid).  Idempotent; existing aggregates are kept when
    the grid is unchanged, reset when it differs."""
    global _stats_enabled, _stats_edges
    edges = tuple(float(e) for e in edges_ms)
    with _stats_lock:
        if edges != _stats_edges:
            _stats.clear()
            _stats_edges = edges
        _stats_enabled = True


def contention_snapshot() -> Dict[str, dict]:
    """Per-lock-name ``{"acquires", "wait_ms": {edges, counts, sum,
    count}}`` — the collector's input; empty until stats are enabled and
    a sanitized lock has been acquired."""
    with _stats_lock:
        edges = list(_stats_edges)
        return {
            name: {
                "acquires": rec[0],
                "wait_ms": {
                    "edges": edges, "counts": list(rec[2]),
                    "sum": rec[1], "count": rec[0],
                },
            }
            for name, rec in sorted(_stats.items())
        }


def _record_wait(name: str, wait_ms: float) -> None:
    idx = bisect.bisect_left(_stats_edges, wait_ms)
    with _stats_lock:
        rec = _stats.get(name)
        if rec is None:
            rec = _stats[name] = [0, 0.0, [0] * (len(_stats_edges) + 1)]
        rec[0] += 1
        rec[1] += wait_ms
        rec[2][min(idx, len(rec[2]) - 1)] += 1


class _SanLock:
    """Order-checking wrapper around ``threading.Lock``/``RLock``."""

    def __init__(
        self,
        name: str,
        leaf: bool,
        before: Tuple[str, ...],
        reentrant: bool,
    ):
        self.name = name
        self.leaf = leaf
        self.reentrant = reentrant
        # ``before=("_lock",)`` names sibling attributes; resolve them to
        # full "<Class>.<attr>" names against our own prefix so runtime
        # comparisons match the static lock ids.
        prefix = name.rsplit(".", 1)[0] + "." if "." in name else ""
        self.before = tuple(
            b if "." in b else prefix + b for b in before
        )
        self._lock = threading.RLock() if reentrant else threading.Lock()

    # -- the check --

    def _check_order(self) -> None:
        held = _held()
        if not held:
            return  # fast path: first lock of this thread, nothing to order
        names_to_record = []
        for h in held:
            if h is self:
                if self.reentrant:
                    continue  # RLock re-entry is legal, and orders nothing
                raise LockOrderViolation(
                    f"locksan: {self.name} re-acquired by the thread that "
                    f"already holds it (non-reentrant: self-deadlock) at "
                    f"{_site()}"
                )
            if h.name == self.name:
                # A PEER instance (two workers in one process): the
                # name-level order is a class contract; peers have no
                # defined mutual order — skip pairwise checks.
                continue
            if h.leaf:
                raise LockOrderViolation(
                    f"locksan: {h.name} is declared leaf but {self.name} "
                    f"is being acquired while it is held, at {_site()}"
                )
            if h.name in self.before:
                raise LockOrderViolation(
                    f"locksan: {self.name} is declared before({h.name}) "
                    f"but is being acquired while {h.name} is held, at "
                    f"{_site()}"
                )
            names_to_record.append(h.name)
        if not names_to_record:
            return
        with _edges_lock:
            for hname in names_to_record:
                first = _edges.get((self.name, hname))
                if first is not None:
                    raise LockOrderViolation(
                        f"locksan: lock order inversion — acquiring "
                        f"{self.name} while holding {hname} at {_site()}, "
                        f"but the opposite order ({self.name} before "
                        f"{hname}) was observed at {first}; one of the two "
                        "paths can deadlock against the other"
                    )
            site = _site()
            for hname in names_to_record:
                _edges.setdefault((hname, self.name), site)

    # -- threading.Lock surface --

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        self._check_order()
        if not _stats_enabled:
            got = self._lock.acquire(blocking, timeout)
        else:
            t0 = time.monotonic()
            got = self._lock.acquire(blocking, timeout)
            if got:
                _record_wait(self.name, (time.monotonic() - t0) * 1000.0)
        if got:
            _held().append(self)
        return got

    def release(self) -> None:
        self._lock.release()
        stack = _held()
        # Remove the NEWEST entry for this lock (RLock re-entries release
        # LIFO; non-LIFO release of distinct locks is legal for Lock).
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] is self:
                del stack[i]
                break

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def _is_owned(self) -> bool:
        """``threading.Condition`` compatibility: Condition(lock) prefers the
        lock's own ``_is_owned`` when present.  Without this, Condition's
        fallback probes ownership via a non-blocking re-``acquire`` — which
        the sanitizer (correctly) rejects as a self-deadlock before the probe
        can return False.  Answer from the per-thread held stack instead."""
        return any(h is self for h in _held())

    def locked(self) -> bool:
        # RLock grew .locked() only in 3.12; absent there, report via the
        # held bookkeeping (callers in this repo only probe plain Locks).
        fn = getattr(self._lock, "locked", None)
        if fn is not None:
            return fn()
        return any(h is self for h in _held())

    def __repr__(self) -> str:
        return f"<locksan {self.name} wrapping {self._lock!r}>"


def lock(
    name: str,
    leaf: bool = False,
    before: Iterable[str] = (),
) -> "threading.Lock | _SanLock":
    """A ``threading.Lock`` (sanitized when ``GRAFT_LOCKSAN=1``).

    ``name`` must be ``"<Class>.<attr>"`` (or ``"<attr>"`` for module-level
    locks) — graftlint's lock-order pass checks it against the assignment.
    ``leaf=True``: no other lock may be acquired while this one is held.
    ``before=("_other",)``: this lock orders before the sibling attribute
    ``self._other`` whenever the two nest.
    """
    if not enabled():
        return threading.Lock()
    return _SanLock(name, leaf=leaf, before=tuple(before), reentrant=False)


def rlock(
    name: str,
    leaf: bool = False,
    before: Iterable[str] = (),
) -> "threading.RLock | _SanLock":
    """``threading.RLock`` twin of :func:`lock`."""
    if not enabled():
        return threading.RLock()
    return _SanLock(name, leaf=leaf, before=tuple(before), reentrant=True)
