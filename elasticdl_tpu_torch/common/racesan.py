"""Runtime shared-state sanitizer — the dynamic twin of graftlint's
``shared-state`` pass (v5).

The static pass (analysis/shared_state.py) judges the LEXICAL picture:
``self.<attr>`` sites, inferred thread roles, lexically held locks.  It
is blind to instance confinement, to callables handed through
containers, and to roles only runtime wiring creates.  This module
closes that half, the way ``locksan`` does for lock order:

- ``@racesan.instrument`` opts a class in.  With ``GRAFT_RACESAN`` !=
  ``1`` the decorator returns the class UNTOUCHED — zero overhead in
  production (the grafttrace stance: disabled means not even a wrapper).
  Enabled (tests/conftest.py sets it for the whole tier-1 suite, like
  ``GRAFT_LOCKSAN``), it installs a checking ``__setattr__`` and a
  SAMPLED ``__getattribute__``.
- Every write (and every Nth read) records, per instance and attribute,
  the observing (thread-role, held-locks) pair.  The thread role comes
  from an explicit ``racesan.set_role(...)`` override or the thread's
  name with trailing instance digits stripped (``edl-ingest_3`` ->
  ``edl-ingest``) — the runtime mirror of the static role model.  Held
  locks are ``locksan``'s per-thread stack (enable both sanitizers
  together: with locksan off, wrapped locks are plain and invisible
  here).
- A WRITE raises :class:`RaceSanViolation` when a prior observation on a
  DIFFERENT role shares no held lock with it — the cross-role unguarded
  write, caught deterministically on the second access (edge-based, like
  locksan: the threads never need to actually collide).  Reads only
  record; a racy read surfaces when the writer next writes.

Observations live on the instance itself (per-instance by design: a
thread-confined instance of a shared class must not trip the checks —
the runtime counterpart of the static pass's instance-confinement blind
spot), so the record dies with the object and no global registry grows.

Exemptions mirror the static escape hatches: construction writes —
everything the constructing thread does before any OTHER thread touches
the instance (the happens-before edge is the spawn/hand-off that
publishes ``self``, so this covers subclass ``__init__`` bodies and
pre-publication setup alike) — attributes named in the decorator's
``atomic=`` set (the ``# gil-atomic`` twin), and
``single_writer={"_attr": "role"}`` declarations, which raise on any
write from another role regardless of locks (the ``# single-writer:``
twin) while their legal writes skip the lock-based cross-role check —
reads on other roles ride GIL-atomic loads by declaration.

Pure stdlib, jax-free (imported by master-process control-plane classes).
"""

from __future__ import annotations

import os
import re
import threading
from typing import Dict, Iterable, Optional

from elasticdl_tpu_torch.common import locksan

__all__ = [
    "RaceSanViolation", "enabled", "instrument", "set_role", "thread_role",
]


class RaceSanViolation(AssertionError):
    """A cross-role unguarded write (or a write outside a declared
    single-writer role) on an instrumented attribute.  Raised AT the
    offending write, naming both observations, so the race is a loud
    deterministic failure instead of a once-a-week corruption."""


def enabled() -> bool:
    return os.environ.get("GRAFT_RACESAN", "") == "1"


_tls = threading.local()

#: Read-sampling period: record every Nth read per process.  Writes are
#: never sampled (writes are rare on control planes and are the raising
#:  side); reads only feed the observation set.
_READ_SAMPLE = 8
_read_tick = 0

_DIGITS = re.compile(r"[-_ ]*\d+$")


def set_role(role: Optional[str]) -> None:
    """Explicit role for the CURRENT thread (e.g. a gRPC handler wrapper
    sets ``grpc:MasterServicer``); ``None`` reverts to name inference."""
    _tls.role = role


def thread_role() -> str:
    role = getattr(_tls, "role", None)
    if role is not None:
        return role
    name = threading.current_thread().name
    if name == "MainThread":
        return "main"
    # Peer instances of one pool ("edl-ingest_0/1", "Thread-3") share a
    # role: the role is the concurrency DOMAIN, instance-agnostic —
    # same stance as locksan's name-level lock contract.
    return _DIGITS.sub("", name) or name


def _held_names() -> frozenset:
    return frozenset(locksan.held_names())


def instrument(cls=None, *, atomic: Iterable[str] = (),
               single_writer: Optional[Dict[str, str]] = None):
    """Class decorator opting into runtime shared-state checking.

    ``atomic`` names attributes exempt from cross-role checks (the
    runtime twin of ``# gil-atomic``); ``single_writer`` maps attribute
    -> role that alone may write it (the ``# single-writer:`` twin —
    violations raise regardless of locks held).
    """
    atomic_set = frozenset(atomic)
    writers = dict(single_writer or {})

    def wrap(klass):
        if not enabled():
            return klass  # production: the class is untouched

        orig_init = klass.__init__
        orig_setattr = klass.__setattr__
        orig_getattribute = klass.__getattribute__

        def __init__(self, *args, **kw):
            object.__setattr__(self, "_racesan_obs", {})
            # Construction tracking: everything the constructing thread
            # does before any OTHER thread touches the instance is
            # pre-publication (the hand-off IS the happens-before edge) —
            # this covers subclass __init__ bodies running after
            # super().__init__() returns, which a plain in-init flag
            # cannot see.
            object.__setattr__(
                self, "_racesan_ctor", threading.get_ident()
            )
            object.__setattr__(self, "_racesan_published", False)
            orig_init(self, *args, **kw)

        def _pre_publication(self) -> bool:
            """True while the constructing thread is still the only one
            to have touched the instance (construction exemption); flips
            the published flag on the first other-thread access."""
            inst = object.__getattribute__(self, "__dict__")
            if inst.get("_racesan_published", False):
                return False
            if threading.get_ident() == inst.get("_racesan_ctor"):
                return True
            object.__setattr__(self, "_racesan_published", True)
            return False

        def __setattr__(self, name, value):
            if (
                name.startswith("_racesan")
                or name in atomic_set
                or "_racesan_obs" not in object.__getattribute__(
                    self, "__dict__"
                )
                or _pre_publication(self)
            ):
                orig_setattr(self, name, value)
                return
            role = thread_role()
            declared = writers.get(name)
            if declared is not None:
                if role != declared:
                    raise RaceSanViolation(
                        f"racesan: {klass.__name__}.{name} is declared "
                        f"single-writer role {declared!r} but written from "
                        f"role {role!r}"
                    )
                # The declared writer's writes are legal by contract:
                # record the observation but skip the lock-based
                # cross-role check (readers on other roles ride
                # GIL-atomic loads — the # single-writer: stance).
                _check_and_record(
                    self, klass, name, role, _held_names(), write=False,
                )
            else:
                _check_and_record(
                    self, klass, name, role, _held_names(), write=True,
                )
            orig_setattr(self, name, value)

        def __getattribute__(self, name):
            value = orig_getattribute(self, name)
            if name.startswith("_racesan") or name.startswith("__"):
                return value
            global _read_tick
            _read_tick += 1  # sampling only: a torn tick skews nothing
            if _read_tick % _READ_SAMPLE:
                return value
            try:
                inst = object.__getattribute__(self, "__dict__")
                if (
                    name in inst
                    and name not in atomic_set
                    and "_racesan_obs" in inst
                    and not _pre_publication(self)
                ):
                    _check_and_record(
                        self, klass, name, thread_role(), _held_names(),
                        write=False,
                    )
            except RaceSanViolation:
                raise
            except Exception:
                pass  # the sanitizer must never break a working read
            return value

        klass.__init__ = __init__
        klass.__setattr__ = __setattr__
        klass.__getattribute__ = __getattribute__
        klass._racesan_instrumented = True
        return klass

    return wrap if cls is None else wrap(cls)


def _check_and_record(self, klass, name, role, held, write: bool) -> None:
    """Record the (role, held) observation; on a WRITE, raise when any
    prior observation on another role shares no lock with it."""
    try:
        obs = object.__getattribute__(self, "_racesan_obs")
    except AttributeError:
        # Instrumented subclass whose __init__ never ran (rare: __new__
        # tricks) — observe from here on.
        obs = {}
        object.__setattr__(self, "_racesan_obs", obs)
    by_role = obs.setdefault(name, {})
    if write:
        for other_role, heldsets in by_role.items():
            if other_role == role:
                continue
            for other_held in heldsets:
                if held.isdisjoint(other_held):
                    raise RaceSanViolation(
                        f"racesan: cross-role unguarded write — "
                        f"{klass.__name__}.{name} written on role {role!r} "
                        f"holding {sorted(held) or 'no locks'} after an "
                        f"access on role {other_role!r} holding "
                        f"{sorted(other_held) or 'no locks'}; guard both "
                        "sides with one lock (or declare the attribute "
                        "single-writer/atomic at the opt-in site)"
                    )
    by_role.setdefault(role, set()).add(held)
