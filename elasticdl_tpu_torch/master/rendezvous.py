"""Elastic membership: the versioned worker list.

Reference parity (SURVEY.md §2 #5 [D: RendezvousServer named in BASELINE
north_star]): the reference's master hosts a rendezvous server from which
elastic Horovod re-initializes its NCCL/Gloo communicator after membership
changes.  TPU rebuild: the version bump is the signal for workers to rebuild
the ``jax.sharding.Mesh`` (parallel/mesh.MeshManager.reform) and re-place
state from the latest checkpoint — see worker/main loop and SURVEY.md §3.5.

Ranks are assigned deterministically (sorted worker ids) so every worker
derives the same mesh layout from the same membership version without extra
coordination.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

from elasticdl_tpu_torch.common import locksan, racesan, trace


# racesan (r16): every mutable field lives under _lock; _listeners is
# append-at-wiring (before events flow) and list iteration/append are
# single-op atomic, so it is declared atomic rather than locked.
@racesan.instrument(atomic=("_listeners",))
class RendezvousServer:
    def __init__(
        self,
        heartbeat_timeout_s: float = 30.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        # Listeners fire OUTSIDE this lock (see _notify) precisely so no
        # other lock is ever acquired under it.
        self._lock = locksan.lock("RendezvousServer._lock", leaf=True)  # lock-order: leaf
        self._workers: Dict[str, float] = {}  # worker_id -> last heartbeat
        # worker_id -> advertised host (multi-host: seeds the rank-0
        # jax.distributed coordinator; empty for single-host workers)
        self._addresses: Dict[str, str] = {}
        # worker_id -> latest membership version the worker has CONFIRMED
        # applying (via registration or a version-carrying heartbeat).  The
        # lockstep task log uses this to withhold collective tasks until the
        # whole world agrees on the topology — a member acting on a stale
        # view would leave its peers wedged inside a collective.
        self._confirmed: Dict[str, int] = {}
        self._version = 0
        self._timeout = heartbeat_timeout_s
        self._clock = clock
        self._listeners: List[Callable[[int, List[str]], None]] = []
        # Versions whose membership has been FULLY confirmed at least once
        # (every live member heartbeat/registered at that version) — each
        # gets one ``elastic:reformed`` instant, the splice timeline's
        # "the gang is whole again" stage (r13, docs/robustness.md).
        self._reformed: set = set()  # guarded-by: _lock
        # DESIRED world size (the pod manager's fleet target; 0 = unknown).
        # Workers' multihost settle loop forms the world the moment the
        # full expected gang is registered instead of heuristically waiting
        # for version stability — without it, staggered relaunches after a
        # failure form worlds one member at a time, and every late
        # registration restarts everyone who already formed (measured: a
        # 2-pod fleet recovery churned for 54 s on the 1-core harness).
        self._expected = 0

    def add_listener(self, fn: Callable[[int, List[str]], None]) -> None:
        """fn(version, sorted_worker_ids) fires on every membership change."""
        self._listeners.append(fn)

    def _notify(self, version: int, members: List[str]) -> None:
        for fn in self._listeners:
            fn(version, members)

    def register(self, worker_id: str, address: str = "", confirmed: bool = True) -> int:
        """Worker joins (or re-joins). Returns the new membership version.

        A re-registration with a CHANGED address also bumps the version:
        peers cache the coordinator address from the membership view, and a
        worker restarted on a new host within the heartbeat window would
        otherwise never be re-discovered.

        ``confirmed=False`` is the heartbeat-revival path: the worker is
        alive but has NOT (re)applied the current membership — stamping it
        confirmed would let the lockstep task log issue collective work to a
        world one member hasn't actually joined (split-brain).
        """
        with self._lock:
            changed = worker_id not in self._workers or (
                bool(address) and self._addresses.get(worker_id) != address
            )
            self._workers[worker_id] = self._clock()
            if address:
                self._addresses[worker_id] = address
            if not changed:
                if confirmed:
                    self._confirmed[worker_id] = self._version
                    self._maybe_reformed_locked()
                return self._version
            self._version += 1
            if confirmed:
                # Registration hands the worker this very version, so it
                # counts as confirmed; everyone else re-confirms by heartbeat.
                self._confirmed[worker_id] = self._version
            else:
                self._confirmed.pop(worker_id, None)
            self._maybe_reformed_locked()
            members = sorted(self._workers)
            version = self._version
        self._notify(version, members)
        return version

    def remove(self, worker_id: str) -> int:
        with self._lock:
            if worker_id not in self._workers:
                return self._version
            del self._workers[worker_id]
            self._addresses.pop(worker_id, None)
            self._confirmed.pop(worker_id, None)
            self._version += 1
            version, members = self._version, sorted(self._workers)
        self._notify(version, members)
        return version

    def heartbeat(self, worker_id: str, version: Optional[int] = None) -> int:
        """Refresh liveness; re-registers a worker the reaper evicted.

        ``version`` (when the caller sends one) records the membership
        version this worker has confirmed applying — see ``all_confirmed``.
        """
        with self._lock:
            if worker_id in self._workers:
                self._workers[worker_id] = self._clock()
                if version is not None:
                    self._confirmed[worker_id] = int(version)
                    self._maybe_reformed_locked()
                return self._version
        # Revival of an evicted worker: alive, but its address was dropped at
        # eviction and it has not applied the post-revival membership — so it
        # must NOT count as confirmed (the returned version differs from the
        # worker's own, which makes it re-read membership / restart).
        return self.register(worker_id, confirmed=False)

    def _maybe_reformed_locked(self) -> None:  # guarded-by: _lock
        """One ``elastic:reformed`` instant per version, the moment EVERY
        live member has confirmed it — the splice timeline's end of the
        membership transition (trace.instant is a lock-free ring append,
        so emitting under this leaf lock acquires nothing)."""
        v = self._version
        if v in self._reformed or not self._workers:
            return
        if all(self._confirmed.get(w) == v for w in self._workers):
            self._reformed.add(v)
            trace.instant(
                "elastic:reformed", cat="elastic", version=v,
                world=len(self._workers),
            )

    def all_confirmed(self, version: int) -> bool:
        """True iff ``version`` is current and every live member has
        confirmed it (registration or heartbeat)."""
        with self._lock:
            return version == self._version and all(
                self._confirmed.get(w) == self._version for w in self._workers
            )

    def reap_dead(self) -> List[str]:
        """Evict workers whose heartbeat is stale. Returns the evicted ids."""
        with self._lock:
            now = self._clock()
            dead = [
                w for w, t in self._workers.items() if now - t > self._timeout
            ]
            if not dead:
                return []
            for w in dead:
                del self._workers[w]
                self._addresses.pop(w, None)
                self._confirmed.pop(w, None)
            self._version += 1
            version, members = self._version, sorted(self._workers)
        self._notify(version, members)
        return dead

    def seed_version(self, version: int) -> None:
        """Continue version numbering from a journal-replayed pre-crash
        value (r18 master restart).  Monotone and wiring-time only (no
        members yet): a reconnecting worker's re-registration must see a
        version strictly ABOVE anything its pre-crash view held — a
        reused number would read as "nothing changed" to a stale peer."""
        with self._lock:
            self._version = max(self._version, int(version))

    def set_expected(self, n: int) -> None:
        """Record the fleet's desired size (master wires scale() here)."""
        with self._lock:
            self._expected = max(0, int(n))

    def membership(self) -> dict:
        """The worker-visible view: version + deterministic rank assignment."""
        with self._lock:
            members = sorted(self._workers)
            return {
                "version": self._version,
                "workers": members,
                "ranks": {w: i for i, w in enumerate(members)},
                "world_size": len(members),
                "expected": self._expected,
                # Per-member confirmed version (registration or versioned
                # heartbeat).  The settle loop forms the jax.distributed
                # world only when every member confirms the CURRENT
                # version: a stale incarnation (live but about to restart)
                # can't confirm, so fresh relaunches wait for each other
                # instead of forming worlds with members that are leaving.
                "confirmed": {
                    w: self._confirmed[w]
                    for w in members
                    if w in self._confirmed
                },
                "addresses": {
                    w: self._addresses[w] for w in members if w in self._addresses
                },
            }

    def version(self) -> int:
        with self._lock:
            return self._version
