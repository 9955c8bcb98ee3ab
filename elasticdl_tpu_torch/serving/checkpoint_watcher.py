"""Checkpoint watcher — the serving tier's hot-reload trigger.

Polls the training job's published-checkpoint manifest
(``common/checkpoint.publish_manifest``: written by temp + atomic rename
AFTER the Orbax commit and host-store snapshot are both complete) and
invokes ``on_new_step(step, manifest)`` whenever the published step
changes.  Keying off the manifest — never directory listings — is what
makes a reload safe: a step directory exists from the moment Orbax starts
writing it, but the manifest names it only once it is whole, so the watcher
can never hand the server a half-written checkpoint.

The callback runs on the watcher thread; the server's reload
(serving/server.py) does the expensive restore there, CONCURRENT with
serving, and only the final reference swap touches the live path.  A
failing callback must not kill the watcher.  TRANSIENT failures (OSError:
a torn volume, an NFS hiccup mid-restore) retry immediately through the
shared backoff helper (``common/rpc.call_with_backoff`` — r18's one retry
code path, never a hand-rolled loop), because a reload deferred a whole
poll interval is a whole poll interval of stale weights; anything else
(a genuinely corrupt checkpoint) is logged and waits for the next poll
or the next publish — hammering it would fail identically.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Optional

from elasticdl_tpu_torch.common import racesan, trace
from elasticdl_tpu_torch.common.checkpoint import read_manifest
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.common.rpc import BackoffPolicy, call_with_backoff

logger = get_logger("serving.ckpt_watcher")

#: Retry shape for a transiently failing reload: a few fast attempts, then
#: give up until the poll cadence — the volume either heals in milliseconds
#: or the next poll (with fresh manifest state) is the right re-entry.
RELOAD_RETRY_POLICY = BackoffPolicy(
    base_s=0.05, multiplier=2.0, max_s=0.5, jitter=0.2, max_attempts=3
)


# racesan (r16): _applied is single-writer (the watcher thread); the
# main/server-side applied_step() read rides a GIL-atomic int load, so
# the attribute is declared atomic rather than locked.
@racesan.instrument(atomic=("_applied",))
class CheckpointWatcher:
    """Manifest poller: ``on_new_step(step, manifest)`` per published change.

    Any CHANGE of the published step triggers — including a step going
    backwards (a training job restarted from an older checkpoint publishes
    an older step; the serving tier must follow its source of truth, not
    ratchet forward onto weights the trainer abandoned)."""

    def __init__(
        self,
        directory: str,
        on_new_step: Callable[[int, Dict[str, Any]], None],
        poll_interval_s: float = 0.5,
        name: str = "serving",
        initial_step: Optional[int] = None,
    ):
        self.directory = directory
        self.poll_interval_s = poll_interval_s
        self._on_new_step = on_new_step
        # initial_step: the step the server already loaded at startup, so
        # the first poll does not redundantly re-apply it.
        # poke() is "also the deterministic test/bench hook" — callable
        # from any thread — so the consistency story is single-op
        # atomicity (matching the runtime opt-in's atomic=("_applied",)),
        # not a single writer role.
        self._applied: Optional[int] = initial_step  # gil-atomic
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name=f"edl-ckpt-watch:{name}", daemon=True
        )

    def start(self) -> "CheckpointWatcher":
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_interval_s):
            self.poke()

    def poke(self) -> bool:
        """One synchronous poll (the loop body; also the deterministic
        test/bench hook).  True when a new step was applied."""
        m = read_manifest(self.directory)
        if m is None or m["step"] == self._applied:
            return False
        step = int(m["step"])
        try:
            call_with_backoff(
                lambda: self._on_new_step(step, m),
                service="serving.ckpt_watcher",
                is_transient=lambda e: isinstance(e, OSError),
                policy=RELOAD_RETRY_POLICY,
            )
        except Exception:
            logger.exception(
                "hot reload to step %d failed (transient attempts "
                "exhausted, or a non-transient error); retrying at the "
                "poll cadence", step,
            )
            return False
        self._applied = step
        trace.instant("serving:hot_reload", cat="serving", step=step)
        logger.info("hot reload applied: serving checkpoint step %d", step)
        return True

    def applied_step(self) -> Optional[int]:
        """The step the last successful reload applied (None = none yet)."""
        return self._applied

    def stop(self, timeout_s: float = 5.0) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout_s)
