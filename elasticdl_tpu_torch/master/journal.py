"""Durable control-plane journal (r18) — master crash survivability.

Before r18 the master was the repo's last single point of failure: the
dispatcher's only durable state was the coarse task-progress watermark
(``job_progress.json``), persisted ONLY at model-checkpoint reports — a
master crash lost every hand-out, report, requeue, gang-log entry and
skip-budget charge since, and a restarted master could do no better than
"skip finished epochs, lose the in-flight shards".  This module is the
fsync'd append-only WAL that closes the gap: every control-plane mutation
records one JSON line, and a restarted master replays the file to the
EXACT pre-crash dispatcher/servicer state (bit-identical, pinned by
tests/test_master_restart.py), then reconciles reconnecting workers'
leases against it.

File format (``<checkpoint_dir>/master_journal.wal``)::

    {"kind": "base", "dispatcher": <full snapshot, incl. the job-shape
     guard: num_shards/num_epochs/task_type>, "group_version": v|null,
     "group_log": [...], "model_version": n, "membership_version": n,
     "report_seqs": {...}, "restarts": k}
    {"kind": "handout", "worker": w, "tasks": [<task dict>, ...]}
    {"kind": "report", "task_id": i, "success": b, "worker": w,
     "requeue": b, "seq": n?}
    {"kind": "recover"|"skip", "worker": w}
    {"kind": "timeout", "tasks": [ids]}
    {"kind": "reconcile", "worker": w, "held": [ids]}
    {"kind": "stop"}
    {"kind": "group_entry", "seq": i, "entry": {...}}
    {"kind": "group_version", "version": v|null}
    {"kind": "membership", "version": n}
    {"kind": "model_version", "version": n}
    {"kind": "report_seq", "worker": w, "seq": n}
    {"kind": "incarnation", "worker": w, "incarnation": s}
    {"kind": "restart"}

Durability/appends: records go through ONE ``os.write`` on an
``O_APPEND`` fd (atomic appends — writers in different lock domains
cannot interleave partial lines) followed by ``fsync``; no journal-level
lock exists, because every recording site already holds its own
subsystem lock and rotation holds ALL of them (see
``MasterServicer.rotate_journal``), which serializes the fd swap against
every writer.

Compaction: the WAL is rotated — a fresh file whose ``base`` record is
the CURRENT full state — every time the coarse watermark persists (the
checkpoint-coupled ``Master._persist_progress``), so the journal stays
bounded by the control-plane traffic of one checkpoint interval and the
two durable artifacts can never disagree for long.  The watermark file
stays: it is the fallback when the journal is missing or corrupt, and
the consistency anchor tying task progress to the restorable model step.

Torn tails (the r12 MetricsWriter stance): a crash mid-append may leave a
torn FINAL line — replay tolerates exactly that (the event was never
acknowledged to anyone).  Garbage MID-file is corruption, not a crash
tail, and raises ``JournalError`` so the master falls back to the
watermark loudly instead of replaying half a history.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional

from elasticdl_tpu_torch.common import durable
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.master.task_dispatcher import (
    JournalReplayError,
    TaskDispatcher,
)

logger = get_logger("master.journal")

JOURNAL_FILENAME = "master_journal.wal"  # durable-file


class JournalError(RuntimeError):
    """The journal file is unusable (mid-file corruption, missing/broken
    base record).  Restart falls back to the coarse watermark."""


class MasterJournal:
    """Append-only fsync'd writer over one O_APPEND fd.

    ``record`` is safe from any thread that holds ITS OWN subsystem lock
    (dispatcher/servicer/group): the single-``os.write`` append is atomic
    at the file level, and ``rotate`` — the only fd swap — runs with all
    of those locks held (MasterServicer.rotate_journal), so no recording
    can straddle a rotation.  ``fsync=False`` exists for tests that
    measure everything but the disk."""

    def __init__(self, path: str, fsync: bool = True):
        self.path = path
        self._fsync = fsync
        self._fd: Optional[int] = None

    def _open(self) -> None:
        self._fd = durable.open_append(self.path)

    def record(self, ev: dict) -> None:
        """Append one event line and make it durable before returning —
        a mutation acknowledged to a worker must survive the crash that
        follows it."""
        if self._fd is None:
            self._open()
        data = json.dumps(ev, sort_keys=True) + "\n"
        try:
            durable.append_durable(
                self._fd, data, fsync=self._fsync, path=self.path
            )
        except durable.ShortWriteError as e:
            # A short write (signal mid-progress, disk full) left a torn
            # line that later appends would bury MID-file — which replay
            # rightly treats as corruption.  durable.append_durable
            # already refused to finish the line (finishing would
            # interleave with other lock domains' appends); surface it as
            # the journal's own error class: the caller's RPC errors, the
            # worker retries, and the record commits whole or not at all.
            raise JournalError(str(e)) from e

    def rotate(self, base: dict) -> None:
        """Compaction: atomically replace the WAL with a fresh file whose
        only record is ``base`` (the CURRENT full state).  The
        durable.atomic_publish commit — a crash mid-rotate leaves either
        the complete old journal or the complete new one."""
        payload = json.dumps(dict(base, kind="base"), sort_keys=True) + "\n"
        durable.atomic_publish(self.path, payload)
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None
        self._open()

    def close(self) -> None:
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None


# recovery-path
def read_journal(path: str):
    """Parse the WAL into ``(base, events, torn_tail)``.

    A torn FINAL line is tolerated (crash mid-append; the event was never
    acknowledged); unparseable content anywhere else raises
    ``JournalError`` — corruption must fall back loudly, never replay a
    partial history as if it were whole.  The tolerance itself is the
    shared reader (durable.read_wal) so the stance cannot drift per WAL."""
    try:
        records, torn = durable.read_wal(path)
    except durable.CorruptWalError as e:
        raise JournalError(str(e)) from e
    if not records or not isinstance(records[0], dict) or (
        records[0].get("kind") != "base"
    ):
        raise JournalError(
            f"journal {path} has no base record — refusing to replay"
        )
    return records[0], records[1:], torn


@dataclasses.dataclass
class ReplayResult:
    """Everything a restarted master adopts from the WAL."""

    dispatcher: TaskDispatcher
    group_version: Optional[int]
    group_log: List[dict]
    model_version: int
    membership_version: int
    report_seqs: Dict[str, int]
    incarnations: Dict[str, str]
    restarts: int
    events_applied: int
    torn_tail: bool


def replay(
    path: str,
    shards,
    *,
    num_epochs: int,
    task_type: str,
    task_timeout_s: float,
    max_task_retries: int = 3,
    task_skip_budget: int = 2,
    base_only: bool = False,
) -> ReplayResult:
    """Rebuild the control plane from the WAL: restore the base snapshot
    into a fresh (journal-less) TaskDispatcher, then re-apply every event
    THROUGH the dispatcher's own mutation code (``replay_event``) so all
    derived transitions — epoch refills, retry/skip budgets, poison
    abandons, duplicate-done accounting — re-derive bit-exactly.  Raises
    ``JournalError``/``JournalReplayError`` when the file is corrupt or
    describes a different job; the caller falls back to the watermark.

    ``base_only`` restores the base snapshot and IGNORES the events: the
    whole-job-restart mode (Master._replay_journal).  The base is written
    at checkpoint-coupled rotation points, so it is consistent with the
    restorable MODEL; the events after it describe progress whose
    gradient updates lived only in worker memory — when the workers died
    with the master, replaying them would mark shards done that the
    restored model never saw (silent data loss).  Skipped-but-journaled
    work simply re-trains: at-least-once, the pre-r18 contract."""
    base, events, torn = read_journal(path)
    if base_only:
        events = []
    job = base.get("dispatcher") or {}
    if (
        job.get("num_shards") != len(shards)
        or job.get("num_epochs") != num_epochs
        or job.get("task_type") != task_type
    ):
        raise JournalReplayError(
            f"journal {path} is for a different job shape "
            f"({job.get('num_shards')} shards x {job.get('num_epochs')} "
            f"epochs, {job.get('task_type')!r} vs {len(shards)} x "
            f"{num_epochs}, {task_type!r})"
        )
    dispatcher = TaskDispatcher(
        shards,
        num_epochs=num_epochs,
        task_type=task_type,
        task_timeout_s=task_timeout_s,
        max_task_retries=max_task_retries,
        task_skip_budget=task_skip_budget,
        restore=base["dispatcher"],
    )
    group_version = base.get("group_version")
    group_log = list(base.get("group_log") or [])
    model_version = int(base.get("model_version") or 0)
    membership_version = int(base.get("membership_version") or 0)
    report_seqs = {
        str(w): int(s) for w, s in (base.get("report_seqs") or {}).items()
    }
    incarnations = {
        str(w): str(i) for w, i in (base.get("incarnations") or {}).items()
    }
    restarts = int(base.get("restarts") or 0)
    applied = 0
    for ev in events:
        kind = ev.get("kind")
        if kind == "group_version":
            group_version = ev["version"]
            group_log = []
        elif kind == "incarnation":
            # A fresh worker incarnation RESETS its seq ledger: without
            # replaying this, the base's dead-incarnation high seq would
            # max() back over the fresh process's low seqs and wrongly
            # dedup its reports.
            incarnations[ev["worker"]] = ev["incarnation"]
            report_seqs.pop(ev["worker"], None)
        elif kind == "restart":
            # A rotation-free restart (full replay keeps the old base):
            # counted on top of the base's restarts.
            restarts += 1
        elif kind == "group_entry":
            if int(ev["seq"]) != len(group_log):
                raise JournalReplayError(
                    f"group log gap: entry seq {ev['seq']} onto a log of "
                    f"{len(group_log)}"
                )
            group_log.append(ev["entry"])
        elif kind == "membership":
            membership_version = max(membership_version, int(ev["version"]))
        elif kind == "model_version":
            model_version = max(model_version, int(ev["version"]))
        elif kind == "report_seq":
            w = ev["worker"]
            report_seqs[w] = max(report_seqs.get(w, 0), int(ev["seq"]))
        else:
            if kind == "report" and ev.get("seq") is not None and ev.get(
                "worker"
            ):
                w = ev["worker"]
                report_seqs[w] = max(report_seqs.get(w, 0), int(ev["seq"]))
            dispatcher.replay_event(ev)
        applied += 1
    return ReplayResult(
        dispatcher=dispatcher,
        group_version=group_version,
        group_log=group_log,
        model_version=model_version,
        membership_version=membership_version,
        report_seqs=report_seqs,
        incarnations=incarnations,
        restarts=restarts,
        events_applied=applied,
        torn_tail=torn,
    )
