"""graftchaos — scheduled fault injection, one injector per process.

The repo can MEASURE a straggler (grafttrace, r12) but could not CREATE
one on demand: every tail-tolerance claim (deadline-bounded gang boundary,
warm-standby splice-in, recovery time) was only testable by hoping real
hardware misbehaved on cue.  This module is the supply side — a
stdlib-only fault injector cheap enough to ride in every process, whose
scheduled faults (kill a rank at a step, stall a prep, drop an RPC, delay
a PS pull) turn "the gang survives churn" into a benchable, CI-checkable
property (tools/chaos_bench.py; docs/robustness.md).

Design constraints, in order (grafttrace's, deliberately):

- **Hot-path safe when disabled.**  The hook points live inside
  ``# hot-path`` functions (the worker task loop, ``JsonRpcClient.call``,
  the PS pull).  Disabled (the default), the module-level ``hook()`` is
  one attribute check and a return — the ``chaos-discipline`` lint rule
  enforces that call sites use exactly this no-op-when-disabled API, the
  ring-API twin of trace-discipline.
- **Stdlib only.**  The injector rides in the master control plane and
  the jax-free bench tools (graftlint import-hygiene covers the package:
  ``common/rpc.py`` imports it, and the master imports rpc).
- **Attributable.**  Every fired fault emits a ``chaos:*`` trace instant
  (common/trace.py) so injected faults are first-class events in the
  merged cross-process trace — a recovery timeline where the FAULT is
  invisible cannot be decomposed.  (A ``kill`` dies before its buffer
  ships; the master-side pod-failure ``elastic:splice`` detect instant is
  the measured t0 for kills — see docs/robustness.md.)

Plan syntax (``GRAFT_CHAOS`` env var / ``--chaos`` JobConfig flag;
semicolon-separated faults, comma-separated ``key=value`` args)::

    kill:rank=1,step=4
    kill:worker=job-worker-1,step=4      # exact id: relaunched
                                         # incarnations (-rN names) do
                                         # NOT re-match, so a kill cannot
                                         # crash-loop its own relaunch
    kill:target=master,step=3            # r18: kill the MASTER once its
                                         # dispatcher has counted step=N
                                         # done tasks (the master:report
                                         # hook in the servicer) — the
                                         # masterfail bench's crash.
                                         # Default target is the worker.
    stall:rank=0,point=prep,step=2,ms=500,count=2
    stall:rank=0,point=collective,shard=1,ms=2000   # stall ONE dp
                                         # shard's contribution at the
                                         # r15 in-step gate (shard= only
                                         # applies here)
    delay_rpc:method=GetTask,ms=100,count=3
    drop_rpc:method=Heartbeat,count=2,skip=5
    delay_ps:ms=50,count=4
    torn_write:file=master_journal.wal,op=3  # r21: crash THIS process at
                                         # its 4th durable op on that
                                         # file (op= is the per-file
                                         # 0-based index, exact match),
                                         # leaving the on-disk state a
                                         # real mid-op death leaves
                                         # (common/crashsan.py produces
                                         # it; mode= picks which —
                                         # default torn_append for
                                         # appends, tmp_torn for
                                         # publishes), then os._exit.

Fault kinds -> hook points (the wire contract with the call sites):

    kill       worker:task            os._exit(CHAOS_KILL_EXIT_CODE)
               master:report          (target=master only; fires in the
                                      servicer after a report is applied
                                      AND journaled — the hardest crash
                                      point for exactly-once)
    stall      worker:{task,prep,step,collective}  time.sleep(ms)
    delay_rpc  rpc:client             time.sleep(ms) before the send
    drop_rpc   rpc:client             raise ChaosRpcDropped (the caller
                                      sees a failed RPC, exactly as a
                                      lossy network would present one)
    delay_ps   ps:pull                time.sleep(ms) in the PS handler
    torn_write durable:write          crashsan produces the exact on-disk
                                      crash state, then
                                      os._exit(CHAOS_KILL_EXIT_CODE).
                                      NOT a hook() crossing: synced into
                                      crashsan at configure time and
                                      matched at the durable op itself —
                                      durable ops fire under leaf
                                      subsystem locks, where the
                                      injector's lock may not be taken

Match conditions: ``rank=``/``worker=`` against the process context
(``set_context``, updated by the worker on every membership apply),
``step=`` fires once the context step reaches it, ``method=``/``point=``
select call sites, ``skip=`` ignores the first N matching occurrences and
``count=`` bounds total fires (0 = unlimited).  The worker hooks refresh
a per-process step mirror as they cross, so ``step=`` gates rpc faults
too: ``drop_rpc:worker=job-worker-0,step=5,count=0`` blacks out that
rank's RPCs from step 5 on while leaving its join path untouched.  A key
a kind could never match (``method=`` on a stall, ``rank=``/``step=`` on
``delay_ps`` — the PS shard has neither) is a parse error, not a fault
that silently never fires (see ``_KIND_KEYS``).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Dict, List, Optional

from elasticdl_tpu_torch.common import locksan, trace

#: Exit code of a chaos ``kill``: anything other than 0 and the worker's
#: RESTART code (3) maps to a FAILED pod event, so an injected kill charges
#: the slot's relaunch budget exactly as a real crash would — chaos must
#: exercise the REAL failure path, not a polite imitation of it.
CHAOS_KILL_EXIT_CODE = 9


class ChaosError(ValueError):
    """A malformed chaos plan (fail at configure time, not mid-job)."""


class ChaosRpcDropped(RuntimeError):
    """An injected RPC drop: the call site sees a failed RPC."""


#: kind -> hook points it may fire at.
_KIND_POINTS = {
    "kill": ("worker:task", "master:report"),
    "stall": (
        "worker:task", "worker:prep", "worker:step", "worker:collective",
    ),
    "delay_rpc": ("rpc:client",),
    "drop_rpc": ("rpc:client",),
    "delay_ps": ("ps:pull",),
    # torn_write's "point" is the durable-op crossing in common/durable.py,
    # reached via crashsan.set_torn_plan at configure time — hook() never
    # carries it (see _sync_torn_plan), so matches() never sees this kind.
    "torn_write": ("durable:write",),
}

#: Keys each fault KIND accepts (typo'd plans must fail loud at parse —
#: and so must a key the kind would silently ignore: ``method=`` on a
#: stall or ``point=`` on an rpc fault parses into a match condition no
#: hook context can ever satisfy, i.e. a fault that never fires).
#: ``delay_ps`` takes no identity/step keys: the PS shard process has no
#: worker rank and no step mirror, so those conditions could never match.
_KIND_KEYS = {
    "kill": {"rank", "worker", "step", "count", "skip", "target"},
    "stall": {
        "rank", "worker", "step", "point", "shard", "ms", "count", "skip",
    },
    "delay_rpc": {"rank", "worker", "step", "method", "ms", "count", "skip"},
    "drop_rpc": {"rank", "worker", "step", "method", "count", "skip"},
    "delay_ps": {"ms", "count", "skip"},
    # torn_write addresses a durable FILE and its per-file op index, not a
    # worker identity: durable ops fire in whichever process owns the file
    # (master WAL/registry, worker checkpoint manifests), and rank/step
    # conditions could never match the master's crossings.
    "torn_write": {"file", "op", "mode", "count", "skip"},
}


@dataclasses.dataclass
class ChaosFault:
    """One scheduled fault plus its firing state."""

    kind: str
    rank: Optional[int] = None
    worker: str = ""
    step: int = 0
    point: str = ""
    shard: Optional[int] = None
    method: str = ""
    ms: float = 0.0
    count: int = 1
    skip: int = 0
    # kill only: which PROCESS dies.  "" / "worker" = the worker task
    # boundary (pre-r18 behavior); "master" = the servicer's report hook.
    target: str = ""
    # torn_write only: which durable file (basename), which of its ops
    # (per-file 0-based index, EXACT match — unlike step=, a crash point
    # is one op, not "from op N on"), and which crash mode
    # (crashsan.ALL_MODES; "" picks the kind's torn default).
    file: str = ""
    op: Optional[int] = None
    mode: str = ""
    # firing state — guarded by the injector's lock
    seen: int = 0
    fired: int = 0

    def matches(self, point: str, ctx: Dict[str, Any]) -> bool:
        if point not in _KIND_POINTS[self.kind]:
            return False
        if self.kind == "kill":
            # A kill binds to ONE process family: target=master fires
            # only at the servicer's report hook, the default only at the
            # worker task boundary — a plan must never kill both.
            wanted = (
                "master:report" if self.target == "master" else "worker:task"
            )
            if point != wanted:
                return False
        if self.kind == "stall":
            # A stall binds to ONE worker hook point (default: the step
            # dispatch) — "stall the prep" and "stall the step" are
            # different experiments.
            if point != f"worker:{self.point or 'step'}":
                return False
        if self.method and ctx.get("method") != self.method:
            return False
        if self.file and ctx.get("file") != self.file:
            return False
        if self.op is not None and ctx.get("op") != self.op:
            return False
        if self.shard is not None and ctx.get("shard") != self.shard:
            return False
        if self.rank is not None and ctx.get("rank") != self.rank:
            return False
        if self.worker and ctx.get("worker_id") != self.worker:
            return False
        if self.step and int(ctx.get("step") or 0) < self.step:
            return False
        return True


def parse_plan(spec: str) -> List[ChaosFault]:
    """Parse a ``GRAFT_CHAOS`` plan string; raises ChaosError naming the
    offending entry (a typo'd fault silently never firing would make a
    chaos run report tolerance that was never exercised)."""
    faults: List[ChaosFault] = []
    for entry in filter(None, (e.strip() for e in spec.split(";"))):
        kind, _, argstr = entry.partition(":")
        kind = kind.strip()
        if kind not in _KIND_POINTS:
            raise ChaosError(
                f"unknown chaos fault kind {kind!r} in {entry!r} "
                f"(known: {sorted(_KIND_POINTS)})"
            )
        kwargs: Dict[str, Any] = {}
        for item in filter(None, (a.strip() for a in argstr.split(","))):
            if "=" not in item:
                raise ChaosError(f"malformed chaos arg {item!r} in {entry!r}")
            key, value = (s.strip() for s in item.split("=", 1))
            if key not in _KIND_KEYS[kind]:
                raise ChaosError(
                    f"chaos arg {key!r} does not apply to {kind!r} in "
                    f"{entry!r} (accepted: {sorted(_KIND_KEYS[kind])})"
                )
            if key in ("rank", "step", "count", "skip", "shard", "op"):
                kwargs[key] = int(value)
            elif key == "ms":
                kwargs[key] = float(value)
            else:
                kwargs[key] = value
        fault = ChaosFault(kind=kind, **kwargs)
        if fault.kind in ("stall", "delay_rpc", "delay_ps") and fault.ms <= 0:
            raise ChaosError(f"{entry!r} needs ms=<positive duration>")
        if fault.point and fault.point not in (
            "task", "prep", "step", "collective"
        ):
            raise ChaosError(
                f"{entry!r}: point must be task|prep|step|collective, got "
                f"{fault.point!r}"
            )
        if fault.target and fault.target not in ("worker", "master"):
            raise ChaosError(
                f"{entry!r}: target must be worker|master, got "
                f"{fault.target!r}"
            )
        if fault.target == "master" and (fault.rank is not None or fault.worker):
            # The master has neither rank nor worker id: such a condition
            # could never match — a fault that silently never fires (the
            # parse-error stance).
            raise ChaosError(
                f"{entry!r}: rank=/worker= do not apply to target=master"
            )
        if fault.kind == "torn_write":
            from elasticdl_tpu_torch.common import crashsan

            if fault.mode and fault.mode not in crashsan.ALL_MODES:
                # A typo'd mode would fall back to the default and report
                # tolerance for a crash shape that was never produced.
                raise ChaosError(
                    f"{entry!r}: mode must be one of "
                    f"{', '.join(crashsan.ALL_MODES)}, got {fault.mode!r}"
                )
            if os.sep in fault.file:
                # Matching is by basename (the hook's ctx); a path could
                # never match — a fault that silently never fires.
                raise ChaosError(
                    f"{entry!r}: file= takes the durable file's basename, "
                    f"not a path"
                )
            if fault.op is not None and fault.op < 0:
                raise ChaosError(f"{entry!r}: op= must be >= 0")
        if fault.shard is not None and fault.point != "collective":
            # shard= addresses one dp contributor crossing the r15
            # collective gate; no other hook point carries a shard, so
            # the condition could never match — a fault that silently
            # never fires (the parse-error stance above).
            raise ChaosError(
                f"{entry!r}: shard= applies only to point=collective"
            )
        faults.append(fault)
    return faults


def _sync_torn_plan(plan: List[ChaosFault]) -> None:
    """Hand the plan's torn_write faults to crashsan, which owns their
    matching and firing at the durable-op crossing.  torn_write is the
    one fault kind that does NOT route through ``hook``/``fire``: durable
    ops cross under leaf-declared subsystem locks (the master journal
    appends under TaskDispatcher._lock), where acquiring the injector's
    locksan-wrapped lock would be a lock-order violation — crashsan's
    plain leaf lock is the only one that crossing may take."""
    from elasticdl_tpu_torch.common import crashsan

    crashsan.set_torn_plan([
        {
            "file": f.file, "op": f.op, "mode": f.mode,
            "count": f.count, "skip": f.skip,
        }
        for f in plan
        if f.kind == "torn_write"
    ])


class ChaosInjector:
    """The per-process fault schedule plus its firing state.

    ``fire`` is only reached when the module-level ``hook`` saw
    ``enabled`` — the disabled hot path never enters this class.  Firing
    state mutates under a leaf lock (hooks run on task-loop, prep-pool,
    gRPC-handler and PS threads at once); the fault ACTIONS (sleep, raise,
    exit) run outside it.
    """

    def __init__(self, plan: Optional[List[ChaosFault]] = None):
        self.enabled = bool(plan)
        self._plan: List[ChaosFault] = list(plan or [])
        self._lock = locksan.lock("ChaosInjector._lock", leaf=True)  # lock-order: leaf
        self._ctx: Dict[str, Any] = {}  # guarded-by: _lock
        _sync_torn_plan(self._plan)

    # test seam: a kill must be observable without killing the test runner
    _exit = staticmethod(os._exit)

    def set_context(self, **ctx: Any) -> None:
        """Merge process identity (rank, worker_id) into the match context.
        The worker calls this on every membership apply — ranks shift
        across reforms, and a rank-addressed fault must follow them."""
        with self._lock:
            self._ctx.update(ctx)

    def configure(self, spec: str = "", plan: Optional[List[ChaosFault]] = None) -> None:
        """(Re)arm the injector from a plan string or a parsed plan;
        empty disables.  Firing state resets — reconfiguring IS a new
        experiment."""
        if plan is None:
            plan = parse_plan(spec) if spec else []
        with self._lock:
            self._plan = list(plan)
            self.enabled = bool(self._plan)
        # Outside the lock: crashsan's plain lock orders below nothing.
        _sync_torn_plan(plan)

    def stats(self) -> List[dict]:
        """Per-fault seen/fired counters (the bench's injection audit)."""
        with self._lock:
            return [dataclasses.asdict(f) for f in self._plan]

    def fire(self, point: str, ctx: Dict[str, Any]) -> None:
        """Match + fire every armed fault for this hook crossing.  The
        decision runs under the lock; the ACTION (sleep/raise/exit) runs
        outside it so a long stall never serializes other threads' hooks."""
        due: List[ChaosFault] = []
        with self._lock:
            # Persist the worker's step mirror: task/prep/step hooks carry
            # ``step`` per crossing, the rpc hooks do not — remembering
            # the last seen value lets ``step=`` gate the worker-process
            # fault kinds ("black out this rank's RPCs once it reaches
            # step N"), which is how the chaos bench severs a skipped
            # straggler without touching its join path.
            if ctx.get("step") is not None:
                self._ctx["step"] = ctx["step"]
            merged = dict(self._ctx)
            merged.update(ctx)
            for f in self._plan:
                if not f.matches(point, merged):
                    continue
                f.seen += 1
                if f.seen <= f.skip:
                    continue
                if f.count > 0 and f.fired >= f.count:
                    continue
                f.fired += 1
                due.append(f)
        for f in due:
            self._apply(f, point, merged)

    def _apply(self, fault: ChaosFault, point: str, ctx: Dict[str, Any]) -> None:
        # The instant FIRST: a fault that raises or exits must still be
        # attributable in whatever trace window survives.  The stderr
        # line is the audit of last resort: a kill's ring dies with its
        # process and a blacked-out (drop_rpc) process can never ship
        # its ring over a heartbeat — the pod LOG is the one channel a
        # severed process still writes, and chaos_bench counts these
        # lines as its injection audit.
        trace.instant(
            f"chaos:{fault.kind}", cat="chaos", point=point,
            ms=fault.ms, rank=ctx.get("rank"), method=ctx.get("method"),
            step=ctx.get("step"), shard=ctx.get("shard"), fired=fault.fired,
            file=ctx.get("file"), op=ctx.get("op"),
        )
        import sys

        print(
            f"[graftchaos] {fault.kind} at {point} (ctx={ctx})",
            file=sys.stderr, flush=True,
        )
        if fault.kind == "kill":
            # os._exit, not sys.exit: a real crash skips interpreter
            # teardown, and the whole point is to exercise the REAL
            # failure path (pod watcher -> FAILED -> relaunch/splice).
            self._exit(CHAOS_KILL_EXIT_CODE)
        elif fault.kind in ("stall", "delay_rpc", "delay_ps"):
            # The injected stall IS the fault under test — hot-path
            # discipline is owned by the disabled-mode no-op, not here.
            # graftlint: allow[hot-path-sync] the injected stall IS the fault; disabled mode never reaches this
            time.sleep(fault.ms / 1e3)
        elif fault.kind == "drop_rpc":
            raise ChaosRpcDropped(
                f"chaos: dropped RPC {ctx.get('method')!r} "
                f"(fault fired {fault.fired}/{fault.count or 'inf'})"
            )
        # torn_write never reaches fire: it is synced into crashsan at
        # configure time (_sync_torn_plan) and fires at the durable-op
        # crossing itself, under crashsan's plain leaf lock.


# -- the process-global injector -------------------------------------------

#: One injector per process.  GRAFT_CHAOS arms it at import (subprocess
#: workers/PS pods inherit the env); ``configure()`` arms it
#: programmatically (the --chaos job flag via the config bus, tests).
_INJ = ChaosInjector(
    parse_plan(os.environ.get("GRAFT_CHAOS", ""))
    if os.environ.get("GRAFT_CHAOS")
    else None
)


def default() -> ChaosInjector:
    return _INJ


def enabled() -> bool:
    return _INJ.enabled


def configure(spec: str = "", plan: Optional[List[ChaosFault]] = None) -> None:
    _INJ.configure(spec, plan)


def set_context(**ctx: Any) -> None:
    _INJ.set_context(**ctx)


def hook(point: str, **ctx: Any) -> None:
    """The one hot-path-legal entry point (chaos-discipline): a single
    attribute check when disabled, the full match/fire only when a plan
    is armed."""
    if not _INJ.enabled:
        return
    _INJ.fire(point, ctx)
