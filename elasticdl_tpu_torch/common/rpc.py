"""JSON-over-gRPC plumbing — the PyTorch port's copy of
``elasticdl_tpu/common/rpc.py`` (the port imports nothing of the JAX
package).  Field for field, its tables are the reference's, so the two
packages speak one wire: a worker of either package completes a job
against a master of the other.

The reference defines its master/PS contract in protobuf (SURVEY.md §2 #12
[U]).  This image ships ``grpcio`` but not ``grpc_tools`` (no protoc python
plugin), so the rebuild keeps gRPC as the wire protocol — HTTP/2, the same
operational surface — with JSON message bodies registered through generic
method handlers instead of generated stubs.  The method table in
``master/servicer.py`` is the contract.
"""

from __future__ import annotations

import dataclasses
import json
import random
import time
from typing import Any, Callable, Dict, Optional, Tuple

import grpc

from elasticdl_tpu_torch import chaos
from elasticdl_tpu_torch.common import gauge as gaugelib
from elasticdl_tpu_torch.common import trace
from elasticdl_tpu_torch.common import wiresan

SERVICE_NAME = "elasticdl.Master"

#: gRPC message cap for the master service, BOTH sides (same stance as the
#: PS tier's GRPC_MAX_MESSAGE_BYTES): the control-plane default of 4 MB
#: was fine for task/report traffic, but a DumpTrace response carries up
#: to a full 65536-event ring per process (~10-16 MB of JSON) — the
#: live-job introspection tool must not break exactly when the trace is
#: large.  64 MB covers several full rings with headroom.
GRPC_MAX_MESSAGE_BYTES = 64 << 20

#: Channel/server options applying the cap (send AND receive: the server
#: sends the big dump, the tool receives it).
GRPC_MESSAGE_OPTIONS = [
    ("grpc.max_send_message_length", GRPC_MAX_MESSAGE_BYTES),
    ("grpc.max_receive_message_length", GRPC_MAX_MESSAGE_BYTES),
]

#: CLIENT channel options: the message caps plus a bounded reconnection
#: backoff.  gRPC's default re-dial schedule backs off to 120 s — after
#: ~15 s of refused connections the channel can sit in TRANSIENT_FAILURE
#: for a minute-plus after the server is BACK, failing every call fast
#: without attempting a connection.  That silently defeats the r18
#: master-outage ride-through (the proxy's own jittered backoff governs
#: the retry cadence; the CHANNEL must merely keep probing), so re-dial
#: attempts are capped at 5 s apart.
GRPC_CLIENT_CHANNEL_OPTIONS = GRPC_MESSAGE_OPTIONS + [
    ("grpc.initial_reconnect_backoff_ms", 500),
    ("grpc.min_reconnect_backoff_ms", 500),
    ("grpc.max_reconnect_backoff_ms", 5000),
]

#: Wire-contract version, negotiated at RegisterWorker (the one RPC every
#: worker must issue first).  Bump when a message's shape changes
#: incompatibly; the master rejects a mismatched worker AT REGISTRATION with
#: a structured error naming both versions — not N tasks later with a
#: schema violation mid-job.  A request without the field is accepted
#: (proto3 unknown-field stance: absent = pre-versioning peer).
PROTOCOL_VERSION = 1


@dataclasses.dataclass(frozen=True)
class MessageSchema:
    """Required/optional field names -> accepted python types.

    The proto-less stand-in for the reference's protobuf message definitions:
    a malformed request fails AT THE BOUNDARY with a structured
    INVALID_ARGUMENT naming the field, instead of as a KeyError deep inside a
    handler (VERDICT r2 Missing #5).

    ``since`` (r22) maps a field name to the wire REVISION (the repo's
    r-number) that added it; a field absent from the map is part of the
    v1 baseline.  Only OPTIONAL fields carry a ``since`` — the additive-
    compat stance makes every post-baseline field optional by definition
    (a new REQUIRED field is a PROTOCOL_VERSION bump, which graftlint's
    wire-evolution rule enforces against the committed schema lock).
    The map powers wiresan's version mask: ``GRAFT_WIRESAN_MASK=<rev>``
    emulates an old peer by stripping every field newer than ``rev``
    from outgoing requests and incoming responses."""

    required: Dict[str, Tuple[type, ...]] = dataclasses.field(default_factory=dict)
    optional: Dict[str, Tuple[type, ...]] = dataclasses.field(default_factory=dict)
    since: Dict[str, int] = dataclasses.field(default_factory=dict)


_STR = (str,)
_INT = (int,)
_NUM = (int, float)
_BOOL = (bool,)
_DICT = (dict,)
_LIST = (list,)

#: The master wire contract (kept in lockstep with MasterServicer's method
#: table — asserted by tests).  Unknown fields pass through (forward
#: compatibility, like proto3 unknown fields).
MASTER_SCHEMAS: Dict[str, MessageSchema] = {
    # lease (r9): how many tasks the caller can accept in one response —
    # the master may return up to that many in the response's "tasks"
    # (GetTask) / "entries" (GetGroupTask) list, amortizing one RPC RTT
    # over the batch.  Optional and additive: an absent field means 1,
    # and old callers ignore the extra response keys, so no PROTOCOL_VERSION
    # bump (proto3 unknown-field stance on both sides).
    "GetTask": MessageSchema(
        required={"worker_id": _STR}, optional={"lease": _INT},
        since={"lease": 9},
    ),
    "GetGroupTask": MessageSchema(
        required={"worker_id": _STR, "seq": _INT, "version": _INT},
        optional={"lease": _INT},
        since={"lease": 9},
    ),
    "ReportTaskResult": MessageSchema(
        required={"worker_id": _STR, "task_id": _INT, "success": _BOOL},
        optional={
            "task_type": _STR,
            # requeue (r9): success=False with requeue=True means the task
            # was returned UNSTARTED (lease/prep abandon on preemption or
            # membership change) — the dispatcher requeues it without
            # charging the retry budget, so routine elastic churn cannot
            # poison-abandon a healthy task.  Additive; absent = a real
            # failure.
            "requeue": _BOOL,
            "metrics": _DICT,
            "weight": _NUM,
            "model_version": _INT,
            # Cumulative task-loop wall decomposition (common/metrics.py
            # PhaseTimers.snapshot): {phase_name: seconds}.  Rides every
            # report so the master's JobStatus and the train-job artifact
            # can attribute throughput to named phases without a new RPC.
            "phase_times": _DICT,
            # seq (r18): per-worker monotonically increasing report
            # sequence number.  The master journals the highest seq seen
            # per worker (master/journal.py) and DEDUPES a replayed seq
            # — the exactly-once guard that lets the proxy's outage
            # ride-through retry a report whose first attempt the dying
            # master may or may not have applied.  Additive and
            # optional: an absent field keeps the pre-r18 at-least-once
            # semantics, so no PROTOCOL_VERSION bump (the r9 stance).
            "seq": _INT,
        },
        since={"requeue": 9, "seq": 18},
    ),
    "ReportVersion": MessageSchema(
        required={"model_version": _INT}, optional={"worker_id": _STR}
    ),
    # incarnation/held_tasks (r18): the lease-reconciliation handshake a
    # worker runs after its proxy rode out a master outage (and, with an
    # empty list, at every fresh boot).  ``held_tasks`` is the exact set
    # of training-task ids the worker still holds (buffered leases,
    # in-flight preps, the pipelined pending slot); the master requeues
    # its journal-replayed ``doing`` entries for this worker that the
    # worker does NOT hold (handouts lost in flight during the crash,
    # requeued now instead of after task_timeout_s) and answers with
    # ``stale_tasks`` — held ids the master no longer attributes to this
    # worker, which the worker must drop unstarted (training them would
    # double-train records the master already re-leased).  Additive:
    # absent fields skip the reconcile entirely.
    "RegisterWorker": MessageSchema(
        required={"worker_id": _STR},
        optional={
            "address": _STR, "proto": _INT,
            "incarnation": _STR, "held_tasks": _LIST,
        },
        since={"proto": 9, "incarnation": 18, "held_tasks": 18},
    ),
    "DeregisterWorker": MessageSchema(required={"worker_id": _STR}),
    "Heartbeat": MessageSchema(
        required={"worker_id": _STR},
        # phase_times: group-mode non-rank-0 members never send task
        # reports (rank-0-gated), so their phase snapshot rides the
        # heartbeat — without it the master's per-worker decomposition
        # only ever held rank 0 and a straggler rank was invisible.
        # gang_seq (r13): the rank's lockstep ARRIVAL progress (entries
        # whose device dispatch it has begun), the deadline-bounded gang
        # boundary's per-rank signal.  Consumption counters (boundary
        # ask seq) cannot carry it: prep-ahead and lease batching freeze
        # every rank's consumption at the same value when the gang
        # wedges, so only begun-dispatch — riding the background beat,
        # the one RPC a wedged gang still sends — tells the straggler
        # from the ranks blocked in the collective on it.
        # collective_skips (r15): cumulative in-collective straggler
        # exclusions charged by the worker's in-step deadline gate
        # (graftreduce) — the master banks the newest value per worker
        # into the same bounded-skip ledger the r13 boundary deadline
        # feeds (JobStatus).  Additive and optional: no PROTOCOL_VERSION
        # bump, the r9/r12/r14 stance.
        optional={
            "version": _INT, "phase_times": _DICT, "gang_seq": _INT,
            "collective_skips": _INT,
        },
        since={"gang_seq": 13, "collective_skips": 15},
    ),
    "GetMembership": MessageSchema(),
    "GetCheckpoint": MessageSchema(),
    "ReportCheckpoint": MessageSchema(
        required={"path": _STR, "step": _INT},
        # Same phase snapshot as ReportTaskResult: the final/periodic
        # checkpoint report is the last word a worker sends, so it carries
        # the checkpoint-wire time the task reports cannot yet include.
        # worker_id keys the snapshot to the SAME per-worker slot the task
        # reports fill — without it the master would hold one worker's
        # cumulative timers under two keys and consumers would double-count.
        optional={"phase_times": _DICT, "worker_id": _STR},
    ),
    "JobStatus": MessageSchema(),
    # DumpTrace (r12): the live-job introspection pull — returns every
    # process's shipped trace buffer plus the master's own recorder window
    # (tools/trace_dump.py merges them into one Chrome-trace JSON with
    # clock alignment).  Non-draining: repeated dumps see the same window.
    # A new METHOD is additive by construction (an old master returns
    # UNIMPLEMENTED, an old worker never calls it) — no PROTOCOL_VERSION
    # bump, the same stance as r9's lease field.
    "DumpTrace": MessageSchema(),
}

# trace (r12): the cross-process trace envelope, additive and optional on
# EVERY master method (same no-version-bump stance as r9's lease):
#   {"ctx": [span_id]}            — the caller's live span, injected by
#                                   JsonRpcClient so the servicer's span
#                                   can name its remote parent;
#   {"events": [...],             — a bounded slice of the worker's ring
#    "clock_offset_us": float,      buffer riding the Heartbeat/Report
#    "dropped": int}                channel (the pull path's supply side),
#                                   with the worker's RTT-midpoint clock
#                                   offset vs the master.
# phase_counts rides beside phase_times on the report/heartbeat methods:
# PhaseTimers.counts() — per-phase entry counts, so consumers can compute
# per-phase AVERAGES, not just cumulative sums, from artifacts.
for _method_schema in MASTER_SCHEMAS.values():
    _method_schema.optional.setdefault("trace", _DICT)
    _method_schema.since.setdefault("trace", 12)
for _method in ("ReportTaskResult", "Heartbeat", "ReportCheckpoint"):
    MASTER_SCHEMAS[_method].optional.setdefault("phase_counts", _DICT)
    MASTER_SCHEMAS[_method].since.setdefault("phase_counts", 12)
# gauge (r14): the live-metrics envelope — a worker/PS process's
# ``gauge.Registry.snapshot()`` ({"families": {...}}) riding the same
# heartbeat/report channel as the trace slices, so the master's /metrics
# endpoint can serve the FLEET view (aggregated examples/sec, per-rank
# gang lag, goodput) without a new RPC.  Additive and optional on the
# same three methods as phase_counts — no PROTOCOL_VERSION bump (the
# r9/r12 stance: old peers ignore the field in either direction).
for _method in ("ReportTaskResult", "Heartbeat", "ReportCheckpoint"):
    MASTER_SCHEMAS[_method].optional.setdefault("gauge", _DICT)
    MASTER_SCHEMAS[_method].since.setdefault("gauge", 14)


SERVING_SERVICE_NAME = "elasticdl.Serving"

#: The serving tier's wire contract (serving/server.py's method table —
#: asserted in lockstep by tests, like MASTER_SCHEMAS above).  Feature
#: values ride as JSON lists: online requests are a handful of examples, so
#: JSON's ~4x float inflation is noise here (the bulk-tensor path that
#: justified the PS tier's binary frames moves 6.8 MB pulls; a Predict
#: moves tens of floats).
SERVING_SCHEMAS: Dict[str, MessageSchema] = {
    # features: {feature_name: nested list}, shaped per the model's feature
    # template (ModelInfo reports it).  A single example may omit the
    # leading batch dim; multi-example requests carry it.  lane (optional,
    # r19): priority lane — "online" (default, the latency-SLO lane) or
    # "bulk" (eval scoring; weighted admission, shed first).  Optional so
    # pre-lane clients keep working unchanged — the r9/r12 stance.
    "Predict": MessageSchema(
        required={"features": _DICT}, optional={"lane": _STR},
        since={"lane": 19},
    ),
    "ModelInfo": MessageSchema(),
}


#: Response contracts (r22): the other half of every method's wire shape.
#: Until r22 only REQUESTS were schema-checked — a master returning a
#: malformed response surfaced as a KeyError deep in the worker's task
#: loop, the exact failure mode validate_message exists to prevent.  The
#: same additive-compat grammar applies: every post-baseline field is
#: OPTIONAL with a ``since`` revision (old masters omit it; consumers use
#: ``.get()``, which graftlint's wire-discipline rule enforces), unknown
#: fields pass through counted-not-rejected (common/wiresan.py), and
#: shape violations raise deterministically when GRAFT_WIRESAN=1 arms
#: the checks on both ends of the wire.
MASTER_RESPONSE_SCHEMAS: Dict[str, MessageSchema] = {
    # task is optional because "no task right now" is encoded as an
    # explicit null; tasks (r9) batches up to ``lease`` task dicts with
    # task mirroring the first entry for pre-lease consumers.
    "GetTask": MessageSchema(
        required={"finished": _BOOL},
        optional={"task": _DICT, "tasks": _LIST},
        since={"tasks": 9},
    ),
    "GetGroupTask": MessageSchema(
        required={"finished": _BOOL, "stale": _BOOL},
        optional={"task": _DICT, "entries": _LIST},
        since={"entries": 9},
    ),
    # duplicate (r18): accepted=True with duplicate=True marks a
    # seq-deduped replay — the retried report was already applied before
    # the master restart; the worker treats it as a normal ack.
    "ReportTaskResult": MessageSchema(
        required={"accepted": _BOOL},
        optional={"duplicate": _BOOL},
        since={"duplicate": 18},
    ),
    "ReportVersion": MessageSchema(),
    # The rendezvous membership view; stale_tasks (r18) rides only the
    # reconcile path (a register that declared held_tasks).
    "RegisterWorker": MessageSchema(
        required={
            "version": _INT, "workers": _LIST, "ranks": _DICT,
            "world_size": _INT, "expected": _INT, "confirmed": _DICT,
            "addresses": _DICT,
        },
        optional={"stale_tasks": _LIST},
        since={"stale_tasks": 18},
    ),
    "DeregisterWorker": MessageSchema(required={"version": _INT}),
    # The beat's reply carries every master->worker hint: eval_pending /
    # draining (r9, the lease-recall hints), server_ts_us (r12, the
    # clock-offset stamp), standby_pool (r13).  All optional — a worker
    # masked to an older revision still gets the one field it needs
    # (the membership version driving restart decisions).
    "Heartbeat": MessageSchema(
        required={"version": _INT},
        optional={
            "server_ts_us": _NUM, "eval_pending": _BOOL,
            "standby_pool": _INT, "draining": _BOOL,
        },
        since={
            "eval_pending": 9, "draining": 9, "server_ts_us": 12,
            "standby_pool": 13,
        },
    ),
    "GetMembership": MessageSchema(
        required={
            "version": _INT, "workers": _LIST, "ranks": _DICT,
            "world_size": _INT, "expected": _INT, "confirmed": _DICT,
            "addresses": _DICT,
        },
    ),
    # path is optional because "no checkpoint yet" is an explicit null.
    "GetCheckpoint": MessageSchema(
        required={"step": _INT}, optional={"path": _STR}
    ),
    "ReportCheckpoint": MessageSchema(),
    # The dispatcher counts plus every banked per-worker view.  The
    # conditional sections (journal replay stats, standby depth, eval
    # aggregates) are optional; the rest rides every response.
    "JobStatus": MessageSchema(
        required={
            "todo": _INT, "doing": _INT, "done": _INT, "abandoned": _INT,
            "epoch": _INT, "skipped": _INT, "skip_counts": _DICT,
            "duplicate_done": _INT, "finished": _BOOL,
            "model_version": _INT, "phase_times": _DICT,
            "phase_counts": _DICT, "skipped_ranks": _DICT,
            "collective_skips": _DICT, "stale_reports": _INT,
        },
        optional={
            "journal": _DICT, "standby_pool": _INT,
            "eval_metrics": _DICT, "eval_rounds": _INT,
        },
        since={"journal": 18, "standby_pool": 13, "eval_rounds": 9},
    ),
    "DumpTrace": MessageSchema(
        required={
            "processes": _DICT, "master_events": _LIST,
            "master_dropped": _INT, "master_now_us": _NUM,
        },
    ),
}

#: Serving responses: outputs may be a list (the common case) or a dict
#: of named output heads (_listify preserves dict-shaped model outputs).
SERVING_RESPONSE_SCHEMAS: Dict[str, MessageSchema] = {
    "Predict": MessageSchema(
        required={"outputs": (list, dict), "model": _STR, "step": _INT},
    ),
    "ModelInfo": MessageSchema(
        required={
            "model": _STR, "step": _INT, "max_batch": _INT,
            "max_delay_ms": _NUM, "batch_buckets": _LIST,
            "features": _DICT, "requests": _INT, "reloads": _INT,
            "last_swap_ms": _NUM, "last_load_s": _NUM, "batcher": _DICT,
            "cache": _DICT,
        },
    ),
}

#: service name -> (request schemas, response schemas): the lookup both
#: JsonRpcClient and make_generic_handler default from, so every client
#: and server of a known service validates both directions without each
#: call site wiring the tables through.
SERVICE_SCHEMAS: Dict[str, Tuple[Dict[str, MessageSchema], Dict[str, MessageSchema]]] = {
    SERVICE_NAME: (MASTER_SCHEMAS, MASTER_RESPONSE_SCHEMAS),
    SERVING_SERVICE_NAME: (SERVING_SCHEMAS, SERVING_RESPONSE_SCHEMAS),
}


class SchemaError(ValueError):
    """A message violated its method's schema (the structured boundary error)."""


class RpcOverloaded(RuntimeError):
    """A handler shed the request: the service is past its capacity knee
    and refusing work ON PURPOSE.  The generic handler surfaces any
    subclass as RESOURCE_EXHAUSTED — the structured back-off-or-add-
    capacity signal callers branch on (e.g. the serving fleet client
    never retries it) — instead of an unstructured UNKNOWN."""


# -- the ONE retry/backoff policy (r18) -------------------------------------
#
# Before r18 the repo had three hand-rolled retry loops — the PS client's
# fixed backoff table, the worker's transient-collective retry, and a
# hard-failing channel-readiness wait — each with its own schedule, its own
# (or no) jitter, and its own observability.  They are now ONE code path:
# ``call_with_backoff`` owns exponential backoff + jitter + max-attempts +
# a wall budget, emits ``edl_rpc_retry_total{service=}`` into the
# process-default gauge registry and an ``rpc:retry`` trace instant per
# retry, and every adopter (PS ``RemoteEmbeddingStore._retry``, the
# worker's ``_retry_transient_collective``, ``RpcMasterProxy``'s outage
# ride-through and every readiness wait via ``wait_channel_ready``) just
# declares its schedule and its transience predicate.  The graftlint
# ``rpc-discipline`` rule enforces the readiness half: the raw
# ``grpc.channel_ready_future`` primitive is legal only in this module.


@dataclasses.dataclass(frozen=True)
class BackoffPolicy:
    """Exponential backoff schedule: ``base_s * multiplier**n`` capped at
    ``max_s``, each delay jittered by ``±jitter`` (a fraction).  Retrying
    stops at ``max_attempts`` total attempts (0 = unbounded) or once
    ``budget_s`` of wall clock has elapsed since the first attempt (0 =
    no wall budget); at least one of the two should bound the loop."""

    base_s: float = 0.5
    multiplier: float = 2.0
    max_s: float = 8.0
    jitter: float = 0.2
    max_attempts: int = 0
    budget_s: float = 0.0


def call_with_backoff(
    fn: Callable[[], Any],
    *,
    service: str,
    is_transient: Callable[[BaseException], bool],
    policy: BackoffPolicy,
    on_retry: Optional[Callable[[BaseException, int, float], None]] = None,
    terminal: Optional[Callable[[BaseException, int, float], BaseException]] = None,
    sleep: Callable[[float], None] = time.sleep,
    clock: Callable[[], float] = time.monotonic,
    budget_s_fn: Optional[Callable[[], float]] = None,
) -> Any:
    """Run ``fn()``, retrying errors ``is_transient`` accepts under
    ``policy``.  Non-transient errors surface immediately.  On exhaustion
    the ORIGINAL error re-raises (so adopters' callers keep their error
    contracts), unless ``terminal`` builds a clearer one — it is raised
    ``from`` the original.  ``on_retry(error, attempt, delay_s)`` runs
    before each sleep (adopter-specific logging/instants); the shared
    ``edl_rpc_retry_total{service=}`` counter and ``rpc:retry`` instant
    fire here for every adopter.  ``budget_s_fn`` makes the wall budget
    DYNAMIC — re-read every attempt, so a caller can shrink it under an
    in-flight retry loop (the preemption path cutting a parked
    ride-through short); it overrides ``policy.budget_s``."""
    attempt = 0
    start = clock()
    while True:
        try:
            return fn()
        except BaseException as e:  # noqa: BLE001 — filtered by predicate
            if not is_transient(e):
                raise
            attempt += 1
            elapsed = clock() - start
            # A STATIC budget of 0 means "no wall budget" (attempts bound
            # the loop); a DYNAMIC budget is always active — its 0 means
            # "exhausted NOW" (the preemption path shrinking an in-flight
            # ride-through must fail it fast, never unbound it).
            if budget_s_fn is not None:
                budget_s = budget_s_fn()
                budget_active = True
            else:
                budget_s = policy.budget_s
                budget_active = bool(budget_s)
            exhausted = (
                policy.max_attempts and attempt >= policy.max_attempts
            ) or (budget_active and elapsed >= budget_s)
            if exhausted:
                if terminal is not None:
                    raise terminal(e, attempt, elapsed) from e
                raise
            delay = min(
                policy.base_s * policy.multiplier ** (attempt - 1),
                policy.max_s,
            )
            if policy.jitter:
                delay *= 1.0 + random.uniform(-policy.jitter, policy.jitter)
            if budget_active:
                delay = min(delay, max(0.0, budget_s - elapsed))
            gaugelib.default().counter(
                "edl_rpc_retry_total",
                "transient-error retries through the shared backoff helper",
                labels={"service": service},
            ).inc()
            trace.instant(
                "rpc:retry", cat="rpc.client", service=service,
                attempt=attempt, delay_ms=round(delay * 1e3, 1),
                error=type(e).__name__,
            )
            if on_retry is not None:
                on_retry(e, attempt, delay)
            sleep(delay)


def wait_channel_ready(
    channel,
    *,
    service: str,
    budget_s: float,
    per_try_s: float = 5.0,
    terminal: Optional[Callable[[BaseException, int, float], BaseException]] = None,
    sleep: Callable[[float], None] = time.sleep,
) -> None:
    """THE readiness wait: short ``channel_ready_future`` probes under the
    shared backoff until the channel is ready or ``budget_s`` elapses.
    One hard ``result(timeout=budget)`` (the pre-r18 shape) spends the
    whole budget inside grpc with no retry accounting and no jitter — a
    thundering herd of relaunched workers all re-dialing a restarting
    master at once is exactly when the jitter matters.  graftlint's
    rpc-discipline rule pins every readiness wait to this helper."""

    def probe():
        grpc.channel_ready_future(channel).result(
            timeout=min(per_try_s, budget_s) if budget_s else per_try_s
        )

    call_with_backoff(
        probe,
        service=service,
        is_transient=lambda e: isinstance(e, grpc.FutureTimeoutError),
        policy=BackoffPolicy(
            base_s=0.2, multiplier=2.0, max_s=2.0, jitter=0.2,
            budget_s=budget_s,
        ),
        terminal=terminal,
        sleep=sleep,
    )


def validate_message(
    method: str, msg: Any, schemas: Dict[str, MessageSchema]
) -> None:
    """Raise SchemaError naming every violation in ``msg`` for ``method``."""
    schema = schemas.get(method)
    if schema is None:
        raise SchemaError(f"unknown method {method!r}")
    if not isinstance(msg, dict):
        raise SchemaError(f"{method}: request must be an object, got {type(msg).__name__}")
    def type_ok(value, types) -> bool:
        # bool subclasses int: reject it for int/float fields, else
        # {"model_version": true} would silently bump the version to 1.
        if isinstance(value, bool):
            return bool in types
        return isinstance(value, types)

    problems = []
    for field, types in schema.required.items():
        if field not in msg:
            problems.append(f"missing required field {field!r}")
        elif not type_ok(msg[field], types):
            problems.append(
                f"field {field!r} must be {'/'.join(t.__name__ for t in types)}, "
                f"got {type(msg[field]).__name__}"
            )
    for field, types in schema.optional.items():
        if field in msg and msg[field] is not None and not type_ok(msg[field], types):
            problems.append(
                f"field {field!r} must be {'/'.join(t.__name__ for t in types)}, "
                f"got {type(msg[field]).__name__}"
            )
    if problems:
        raise SchemaError(f"{method}: " + "; ".join(problems))


def _serialize(msg: Dict[str, Any]) -> bytes:
    return json.dumps(msg).encode()


def _deserialize(payload: bytes) -> Dict[str, Any]:
    return json.loads(payload.decode()) if payload else {}


def make_generic_handler(
    service_name: str,
    methods: Dict[str, Callable[[dict], dict]],
    schemas: Optional[Dict[str, MessageSchema]] = None,
    response_schemas: Optional[Dict[str, MessageSchema]] = None,
) -> grpc.GenericRpcHandler:
    """gRPC handler table; with ``schemas``, every request is validated at
    the server boundary and violations abort with INVALID_ARGUMENT (unknown
    methods already return UNIMPLEMENTED via the generic handler).  With
    GRAFT_WIRESAN=1 armed, undeclared request fields are counted per
    method and each handler's OWN response is validated against
    ``response_schemas`` before it serializes (defaulted from
    SERVICE_SCHEMAS for known services) — a malformed response is a
    server bug and raises WireSanViolation in the handler's frame, where
    the stack names the culprit, instead of as a client-side KeyError."""
    if response_schemas is None:
        known = SERVICE_SCHEMAS.get(service_name)
        if known is not None:
            response_schemas = known[1]

    def wrap(name: str, fn: Callable[[dict], dict]):
        def handler(req, ctx):
            if schemas is not None:
                try:
                    validate_message(name, req, schemas)
                except SchemaError as e:
                    ctx.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
            if wiresan.enabled():
                # Counts undeclared request fields (the additive-compat
                # visibility counter); the shape itself was validated
                # above, so a violation here can only be an undeclared
                # SERVICE — schemas=None — which stays unjudged.
                wiresan.check(name, req, schemas, "request")
            # Server half of the RPC span: names its remote parent (the
            # client span id propagated in the trace envelope) so the
            # merged view links one logical RPC across the two processes.
            remote = 0
            if isinstance(req, dict):
                tctx = req.get("trace")
                if isinstance(tctx, dict):
                    # Shape-checked, never trusted: the schema only says
                    # "trace is a dict", and a malformed envelope must
                    # degrade to "no parent" — not turn every method into
                    # an unstructured INTERNAL before its handler runs.
                    tc = tctx.get("ctx")
                    if (
                        isinstance(tc, (list, tuple)) and tc
                        and isinstance(tc[0], int)
                    ):
                        remote = tc[0]
            try:
                with trace.span(
                    f"rpc:{name}", cat="rpc.server",
                    method=name, remote_parent=remote,
                ):
                    resp = fn(req)
                    if wiresan.enabled():
                        wiresan.check(name, resp, response_schemas, "response")
                    return resp
            except SchemaError as e:
                # Contract violations detected INSIDE a handler (e.g. the
                # RegisterWorker protocol-version check) surface as the same
                # structured boundary error, not a generic INTERNAL.
                ctx.abort(grpc.StatusCode.FAILED_PRECONDITION, str(e))
            except RpcOverloaded as e:
                ctx.abort(grpc.StatusCode.RESOURCE_EXHAUSTED, str(e))

        return handler

    handlers = {
        name: grpc.unary_unary_rpc_method_handler(
            wrap(name, fn),
            request_deserializer=_deserialize,
            response_serializer=_serialize,
        )
        for name, fn in methods.items()
    }
    return grpc.method_handlers_generic_handler(service_name, handlers)


class JsonRpcClient:
    """Typed-enough client for a JSON-over-gRPC service.

    Requests to the master service are validated against MASTER_SCHEMAS
    BEFORE they hit the wire, so a malformed message fails in the caller's
    stack frame with a field-naming SchemaError rather than as a remote
    INVALID_ARGUMENT (the server still enforces the same schemas)."""

    def __init__(
        self,
        address: str,
        service_name: str = SERVICE_NAME,
        schemas: Optional[Dict[str, MessageSchema]] = None,
        response_schemas: Optional[Dict[str, MessageSchema]] = None,
    ):
        self._channel = grpc.insecure_channel(
            address, options=GRPC_CLIENT_CHANNEL_OPTIONS
        )
        self._service = service_name
        self._stubs: Dict[str, Callable] = {}
        known = SERVICE_SCHEMAS.get(service_name)
        if schemas is None and known is not None:
            schemas = known[0]
        if response_schemas is None and known is not None:
            response_schemas = known[1]
        self._schemas = schemas
        self._response_schemas = response_schemas

    def wait_ready(self, timeout_s: float = 10.0) -> None:
        wait_channel_ready(
            self._channel, service=self._service, budget_s=timeout_s
        )

    def call(self, method: str, request: Dict[str, Any], timeout_s: float = 30.0):
        if self._schemas is not None:
            validate_message(method, request, self._schemas)
        if method not in self._stubs:
            # graftlint: allow[shared-state] idempotent per-method stub memo: racing creators (loop + beat threads) build equivalent stubs and the dict item set is atomic
            self._stubs[method] = self._channel.unary_unary(
                f"/{self._service}/{method}",
                request_serializer=_serialize,
                response_deserializer=_deserialize,
            )
        # Client half of the RPC span (deadline attribute included — a
        # deadline-bounded wait that times out shows as a span of exactly
        # that length).  The span id propagates in the request's trace
        # envelope; the request dict is COPIED before injection so a caller
        # reusing its dict (retries, pipelined reports) is never mutated.
        sp = trace.span(
            f"rpc:{method}", cat="rpc.client",
            method=method, deadline_s=timeout_s,
        )
        with sp:
            if sp.span_id and isinstance(request, dict):
                envelope = dict(request.get("trace") or {})
                envelope["ctx"] = [sp.span_id]
                request = dict(request)
                request["trace"] = envelope
            # graftchaos hook (no-op when disabled): an armed delay_rpc
            # sleeps HERE — inside the client span, so the injected
            # latency shows in the trace exactly where real network
            # latency would — and a drop_rpc raises ChaosRpcDropped, which
            # the call site sees as a failed RPC (lossy-network shape).
            chaos.hook("rpc:client", method=method)
            if wiresan.active():
                # Outgoing: count undeclared request fields (validation
                # is already always-on above) and apply the version mask
                # — a masked client sends exactly what a peer built at
                # that revision would.
                wiresan.check(method, request, self._schemas, "request")
                rev = wiresan.mask_rev()
                if rev is not None:
                    request = wiresan.mask(method, request, self._schemas, rev)
                response = self._stubs[method](request, timeout=timeout_s)
                # Incoming: the response is validated as sent (a current
                # master's response must satisfy the full contract), then
                # masked — the caller sees the old peer's view of it.
                wiresan.check(
                    method, response, self._response_schemas, "response"
                )
                if rev is not None:
                    response = wiresan.mask(
                        method, response, self._response_schemas, rev
                    )
                return response
            return self._stubs[method](request, timeout=timeout_s)

    def close(self) -> None:
        self._channel.close()
