"""JSON-over-gRPC plumbing: the serving half of ``elasticdl_tpu/common/rpc.py``.

The PyTorch port keeps its own copy (it imports nothing of the JAX
package).  Only what the serving tier uses is here: the message caps, the
``MessageSchema`` grammar with the serving request and response tables,
the generic server handler, the JSON client, and the shared backoff helper
behind the client's readiness wait.  The master tables and the fault
injector's client hook belong to later slices of the port.
"""

from __future__ import annotations

import dataclasses
import json
import random
import time
from typing import Any, Callable, Dict, Optional, Tuple

import grpc

from elasticdl_tpu_torch.common import gauge as gaugelib
from elasticdl_tpu_torch.common import trace
from elasticdl_tpu_torch.common import wiresan

#: gRPC message cap, BOTH sides (same stance as the
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

SERVING_SERVICE_NAME = "elasticdl.Serving"

#: The serving tier's wire contract (serving/server.py's method table —
#: asserted in lockstep by tests).  Feature
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
#: JsonRpcClient and make_generic_handler default from.
SERVICE_SCHEMAS: Dict[str, Tuple[Dict[str, MessageSchema], Dict[str, MessageSchema]]] = {
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
) -> Any:
    """Run ``fn()``, retrying errors ``is_transient`` accepts under
    ``policy``.  Non-transient errors surface immediately; on exhaustion
    the original error re-raises.  Every retry counts into
    ``edl_rpc_retry_total{service=}`` and leaves an ``rpc:retry`` trace
    instant."""
    attempt = 0
    start = time.monotonic()
    while True:
        try:
            return fn()
        except BaseException as e:  # noqa: BLE001 — filtered by predicate
            if not is_transient(e):
                raise
            attempt += 1
            elapsed = time.monotonic() - start
            exhausted = (
                policy.max_attempts and attempt >= policy.max_attempts
            ) or (policy.budget_s and elapsed >= policy.budget_s)
            if exhausted:
                raise
            delay = min(
                policy.base_s * policy.multiplier ** (attempt - 1),
                policy.max_s,
            )
            if policy.jitter:
                delay *= 1.0 + random.uniform(-policy.jitter, policy.jitter)
            if policy.budget_s:
                delay = min(delay, max(0.0, policy.budget_s - elapsed))
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
            time.sleep(delay)


def wait_channel_ready(
    channel, *, service: str, budget_s: float, per_try_s: float = 5.0
) -> None:
    """THE readiness wait: short ``channel_ready_future`` probes under the
    shared backoff until the channel is ready or ``budget_s`` elapses."""

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

    Requests are validated against the service's request schemas
    BEFORE they hit the wire, so a malformed message fails in the caller's
    stack frame with a field-naming SchemaError rather than as a remote
    INVALID_ARGUMENT (the server still enforces the same schemas)."""

    def __init__(
        self,
        address: str,
        service_name: str,
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
            # Idempotent per-method stub memo: racing creators build
            # equivalent stubs and the dict item set is atomic.
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
