# The PyTorch port's own copy of elasticdl_tpu/common/wiresan.py: the port imports
# nothing of the JAX package.
"""wiresan — wire-schema sanitizer for the JSON-RPC control plane
(GRAFT_WIRESAN).

The dynamic twin of graftlint v8's wire-discipline / wire-evolution
passes, in the locksan / racesan / jitsan / crashsan stance: the static
passes prove every sender payload and receiver field access matches the
``MessageSchema`` tables in ``common/rpc.py``; this module proves the
MESSAGES THEMSELVES match at runtime, on BOTH ends of the wire.  Armed
(GRAFT_WIRESAN=1, tier-1-wide via conftest), every request AND response
crossing ``JsonRpcClient.call`` / ``make_generic_handler`` is validated
against its method's schema — until r22 only master requests were
checked, so a master returning a malformed response surfaced as a
KeyError deep inside the worker's task loop instead of at the boundary.

Violation grammar (the validate_message contract):

- a missing REQUIRED field, or a required/optional field of the wrong
  type, raises :class:`WireSanViolation` deterministically — a schema
  bug must fail the test that exercises it, not corrupt downstream
  state;
- an UNKNOWN field is counted per method into the stats this module
  serves (``edl_wire_unknown_fields_total{method=}`` via
  ``gauge.install_wire_collector``), never raised: unknown fields are
  the additive-compat mechanism itself (proto3 unknown-field stance —
  a NEWER peer's extra fields must pass through old code unharmed), so
  the right response is visibility, not rejection.

Version mask (``GRAFT_WIRESAN_MASK=<rev>`` or :func:`set_mask`): emulate
an OLD peer by stripping every field whose ``MessageSchema.since``
revision is newer than ``rev`` from outgoing requests and incoming
responses — the client behaves exactly like a peer built at revision
``rev``, which is how tools/wire_skew.py proves a v1-masked worker
completes a real gRPC job against a current master with zero errors and
zero double-trains (the additive-compat proof stamped into the LINT
artifact).  Masking requires the sanitizer armed: a mask with
GRAFT_WIRESAN off would silently strip nothing, so it fails loud
instead (the crashsan arm stance).

Cost contract: disabled, each hook is one ``os.environ`` read (the
crashsan pattern); the control-plane calls it guards already pay a JSON
serialization, so the armed cost (one dict scan per message) is noise.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, Optional


class WireSanViolation(AssertionError):
    """A message violated its method's declared wire schema."""


class WireSanError(AssertionError):
    """Misuse of the sanitizer itself (mask armed while disabled)."""


_lock = threading.Lock()  # lock-order: leaf
_unknown: Dict[str, int] = {}  # guarded-by: _lock
_violations = 0  # guarded-by: _lock
_mask_override: Optional[int] = None  # guarded-by: _lock


def enabled() -> bool:
    return os.environ.get("GRAFT_WIRESAN") == "1"


def active() -> bool:
    """True when any hook should run: armed, or a mask is requested (the
    latter without arming fails loud inside :func:`mask_rev`)."""
    return enabled() or bool(os.environ.get("GRAFT_WIRESAN_MASK")) or (
        _mask_override is not None
    )


def mask_rev() -> Optional[int]:
    """The active version mask (None = no mask).  :func:`set_mask` wins
    over the env var — a test overriding the suite-wide env must not
    need to mutate os.environ."""
    with _lock:
        override = _mask_override
    if override is None:
        raw = os.environ.get("GRAFT_WIRESAN_MASK", "")
        if not raw:
            return None
        override = int(raw)
    if not enabled():
        # Fail LOUD: a masked run with the sanitizer off would strip
        # nothing and "pass" by testing the current protocol.
        raise WireSanError("GRAFT_WIRESAN=1 required to arm the version mask")
    return override


def set_mask(rev: Optional[int]) -> None:
    """Arm (or with None clear) the version mask for this process."""
    global _mask_override
    if rev is not None and not enabled():
        raise WireSanError("GRAFT_WIRESAN=1 required to arm the version mask")
    with _lock:
        _mask_override = None if rev is None else int(rev)


def reset() -> None:
    """Forget counters and the mask override (test isolation)."""
    global _violations, _mask_override
    with _lock:
        _unknown.clear()
        _violations = 0
        _mask_override = None


def stats() -> Dict[str, Any]:
    """``{"unknown_fields": {method: count}, "violations": n}`` — the
    surface the gauge collector and the LINT artifact read."""
    with _lock:
        return {"unknown_fields": dict(_unknown), "violations": _violations}


def _type_ok(value: Any, types: tuple) -> bool:
    # bool subclasses int: reject it for int/float fields (the
    # validate_message stance — {"step": true} must not read as step 1).
    if isinstance(value, bool):
        return bool in types
    return isinstance(value, types)


def check(method: str, msg: Any, schemas: Optional[dict], direction: str) -> None:
    """Validate ``msg`` against ``schemas[method]`` and count unknown
    fields.  Methods outside the table (the PS tier's binary frames) and
    absent tables pass through unjudged — wiresan only enforces contracts
    that are DECLARED."""
    global _violations
    schema = schemas.get(method) if schemas else None
    if schema is None:
        return
    problems = []
    if not isinstance(msg, dict):
        problems.append(f"must be an object, got {type(msg).__name__}")
    else:
        for field, types in schema.required.items():
            if field not in msg:
                problems.append(f"missing required field {field!r}")
            elif not _type_ok(msg[field], types):
                problems.append(
                    f"field {field!r} must be "
                    f"{'/'.join(t.__name__ for t in types)}, "
                    f"got {type(msg[field]).__name__}"
                )
        for field, types in schema.optional.items():
            if (
                field in msg and msg[field] is not None
                and not _type_ok(msg[field], types)
            ):
                problems.append(
                    f"field {field!r} must be "
                    f"{'/'.join(t.__name__ for t in types)}, "
                    f"got {type(msg[field]).__name__}"
                )
        unknown = sum(
            1 for k in msg
            if k not in schema.required and k not in schema.optional
        )
        if unknown:
            with _lock:
                _unknown[method] = _unknown.get(method, 0) + unknown
    if problems:
        with _lock:
            _violations += 1
        raise WireSanViolation(f"{direction} {method}: " + "; ".join(problems))


def mask(method: str, msg: Any, schemas: Optional[dict], rev: int) -> Any:
    """``msg`` as a peer built at wire revision ``rev`` would see it:
    every field newer than ``rev`` (per ``MessageSchema.since``) removed.
    Returns ``msg`` itself when nothing strips (no copy on the fast
    path)."""
    schema = schemas.get(method) if schemas else None
    if schema is None or not isinstance(msg, dict) or not schema.since:
        return msg
    drop = {f for f, r in schema.since.items() if r > rev}
    if not drop or not any(f in msg for f in drop):
        return msg
    return {k: v for k, v in msg.items() if k not in drop}
