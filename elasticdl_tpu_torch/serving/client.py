"""Typed clients for the port's serving tier (serving/server.ServingServer).

Port of ``elasticdl_tpu/serving/client.py``.  Torch-free and numpy-light:
an online caller (a web frontend, a load generator) dials the prediction
service with plain feature lists; the client validates against
SERVING_SCHEMAS before the wire.

Two clients:

- :class:`ServingClient` — one replica.
- :class:`FleetServingClient` — a replica FLEET (serving/fleet.py):
  client-side load balancing by power-of-two-choices over shared
  per-replica inflight counts (two random replicas, route to the less
  loaded), replica health from failure marking + the controller's
  readiness view via ``set_replicas``, and transient faults (a replica
  mid-retirement or killed, answering UNAVAILABLE) retried onto ANOTHER
  replica through the shared backoff helper
  (``common/rpc.call_with_backoff``).
"""

from __future__ import annotations

import random
import time
from typing import Any, Dict, List, Optional

import grpc
import numpy as np

from elasticdl_tpu_torch.common import locksan
from elasticdl_tpu_torch.common.rpc import (
    SERVING_SCHEMAS,
    SERVING_SERVICE_NAME,
    BackoffPolicy,
    JsonRpcClient,
    call_with_backoff,
)


def _jsonable(value: Any) -> Any:
    """Feature value -> JSON-serializable nested lists (numpy arrays and
    scalars included; python lists pass through)."""
    if isinstance(value, np.ndarray):
        return value.tolist()
    if isinstance(value, (np.generic,)):
        return value.item()
    return value


class ServingClient:
    """Blocking Predict/ModelInfo calls to one serving replica."""

    def __init__(self, address: str):
        self.address = address
        self._rpc = JsonRpcClient(
            address, SERVING_SERVICE_NAME, schemas=SERVING_SCHEMAS
        )

    def wait_ready(self, timeout_s: float = 10.0) -> None:
        self._rpc.wait_ready(timeout_s)

    # hot-path: the caller-side request — serialize, one RPC, done
    def predict(
        self, features: Dict[str, Any], timeout_s: float = 30.0,
        lane: str = "online",
    ) -> Dict[str, Any]:
        """``features``: {name: array-like} per the model's feature template
        (ModelInfo reports dtypes/shapes; a single example may omit the
        batch dim).  ``lane``: priority lane ("online" default, "bulk" for
        eval/backfill scoring — weighted admission, shed first).  Returns
        {"outputs": nested lists, "model": name, "step": serving step}."""
        # graftlint: allow[blocking-propagation] _jsonable's .item() is numpy-scalar unboxing, not a device read
        payload = {k: _jsonable(v) for k, v in features.items()}
        request: Dict[str, Any] = {"features": payload}
        if lane != "online":
            # Omitted = online: pre-lane servers never see the field.
            request["lane"] = lane
        return self._rpc.call("Predict", request, timeout_s=timeout_s)

    def predict_outputs(
        self, features: Dict[str, Any], timeout_s: float = 30.0
    ) -> np.ndarray:
        """predict() with the outputs as a numpy array (the common case)."""
        return np.asarray(self.predict(features, timeout_s)["outputs"])

    def model_info(self, timeout_s: float = 10.0) -> Dict[str, Any]:
        return self._rpc.call("ModelInfo", {}, timeout_s=timeout_s)

    def close(self) -> None:
        self._rpc.close()


#: Retry shape for fleet predicts: three attempts, fast — each retry
#: RE-PICKS a replica, so the point is routing around one dead/retiring
#: replica, not waiting one out.
FLEET_RETRY_POLICY = BackoffPolicy(
    base_s=0.05, multiplier=2.0, max_s=0.5, jitter=0.2, max_attempts=3
)

#: How long a replica that just failed transiently sits out of p2c picks.
#: Short on purpose: a retiring replica disappears from ``set_replicas``
#: anyway; this only bridges the gap until the membership refresh.
SUSPECT_S = 1.0


def _is_transient_fleet_error(e: BaseException) -> bool:
    """Worth retrying ON ANOTHER REPLICA: UNAVAILABLE is a replica down or
    mid-retirement.  DEADLINE_EXCEEDED is deliberately NOT transient — the
    request may still be queued server-side, and re-sending it doubles the
    load on a fleet exactly when it is slowest.  Schema errors and sheds
    (RESOURCE_EXHAUSTED from a BatcherOverloaded) are the caller's signal,
    never retried here."""
    return (
        isinstance(e, grpc.RpcError)
        and e.code() == grpc.StatusCode.UNAVAILABLE
    )


class FleetServingClient:
    """Predict across a serving fleet: p2c load balancing + health-aware
    retries.  Thread-safe and meant to be SHARED by every caller thread —
    the inflight counts p2c compares are only meaningful when one instance
    sees the whole process's traffic."""

    def __init__(
        self,
        addresses: List[str],
        policy: BackoffPolicy = FLEET_RETRY_POLICY,
        suspect_s: float = SUSPECT_S,
        rng: Optional[random.Random] = None,
    ):
        if not addresses:
            raise ValueError("FleetServingClient needs at least one address")
        self._policy = policy
        self._suspect_s = suspect_s
        self._rng = rng or random.Random()
        self._lock = locksan.lock("FleetServingClient._lock", leaf=True)  # lock-order: leaf
        self._clients: Dict[str, ServingClient] = {}  # guarded-by: _lock
        self._inflight: Dict[str, int] = {}  # guarded-by: _lock
        self._suspect_until: Dict[str, float] = {}  # guarded-by: _lock
        #: Removed from membership but lingering until in-flight work on
        #: their channel drains — closing a grpc channel CANCELS whatever
        #: is riding it, and CANCELLED is not transient.  guarded-by: _lock
        self._retired: Dict[str, ServingClient] = {}
        self.set_replicas(addresses)

    def set_replicas(self, addresses: List[str]) -> None:
        """Refresh fleet membership (the controller's readiness view —
        ``ServingFleetController.ready_addresses``).  New replicas join the
        pick set immediately; removed ones leave it immediately but their
        channels LINGER until in-flight requests drain — an eager
        channel.close() cancels the requests still riding it (CANCELLED,
        deliberately not a transient error) and turns the controller's
        graceful drain into client-visible failures.  A lingering replica
        that rejoins (the controller un-drained a scale-down victim) is
        resurrected, warm channel and all."""
        to_close: List[ServingClient] = []
        with self._lock:
            for addr in addresses:
                if addr in self._clients:
                    continue
                revived = self._retired.pop(addr, None)
                self._clients[addr] = revived or ServingClient(addr)
                self._inflight.setdefault(addr, 0)
            for addr in list(self._clients):
                if addr not in addresses:
                    self._retired[addr] = self._clients.pop(addr)
                    self._suspect_until.pop(addr, None)
            for addr in list(self._retired):
                if self._inflight.get(addr, 0) <= 0:
                    to_close.append(self._retired.pop(addr))
                    self._inflight.pop(addr, None)
        for client in to_close:
            client.close()

    def addresses(self) -> List[str]:
        with self._lock:
            return sorted(self._clients)

    # hot-path: replica choice — two dict reads and a comparison, no RPC
    def _pick_locked(self, now: float) -> str:  # guarded-by: _lock
        candidates = [
            a for a in self._clients
            if self._suspect_until.get(a, 0.0) <= now
        ]
        if not candidates:
            # Everyone suspect (whole fleet blinked): fall back to all —
            # shedding at the client with zero attempts would turn a
            # 1-second blip into hard errors.
            candidates = list(self._clients)
        if len(candidates) == 1:
            return candidates[0]
        a, b = self._rng.sample(candidates, 2)
        return a if self._inflight.get(a, 0) <= self._inflight.get(b, 0) else b

    def predict(
        self, features: Dict[str, Any], timeout_s: float = 30.0,
        lane: str = "online",
    ) -> Dict[str, Any]:
        """p2c-routed Predict.  Transient replica failures mark the replica
        suspect and retry on a fresh pick via the shared backoff helper."""

        def attempt() -> Dict[str, Any]:
            now = time.monotonic()
            with self._lock:
                addr = self._pick_locked(now)
                client = self._clients[addr]
                self._inflight[addr] = self._inflight.get(addr, 0) + 1
            try:
                return client.predict(features, timeout_s=timeout_s, lane=lane)
            except grpc.RpcError as e:
                if _is_transient_fleet_error(e):
                    with self._lock:
                        self._suspect_until[addr] = (
                            time.monotonic() + self._suspect_s
                        )
                raise
            finally:
                retired = None
                with self._lock:
                    if addr in self._inflight:
                        self._inflight[addr] -= 1
                        if (addr in self._retired
                                and self._inflight[addr] <= 0):
                            # Last rider off a lingering channel closes it.
                            retired = self._retired.pop(addr)
                            self._inflight.pop(addr, None)
                if retired is not None:
                    retired.close()

        return call_with_backoff(
            attempt,
            service="serving.fleet",
            is_transient=_is_transient_fleet_error,
            policy=self._policy,
        )

    def predict_outputs(
        self, features: Dict[str, Any], timeout_s: float = 30.0,
        lane: str = "online",
    ) -> np.ndarray:
        return np.asarray(
            self.predict(features, timeout_s, lane=lane)["outputs"]
        )

    def inflight(self) -> Dict[str, int]:
        """Live per-replica inflight counts (tests assert p2c spreads)."""
        with self._lock:
            return dict(self._inflight)

    def close(self) -> None:
        with self._lock:
            clients = list(self._clients.values())
            clients.extend(self._retired.values())
            self._clients.clear()
            self._retired.clear()
            self._inflight.clear()
            self._suspect_until.clear()
        for client in clients:
            client.close()
