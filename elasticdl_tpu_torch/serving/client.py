"""Typed client for the port's serving tier (serving/server.ServingServer).

Port of ``elasticdl_tpu/serving/client.py``'s single-replica
``ServingClient``.  An online caller dials the prediction service with
plain feature lists; the client validates against SERVING_SCHEMAS before
the wire.  The fleet client (power-of-two-choices over replicas) belongs
to the fleet slice of the port.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from elasticdl_tpu_torch.common.rpc import (
    SERVING_SCHEMAS,
    SERVING_SERVICE_NAME,
    JsonRpcClient,
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
