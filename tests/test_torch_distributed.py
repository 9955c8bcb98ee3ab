"""The port's process-group world (``elasticdl_tpu_torch/parallel/
distributed.py``) against the JAX package's ``parallel/distributed.py``.

The reference's cases of tests/test_distributed.py run through both
``spec_from_membership`` functions; a world of one is a no-op in both.  A
world of two forms over gloo under ``ELASTICDL_TORCH_DEVICE=cpu``, reduces
one tensor and shuts down (tests/_torch_gloo_ranks.py).
"""

import pytest
import torch

from elasticdl_tpu.parallel import distributed as jdist
from elasticdl_tpu_torch.common.device import resolve_device
from elasticdl_tpu_torch.master.rendezvous import RendezvousServer
from elasticdl_tpu_torch.parallel import distributed

from _torch_gloo_ranks import all_reduce_one, run_ranks

MEMBERSHIPS = [
    ({"version": 3, "ranks": {"w-a": 0, "w-b": 1, "w-c": 2}, "world_size": 3,
      "addresses": {"w-a": "10.0.0.1", "w-b": "10.0.0.2", "w-c": "10.0.0.3"}}, "w-b"),
    ({"ranks": {"w-a": 0}, "addresses": {"w-a": "10.0.0.1"}}, "w-a"),
    ({"ranks": {"w-a": 0, "w-b": 1}, "addresses": {}}, "w-a"),
    ({"ranks": {"w-a": 0, "w-b": 1}, "addresses": {"w-b": "10.0.0.2"}}, "w-b"),
    ({"ranks": {"w-a": 0, "w-b": 1}, "addresses": {"w-a": "h0", "w-b": "h1"}}, "w-x"),
]


@pytest.mark.parametrize("membership,worker", MEMBERSHIPS)
def test_spec_from_membership_matches_the_reference(membership, worker):
    got = distributed.spec_from_membership(membership, worker, coordinator_port=9000,
                                           heartbeat_timeout_s=12.0)
    ref = jdist.spec_from_membership(membership, worker, coordinator_port=9000,
                                     heartbeat_timeout_s=12.0)
    assert (got.coordinator_address, got.num_processes, got.process_id, got.enabled) == (
        ref.coordinator_address, ref.num_processes, ref.process_id, ref.enabled)
    if got.enabled:
        assert got.heartbeat_timeout_s == ref.heartbeat_timeout_s == 12.0


def test_the_multihost_case_of_the_reference():
    spec = distributed.spec_from_membership(MEMBERSHIPS[0][0], "w-b", coordinator_port=9000)
    assert spec.enabled and spec.coordinator_address == "10.0.0.1:9000"
    assert (spec.num_processes, spec.process_id) == (3, 1)


def test_initialize_is_a_noop_for_one_process():
    distributed.initialize(distributed.DistributedSpec("", 1, 0), torch.device("cpu"))
    jdist.initialize(jdist.DistributedSpec("", 1, 0))
    assert distributed.active_spec() is None and not torch.distributed.is_initialized()
    distributed.shutdown()  # nothing to destroy


def test_rendezvous_tracks_addresses():
    rdv = RendezvousServer()
    rdv.register("w-b", address="10.0.0.2")
    rdv.register("w-a", address="10.0.0.1")
    m = rdv.membership()
    assert m["addresses"] == {"w-a": "10.0.0.1", "w-b": "10.0.0.2"}
    assert m["ranks"] == {"w-a": 0, "w-b": 1}
    rdv.remove("w-a")
    assert rdv.membership()["addresses"] == {"w-b": "10.0.0.2"}


def test_backend_follows_the_device_unless_set(monkeypatch):
    monkeypatch.delenv(distributed.BACKEND_ENV, raising=False)
    assert distributed.backend_for(torch.device("cpu")) == "gloo"
    assert distributed.backend_for(torch.device("cuda")) == "nccl"
    monkeypatch.setenv(distributed.BACKEND_ENV, "gloo")
    assert distributed.backend_for(torch.device("cuda")) == "gloo"
    monkeypatch.setenv(distributed.BACKEND_ENV, "mpi")
    with pytest.raises(ValueError, match="expected one of"):
        distributed.backend_for(torch.device("cpu"))


def test_advertised_address(monkeypatch):
    monkeypatch.delenv("MY_POD_IP", raising=False)
    assert distributed.advertised_address("localhost:5000") == "127.0.0.1"
    assert distributed.advertised_address("127.0.0.1:5000") == "127.0.0.1"
    monkeypatch.setenv("MY_POD_IP", "10.1.2.3")
    assert distributed.advertised_address("localhost:5000") == "10.1.2.3"


def test_a_world_of_two_forms_reduces_and_shuts_down(monkeypatch):
    monkeypatch.setenv("ELASTICDL_TORCH_DEVICE", "cpu")
    assert resolve_device("cpu").type == "cpu"
    results = run_ranks(all_reduce_one, 2)
    assert results == [(3.0, "gloo", 2), (3.0, "gloo", 2)]
