"""The online serving tier of the PyTorch port.

Import surfaces are split so control-plane processes can run or dial the
service without importing torch:

- torch-free: ``serving.client`` (ServingClient, FleetServingClient),
  ``serving.fleet`` (ServingFleetController, the autoscaler over replica
  pods), ``serving.micro_batcher``, ``serving.embedding_cache``,
  ``serving.checkpoint_watcher``.
- torch-bound: ``serving.server`` (ServingServer, the forward on the
  card or the CPU) and ``serving.main`` (the replica process the fleet
  spawns per slot).

Import the module you need, not the package surface.
"""
