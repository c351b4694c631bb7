"""Placement of the scenario axis over devices (the JAX package's
``repro.distributed``, scenario part)."""
from repro_torch.distributed.sharding import scenario_mesh, shard_scenarios

__all__ = ["scenario_mesh", "shard_scenarios"]
