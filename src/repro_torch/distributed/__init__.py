"""Sharding rules and the scenario axis over ranks (the JAX package's
``repro.distributed``): parameter, optimizer, batch, activation and cache
specs, their DTensor placements, and the split of a scenario grid's
cells over the ranks of a process group."""
from repro_torch.distributed.sharding import (
    DATA,
    activation_policy,
    active_mesh,
    batch_specs,
    cache_spec_for,
    cache_specs,
    constrain,
    constrain_residual,
    distribute,
    fit_spec,
    opt_state_specs,
    param_spec_for,
    param_specs,
    param_specs_serving,
    placements,
    scenario_mesh,
    shard_scenarios,
)

__all__ = ["DATA", "activation_policy", "active_mesh", "batch_specs",
           "cache_spec_for", "cache_specs", "constrain",
           "constrain_residual", "distribute", "fit_spec",
           "opt_state_specs", "param_spec_for", "param_specs",
           "param_specs_serving", "placements", "scenario_mesh",
           "shard_scenarios"]
