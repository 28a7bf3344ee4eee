"""parallel/ — the parameter sweep over Re buckets (config 5) and the
scenario sharding over torch.distributed ranks."""
from .mesh import (
    ScenarioMesh,
    init_multihost,
    replicate,
    scenario_mesh,
    shard_scenarios,
)
from .param_sweep import (
    SweepLayout,
    assign_re_buckets,
    build_sweep_gains_and_caches,
    masked_sweep_stats,
    sharded_sweep_rollout,
    sweep_layout,
    sweep_rollout,
)
from .sharded_mpc import sharded_closed_loop, sharded_nse_rollout

__all__ = [
    "ScenarioMesh",
    "SweepLayout",
    "assign_re_buckets",
    "build_sweep_gains_and_caches",
    "init_multihost",
    "masked_sweep_stats",
    "replicate",
    "scenario_mesh",
    "shard_scenarios",
    "sharded_closed_loop",
    "sharded_nse_rollout",
    "sharded_sweep_rollout",
    "sweep_layout",
    "sweep_rollout",
]
