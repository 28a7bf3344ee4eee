"""parallel/ — the parameter sweep over Re buckets (config 5)."""
from .param_sweep import (
    assign_re_buckets,
    build_sweep_gains_and_caches,
    masked_sweep_stats,
    sweep_rollout,
)

__all__ = [
    "assign_re_buckets",
    "build_sweep_gains_and_caches",
    "masked_sweep_stats",
    "sweep_rollout",
]
