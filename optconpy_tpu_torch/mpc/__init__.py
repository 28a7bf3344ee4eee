"""mpc/ — closed-loop rollouts: linear (LTI) and nonlinear NSE."""
from .nse_rollout import (
    NSEFusedCache,
    NSEStepCache,
    batched_nse_closed_loop,
    batched_nse_closed_loop_fused,
    build_nse_fused,
    build_nse_stepper,
    nse_closed_loop_rollout,
)
from .rollout import (
    batched_closed_loop,
    build_step_cache,
    build_step_cache_dae,
    closed_loop_rollout,
)

__all__ = [
    "NSEFusedCache",
    "NSEStepCache",
    "batched_closed_loop",
    "batched_nse_closed_loop",
    "batched_nse_closed_loop_fused",
    "build_nse_fused",
    "build_nse_stepper",
    "build_step_cache",
    "build_step_cache_dae",
    "closed_loop_rollout",
    "nse_closed_loop_rollout",
]
