"""mpc/ — closed-loop rollouts (linear LTI and nonlinear NSE) and
receding-horizon MPC."""
from .nse_rollout import (
    NSEFusedCache,
    NSEMatfreeStepCache,
    NSEStepCache,
    batched_nse_closed_loop,
    batched_nse_closed_loop_fused,
    build_nse_fused,
    build_nse_stepper,
    build_nse_stepper_matfree,
    build_sweep_steppers_ns_chain,
    nse_closed_loop_outputs,
    nse_closed_loop_rollout,
    nse_sweep_outputs,
)
from .receding import RHConfig, receding_horizon_mpc
from .rollout import (
    batched_closed_loop,
    build_step_cache,
    build_step_cache_dae,
    closed_loop_rollout,
)

__all__ = [
    "NSEFusedCache",
    "NSEMatfreeStepCache",
    "NSEStepCache",
    "RHConfig",
    "batched_closed_loop",
    "batched_nse_closed_loop",
    "batched_nse_closed_loop_fused",
    "build_nse_fused",
    "build_nse_stepper",
    "build_nse_stepper_matfree",
    "build_step_cache",
    "build_step_cache_dae",
    "build_sweep_steppers_ns_chain",
    "closed_loop_rollout",
    "nse_closed_loop_outputs",
    "nse_closed_loop_rollout",
    "nse_sweep_outputs",
    "receding_horizon_mpc",
]
