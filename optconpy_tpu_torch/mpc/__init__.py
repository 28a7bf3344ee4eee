"""mpc/ — closed-loop rollouts."""
from .nse_rollout import (
    NSEFusedCache,
    batched_nse_closed_loop,
    batched_nse_closed_loop_fused,
    build_nse_fused,
)

__all__ = [
    "NSEFusedCache",
    "batched_nse_closed_loop",
    "batched_nse_closed_loop_fused",
    "build_nse_fused",
]
