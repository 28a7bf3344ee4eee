"""control/ — LQR feedback and the tracking feedforward sweep."""
from .lqr import (
    build_costate_cache,
    build_costate_cache_dae,
    control_input,
    feedforward_sweep,
)

__all__ = [
    "build_costate_cache",
    "build_costate_cache_dae",
    "control_input",
    "feedforward_sweep",
]
