"""utils/ — run config, checkpoint cache, metrics, VTK export and the
runtime precision policy."""
from .cache import load_arrays, load_or_comp, save_arrays
from .config import (
    CostConfig,
    OptConConfig,
    ProblemConfig,
    ShardingConfig,
    SolverConfig,
    TimeConfig,
    config_from_json,
)
from .metrics import MetricsLogger, device_timeit
from .runtime import setup

__all__ = [
    "CostConfig",
    "MetricsLogger",
    "OptConConfig",
    "ProblemConfig",
    "ShardingConfig",
    "SolverConfig",
    "TimeConfig",
    "config_from_json",
    "device_timeit",
    "load_arrays",
    "load_or_comp",
    "save_arrays",
    "setup",
]
