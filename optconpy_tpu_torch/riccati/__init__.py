"""riccati/ — shifts, low-rank ADI, Newton-Kleinman and the DRE sweep."""
from .dre import (
    build_dre_cache,
    build_dre_cache_dae,
    build_dre_cache_dae_krylov,
    build_dre_cache_dae_matfree,
    build_dre_cache_dae_ns,
    dre_backward_sweep,
    dre_shift_schedule,
    dre_shift_schedule_dae,
    load_or_build_inverse_stack,
)
from .lyap_adi import lowrank_adi
from .newton_kleinman import gain_from_factor, newton_adi_are
from .shifts import cycled_shifts, spectral_interval

__all__ = [
    "build_dre_cache",
    "build_dre_cache_dae",
    "build_dre_cache_dae_krylov",
    "build_dre_cache_dae_matfree",
    "build_dre_cache_dae_ns",
    "cycled_shifts",
    "dre_backward_sweep",
    "dre_shift_schedule",
    "dre_shift_schedule_dae",
    "gain_from_factor",
    "load_or_build_inverse_stack",
    "lowrank_adi",
    "newton_adi_are",
    "spectral_interval",
]
