"""riccati/ — low-rank ADI, Newton-Kleinman and the DRE sweep."""
from .dre import (
    dre_backward_sweep,
    dre_shift_schedule_dae,
    load_or_build_inverse_stack,
)
from .lyap_adi import lowrank_adi
from .newton_kleinman import gain_from_factor, newton_adi_are

__all__ = [
    "dre_backward_sweep",
    "dre_shift_schedule_dae",
    "gain_from_factor",
    "load_or_build_inverse_stack",
    "lowrank_adi",
    "newton_adi_are",
]
