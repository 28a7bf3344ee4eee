"""krylov.fgmres_capped_share.gains: percent of FGMRES solves returned
above their tolerance at the cycle cap, the Krylov layer's failed solves,
from the program's counters (solvers/krylov.py fgmres_capped over
fgmres_solves), process-wide. Moves dre_device_ms_per_step. None where
the program has no such counters or ran no solve."""


def read(ctx):
    from optconpy_tpu_torch.solvers import krylov

    solves = getattr(krylov, "fgmres_solves", 0)
    capped = getattr(krylov, "fgmres_capped", None)
    if not solves or capped is None:
        return None
    return 100.0 * capped / solves
