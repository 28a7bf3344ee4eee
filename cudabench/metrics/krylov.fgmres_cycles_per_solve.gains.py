"""krylov.fgmres_cycles_per_solve.gains: FGMRES restart cycles per solve,
from the program's counters (solvers/krylov.py fgmres_cycles over
fgmres_solves), process-wide: every DRE step of the cell, warm-up
included, is the same work. Each cycle is 30 Arnoldi steps and one host
read of the residual. Moves dre_device_ms_per_step. None where the
program has no such counters or ran no solve."""


def read(ctx):
    from optconpy_tpu_torch.solvers import krylov

    solves = getattr(krylov, "fgmres_solves", 0)
    cycles = getattr(krylov, "fgmres_cycles", None)
    if not solves or cycles is None:
        return None
    return cycles / solves
