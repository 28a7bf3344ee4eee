"""ns_dre.inverse_reads_per_adi.gains_ns: applies of a dense inverse
block per ADI iteration, from the program's counters (solvers/saddle.py
inverse_applies over riccati/lyap_adi.py adi_iterations), process-wide:
every DRE step of the cell, warm-up included, is the same work. The SMW
solve of an iteration applies its shift's block to the right-hand side
and again to U's m columns, so it reads 2.0 while both go through the
block; a solve that merged them would read 1.0. Moves
dre_device_ms_per_step. None where the program has no such counter or
ran no ADI iteration."""


def read(ctx):
    from optconpy_tpu_torch.riccati import lyap_adi
    from optconpy_tpu_torch.solvers import saddle

    iters = getattr(lyap_adi, "adi_iterations", 0)
    applies = getattr(saddle, "inverse_applies", None)
    if not iters or applies is None:
        return None
    return applies / iters
