"""krylov.host_launches_per_adi.gains: the host's kernel and graph launch
calls (profiler runtime events, harness.LAUNCH_CALLS) in the traced slice
(traffic gains-matfree: slice_steps, one whole DRE step of n_newton x
n_adi ADI iterations), over its ADI iterations. Nearly all of them are
FGMRES's: its Arnoldi steps, the matrix-free saddle's K2 products and
the block-Jacobi and pressure-Schur preconditioner. Moves
dre_device_ms_per_step: each launch is a device operation."""


def read(ctx):
    tr = ctx.trace
    iters = tr.units.get("adi_iters")
    if not iters or tr.launches == 0:
        return None
    return tr.launches / iters
