"""ns_dre.roofline_share.gains_ns: percent of the traced slice's device
busy time (traffic gains-ns: slice_steps, one whole DRE step on the
dense-inverse tier) that the bytes the step needs would take at the HBM
peak: one read of its shift's velocity block (n^2 float32, the
configuration's n) per ADI iteration of the slice, over
roofline.HBM_BYTES_S, over the slice's busy time. The step's share of
its bandwidth bound. The block is counted once an iteration because the
SMW solve needs it once: an apply to the right-hand side and U's m
columns together. A solve that applies it twice
(ns_dre.inverse_reads_per_adi.gains_ns reads 2.0) spends the second read
inside the busy time, so merging the two applies moves this share up.
No hand-written kernel serves the applies (cuBLAS GEMMs), so this is the
mechanism's share, not a kernel's. Moves dre_device_ms_per_step. None
where the slice carries no ADI iterations or no device time."""
import roofline

BYTES_AN_ELEMENT = 4  # the configuration's float32


def read(ctx):
    tr = ctx.trace
    iters = tr.units.get("adi_iters")
    if not iters or tr.busy_s <= 0:
        return None
    n = ctx.cell.config["n"]
    nbytes = iters * n * n * BYTES_AN_ELEMENT
    return 100.0 * (nbytes / roofline.HBM_BYTES_S) / tr.busy_s
