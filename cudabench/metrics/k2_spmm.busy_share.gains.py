"""k2_spmm.busy_share.gains: percent of the device's busy time in the
traced slice (one whole DRE step) spent in the SpMM kernel K2
(ops/spmm_kernel.py, csrc/spmm_tile.cu): kernels whose name holds
"spmm". A roofline share needs each call's widths, which the program does
not record yet. Moves dre_device_ms_per_step."""


def read(ctx):
    tr = ctx.trace
    t, n = tr.device_seconds(lambda name: "spmm" in name)
    if n == 0 or tr.busy_s <= 0:
        return None
    return 100.0 * t / tr.busy_s
