"""k1_conv.roofline_share.sweep: percent of its roofline that the
convection kernel K1 (ops/conv_kernel.py, csrc/conv_p2.cu) reaches in
the traced slice (one whole sweep): the least time of one call on the
sweep's whole state (roofline.k1_work at n, nt and the slice's columns,
every bucket's padded rows included, the larger of the byte and
operation bounds at the H100's peaks) over the mean device time a call
takes, that is the device time of every kernel whose name holds
"conv_p2" over the calls counted by conv_kernel.launches. Moves
closed_loop_solves_per_s."""
import roofline


def read(ctx):
    tr = ctx.trace
    calls = tr.counters.get("k1_launches", 0)
    columns = tr.units.get("columns")
    t, n = tr.device_seconds(lambda name: "conv_p2" in name)
    if calls == 0 or n == 0 or t <= 0 or not columns:
        return None
    cfg = ctx.cell.config
    least, _ = roofline.bound_s(*roofline.k1_work(cfg["n"], cfg["nt"],
                                                  columns))
    return 100.0 * least / (t / calls)
