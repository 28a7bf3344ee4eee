"""krylov.glue_idle_share.gains: percent of the traced slice (one whole
DRE step) in which the device is idle and the innermost host event is
one of the program's DRE spans (utils/profiling.py SPANS of the layers
newton, adi, matfree, krylov and lowrank): the program's own Python
between its operations, no aten operation or launch running. Moves
dre_device_ms_per_step. None where the slice holds none of these spans
(a program without them).

It locates the host's time within the traced step; it is no evidence
that the program's Python changed: over four traced runs of one H100 it
read 16.9-30.3% (quartile spread 58% of the median), following the
host's speed under the profiler, whose bookkeeping between operations
lands here too. A change of the Krylov loop shows in
krylov.host_launches_per_adi.gains and the counters."""

LAYERS = ("newton", "adi", "matfree", "krylov", "lowrank")


def read(ctx):
    from optconpy_tpu_torch.utils import profiling

    names = [s for s in getattr(profiling, "SPANS", ())
             if s.split(".")[0] in LAYERS]
    tr = ctx.trace
    found = [tr.idle_by_host[s] for s in names if s in tr.idle_by_host]
    if not found or tr.window_s <= 0:
        return None
    return 100.0 * sum(found) / tr.window_s
