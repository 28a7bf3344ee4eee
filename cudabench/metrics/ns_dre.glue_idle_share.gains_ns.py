"""ns_dre.glue_idle_share.gains_ns: percent of the traced slice (one
whole DRE step on the dense-inverse tier) in which the device is idle
and the innermost host event is one of the program's spans of this
path (utils/profiling.py SPANS: inverse.solve, adi.iteration,
newton.solve, lowrank.compress): the program's own Python between its
operations, no aten operation or launch running. Spans the program
lacks are left out (a program without inverse.solve reads the other
three). Moves dre_device_ms_per_step. None where the slice holds none of
these spans. Like krylov.glue_idle_share.gains it places the host's time
within the step and follows the host's speed under the profiler."""

SPANS = ("inverse.solve", "adi.iteration", "newton.solve",
         "lowrank.compress")


def read(ctx):
    tr = ctx.trace
    found = [tr.idle_by_host[s] for s in SPANS if s in tr.idle_by_host]
    if not found or tr.window_s <= 0:
        return None
    return 100.0 * sum(found) / tr.window_s
