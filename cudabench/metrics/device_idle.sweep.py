"""device_idle.sweep: percent of the traced slice (traffic sweep-b10240:
slice_sweeps, one whole sweep) in which no device operation ran: one
minus the union of the profiler's device intervals over the slice's
length. Moves closed_loop_solves_per_s."""
import harness


def read(ctx):
    return harness.idle_share(ctx.trace)
