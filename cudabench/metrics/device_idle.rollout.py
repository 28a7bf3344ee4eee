"""device_idle.rollout: percent of the traced slice (traffic
rollout-b1024: slice_batches, two whole batches of 1024 x 64 steps) in
which no device operation ran: one minus the union of the profiler's
device intervals over the slice's length. Moves closed_loop_solves_per_s."""
import harness


def read(ctx):
    return harness.idle_share(ctx.trace)
