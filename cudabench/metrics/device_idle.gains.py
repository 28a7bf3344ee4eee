"""device_idle.gains: percent of the traced slice (traffic
gains-matfree: slice_steps, one whole DRE step) in
which no device operation ran: one minus the union of the profiler's
device intervals over the slice's length. Moves
dre_device_ms_per_step."""
import harness


def read(ctx):
    return harness.idle_share(ctx.trace)
