"""device_idle.gains_ns: percent of the traced slice (traffic gains-ns:
slice_steps, one whole DRE step on the dense-inverse tier) in which no
device operation ran: one minus the union of the profiler's device
intervals over the slice's length, as device_idle.gains. Moves
dre_device_ms_per_step."""
import harness


def read(ctx):
    return harness.idle_share(ctx.trace)
