"""device_idle.realtime: percent of the traced slice (traffic
realtime-b1: slice_steps, 512 single-scenario steps with their readbacks) in
which no device operation ran: one minus the union of the profiler's
device intervals over the slice's length. Moves step_latency_p95_ms."""
import harness


def read(ctx):
    return harness.idle_share(ctx.trace)
