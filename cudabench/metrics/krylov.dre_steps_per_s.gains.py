"""krylov.dre_steps_per_s.gains: whole DRE steps over the host's time to
complete them, in the traced run's window before its slice (traffic
gains-matfree: slice_steps[0] steps from the window's start, a fixed
amount of work). On this launch-bound path the host's speed sets it, and
it spreads from run to run with the host (PERF.md, section 2). Moves
dre_device_ms_per_step: fewer or fused launches shorten both."""


def read(ctx):
    units = ctx.trace.units
    steps, seconds = units.get("steps_before"), units.get("seconds_before")
    if not steps or not seconds:
        return None
    return steps / seconds
