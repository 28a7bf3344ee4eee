"""realtime.host_launches_per_step: the host's kernel and graph launch
calls (profiler runtime events, harness.LAUNCH_CALLS) in the traced slice
(512 control steps), over the steps. Moves step_latency_p95_ms."""


def read(ctx):
    tr = ctx.trace
    steps = tr.units.get("steps")
    if not steps or tr.launches == 0:
        return None
    return tr.launches / steps
