"""realtime.glue_idle_us_per_step: microseconds a control step in which
the device is idle and the innermost host event is the program's
rollout.call or rollout.step span (utils/profiling.py): the program's
own Python in mpc.batched_nse_closed_loop between its operations, not
the benchmark loop's around the call, over the traced slice's 512
steps. Moves step_latency_p95_ms. None where the slice holds neither
span (a program without them).

It locates the host's time within a traced step; it is no evidence that
the entry's Python changed. Over six traced runs of one H100 it read
130-307 us a step (quartile spread 56% of the median, 195), following
the traced window a step (778-1,177 us; correlation 0.92), and the
profiler itself added a median 368 us a step (107-525: the slice's
median step latency less that of the steps before it), more than the
reading: its bookkeeping between the operations lands here too. A
change of the entry shows in realtime.host_launches_per_step and the
end-to-end latency."""

NAMES = ("rollout.call", "rollout.step")


def read(ctx):
    tr = ctx.trace
    steps = tr.units.get("steps")
    found = [tr.idle_by_host[s] for s in NAMES if s in tr.idle_by_host]
    if not steps or not found:
        return None
    return 1e6 * sum(found) / steps
