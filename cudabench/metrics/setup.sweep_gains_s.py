"""setup.sweep_gains_s: seconds of the sweep's gains and steppers
(`parallel.build_sweep_gains_and_caches`: per bucket the shifts, the
matrix-free DRE cache and sweep; the steppers' Newton-Schulz chain), on
the harness clock around the call, the device synchronized at its end.
Moves setup_s."""


def read(ctx):
    return ctx.setup.get("sweep_gains_s")
