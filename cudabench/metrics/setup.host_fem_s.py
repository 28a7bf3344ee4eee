"""setup.host_fem_s: seconds of the program's host FEM set-up
(`models.cylinder.cylinder_setup`: Taylor-Hood assembly, steady state,
linearization), on the harness clock around the call. Moves setup_s."""


def read(ctx):
    return ctx.setup.get("host_fem_s")
