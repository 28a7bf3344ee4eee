"""ns_build.passes_per_shift: the Newton-Schulz passes over the whole
saddle per shift built, from the set-up build's record (the driver keeps
build_dre_cache_dae_ns's info["ns_passes"] and its shift count as
ns_build). A pass is one (n + n_p)^2 dense GEMM and one sparse apply
(ns_inverse._ns_pass_saddle), so passes set the build's time; the seed's
refinement, the ladder's rungs, each shift's own pass and its certifying
ones all count (not the M^-1 passes). Moves setup_s. None where set-up
built no shift."""


def read(ctx):
    build = ctx.setup.get("ns_build")
    if not build or not build["shifts"]:
        return None
    return build["ns_passes"] / build["shifts"]
