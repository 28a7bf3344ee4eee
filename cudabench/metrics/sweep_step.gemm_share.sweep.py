"""sweep_step.gemm_share.sweep: percent of the device's busy time in the
traced slice (traffic sweep-b10240: slice_sweeps, one whole sweep of
8 x 1,280 scenarios x 200 steps) spent in GEMM kernels, the sweep step's
batched per-bucket (n, n) @ (n, S) products and its feedback products.
A kernel counts as a GEMM as in fused_step.gemm_share.rollout (its
GEMM_CLASSES). Moves closed_loop_solves_per_s."""
import harness


def read(ctx):
    classes = harness.load_module(
        "metrics", "fused_step.gemm_share.rollout").GEMM_CLASSES
    tr = ctx.trace
    t, n = tr.device_seconds(lambda name: any(c in name for c in classes))
    if n == 0 or tr.busy_s <= 0:
        return None
    return 100.0 * t / tr.busy_s
