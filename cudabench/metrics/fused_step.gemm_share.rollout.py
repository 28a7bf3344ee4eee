"""fused_step.gemm_share.rollout: percent of the device's busy time in the
traced slice (two whole batches of 1024 x 64 steps) spent in GEMM kernels,
the fused step's two (n, n) @ (n, S) products and its tall-skinny
feedback products. A kernel counts as a GEMM when its lower-case name
holds one of GEMM_CLASSES (cuBLAS and CUTLASS kernel names). Moves
closed_loop_solves_per_s."""
GEMM_CLASSES = ("gemm", "cutlass", "xmma", "cublas")


def read(ctx):
    tr = ctx.trace
    t, n = tr.device_seconds(lambda name: any(c in name for c in GEMM_CLASSES))
    if n == 0 or tr.busy_s <= 0:
        return None
    return 100.0 * t / tr.busy_s
