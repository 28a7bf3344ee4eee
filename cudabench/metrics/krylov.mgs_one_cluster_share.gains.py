"""krylov.mgs_one_cluster_share.gains: the share of the Arnoldi step's MGS
kernel launches (ops/arnoldi_kernel.py, csrc/mgs_step.cu) whose grid was
one thread-block cluster, so that no barrier crossed the card, from the
program's counters (arnoldi_kernel.launches_one_cluster over launches),
process-wide, in %. The gains cell's narrow saddle solves (q = 4) should
take the one-cluster launch and its wide ones several clusters. Moves
dre_device_ms_per_step. None where the program has no such kernel or
counter, or made no launch."""


def read(ctx):
    try:
        from optconpy_tpu_torch.ops import arnoldi_kernel
    except ImportError:  # a program without the kernel
        return None
    launches = getattr(arnoldi_kernel, "launches", 0)
    one = getattr(arnoldi_kernel, "launches_one_cluster", None)
    if not launches or one is None:
        return None
    return 100.0 * one / launches
