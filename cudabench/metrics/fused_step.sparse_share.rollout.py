"""fused_step.sparse_share.rollout: the share of the fused step's steps
(mpc/nse_rollout.py::batched_nse_closed_loop_fused) that applied
P = M/dt + L1 through the SpMM kernel rather than as the dense
pmat = inv_vv P, from the program's counters (nse_rollout.
fused_sparse_steps over it plus fused_dense_steps), process-wide, in %.
A sparse step makes one (n, n) GEMM where a dense one makes two. Moves
closed_loop_solves_per_s. None where the program has no such counter or
took no fused step."""


def read(ctx):
    try:
        from optconpy_tpu_torch.mpc import nse_rollout
    except ImportError:  # a program without the module
        return None
    sparse = getattr(nse_rollout, "fused_sparse_steps", None)
    dense = getattr(nse_rollout, "fused_dense_steps", None)
    if sparse is None or dense is None or sparse + dense == 0:
        return None
    return 100.0 * sparse / (sparse + dense)
