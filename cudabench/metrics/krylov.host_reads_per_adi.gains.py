"""krylov.host_reads_per_adi.gains: device-to-host reads of the
matrix-free DRE path per ADI iteration, from the program's counters
(utils/profiling.py host_reads over riccati/lyap_adi.py adi_iterations),
process-wide: the points where the host can dispatch nothing ahead
(FGMRES's residual a cycle, the SMW solve's and the compression's
checks, each counted where it is made; utils/profiling.py names the
sites). Moves dre_device_ms_per_step. None where the program has no such
counters or ran no ADI iteration."""


def read(ctx):
    from optconpy_tpu_torch.riccati import lyap_adi
    from optconpy_tpu_torch.utils import profiling

    iters = getattr(lyap_adi, "adi_iterations", 0)
    reads = getattr(profiling, "host_reads", None)
    if not iters or reads is None:
        return None
    return reads / iters
