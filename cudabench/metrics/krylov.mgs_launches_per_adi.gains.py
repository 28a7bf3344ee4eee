"""krylov.mgs_launches_per_adi.gains: launches of the Arnoldi step's MGS
kernel (ops/arnoldi_kernel.py, csrc/mgs_step.cu) that kept w on chip, per
ADI iteration, from the program's counters (arnoldi_kernel.launches_onchip
over riccati/lyap_adi.py adi_iterations), process-wide: every DRE step of
the cell, warm-up included, is the same work. One launch is one Arnoldi
step, so this reads the FGMRES cycles an iteration times 30 when every
step went through the kernel with w on chip; a launch in the kernel's
streamed mode (arnoldi_kernel.launches counts both) would read below
that. Moves dre_device_ms_per_step. None where the program has no such
kernel or counters, or ran no ADI iteration."""


def read(ctx):
    from optconpy_tpu_torch.riccati import lyap_adi

    try:
        from optconpy_tpu_torch.ops import arnoldi_kernel
    except ImportError:  # a program without the kernel
        return None
    iters = getattr(lyap_adi, "adi_iterations", 0)
    onchip = getattr(arnoldi_kernel, "launches_onchip", None)
    if not iters or onchip is None:
        return None
    return onchip / iters
