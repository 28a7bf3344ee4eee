"""optconpy_tpu_torch — the PyTorch/CUDA port of optconpy_tpu.

The JAX package `optconpy_tpu` stays the reference; this package mirrors
its module paths and names so each counterpart is easy to find, and is
tested against it. Host-side setup (mesh, Taylor-Hood assembly, steady
state, shift selection, sparse LU) is numpy/scipy code carried over with
its math unchanged; device math is plain torch on tensors, with an
explicit `device` argument wherever tensors are created. The kernels
are hand-written CUDA for Hopper, built by ops/cuda_build.py: the
batched P2 convection N(v)v (csrc/conv_p2.cu, bound in
ops/conv_kernel.py) and the sparse-times-dense product of the
Newton-Schulz inverse build, the matrix-free saddle solves and the
quadrature convection (csrc/spmm_tile.cu, ops/spmm_kernel.py).

Layer map (mirrors optconpy_tpu):
    optcont    the driver optcon_nse: config -> setup -> gains ->
               feedforward -> batched closed loop, on the card by default
    ops/       ELL sparse operator, low-rank algebra, host-LU and
               explicit-inverse caches, the CUDA kernels
    fem/       host discretization (heat1d, Taylor-Hood); LTISystem,
               DAESystem and ConvKernel on tensors
    solvers/   steady state (host), shifted and saddle LU/inverse caches,
               the Newton-Schulz inverse-stack build on the device,
               Krylov solvers and the matrix-free saddle cache
    riccati/   shifts (host), low-rank ADI, Newton-Kleinman, DRE sweep,
               the DRE residual check (host)
    control/   costate caches and the feedforward sweep
    mpc/       closed-loop rollouts: LTI, IMEX step tiers (dense and
               matrix-free), fused, receding horizon, the sweep's
               bucket loop and its Newton-Schulz stepper chain
    parallel/  the parameter sweep over Re buckets (config 5)
    models/    driven-cavity and cylinder-wake setups
    utils/     config and its hash, checkpoint cache, metrics, VTK,
               runtime precision policy
    interop    numpy arrays of reference objects -> port objects

This package imports torch, numpy and scipy, and never jax.
"""

__version__ = "0.1.0"
