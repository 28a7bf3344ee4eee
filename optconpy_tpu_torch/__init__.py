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
Newton-Schulz inverse build (csrc/spmm_tile.cu, ops/spmm_kernel.py).

Layer map (mirrors optconpy_tpu):
    ops/       ELL sparse operator, low-rank algebra, the CUDA kernels
    fem/       host discretization; DAESystem and ConvKernel on tensors
    solvers/   steady state (host), the shifted-saddle inverse cache and
               its Newton-Schulz build on the device
    riccati/   shifts (host), low-rank ADI, Newton-Kleinman, DRE sweep,
               the DRE residual check (host)
    mpc/       fused Oseen-IMEX closed-loop rollouts
    models/    driven-cavity and cylinder-wake setups
    utils/     runtime precision policy
    interop    numpy arrays of reference objects -> port objects

This package imports torch, numpy and scipy, and never jax.
"""

__version__ = "0.1.0"
