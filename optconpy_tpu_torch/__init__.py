"""optconpy_tpu_torch — the PyTorch/CUDA port of optconpy_tpu.

The JAX package `optconpy_tpu` stays the reference; this package mirrors
its module paths and names so each counterpart is easy to find, and is
tested against it. Host-side setup (mesh, Taylor-Hood assembly, steady
state, shift selection, sparse LU) is numpy/scipy code carried over with
its math unchanged; device math is plain torch on tensors, with an
explicit `device` argument wherever tensors are created. The one kernel
of the main path, the batched P2 convection N(v)v, is hand-written CUDA
for Hopper (csrc/conv_p2.cu, bound in ops/conv_kernel.py).

Layer map (mirrors optconpy_tpu):
    ops/       ELL sparse operator, low-rank algebra, the convection kernel
    fem/       host discretization; DAESystem and ConvKernel on tensors
    solvers/   steady state (host) and the shifted-saddle inverse cache
    riccati/   shifts (host), low-rank ADI, Newton-Kleinman, DRE sweep
    mpc/       fused Oseen-IMEX closed-loop rollouts
    models/    cylinder-wake setup
    utils/     runtime precision policy
    interop    numpy arrays of reference objects -> port objects

This package imports torch, numpy and scipy, and never jax.
"""

__version__ = "0.1.0"
