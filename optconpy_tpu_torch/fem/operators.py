"""Unconstrained LTI system container on tensors.

Counterpart of optconpy_tpu/fem/operators.py: FEM assembly happens on
the host (numpy/scipy); the device only sees the frozen-sparsity ELL
operators and dense input/output maps.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops.sparse import ELL, ell_from_scipy


@dataclass(frozen=True)
class LTISystem:
    """Unconstrained LTI descriptor system  M v' = A v + B u,  y = C v.

    mass:    M  (n, n) SPD, padded-ELL.
    stiff:   A  (n, n) stable (Hurwitz w.r.t. M pencil), padded-ELL.
    stiff_t: A^T as its own ELL (adjoint/costate solves).
    b:       (n, m_in) dense input map.
    c:       (p_out, n) dense output map.
    """

    mass: ELL
    stiff: ELL
    stiff_t: ELL
    b: torch.Tensor
    c: torch.Tensor
    n: int
    m_in: int
    p_out: int

    def dense(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Densified (M, A) for direct factorizations on small problems."""
        return self.mass.todense(), self.stiff.todense()

    def to(self, device=None, dtype=None) -> "LTISystem":
        return LTISystem(
            self.mass.to(device, dtype),
            self.stiff.to(device, dtype),
            self.stiff_t.to(device, dtype),
            self.b.to(device=device, dtype=dtype),
            self.c.to(device=device, dtype=dtype),
            self.n,
            self.m_in,
            self.p_out,
        )


def lti_from_scipy(m_sp, a_sp, b, c, pad_to: int = 4, *, device,
                   dtype=None) -> LTISystem:
    """Build an LTISystem on `device` from scipy sparse M, A and dense
    numpy B, C; dtype defaults to the host arrays' own (float64)."""

    def ell(a):
        return ell_from_scipy(a, device=device, pad_to=pad_to, dtype=dtype)

    def dense(x):
        return torch.as_tensor(np.asarray(x)).to(device=device, dtype=dtype)

    return LTISystem(
        mass=ell(m_sp),
        stiff=ell(a_sp),
        stiff_t=ell(a_sp.T),
        b=dense(b),
        c=dense(c),
        n=m_sp.shape[0],
        m_in=b.shape[1],
        p_out=c.shape[0],
    )
