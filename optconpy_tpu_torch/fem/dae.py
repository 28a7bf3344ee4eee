"""Constrained (index-2 DAE) system container: the Stokes/NSE setting.

    M v' = A v + J^T p + B u + f,    J v = 0,    y = C v

on the condensed free-dof velocity space (fem/condense.py). Counterpart
of optconpy_tpu/fem/dae.py: the divergence constraint is never
eliminated on the device; saddle-point solves keep iterates in ker J.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops.sparse import ELL, ell_from_scipy


@dataclass(frozen=True)
class DAESystem:
    """Index-2 DAE descriptor system on the free velocity dofs.

    mass, stiff: (n, n) ELL;  jmat: (n_p, n) ELL divergence (pinned
    pressure removed);  b: (n, m_in);  c: (p_out, n);  fv: (n,)
    constant forcing (BC contributions + body force).
    """

    mass: ELL
    stiff: ELL
    stiff_t: ELL
    jmat: ELL
    jmat_t: ELL
    b: torch.Tensor
    c: torch.Tensor
    fv: torch.Tensor
    n: int
    n_p: int
    m_in: int
    p_out: int

    def to(self, device=None, dtype=None) -> "DAESystem":
        return DAESystem(
            self.mass.to(device, dtype),
            self.stiff.to(device, dtype),
            self.stiff_t.to(device, dtype),
            self.jmat.to(device, dtype),
            self.jmat_t.to(device, dtype),
            self.b.to(device=device, dtype=dtype),
            self.c.to(device=device, dtype=dtype),
            self.fv.to(device=device, dtype=dtype),
            self.n,
            self.n_p,
            self.m_in,
            self.p_out,
        )


def dae_from_scipy(m_sp, a_sp, j_sp, b, c, fv=None, pad_to: int = 4, *,
                   device, dtype=None) -> DAESystem:
    """Build the DAESystem on `device` from host scipy/numpy operators;
    dtype defaults to the host arrays' own (float64)."""
    n = m_sp.shape[0]
    n_p = j_sp.shape[0]
    if fv is None:
        fv = np.zeros(n)

    def ell(a):
        return ell_from_scipy(a, device=device, pad_to=pad_to, dtype=dtype)

    def dense(x):
        return torch.as_tensor(np.asarray(x)).to(device=device, dtype=dtype)

    return DAESystem(
        mass=ell(m_sp),
        stiff=ell(a_sp),
        stiff_t=ell(a_sp.T),
        jmat=ell(j_sp),
        jmat_t=ell(j_sp.T),
        b=dense(b),
        c=dense(c),
        fv=dense(fv),
        n=n,
        n_p=n_p,
        m_in=b.shape[1],
        p_out=c.shape[0],
    )
