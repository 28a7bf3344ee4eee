"""1D heat-equation FEM — acceptance config 1.

P1 finite elements on [0, 1] with homogeneous Dirichlet BCs, giving the
descriptor system  M v' = A v + B u,  y = C v  with tridiagonal SPD mass
M, tridiagonal stiffness A = -K (negative definite), distributed control
B on control subintervals and averaged observation C on observation
subintervals. Same host math as optconpy_tpu/fem/heat1d.py, so the
operators of both packages are bitwise equal.

Assembly is exact: P1 mass/stiffness closed forms; B and C use exact
integrals of hat functions against interval indicators.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from .operators import lti_from_scipy


def _hat_integral_over_interval(nodes, h, i, a, b):
    """Exact integral of the P1 hat function phi_i over [a, b] cap supp."""
    xi = nodes[i]
    total = 0.0
    # left piece: phi rises on [xi - h, xi]
    lo, hi = max(a, xi - h), min(b, xi)
    if hi > lo:
        # phi(x) = (x - (xi - h)) / h ; antiderivative (x-(xi-h))^2/(2h)
        total += ((hi - (xi - h)) ** 2 - (lo - (xi - h)) ** 2) / (2 * h)
    # right piece: phi falls on [xi, xi + h]
    lo, hi = max(a, xi), min(b, xi + h)
    if hi > lo:
        # phi(x) = ((xi + h) - x) / h ; antiderivative -((xi+h)-x)^2/(2h)
        total += (((xi + h) - lo) ** 2 - ((xi + h) - hi) ** 2) / (2 * h)
    return total


def heat1d_operators(
    n: int = 64,
    nu: float = 1.0,
    control_intervals=((0.1, 0.3), (0.6, 0.8)),
    obs_intervals=((0.4, 0.6),),
    *,
    device,
    dtype=None,
):
    """Assemble config-1 operators; returns (numpy dict, LTISystem on
    `device` in `dtype`, default float64).

    n: number of interior dofs (mesh has n+1 cells).
    nu: diffusion coefficient.
    """
    h = 1.0 / (n + 1)
    nodes = np.linspace(h, 1.0 - h, n)

    main = np.full(n, 2.0 * h / 3.0)
    off = np.full(n - 1, h / 6.0)
    m_sp = sp.diags([off, main, off], [-1, 0, 1], format="csr")

    kmain = np.full(n, 2.0 / h)
    koff = np.full(n - 1, -1.0 / h)
    k_sp = sp.diags([koff, kmain, koff], [-1, 0, 1], format="csr")
    a_sp = (-nu * k_sp).tocsr()

    m_in = len(control_intervals)
    b = np.zeros((n, m_in))
    for j, (a0, b0) in enumerate(control_intervals):
        for i in range(n):
            b[i, j] = _hat_integral_over_interval(nodes, h, i, a0, b0)

    p_out = len(obs_intervals)
    c = np.zeros((p_out, n))
    for j, (a0, b0) in enumerate(obs_intervals):
        for i in range(n):
            c[j, i] = _hat_integral_over_interval(nodes, h, i, a0, b0) / (
                b0 - a0
            )

    np_ops = {"M": m_sp, "A": a_sp, "B": b, "C": c, "nodes": nodes, "h": h}
    return np_ops, lti_from_scipy(m_sp, a_sp, b, c, device=device,
                                  dtype=dtype)


def initial_state(n: int, kind: str = "bump") -> np.ndarray:
    """A nonzero initial velocity profile for closed-loop tests."""
    h = 1.0 / (n + 1)
    nodes = np.linspace(h, 1.0 - h, n)
    if kind == "bump":
        return np.sin(np.pi * nodes) + 0.5 * np.sin(3 * np.pi * nodes)
    raise ValueError(kind)
