# Frozen copy of optconpy_tpu_torch/models/cylinder.py at commit 3a68254c7aaa53570d941aa3f88a196ecc19d430, less
# the DAESystem it hands to the device: the reference keeps the host operators.
"""Cylinder-wake problem setup (host assembly + steady state + DAESystem).

Schaefer-Turek 2D channel with circular cylinder: parabolic inflow,
no-slip walls + cylinder, free outflow (do-nothing) at x = L. Reynolds
number Re = U_mean * D / nu with D = 2*radius and U_mean = 2/3 * u_max.
The steady state is computed at setup by Picard/Newton on the host; its
linearization A_lin = A - L1(vbar) - L2(vbar) becomes the DAESystem of
the Riccati/MPC pipeline. Same math as optconpy_tpu/models/cylinder.py,
so the host operators of both packages are bitwise equal.
"""
from __future__ import annotations

import numpy as np

from .condense import BCCondenser
from .contobs import get_inp_opa, get_mout_opa
from .mesh2d import cylinder_channel_mesh
from .taylor_hood import (
    TaylorHoodSpace,
    assemble_stokes,
    convection_matrices,
)
from .steady import solve_steady_nse_host

LENGTH = 2.2
HEIGHT = 0.41
CX, CY, RADIUS = 0.2, 0.2, 0.05


def cylinder_setup(
    re: float = 60.0,
    refinement: int = 1,
    u_max: float = 1.5,
    control_boxes=(
        (0.27, 0.42, 0.15, 0.25),  # just behind the cylinder
        (0.45, 0.65, 0.1, 0.3),  # near-wake
    ),
    obs_box=(0.65, 1.0, 0.1, 0.3),
    steady_kwargs: dict | None = None,
):
    """Assemble + steady-solve + linearize the cylinder wake at Re.

    Returns (np_ops, cond): np_ops carries the scipy inner LINEARIZED
    operators (A = A_stokes - L1 - L2 at the steady state), the steady
    state and the assembly dict.
    """
    u_mean = 2.0 / 3.0 * u_max
    nu = u_mean * (2 * RADIUS) / re

    mesh = cylinder_channel_mesh(refinement=refinement)
    space = TaylorHoodSpace.build(mesh)
    ops = assemble_stokes(space, nu=nu)
    ns = space.n_scalar
    coords = space.dof_coords()
    x, y = coords[:, 0], coords[:, 1]

    on_walls = (y < 1e-9) | (y > HEIGHT - 1e-9)
    on_in = x < 1e-9
    on_cyl = np.hypot(x - CX, y - CY) < RADIUS * 1.02
    dirichlet_scalar = on_walls | on_in | on_cyl
    # outflow (x = L) is free (do-nothing) except where walls meet it.

    mask = np.concatenate([dirichlet_scalar, dirichlet_scalar])
    g = np.zeros(2 * ns)
    inflow = 4.0 * u_max * y * (HEIGHT - y) / HEIGHT**2
    g[:ns][on_in] = inflow[on_in]

    # The do-nothing outflow fixes the pressure: no pinning needed.
    cond = BCCondenser.build(2 * ns, mask, g, n_press=mesh.nv,
                             pin_pressure=False)

    vbar_full, info = solve_steady_nse_host(
        ops, cond, **(steady_kwargs or {})
    )

    # Perturbation dynamics about vbar: M dv' = (A - L1 - L2) dv + B u
    # (physical convection enters the momentum balance as -N(v)v).
    l1, l2 = convection_matrices(ops, vbar_full)
    a_lin_full = ops["A"] - l1 - l2

    m_i = cond.mat_inner(ops["M"])
    a_i = cond.mat_inner(a_lin_full)
    j_i = cond.jmat_inner(ops["J"])

    b_full = get_inp_opa(space, control_boxes)
    c_full = get_mout_opa(space, (obs_box,))

    np_ops = {
        "M": m_i,
        "A": a_i,
        "J": j_i,
        "B": b_full[cond.free],
        "C": c_full[:, cond.free],
        "vbar_full": vbar_full,
        "steady_info": info,
        "space": space,
        "cond": cond,
        "full": ops,
        "nu": nu,
        "re": re,
    }
    return np_ops, cond
