"""Driven-cavity Stokes problem setup (host assembly + DAESystem).

Unit-square Taylor-Hood discretization, no-slip walls, moving lid
(u_x = LID_SPEED at y = 1), distributed control and observation boxes.
Same math as optconpy_tpu/models/cavity.py, so the host operators of
both packages are bitwise equal.
"""
from __future__ import annotations

import numpy as np

from ..fem.condense import BCCondenser
from ..fem.contobs import get_inp_opa, get_mout_opa
from ..fem.dae import dae_from_scipy
from ..fem.mesh2d import unit_square_mesh
from ..fem.taylor_hood import TaylorHoodSpace, assemble_stokes


# The reference's defaults (optconpy_tpu/models/cavity.py).
NU = 1.0
LID_SPEED = 1.0
CONTROL_BOXES = ((0.1, 0.4, 0.0, 0.2), (0.6, 0.9, 0.0, 0.2))
OBS_BOX = (0.25, 0.75, 0.4, 0.6)


def cavity_stokes_setup(nx: int, *, device, dtype=None, nu: float = NU):
    """Assemble the condensed Stokes cavity control problem at viscosity
    nu (a viscosity sweep gives the buckets of a parameter sweep).

    Returns (np_ops, dae_system, cond): np_ops holds the scipy inner
    matrices {M, A, J, B, C, fv, fp}; dae_system lives on `device` in
    `dtype` (default float64).
    """
    mesh = unit_square_mesh(nx)
    space = TaylorHoodSpace.build(mesh)
    ops = assemble_stokes(space, nu=nu)
    ns = space.n_scalar
    coords = space.dof_coords()  # (ns, 2)

    on_bnd = (
        (coords[:, 0] < 1e-12)
        | (coords[:, 0] > 1 - 1e-12)
        | (coords[:, 1] < 1e-12)
        | (coords[:, 1] > 1 - 1e-12)
    )
    # Velocity dof layout: [u_x scalar dofs | u_y scalar dofs].
    mask = np.concatenate([on_bnd, on_bnd])
    g = np.zeros(2 * ns)
    lid = on_bnd & (coords[:, 1] > 1 - 1e-12)
    g[:ns][lid] = LID_SPEED  # u_x = LID_SPEED on the lid ("leaky" corners)

    cond = BCCondenser.build(2 * ns, mask, g, n_press=mesh.nv)

    a_i = cond.mat_inner(ops["A"])
    m_i = cond.mat_inner(ops["M"])
    j_i = cond.jmat_inner(ops["J"])
    fv = cond.mat_bc_rhs(ops["A"])  # momentum BC contribution
    fp = cond.jmat_bc_rhs(ops["J"])  # continuity BC contribution

    b_i = get_inp_opa(space, CONTROL_BOXES)[cond.free]
    c_i = get_mout_opa(space, (OBS_BOX,))[:, cond.free]

    np_ops = {
        "M": m_i,
        "A": a_i,
        "J": j_i,
        "B": b_i,
        "C": c_i,
        "fv": fv,
        "fp": fp,
        "space": space,
        "cond": cond,
        "full": ops,
    }
    sys = dae_from_scipy(
        m_i, a_i, j_i, b_i, c_i, fv=fv, device=device, dtype=dtype
    )
    return np_ops, sys, cond
