# Frozen copy of optconpy_tpu_torch/fem/contobs.py at commit 3a68254c7aaa53570d941aa3f88a196ecc19d430, kept
# here so that a later change to the port cannot move the yardstick; less
# the functions the cylinder wake does not reach.
"""Control (B) and observation (C) operators on Taylor-Hood spaces.

Parity with the reference's cont_obs_utils (SURVEY.md SS2 row 4):
get_inp_opa builds a distributed-control input operator over a control
subdomain (characteristic-function shapes per velocity component);
get_mout_opa builds an observation operator averaging each velocity
component over an observation subdomain. Subdomains are resolved at
element granularity (an element belongs to the box iff its centroid
does), which is the static-sparsity-friendly discrete analogue.
"""
from __future__ import annotations

import numpy as np

from .taylor_hood import TaylorHoodSpace, _p2_values, _QL, _QW


def _elements_in_box(space: TaylorHoodSpace, box) -> np.ndarray:
    x0, x1, y0, y1 = box
    cent = space.mesh.vertices[space.mesh.triangles].mean(axis=1)
    return (
        (cent[:, 0] >= x0)
        & (cent[:, 0] <= x1)
        & (cent[:, 1] >= y0)
        & (cent[:, 1] <= y1)
    )


def _basis_box_integrals(space: TaylorHoodSpace, box) -> np.ndarray:
    """integral over box of each scalar P2 basis function: (ns,)."""
    sel = _elements_in_box(space, box)
    phi = _p2_values(_QL)
    w = _QW * 0.5
    # integral of phi_i over each selected element: 2A_e * sum_q w_q phi_qi
    loc = 2 * space.area[sel, None] * np.einsum("q,qi->i", w, phi)[None]
    out = np.zeros(space.n_scalar)
    np.add.at(out, space.tri_dofs[sel].ravel(), loc.ravel())
    return out


def get_inp_opa(space: TaylorHoodSpace, boxes) -> np.ndarray:
    """Input operator B (2ns, 2*len(boxes)).

    For each control box: one column of unit body force in x over the
    box, one in y (tested against the velocity basis, i.e. already in
    weak/dual form — apply as M v' = ... + B u).
    """
    ns = space.n_scalar
    cols = []
    for box in boxes:
        integ = _basis_box_integrals(space, box)
        bx = np.concatenate([integ, np.zeros(ns)])
        by = np.concatenate([np.zeros(ns), integ])
        cols += [bx, by]
    return np.stack(cols, axis=1)


def get_mout_opa(space: TaylorHoodSpace, boxes) -> np.ndarray:
    """Observation operator C (2*len(boxes), 2ns): component means."""
    ns = space.n_scalar
    rows = []
    for box in boxes:
        sel = _elements_in_box(space, box)
        area = float(space.area[sel].sum())
        integ = _basis_box_integrals(space, box) / max(area, 1e-300)
        rows += [
            np.concatenate([integ, np.zeros(ns)]),
            np.concatenate([np.zeros(ns), integ]),
        ]
    return np.stack(rows, axis=0)
