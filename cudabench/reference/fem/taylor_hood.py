# Frozen copy of optconpy_tpu_torch/fem/taylor_hood.py at commit 3a68254c7aaa53570d941aa3f88a196ecc19d430, kept
# here so that a later change to the port cannot move the yardstick.
"""Taylor-Hood (P2/P1) assembly for 2D incompressible flow — pure numpy.

First-party replacement for the reference's DOLFIN assembly +
dolfin_to_sparrays conversion (SURVEY.md SS2 rows 3, 9): produces the
index-2 DAE operators

    M v' = A v + N(v)v + J^T p + B u + f,   J v = g

as scipy sparse (M, A = -nu*K, J) plus a per-element convection tensor
T0 with  <w, (v.grad)u> = w_(i,a) v_(j,b) u_(k,a) T0[e,i,j,k,b]  that
the device-side code contracts directly (fem/convection on device; no
re-assembly per step — SURVEY.md SS3.5 boundary).

Velocity dof layout: [all u_x scalar dofs | all u_y scalar dofs],
scalar P2 dofs = [vertices | edge midpoints]. Pressure dofs = vertices.

Quadrature: 7-point degree-5 Gauss rule (exact for the degree-5
convection integrand).

Host numpy/scipy, the same math as optconpy_tpu/fem/taylor_hood.py, so
both packages assemble bitwise-equal operators.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp

from .mesh2d import TriMesh

# 7-point degree-5 triangle rule (barycentric coords, weights sum to 1).
_QW = np.array(
    [0.225]
    + [0.125939180544827] * 3
    + [0.132394152788506] * 3
)
_A1, _B1 = 0.797426985353087, 0.101286507323456
_A2, _B2 = 0.059715871789770, 0.470142064105115
_QL = np.array(
    [
        [1 / 3, 1 / 3, 1 / 3],
        [_A1, _B1, _B1],
        [_B1, _A1, _B1],
        [_B1, _B1, _A1],
        [_A2, _B2, _B2],
        [_B2, _A2, _B2],
        [_B2, _B2, _A2],
    ]
)


def _p2_values(lam: np.ndarray) -> np.ndarray:
    """P2 basis values at barycentric points lam (nq, 3) -> (nq, 6).

    Local scalar dofs: 0-2 vertices, 3-5 edge midpoints with edge k
    opposite vertex k (edge 3 connects vertices 1-2, etc.).
    """
    l0, l1, l2 = lam[:, 0], lam[:, 1], lam[:, 2]
    return np.stack(
        [
            l0 * (2 * l0 - 1),
            l1 * (2 * l1 - 1),
            l2 * (2 * l2 - 1),
            4 * l1 * l2,
            4 * l0 * l2,
            4 * l0 * l1,
        ],
        axis=1,
    )


def _p2_dlam(lam: np.ndarray) -> np.ndarray:
    """d(phi_i)/d(lambda_j) at quad points: (nq, 6, 3)."""
    nq = lam.shape[0]
    l0, l1, l2 = lam[:, 0], lam[:, 1], lam[:, 2]
    d = np.zeros((nq, 6, 3))
    d[:, 0, 0] = 4 * l0 - 1
    d[:, 1, 1] = 4 * l1 - 1
    d[:, 2, 2] = 4 * l2 - 1
    d[:, 3, 1] = 4 * l2
    d[:, 3, 2] = 4 * l1
    d[:, 4, 0] = 4 * l2
    d[:, 4, 2] = 4 * l0
    d[:, 5, 0] = 4 * l1
    d[:, 5, 1] = 4 * l0
    return d


@dataclass(frozen=True)
class TaylorHoodSpace:
    """Scalar P2 dof map + geometry for a TriMesh."""

    mesh: TriMesh
    n_scalar: int  # nv + ne
    tri_dofs: np.ndarray  # (nt, 6) scalar P2 dofs per element
    grad_lam: np.ndarray  # (nt, 3, 2) gradients of barycentric coords
    area: np.ndarray  # (nt,)

    @staticmethod
    def build(mesh: TriMesh) -> "TaylorHoodSpace":
        tri_dofs = np.concatenate(
            [mesh.triangles, mesh.nv + mesh.tri_edges], axis=1
        ).astype(np.int32)
        v = mesh.vertices[mesh.triangles]  # (nt, 3, 2)
        d1 = v[:, 1] - v[:, 0]
        d2 = v[:, 2] - v[:, 0]
        det = d1[:, 0] * d2[:, 1] - d1[:, 1] * d2[:, 0]  # = 2*area (ccw)
        area = 0.5 * det
        # grad lambda_i: lambda affine, lambda_i(x_j) = delta_ij.
        g = np.empty((mesh.nt, 3, 2))
        g[:, 1, 0] = d2[:, 1] / det
        g[:, 1, 1] = -d2[:, 0] / det
        g[:, 2, 0] = -d1[:, 1] / det
        g[:, 2, 1] = d1[:, 0] / det
        g[:, 0] = -g[:, 1] - g[:, 2]
        return TaylorHoodSpace(
            mesh, mesh.nv + mesh.ne, tri_dofs, g, area
        )

    def dof_coords(self) -> np.ndarray:
        """(n_scalar, 2) coordinates of P2 dofs (vertices + midpoints)."""
        return np.concatenate(
            [self.mesh.vertices, self.mesh.edge_midpoints()], axis=0
        )


def _accumulate(rows, cols, vals, shape):
    a = sp.coo_matrix(
        (vals.ravel(), (rows.ravel(), cols.ravel())), shape=shape
    )
    a.sum_duplicates()
    return a.tocsr()


def assemble_stokes(space: TaylorHoodSpace, nu: float = 1.0):
    """Assemble (M_scalar, K_scalar, J, Bdiv-free ops) for Taylor-Hood.

    The element matrices come from vectorized numpy only (the
    reference's numpy path, line for line), so the operators do not
    depend on the machine or on a compiled library.

    Returns dict with:
      Ms: (ns, ns) scalar P2 mass;  Ks: (ns, ns) scalar P2 stiffness;
      M:  (2ns, 2ns) vector mass (block diag);
      A:  (2ns, 2ns) = -nu * vector stiffness;
      J:  (np, 2ns) divergence, J v = integral of q * div(v);
      conv_T0: (nt, 6, 6, 3, 2) per-element convection kernel in the
        FACTORED form T0[e,i,j,k->lam,b]; contract with grad_lam to get
        the full (nt,6,6,6,2) tensor, or use assemble-free device code.
      plus the space itself.
    """
    mesh = space.mesh
    ns = space.n_scalar
    nt = mesh.nt
    npress = mesh.nv
    dofs = space.tri_dofs
    area = space.area
    glam = space.grad_lam

    phi = _p2_values(_QL)  # (nq, 6)
    dphi = _p2_dlam(_QL)  # (nq, 6, 3)
    w = _QW * 0.5  # reference-triangle weights (area 1/2)

    # Scalar mass: element-independent reference integral * 2*area.
    m_ref = np.einsum("q,qi,qj->ij", w, phi, phi)  # (6, 6)
    m_loc = 2 * area[:, None, None] * m_ref[None]

    # Scalar stiffness: grad phi_i . grad phi_j (grads via glam).
    # gphi[e, q, i, d] = dphi[q, i, l] glam[e, l, d]
    gq = np.einsum("qil,eld->eqid", dphi, glam)
    k_loc = 2 * area[:, None, None] * np.einsum(
        "q,eqid,eqjd->eij", w, gq, gq
    )
    # Divergence: J[p_i, (u_j, comp d)] = int lambda_i d(phi_j)/dx_d.
    p1 = _QL  # P1 values at quad points = barycentric coords (nq, 3)
    j_loc = 2 * area[:, None, None, None] * np.einsum(
        "q,qi,eqjd->eijd", w, p1, gq
    )  # (nt, 3, 6, 2)

    rows = np.broadcast_to(dofs[:, :, None], (nt, 6, 6))
    cols = np.broadcast_to(dofs[:, None, :], (nt, 6, 6))
    ms = _accumulate(rows, cols, m_loc, (ns, ns))
    ks = _accumulate(rows, cols, k_loc, (ns, ns))

    m_vec = sp.block_diag([ms, ms], format="csr")
    a_vec = (-nu) * sp.block_diag([ks, ks], format="csr")
    prow = np.broadcast_to(
        mesh.triangles[:, :, None], (nt, 3, 6)
    )
    jcol_x = np.broadcast_to(dofs[:, None, :], (nt, 3, 6))
    j_x = _accumulate(prow, jcol_x, j_loc[..., 0], (npress, 2 * ns))
    j_y = _accumulate(
        prow, jcol_x + ns, j_loc[..., 1], (npress, 2 * ns)
    )
    j_div = (j_x + j_y).tocsr()

    # Convection kernel, factored: full tensor is
    #   T0[e,i,j,k,b] = 2A_e sum_q w_q phi_qi phi_qj dphi[q,k,l] glam[e,l,b]
    # Store the reference part contracted at assembly:
    t_ref = np.einsum("q,qi,qj,qkl->ijkl", w, phi, phi, dphi)  # (6,6,6,3)
    return {
        "space": space,
        "Ms": ms,
        "Ks": ks,
        "M": m_vec,
        "A": a_vec,
        "J": j_div,
        "conv_t_ref": t_ref,
        "nu": nu,
    }


def convection_tensor(ops: dict) -> np.ndarray:
    """Full per-element convection tensor T0: (nt, 6, 6, 6, 2).

    <w, (v.grad)u> = sum_e w_(i,a) v_(j,b) u_(k,a) T0[e,i,j,k,b]
    (velocity local dof = (scalar dof s in element, component)).
    """
    space = ops["space"]
    return np.einsum(
        "ijkl,elb,e->eijkb",
        ops["conv_t_ref"],
        space.grad_lam,
        2 * space.area,
    )


def convection_matrices(ops: dict, vbar: np.ndarray):
    """Linearized convection at velocity vbar (full 2ns vector).

    Returns (L1, L2) scipy CSR on the FULL vector dof set:
      L1 u = (vbar . grad) u     [the Oseen/Picard term]
      L2 u = (u . grad) vbar     [the extra Newton term]
    and conv_vec(vbar) = L1 @ vbar (= N(vbar) vbar).
    """
    space = ops["space"]
    t0 = convection_tensor(ops)  # (e, i, j, k, b)
    ns = space.n_scalar
    dofs = space.tri_dofs
    nt = space.mesh.nt

    vb = vbar.reshape(2, ns)  # [comp, scalar dof]
    v_loc = vb[:, dofs].transpose(1, 2, 0)  # (nt, 6, 2)

    # L1[(i,a),(k,a)] = sum_{j,b} T0[e,i,j,k,b] vbar_loc[e,j,b]
    l1_loc = np.einsum("eijkb,ejb->eik", t0, v_loc)  # (nt, 6, 6)
    rows = np.broadcast_to(dofs[:, :, None], (nt, 6, 6))
    cols = np.broadcast_to(dofs[:, None, :], (nt, 6, 6))
    l1_s = _accumulate(rows, cols, l1_loc, (ns, ns))
    l1 = sp.block_diag([l1_s, l1_s], format="csr")

    # L2[(i,a),(j,b)] = sum_k T0[e,i,j,k,b] vbar_loc[e,k,a]
    l2_loc = np.einsum("eijkb,eka->eijab", t0, v_loc)  # (nt,6,6,2,2)
    blocks = []
    for a_c in range(2):
        row_blocks = []
        for b_c in range(2):
            row_blocks.append(
                _accumulate(rows, cols, l2_loc[:, :, :, a_c, b_c], (ns, ns))
            )
        blocks.append(row_blocks)
    l2 = sp.bmat(blocks, format="csr")
    return l1, l2
