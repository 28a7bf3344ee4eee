"""2D triangle meshes — the unit-square cavity and the Schaefer-Turek
cylinder channel (host numpy).

Cavity: structured crossed-diagonal triangulation of the unit square.
Cylinder: graded point cloud (boundary rings around the cylinder + rectangular
background + wake band) triangulated with scipy Delaunay, with
cylinder-interior triangles removed: channel [0, 2.2] x [0, 0.41],
cylinder center (0.2, 0.2), radius 0.05. Same math as
optconpy_tpu/fem/mesh2d.py, so both packages produce the same mesh.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass(frozen=True)
class TriMesh:
    """Triangle mesh: vertices (nv, 2) f64, triangles (nt, 3) int32.

    edges: (ne, 2) sorted vertex pairs; tri_edges: (nt, 3) edge index
    opposite each local vertex (local edge 0 connects vertices 1-2).
    """

    vertices: np.ndarray
    triangles: np.ndarray
    edges: np.ndarray = field(default=None)
    tri_edges: np.ndarray = field(default=None)

    @staticmethod
    def build(vertices: np.ndarray, triangles: np.ndarray) -> "TriMesh":
        tris = np.asarray(triangles, np.int32)
        # Enforce counterclockwise orientation (positive area).
        v = np.asarray(vertices, float)
        d1 = v[tris[:, 1]] - v[tris[:, 0]]
        d2 = v[tris[:, 2]] - v[tris[:, 0]]
        det = d1[:, 0] * d2[:, 1] - d1[:, 1] * d2[:, 0]
        flip = det < 0
        tris[flip] = tris[flip][:, [0, 2, 1]]
        # Local edge k is opposite local vertex k.
        pairs = np.stack(
            [tris[:, [1, 2]], tris[:, [0, 2]], tris[:, [0, 1]]], axis=1
        )  # (nt, 3, 2)
        pairs_sorted = np.sort(pairs.reshape(-1, 2), axis=1)
        edges, inv = np.unique(pairs_sorted, axis=0, return_inverse=True)
        tri_edges = inv.reshape(-1, 3).astype(np.int32)
        return TriMesh(v, tris, edges.astype(np.int32), tri_edges)

    @property
    def nv(self) -> int:
        return len(self.vertices)

    @property
    def nt(self) -> int:
        return len(self.triangles)

    @property
    def ne(self) -> int:
        return len(self.edges)

    def edge_midpoints(self) -> np.ndarray:
        return 0.5 * (
            self.vertices[self.edges[:, 0]] + self.vertices[self.edges[:, 1]]
        )


def unit_square_mesh(nx: int) -> TriMesh:
    """Structured crossed-diagonal triangulation of [0,1]^2, nx x nx
    squares."""
    x = np.linspace(0.0, 1.0, nx + 1)
    xx, yy = np.meshgrid(x, x, indexing="ij")
    verts = np.stack([xx.ravel(), yy.ravel()], axis=1)

    def vid(i, j):
        return i * (nx + 1) + j

    tris = []
    for i in range(nx):
        for j in range(nx):
            a, b = vid(i, j), vid(i + 1, j)
            c, d = vid(i + 1, j + 1), vid(i, j + 1)
            # Alternate the diagonal for isotropy.
            if (i + j) % 2 == 0:
                tris += [[a, b, c], [a, c, d]]
            else:
                tris += [[a, b, d], [b, c, d]]
    return TriMesh.build(verts, np.asarray(tris))


def cylinder_channel_mesh(
    refinement: int = 1,
    length: float = 2.2,
    height: float = 0.41,
    cx: float = 0.2,
    cy: float = 0.2,
    radius: float = 0.05,
) -> TriMesh:
    """Schaefer-Turek cylinder-wake mesh via graded Delaunay.

    refinement=1 gives ~1-2k velocity dofs; each +1 roughly doubles
    resolution. Points: concentric rings around the cylinder (graded),
    a wake-refined band, and a background grid; triangles inside the
    cylinder are dropped, ring-0 points sit exactly on the circle.
    """
    from scipy.spatial import Delaunay

    h_far = height / (8 * refinement)
    h_cyl = radius * 2 * np.pi / (16 * refinement) / 2

    pts = []
    # Concentric rings on/around the cylinder.
    n_rings = 4 + 2 * refinement
    for k in range(n_rings):
        r = radius * (1.0 + 0.55 * k) if k else radius
        n_on = max(int(2 * np.pi * r / (h_cyl * (1 + 0.8 * k))), 12)
        th = np.linspace(0, 2 * np.pi, n_on, endpoint=False)
        th += (k % 2) * np.pi / n_on  # stagger
        ring = np.stack([cx + r * np.cos(th), cy + r * np.sin(th)], axis=1)
        keep = (
            (ring[:, 0] > 1e-9)
            & (ring[:, 0] < length - 1e-9)
            & (ring[:, 1] > 1e-9)
            & (ring[:, 1] < height - 1e-9)
        )
        pts.append(ring[keep])
    r_max = radius * (1.0 + 0.55 * (n_rings - 1))

    # Background grid (graded: finer in the wake band).
    nx_bg = int(length / h_far)
    ny_bg = int(height / h_far)
    xb = np.linspace(0, length, nx_bg + 1)
    yb = np.linspace(0, height, ny_bg + 1)
    xx, yy = np.meshgrid(xb, yb, indexing="ij")
    bg = np.stack([xx.ravel(), yy.ravel()], axis=1)
    dist = np.hypot(bg[:, 0] - cx, bg[:, 1] - cy)
    bg = bg[dist > r_max + 0.4 * h_far]
    pts.append(bg)

    # Wake refinement band behind the cylinder.
    wake_x = np.arange(cx + r_max, min(cx + 12 * radius, length), h_far / 2)
    wake_y = np.arange(
        max(cy - 2.5 * radius, 0) + h_far / 2,
        min(cy + 2.5 * radius, height),
        h_far / 2,
    )
    wx, wy = np.meshgrid(wake_x, wake_y, indexing="ij")
    wk = np.stack([wx.ravel(), wy.ravel()], axis=1)
    dist = np.hypot(wk[:, 0] - cx, wk[:, 1] - cy)
    wk = wk[dist > r_max + 0.2 * h_far]
    pts.append(wk)

    allpts = np.concatenate(pts, axis=0)
    # Deduplicate near-coincident points.
    key = np.round(allpts / (h_cyl * 0.25)).astype(np.int64)
    _, uniq = np.unique(key, axis=0, return_index=True)
    allpts = allpts[np.sort(uniq)]

    tri = Delaunay(allpts)
    simplices = tri.simplices
    cent = allpts[simplices].mean(axis=1)
    inside = np.hypot(cent[:, 0] - cx, cent[:, 1] - cy) < radius * 0.995
    # Drop sliver triangles along the hull (degenerate area).
    v = allpts
    d1 = v[simplices[:, 1]] - v[simplices[:, 0]]
    d2 = v[simplices[:, 2]] - v[simplices[:, 0]]
    area2 = np.abs(d1[:, 0] * d2[:, 1] - d1[:, 1] * d2[:, 0])
    sliver = area2 < 1e-6 * np.median(area2)
    simplices = simplices[~inside & ~sliver]
    return TriMesh.build(allpts, simplices)
