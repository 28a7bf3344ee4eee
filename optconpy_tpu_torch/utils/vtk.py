"""Legacy-VTK field export (numpy only).

Counterpart of optconpy_tpu/utils/vtk.py: an offline host post-process
from saved states. P2 velocities are sampled at mesh vertices (the P1
subset of the P2 dofs) and written as an ASCII legacy .vtk unstructured
grid, which ParaView opens directly.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np


def write_vtk_snapshot(
    path: str | Path,
    space,
    v_full: np.ndarray,
    p: np.ndarray | None = None,
    name: str = "velocity",
) -> Path:
    """Write one velocity (+ optional pressure) snapshot.

    space: fem.taylor_hood.TaylorHoodSpace; v_full: (2*ns,) full-dof
    velocity (use BCCondenser.expand for inner states); p: (nv,)
    vertex pressure.
    """
    mesh = space.mesh
    ns = space.n_scalar
    nv = mesh.nv
    pts = mesh.vertices  # (nv, 2)
    tris = mesh.triangles  # (nt, 3)
    # Vertex dofs are the first nv scalar P2 dofs by construction
    # (fem/taylor_hood.py dof layout: vertices then edge midpoints).
    ux = np.asarray(v_full[:ns][:nv])
    uy = np.asarray(v_full[ns:][:nv])

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with path.open("w") as f:
        f.write("# vtk DataFile Version 3.0\noptconpy_tpu snapshot\n")
        f.write("ASCII\nDATASET UNSTRUCTURED_GRID\n")
        f.write(f"POINTS {nv} float\n")
        for x, y in pts:
            f.write(f"{x} {y} 0.0\n")
        f.write(f"CELLS {len(tris)} {4 * len(tris)}\n")
        for t in tris:
            f.write(f"3 {t[0]} {t[1]} {t[2]}\n")
        f.write(f"CELL_TYPES {len(tris)}\n")
        f.write("5\n" * len(tris))  # VTK_TRIANGLE
        f.write(f"POINT_DATA {nv}\n")
        f.write(f"VECTORS {name} float\n")
        for a, b in zip(ux, uy):
            f.write(f"{a} {b} 0.0\n")
        if p is not None:
            f.write("SCALARS pressure float 1\nLOOKUP_TABLE default\n")
            for val in np.asarray(p)[:nv]:
                f.write(f"{val}\n")
    return path


def write_vtk_series(
    directory: str | Path,
    space,
    vs_full: np.ndarray,
    times: np.ndarray,
    stride: int = 1,
    prefix: str = "flow",
) -> list:
    """Write a time series of snapshots + a ParaView .series index."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    files = []
    for k in range(0, len(vs_full), stride):
        fname = f"{prefix}_{k:05d}.vtk"
        write_vtk_snapshot(directory / fname, space, vs_full[k])
        files.append({"name": fname, "time": float(times[k])})
    series = {"file-series-version": "1.0", "files": files}
    (directory / f"{prefix}.vtk.series").write_text(json.dumps(series))
    return files
