"""ops/ — ELL sparse operator, low-rank algebra, dense factorization
caches, the CUDA kernels (convection, SpMM, the Arnoldi step's MGS) and
their build."""
from .dense import CholeskySolver, LUSolver
from .lowrank import (
    append_columns,
    compress,
    lowrank_matvec,
    smw_solve,
    tsqr,
    tsqr_cholqr2,
)
from .sparse import ELL, ell_from_scipy, ell_to_scipy

__all__ = [
    "CholeskySolver",
    "ELL",
    "LUSolver",
    "append_columns",
    "compress",
    "ell_from_scipy",
    "ell_to_scipy",
    "lowrank_matvec",
    "smw_solve",
    "tsqr",
    "tsqr_cholqr2",
]
