"""Dense factorization caches: factor once on the host, solve many times
on the device.

Counterpart of optconpy_tpu/ops/dense.py. The factorization runs on the
host in LAPACK float64 (scipy) and its factors are cast once to the
device dtype, so the float32 factors are the cast of the float64 ones;
the solves run on the device: triangular solves on the LU (LUSolver) or
one GEMM against a host-computed explicit inverse (DenseInverse).

Pivot convention: scipy's lu_factor returns 0-based row interchanges;
torch.linalg.lu_solve takes LAPACK's 1-based int32 pivots on the
factor's device. host_lu_factor converts once, so every `piv` tensor in
this package is 1-based. (An off-by-one pivot gives wrong solves and
raises nothing.)
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


def to_host64(a) -> np.ndarray:
    """A tensor or array as a float64 numpy array on the host."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=np.float64)


def _placement(a, device, dtype):
    """device/dtype default to the input tensor's own."""
    if isinstance(a, torch.Tensor):
        return device or a.device, dtype or a.dtype
    if device is None:
        raise ValueError("a numpy input needs an explicit device")
    return device, dtype or torch.float64


def host_lu_factor(a, *, device=None, dtype=None):
    """LAPACK f64 LU on the host; returns (lu, piv) on `device`: lu in
    `dtype`, piv 1-based int32 (torch.linalg.lu_solve's convention).
    device/dtype default to those of a tensor input."""
    import scipy.linalg as sla

    device, dtype = _placement(a, device, dtype)
    lu, piv = sla.lu_factor(to_host64(a))
    return (
        torch.as_tensor(lu).to(device=device, dtype=dtype),
        torch.as_tensor(piv.astype(np.int32) + 1).to(device),
    )


def inverse64(a) -> np.ndarray:
    """Host f64 explicit inverse (LAPACK LU, then solves against I)."""
    import scipy.linalg as sla

    a_np = to_host64(a)
    return sla.lu_solve(sla.lu_factor(a_np), np.eye(a_np.shape[0]))


def host_inverse(a, *, device=None, dtype=None) -> torch.Tensor:
    """Host f64 explicit inverse, cast to `dtype` on `device`."""
    device, dtype = _placement(a, device, dtype)
    return torch.as_tensor(inverse64(a)).to(device=device, dtype=dtype)


def lu_apply(lu: torch.Tensor, piv: torch.Tensor, b: torch.Tensor):
    """Solve with packed LU factors for b (n,) or (n, k)."""
    if b.ndim == 1:
        return torch.linalg.lu_solve(lu, piv, b[:, None])[:, 0]
    return torch.linalg.lu_solve(lu, piv, b)


@dataclass(frozen=True)
class LUSolver:
    """Cached dense LU of a square matrix.

    lu: (n, n) packed LU factors; piv: (n,) 1-based int32 pivots.
    `apply` solves A x = b for b (n,) or (n, k).
    """

    lu: torch.Tensor
    piv: torch.Tensor

    @staticmethod
    def factor(a, *, device=None, dtype=None) -> "LUSolver":
        """Host-LAPACK factorization (host_lu_factor)."""
        return LUSolver(*host_lu_factor(a, device=device, dtype=dtype))

    def apply(self, b: torch.Tensor) -> torch.Tensor:
        return lu_apply(self.lu, self.piv, b)


@dataclass(frozen=True)
class DenseInverse:
    """Explicit inverse applied as one GEMM. Built on the host in f64,
    so the apply error is cond(A) * eps(device dtype) like an LU solve."""

    inv: torch.Tensor

    @staticmethod
    def factor(a, *, device=None, dtype=None) -> "DenseInverse":
        return DenseInverse(host_inverse(a, device=device, dtype=dtype))

    def apply(self, b: torch.Tensor) -> torch.Tensor:
        return self.inv @ b
