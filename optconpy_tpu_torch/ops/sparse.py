"""Padded-ELL sparse operator on torch tensors.

Counterpart of optconpy_tpu/ops/sparse.py: every row stores exactly `k`
(value, col) pairs, zero-padded, so SpMV/SpMM is a static gather plus a
dense contraction. The sparsity is frozen on the host at setup
(ell_from_scipy); the operator lives on whatever device it was built
for or moved to with `.to()`.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

# Cap on the (m, k, b) gather that matmat materializes per chunk.
GATHER_BUDGET_BYTES = 128 * 1024 * 1024


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def chunk_columns(m: int, k: int, itemsize: int) -> int:
    """Widest column chunk (a multiple of 128, at least 128) whose
    (m, k, chunk) gather of `itemsize`-byte values fits the budget."""
    return max(
        128,
        GATHER_BUDGET_BYTES // max(m * k * itemsize, 1) // 128 * 128,
    )


@dataclass(frozen=True)
class ELL:
    """Padded-ELL sparse matrix: row-major, fixed nnz per row.

    data: (m, k) float values, zero-padded.
    cols: (m, k) int64 column indices; padded entries point at column 0
          with data 0.0 so gathers stay in-bounds and contribute nothing.
    shape: (m, n).
    """

    data: torch.Tensor
    cols: torch.Tensor
    shape: tuple

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self):
        return self.data.device

    @property
    def row_nnz(self) -> int:
        return self.data.shape[1]

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """y = A @ x for x of shape (n,)."""
        return (self.data * x[self.cols]).sum(dim=1)

    def matmat(self, x: torch.Tensor) -> torch.Tensor:
        """Y = A @ X for X of shape (n, b) — batched SpMM.

        Wide X is column-chunked so the (m, k, chunk) gather stays
        under GATHER_BUDGET_BYTES, sized with the element size of the
        data (identical math for every chunk width).
        """
        m, k = self.data.shape
        b = x.shape[1]
        cb = chunk_columns(m, k, self.data.element_size())
        if b <= cb:
            return torch.einsum("mk,mkb->mb", self.data, x[self.cols])
        return torch.cat(
            [
                torch.einsum(
                    "mk,mkb->mb", self.data, x[:, lo:lo + cb][self.cols]
                )
                for lo in range(0, b, cb)
            ],
            dim=1,
        )

    def __matmul__(self, x: torch.Tensor) -> torch.Tensor:
        if x.ndim == 1:
            return self.matvec(x)
        return self.matmat(x)

    def todense(self) -> torch.Tensor:
        m, n = self.shape
        out = torch.zeros((m, n), dtype=self.dtype, device=self.device)
        rows = torch.arange(m, device=self.device)[:, None].expand_as(
            self.cols
        )
        return out.index_put_((rows, self.cols), self.data, accumulate=True)

    def to(self, device=None, dtype=None) -> "ELL":
        """Move to `device` and cast the values to `dtype` (indices keep
        their integer type)."""
        return ELL(
            self.data.to(device=device, dtype=dtype),
            self.cols.to(device=device),
            self.shape,
        )


def ell_from_scipy(a, *, device, pad_to: int | None = None,
                   dtype=None) -> ELL:
    """Convert a scipy.sparse matrix to padded ELL on `device`.

    pad_to: round the per-row nnz up to a multiple; default keeps the
    max row nnz. dtype: torch dtype of the values (default: the scipy
    matrix's own, e.g. float64).
    """
    import scipy.sparse as sp

    a = sp.csr_matrix(a)
    a.sum_duplicates()
    m, n = a.shape
    row_nnz = np.diff(a.indptr)
    k = int(row_nnz.max()) if m else 0
    if pad_to:
        k = _round_up(max(k, 1), pad_to)
    k = max(k, 1)
    data = np.zeros((m, k), dtype=a.dtype)
    cols = np.zeros((m, k), dtype=np.int64)
    # Vectorized scatter: nnz j of row i lands at (i, j - indptr[i]).
    rows_flat = np.repeat(np.arange(m), row_nnz)
    slot_flat = np.arange(a.nnz) - np.repeat(a.indptr[:-1], row_nnz)
    data[rows_flat, slot_flat] = a.data
    cols[rows_flat, slot_flat] = a.indices
    return ELL(
        torch.as_tensor(data).to(device=device, dtype=dtype),
        torch.as_tensor(cols).to(device=device),
        (m, n),
    )


def ell_to_scipy(a: ELL):
    """Inverse of ell_from_scipy (host-side, for setup and checks)."""
    import scipy.sparse as sp

    m, n = a.shape
    data = a.data.detach().cpu().numpy()
    cols = a.cols.detach().cpu().numpy()
    rows = np.repeat(np.arange(m), a.row_nnz)
    mat = sp.coo_matrix(
        (data.ravel(), (rows, cols.ravel())), shape=(m, n)
    )
    mat.sum_duplicates()
    mat = mat.tocsr()
    # Drop the ELL padding slots (explicit zeros at column 0).
    mat.eliminate_zeros()
    return mat
