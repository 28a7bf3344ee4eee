"""Sparse times dense, Y = A X: the CUDA kernel and its plain version.

`spmm` is the wrapper of the hand-written Hopper kernel in
csrc/spmm_ell.cu, which replaces the TPU kernel
optconpy_tpu/ops/pallas_spmm.py::windowed_dense_spmm. On a CPU tensor it
runs `spmm_plain`, the same function in plain torch; on a CUDA tensor it
launches the kernel or raises.

Host helpers (numpy/scipy, the same math as optconpy_tpu/ops/pallas_spmm.py):
`rcm_permutation` and `sort_rows_by_window` order a FEM operator so that
neighbouring rows touch neighbouring columns, and `pack_ell` stores it in
the kernel's layout.

Layout (ELLPack, shared by the kernel and the plain version):
  data:    (m, k) values, zero-padded; row i's entries in slots
           [0, row_nnz[i]);
  cols:    (m, k) int32 column indices; padding slots hold column 0;
  row_nnz: (m,) int32 entries per row (the kernel skips the padding).

The kernel is compiled with nvcc for sm_90a at first use, from the
sources in csrc/ into build/ at the repository root (ops/cuda_build.py),
and bound with ctypes.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from . import cuda_build
from .cuda_build import check_tensor as _check
from .sparse import ELL, ell_from_scipy

ROWS_PER_BLOCK = 8  # kRows of csrc/spmm_ell.cu
SHARED_BYTES = 48 * 1024  # dynamic shared memory a block may use unasked
MAX_GRID_Y = 65535

# Kernel launches made through `spmm` (one per call on CUDA).
launches = 0


def rcm_permutation(*mats) -> np.ndarray:
    """Reverse Cuthill-McKee ordering of the union pattern of `mats`:
    perm such that mat[perm][:, perm] has narrow row bandwidth."""
    import scipy.sparse as sp
    import scipy.sparse.csgraph as csg

    patt = None
    for m in mats:
        m = sp.csr_matrix(m)
        m = abs(m) + abs(m).T
        patt = m if patt is None else patt + m
    return np.asarray(
        csg.reverse_cuthill_mckee(patt.tocsr(), symmetric_mode=True)
    )


def sort_rows_by_window(csr) -> np.ndarray:
    """Row order sorting rows by their first nonzero column (empty rows
    last): for a rectangular operator (J: pressure rows over velocity
    columns) whose columns were RCM-ordered."""
    import scipy.sparse as sp

    m = sp.csr_matrix(csr)
    first = np.full(m.shape[0], m.shape[1], dtype=np.int64)
    nonempty = np.diff(m.indptr) > 0
    if nonempty.any():
        first[nonempty] = np.minimum.reduceat(
            m.indices, m.indptr[:-1][nonempty]
        )
    return np.argsort(first, kind="stable")


@dataclass(frozen=True)
class ELLPack:
    """A sparse operator in the kernel's layout (module docstring)."""

    data: torch.Tensor
    cols: torch.Tensor
    row_nnz: torch.Tensor
    shape: tuple

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self):
        return self.data.device

    @property
    def nnz(self) -> int:
        return int(self.row_nnz.sum())


def pack_ell(a, *, device, dtype=None) -> ELLPack:
    """Host pack of a scipy sparse matrix (rows in its own order) on
    `device`; dtype defaults to the matrix's own."""
    import scipy.sparse as sp

    a = sp.csr_matrix(a)
    a.sum_duplicates()
    if max(a.shape) >= 2**31:
        raise ValueError(f"shape {a.shape} does not fit int32 indices")
    ell = ell_from_scipy(a, device=device, dtype=dtype)
    row_nnz = np.diff(a.indptr).astype(np.int32)
    return ELLPack(
        ell.data,
        ell.cols.to(torch.int32),
        torch.as_tensor(row_nnz).to(device),
        ell.shape,
    )


def spmm_plain(a: ELLPack, x: torch.Tensor) -> torch.Tensor:
    """Plain torch Y = A X for X (n, B): the padded-ELL gather and
    contraction of ops/sparse.py (padding slots add 0)."""
    return ELL(a.data, a.cols, a.shape).matmat(x)


@functools.cache
def _library():
    lib = cuda_build.library()
    p = ctypes.c_void_p
    i64 = ctypes.c_int64
    for name in ("spmm_ell_f32", "spmm_ell_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [p, p, p, p, p, i64, i64, i64, p]
        fn.restype = ctypes.c_int
    lib.spmm_ell_error_string.argtypes = [ctypes.c_int]
    lib.spmm_ell_error_string.restype = ctypes.c_char_p
    return lib


_KERNELS = {torch.float32: "spmm_ell_f32", torch.float64: "spmm_ell_f64"}


def spmm(a: ELLPack, x: torch.Tensor) -> torch.Tensor:
    """Y = A X for X (n, B) -> (m, B).

    CPU tensors take the plain version. CUDA tensors launch the kernel:
    float32 or float64 values matching X, int32 indices, contiguous,
    all on one device; anything else raises.
    """
    global launches
    if x.device.type == "cpu":
        return spmm_plain(a, x)
    if x.device.type != "cuda":
        raise ValueError(f"no SpMM kernel for {x.device}")
    if a.dtype not in _KERNELS:
        raise TypeError(f"spmm takes float32 or float64, not {a.dtype}")
    if x.ndim != 2:
        raise ValueError(f"x must be (n, B), got shape {tuple(x.shape)}")
    dev = x.device
    m, n = a.shape
    k = a.data.shape[1]
    b = x.shape[1]
    if b < 1 or m < 1:
        raise ValueError(f"empty product: m={m}, B={b}")
    _check("x", x, a.dtype, (n, b), dev)
    _check("data", a.data, a.dtype, (m, k), dev)
    _check("cols", a.cols, torch.int32, (m, k), dev)
    _check("row_nnz", a.row_nnz, torch.int32, (m,), dev)
    smem = ROWS_PER_BLOCK * k * (a.data.element_size() + 4)
    if smem > SHARED_BYTES:
        raise ValueError(f"row width k={k} needs {smem} B of shared memory")
    if -(-b // 32) > MAX_GRID_Y:
        raise ValueError(f"B={b} exceeds the kernel's column grid")
    lib = _library()
    y = torch.empty((m, b), dtype=a.dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, _KERNELS[a.dtype])(
            a.data.data_ptr(), a.cols.data_ptr(), a.row_nnz.data_ptr(),
            x.data_ptr(), y.data_ptr(), m, k, b, stream,
        )
    if rc != 0:
        msg = lib.spmm_ell_error_string(rc).decode()
        raise RuntimeError(f"spmm_ell launch failed: {msg} ({rc})")
    launches += 1
    return y
