"""Sparse times dense, Y = A X: the CUDA kernel and its plain version.

`spmm` is the wrapper of the hand-written Hopper kernel in
csrc/spmm_tile.cu, which replaces the TPU kernel
optconpy_tpu/ops/pallas_spmm.py::windowed_dense_spmm. On a CPU tensor it
runs `spmm_plain`, the same function in plain torch over the same pack;
on a CUDA tensor it launches the kernel or raises.

Host helpers (numpy/scipy, the same math as optconpy_tpu/ops/pallas_spmm.py):
`rcm_permutation` and `sort_rows_by_window` order a FEM operator so that
neighbouring rows touch neighbouring columns, and `pack_spmm` stores it
in the kernel's layout.

Layout (SpmmPack, shared by the kernel and the plain version). Rows are
taken in groups of GROUP consecutive rows, and groups in tiles of
TILE_GROUPS; one block of the kernel computes one tile for one tile of
columns, a warp per group:
  eptr:  (n_groups + 1,) int32 offsets of each group's entries, every
         count a multiple of 4 (groups past the last row are empty);
  ecol:  (E,) int32 an entry's column: the sorted union of the group's
         columns, padded with its last column;
  evals: (E, GROUP) the group's GROUP row values at that column, 0 where
         a row has no entry (and in the padding).

Semantics: Y = A X for finite X. The kernel and the plain version both
multiply the zeros of the layout by X, so a non-finite X value at a
column that one row of a group holds makes every row of that group
non-finite (0 * inf = NaN), where a product over the stored entries
alone would leave the other rows finite. Groups that do not hold the
column are not touched. The callers' X are finite: the NS build raises
on a non-finite residual.

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

GROUP = 4  # rows whose outputs one warp holds (kGroup of csrc/spmm_tile.cu)
TILE_GROUPS = 4  # groups of one block (kWarps)
SHARED_MAX = 227 * 1024  # dynamic shared memory a block may use
MAX_GRID_Y = 65535
# Columns per lane: the most (at most 16 bytes) for which the slab of X
# that the blocks in flight read, RESIDENT_WARPS per SM spread over the
# groups, fits in half of L2.
RESIDENT_WARPS = 32
PLAIN_CHUNK_BYTES = 256 * 1024 * 1024  # the plain version's (E, GROUP, b) cap

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
class SpmmPack:
    """A sparse operator in the kernel's layout (module docstring). Its
    products equal A X for finite X only: the zeros that pad a group are
    multiplied too."""

    eptr: torch.Tensor
    ecol: torch.Tensor
    evals: torch.Tensor
    shape: tuple
    nnz: int
    smem_bytes: int  # dynamic shared memory of the largest tile

    @property
    def dtype(self):
        return self.evals.dtype

    @property
    def device(self):
        return self.evals.device

    @property
    def n_tiles(self) -> int:
        return (self.eptr.shape[0] - 1) // TILE_GROUPS

    def to(self, device=None, dtype=None) -> "SpmmPack":
        """Move to `device` and cast the values to `dtype` (indices keep
        int32; the shared memory a tile needs follows the value size)."""
        evals = self.evals.to(device=device, dtype=dtype)
        per_entry = GROUP * self.evals.element_size() + 4
        entries = self.smem_bytes // per_entry  # of the largest tile
        return SpmmPack(
            eptr=self.eptr.to(device), ecol=self.ecol.to(device),
            evals=evals, shape=self.shape, nnz=self.nnz,
            smem_bytes=entries * (GROUP * evals.element_size() + 4),
        )


def pack_spmm(a, *, device, dtype=None) -> SpmmPack:
    """Host pack of a scipy sparse matrix (rows in its own order) on
    `device`; dtype defaults to the matrix's own."""
    import scipy.sparse as sp

    a = sp.csr_matrix(a, copy=True)
    a.sum_duplicates()
    a.sort_indices()
    m, n = a.shape
    if max(m, n) >= 2**31 or a.nnz * GROUP >= 2**31:
        raise ValueError(f"shape {a.shape} does not fit int32 indices")
    dtype = dtype or torch.from_numpy(a.data[:0]).dtype
    itemsize = torch.empty((), dtype=dtype).element_size()
    n_groups = max(1, -(-m // (GROUP * TILE_GROUPS))) * TILE_GROUPS
    rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(a.indptr))
    # The entries of each group: unique (group, column) keys, each group's
    # count padded to a multiple of 4.
    gkeys, inv = np.unique(rows // GROUP * n + a.indices, return_inverse=True)
    g_of = gkeys // n
    cnt = np.bincount(g_of, minlength=n_groups)
    eptr = np.concatenate([[0], np.cumsum(-(-cnt // 4) * 4)])
    first = np.searchsorted(g_of, np.arange(n_groups))
    pos = eptr[g_of] + np.arange(gkeys.size) - first[g_of]
    ecol = np.zeros(eptr[-1], np.int32)
    ecol[pos] = gkeys % n
    # The padding repeats its group's last column: it reads X only where
    # the group does.
    real = np.zeros(eptr[-1], np.int64)
    real[pos] = pos
    ecol = ecol[np.maximum.accumulate(real)]
    evals = np.zeros((eptr[-1], GROUP), a.data.dtype)
    evals[pos[inv.reshape(-1)], rows % GROUP] = a.data
    per_tile = np.diff(eptr[::TILE_GROUPS])
    smem = int(per_tile.max()) * (GROUP * itemsize + 4)
    if smem > SHARED_MAX:
        raise ValueError(f"a tile of {a.shape} needs {smem} B of shared memory")

    def dev(x, dt=None):
        return torch.as_tensor(x).to(device=device, dtype=dt)

    return SpmmPack(
        eptr=dev(eptr.astype(np.int32)), ecol=dev(ecol),
        evals=dev(evals, dtype), shape=a.shape, nnz=int(a.nnz),
        smem_bytes=smem,
    )


def spmm_plain(a: SpmmPack, x: torch.Tensor) -> torch.Tensor:
    """Plain torch Y = A X for X (n, B) over the same pack: each entry's
    GROUP products summed into its group, in column chunks."""
    m = a.shape[0]
    n_groups = a.eptr.shape[0] - 1
    group = torch.repeat_interleave(
        torch.arange(n_groups, device=x.device), (a.eptr[1:] - a.eptr[:-1]).long()
    )
    col = a.ecol.long()
    b = x.shape[1]
    per_col = max(a.evals.numel() * a.evals.element_size(), 1)
    step = max(1, PLAIN_CHUNK_BYTES // per_col)
    y = x.new_empty((n_groups * GROUP, b))
    for c0 in range(0, b, step):
        xc = x[:, c0:c0 + step]
        part = a.evals[:, :, None] * xc[col][:, None, :]
        acc = x.new_zeros((n_groups, GROUP, xc.shape[1]))
        acc.index_add_(0, group, part)
        y[:, c0:c0 + step] = acc.reshape(n_groups * GROUP, -1)
    return y[:m]


def columns_per_lane(n_groups: int, x_rows: int, b: int, itemsize: int,
                     address: int, sms: int, l2_bytes: int) -> int:
    """The kernel's columns per lane for X (x_rows, b) at `address` on a
    card with `sms` SMs and `l2_bytes` of L2: the most, of 4 and 2, that
    load at most 16 bytes, divide b, are aligned at the address, and keep
    the slab of X that the blocks in flight read (RESIDENT_WARPS warps
    per SM over the n_groups groups) within half of L2; else 1."""
    in_flight = -(-sms * RESIDENT_WARPS // n_groups)  # column tiles at once
    for cpt in (4, 2):
        slab = in_flight * 32 * cpt * x_rows * itemsize
        if (cpt * itemsize <= 16 and slab <= l2_bytes // 2 and b % cpt == 0
                and address % (cpt * itemsize) == 0):
            return cpt
    return 1


@functools.cache
def _library():
    lib = cuda_build.library()
    p = ctypes.c_void_p
    i64 = ctypes.c_int64
    for name in ("spmm_tile_f32", "spmm_tile_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [p] * 5 + [i64] * 5 + [p]
        fn.restype = ctypes.c_int
    lib.spmm_tile_error_string.argtypes = [ctypes.c_int]
    lib.spmm_tile_error_string.restype = ctypes.c_char_p
    return lib


_KERNELS = {torch.float32: "spmm_tile_f32", torch.float64: "spmm_tile_f64"}


def spmm(a: SpmmPack, x: torch.Tensor) -> torch.Tensor:
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
    b = x.shape[1]
    if b < 1 or m < 1:
        raise ValueError(f"empty product: m={m}, B={b}")
    n_entries = a.ecol.shape[0]
    _check("x", x, a.dtype, (n, b), dev)
    _check("eptr", a.eptr, torch.int32, (a.n_tiles * TILE_GROUPS + 1,), dev)
    _check("ecol", a.ecol, torch.int32, (n_entries,), dev)
    _check("evals", a.evals, a.dtype, (n_entries, GROUP), dev)
    if a.smem_bytes > SHARED_MAX:
        raise ValueError(f"a block needs {a.smem_bytes} B of shared memory")
    props = torch.cuda.get_device_properties(dev)
    cpt = columns_per_lane(
        a.eptr.shape[0] - 1, n, b, x.element_size(), x.data_ptr(),
        props.multi_processor_count, props.L2_cache_size,
    )
    if -(-b // (32 * cpt)) > MAX_GRID_Y:
        raise ValueError(f"B={b} exceeds the kernel's column grid")
    lib = _library()
    y = torch.empty((m, b), dtype=a.dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, _KERNELS[a.dtype])(
            a.eptr.data_ptr(), a.ecol.data_ptr(), a.evals.data_ptr(),
            x.data_ptr(), y.data_ptr(), m, b, a.n_tiles, cpt, a.smem_bytes,
            stream,
        )
    if rc != 0:
        msg = lib.spmm_tile_error_string(rc).decode()
        raise RuntimeError(f"spmm_tile launch failed: {msg} ({rc})")
    launches += 1
    return y
