"""The orthogonalisation of one Arnoldi step: the CUDA kernel and its plain
version.

`mgs_step(vs, w, h, j, safe_beta, factor)` orthogonalises w (n, q)
against the basis vs[0..j] by modified Gram-Schmidt, column by column,
and stores the Hessenberg column h[0..j+1, j] and the next basis vector
vs[j+1], with the reference's guards (optconpy_tpu/solvers/krylov.py,
gmres): a column whose remaining norm is below factor * safe_beta (gmres
passes 64 eps) breaks down to a zero basis vector and a zero H entry, and a norm is floored at 1e-30 where it
divides. vs (m + 1, n, q), h (m + 1, m, q) and safe_beta (q,) are the
caller's; vs[j+1] and h[:j+2, j] are written in place, w is only read.

On a CPU tensor it runs `mgs_step_plain`, the loop solvers/krylov.py's
gmres ran inline. On a CUDA tensor it launches the hand-written kernel
in csrc/mgs_step.cu (one cooperative launch a step; built by
ops/cuda_build.py) or raises. The kernel replaces no TPU kernel: the
reference runs the loop as a lax.fori_loop, which XLA fuses; the port's
loop was three launches a projection.

The kernel takes the same projections in the same order; its sums run in
another order than torch's (per block, then across blocks, in a fixed
order), so its results differ from the plain version's in rounding only,
and repeat bit for bit on one card. The wrapper picks the kernel's
parameters from n, q and the dtype (`plan`): where the grid's shared
memory holds w and three basis slabs, w stays on chip and each basis
vector is read once from device memory ("on chip"); otherwise w lives in
vs[j+1] between passes ("streamed"). It keeps the word of the kernel's
grid barrier for each stream it launches on (`_barrier`).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build
from .cuda_build import check_tensor as _check
from ..utils import runtime

# Kernel launches made through `mgs_step` (one a call on CUDA), and those
# of them that kept w on chip.
launches = 0
launches_onchip = 0


def mgs_step_plain(vs: torch.Tensor, w: torch.Tensor, h: torch.Tensor,
                   j: int, safe_beta: torch.Tensor, factor: float) -> None:
    """Plain torch mgs_step (module docstring): a column sum of products
    and an `addcmul` a projection, then the norm and the guards."""
    # Modified Gram-Schmidt against v_0..v_j (w -= h_ij v_i in one
    # kernel; the column of H is stored once).
    hcol = []
    for i in range(j + 1):
        hcol.append((vs[i] * w).sum(dim=0))
        w = w.addcmul(vs[i], hcol[-1], value=-1.0)
    h[: j + 1, j] = torch.stack(hcol)
    hnorm = (w * w).sum(dim=0).sqrt()
    # A converged column's w must become a ZERO basis vector (and a
    # zero H entry), not w/eps noise. The threshold sits above the
    # dtype's MGS roundoff floor (~eps |w| before orthogonalization):
    # an absolute 1e-12 never fires in f32, and w / 1e-30 -> inf.
    breakdown = hnorm < factor * safe_beta
    h[j + 1, j] = torch.where(breakdown, 0.0, hnorm)
    vs[j + 1] = torch.where(breakdown, 0.0, w / hnorm.clamp_min(1e-30))


@functools.cache
def _library():
    lib = cuda_build.library()
    p = ctypes.c_void_p
    i64 = ctypes.c_int64
    for name in ("mgs_step_plan_f32", "mgs_step_plan_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [i64, i64, p]
        fn.restype = ctypes.c_int
    for name in ("mgs_step_f32", "mgs_step_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [p] * 6 + [i64] * 4 + [ctypes.c_double] + [i64] * 4 + [p]
        fn.restype = ctypes.c_int
    lib.mgs_step_error_string.argtypes = [ctypes.c_int]
    lib.mgs_step_error_string.restype = ctypes.c_char_p
    return lib


_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _raise(rc: int, what: str):
    msg = _library().mgs_step_error_string(rc).decode()
    raise RuntimeError(f"mgs_step {what} failed: {msg} ({rc})")


@functools.cache
def plan(device_index: int, dtype: torch.dtype, n: int, q: int):
    """The kernel's launch for (n, q) blocks of `dtype` on a card: (grid,
    bytes of shared memory, whether w stays on chip, elements a thread
    moves at once: 16 bytes' worth where n q and q allow, else 1)."""
    out = (ctypes.c_int32 * 4)()
    with torch.cuda.device(device_index):
        rc = getattr(_library(), f"mgs_step_plan_{_SUFFIX[dtype]}")(
            n, q, ctypes.addressof(out))
    if rc != 0:
        _raise(rc, f"plan for n={n}, q={q}, {dtype}")
    return out[0], out[1], bool(out[2]), out[3]


@functools.cache
def _barrier(device_index: int, stream: int) -> torch.Tensor:
    """The word of the kernel's grid barrier for launches on one stream:
    zero at first; a launch flips its top bit at each barrier and leaves
    the other bits zero. Launches on one stream run one after another, so
    they share it."""
    return torch.zeros(1, dtype=torch.int32,
                       device=torch.device("cuda", device_index))


def validate(vs: torch.Tensor, w: torch.Tensor, h: torch.Tensor, j: int,
             safe_beta: torch.Tensor) -> tuple[int, int, int]:
    """(m, n, q) of a kernel call. Raises unless the tensors are float32
    or float64 of one dtype and device, contiguous, vs (m + 1, n, q),
    w (n, q), h (m + 1, m, q), safe_beta (q,), and 0 <= j < m."""
    if w.dtype not in _SUFFIX:
        raise TypeError(f"mgs_step takes float32 or float64, not {w.dtype}")
    if vs.ndim != 3 or vs.shape[0] < 2:
        raise ValueError(f"vs must be (m + 1, n, q), got {tuple(vs.shape)}")
    m1, n, q = vs.shape
    if not 0 <= j < m1 - 1:
        raise ValueError(f"step j={j} outside 0..{m1 - 2}")
    _check("vs", vs, w.dtype, (m1, n, q), w.device)
    _check("w", w, w.dtype, (n, q), w.device)
    _check("h", h, w.dtype, (m1, m1 - 1, q), w.device)
    _check("safe_beta", safe_beta, w.dtype, (q,), w.device)
    return m1 - 1, n, q


def mgs_step(vs: torch.Tensor, w: torch.Tensor, h: torch.Tensor, j: int,
             safe_beta: torch.Tensor, factor: float) -> None:
    """Orthogonalise w against vs[0..j]; store h[:j+2, j] and vs[j+1]
    (module docstring). A column breaks down where its remaining norm is
    below factor * safe_beta.

    CPU tensors take the plain version. CUDA tensors launch the kernel:
    float32 or float64, vs (m + 1, n, q), w (n, q), h (m + 1, m, q),
    safe_beta (q,), contiguous, one dtype and device, 0 <= j < m;
    anything else raises.
    """
    global launches, launches_onchip
    if w.device.type == "cpu":
        return mgs_step_plain(vs, w, h, j, safe_beta, factor)
    if w.device.type != "cuda":
        raise ValueError(f"no MGS kernel for {w.device}")
    m, n, q = validate(vs, w, h, j, safe_beta)
    dev = w.device
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    grid, smem, onchip, vec = plan(index, w.dtype, n, q)
    part = torch.empty(2 * grid * q, dtype=w.dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(_library(), f"mgs_step_{_SUFFIX[w.dtype]}")(
            vs.data_ptr(), w.data_ptr(), h.data_ptr(), safe_beta.data_ptr(),
            part.data_ptr(), _barrier(index, stream).data_ptr(), n, q, m, j,
            factor, grid, smem, int(onchip), vec, stream,
        )
    if rc != 0:
        _raise(rc, "launch")
    launches += 1
    launches_onchip += onchip
    if runtime.debug_nans():  # the launch bypasses the sanitizer's dispatch
        runtime.check_nan("mgs_step", vs[j + 1])
