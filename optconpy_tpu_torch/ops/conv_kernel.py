"""Batched P2 convection N(v)v: the CUDA kernel and its plain version.

`conv_full_batch` is the wrapper of the hand-written Hopper kernel in
csrc/conv_p2.cu, which replaces the TPU kernel
optconpy_tpu/ops/pallas_conv.py::conv_element_blocks and the XLA gather
and scatter around it. On a CPU tensor it runs `conv_full_batch_plain`,
the same function in plain torch; on a CUDA tensor it launches the
kernel or raises.

Shared layout (no padding):
  v_full_t: (2*ns, B) batch-last velocities, [x dofs | y dofs];
  t0:       (nt, 6, 6, 6, 2) per-element tensor T0[e, i, j, k, c];
  tri_dofs: (nt, 6) int64 scalar P2 dofs per element;
  slots:    (ns, k_s) int64 flat element slots e*6 + i accumulating into
            each scalar dof, padded with the sentinel nt*6.

The kernel is compiled with nvcc for sm_90a at first use, from the
sources in csrc/ into build/ at the repository root, and bound with
ctypes.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# Kernel launches made through `conv_full_batch` (one per call on CUDA).
launches = 0


def conv_full_batch_plain(v_full_t, t0, tri_dofs, slots, ns: int):
    """Plain torch N(v)v: (2ns, B) -> (2ns, B). Gather, einsum,
    unrolled k-combine, then the slot gather-sum (the same steps as
    optconpy_tpu ConvKernel.conv_full_batch)."""
    nt = tri_dofs.shape[0]
    b = v_full_t.shape[1]
    v2 = v_full_t.reshape(2, ns, b)
    v_loc = v2[:, tri_dofs.reshape(-1)].reshape(2, nt, 6, b)
    # w[e, i, k, :] = sum_{j, c} T0[e, i, j, k, c] v_loc[c, e, j, :]
    w = torch.einsum("eijkc,cejb->eikb", t0, v_loc)
    # out[a, e, i, :] = sum_k w[e, i, k, :] v_loc[a, e, k, :], unrolled
    # over k so no (2, nt, 6, 6, B) broadcast is materialized.
    out_loc = w[None, :, :, 0, :] * v_loc[:, :, None, 0, :]
    for k in range(1, 6):
        out_loc = out_loc + w[None, :, :, k, :] * v_loc[:, :, None, k, :]
    out_flat = torch.cat(
        [out_loc.reshape(2, nt * 6, b), out_loc.new_zeros((2, 1, b))], dim=1
    )
    return out_flat[:, slots].sum(dim=2).reshape(2 * ns, b)


@dataclass(frozen=True)
class BuildInfo:
    path: Path
    seconds: float  # 0.0 when an earlier build of these sources was reused
    log: str  # nvcc's output (-Xptxas -v resource usage)


def _sources() -> list[Path]:
    return sorted(_CSRC.glob("*.cu"))


@functools.cache
def build() -> BuildInfo:
    """Compile csrc/*.cu into build/ (once per source content)."""
    srcs = _sources()
    h = hashlib.sha256()
    for p in srcs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    path = _BUILD_DIR / f"liboptconpy_kernels_{h.hexdigest()[:12]}.so"
    if path.exists():
        return BuildInfo(path, 0.0, "")
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=_BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-o", tmp, *map(str, srcs)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return BuildInfo(path, time.perf_counter() - t0, proc.stdout + proc.stderr)


@functools.cache
def _library():
    lib = ctypes.CDLL(str(build().path))
    p = ctypes.c_void_p
    i64 = ctypes.c_int64
    lib.conv_p2_forward.argtypes = [p, p, p, p, p, p, i64, i64, i64, i64, p]
    lib.conv_p2_forward.restype = ctypes.c_int
    lib.conv_p2_error_string.argtypes = [ctypes.c_int]
    lib.conv_p2_error_string.restype = ctypes.c_char_p
    return lib


def _check(name, x, dtype, shape, device):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def conv_full_batch(v_full_t, t0, tri_dofs, slots, ns: int):
    """N(v)v for a batch: (2ns, B) -> (2ns, B).

    CPU tensors take the plain version. CUDA tensors launch the kernel:
    float32 values, int64 maps, contiguous, all on one device; anything
    else raises.
    """
    global launches
    if v_full_t.device.type == "cpu":
        return conv_full_batch_plain(v_full_t, t0, tri_dofs, slots, ns)
    if v_full_t.device.type != "cuda":
        raise ValueError(f"no convection kernel for {v_full_t.device}")
    dev = v_full_t.device
    nt = tri_dofs.shape[0]
    b = v_full_t.shape[1]
    k_s = slots.shape[1]
    if b < 1 or nt < 1:
        raise ValueError(f"empty batch or mesh: B={b}, nt={nt}")
    _check("v_full_t", v_full_t, torch.float32, (2 * ns, b), dev)
    _check("t0", t0, torch.float32, (nt, 6, 6, 6, 2), dev)
    _check("tri_dofs", tri_dofs, torch.int64, (nt, 6), dev)
    _check("slots", slots, torch.int64, (ns, k_s), dev)
    lib = _library()
    elem_out = torch.empty((2, nt * 6, b), dtype=torch.float32, device=dev)
    out = torch.empty((2 * ns, b), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.conv_p2_forward(
            v_full_t.data_ptr(), t0.data_ptr(), tri_dofs.data_ptr(),
            slots.data_ptr(), elem_out.data_ptr(), out.data_ptr(),
            nt, ns, k_s, b, stream,
        )
    if rc != 0:
        msg = lib.conv_p2_error_string(rc).decode()
        raise RuntimeError(f"conv_p2 launch failed: {msg} ({rc})")
    launches += 1
    return out
