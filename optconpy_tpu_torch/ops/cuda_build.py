"""Build and load the hand-written CUDA kernels of csrc/.

Every csrc/*.cu file is compiled by nvcc for sm_90a at first use, one
nvcc process per source, all started together, and the objects are
linked into one shared library under build/ at the repository root
(named by a hash of the sources and flags, so a changed source builds
anew). The library exports plain C functions; each kernel's wrapper
declares the argtypes of its own functions on `library()`.
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
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


@dataclass(frozen=True)
class BuildInfo:
    path: Path
    seconds: float  # wall time; 0.0 when an earlier build was reused
    steps: dict  # seconds of each nvcc run: one per source, and "link"
    log: str  # nvcc's output (-Xptxas -v resource usage)


def _sources() -> list[Path]:
    return sorted(_CSRC.glob("*.cu"))


def _nvcc(*args) -> tuple[float, str]:
    """Run nvcc once; its seconds and output. Raises if it failed."""
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [nvcc, *NVCC_FLAGS, *args], capture_output=True, text=True
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc {' '.join(args)} failed "
                           f"({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    return time.perf_counter() - t0, proc.stdout + proc.stderr


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
        return BuildInfo(path, 0.0, {}, "")
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, f"{p.stem}.o") for p in srcs]
        # Leaving the pool waits for every nvcc, also when one failed.
        with ThreadPoolExecutor(len(srcs)) as pool:
            runs = list(pool.map(
                lambda src, obj: _nvcc("-c", "-o", obj, str(src)), srcs, objs
            ))
        lib = os.path.join(tmp, path.name)
        link = _nvcc("-shared", "-o", lib, *objs)
        os.replace(lib, path)
    steps = {p.name: t for p, (t, _) in zip(srcs, runs)} | {"link": link[0]}
    log = "".join(f"== {p.name}\n{out}" for p, (_, out) in zip(srcs, runs))
    return BuildInfo(path, time.perf_counter() - t0, steps, log + link[1])


@functools.cache
def library() -> ctypes.CDLL:
    """The built library, loaded once per process."""
    return ctypes.CDLL(str(build().path))


def check_tensor(name, x, dtype, shape, device):
    """Raise unless x is a contiguous tensor of this dtype, shape and
    device (what a kernel reads through a raw pointer)."""
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
