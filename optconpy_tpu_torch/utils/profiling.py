"""Tracing, section timing, spans and counters, on torch.profiler and
synchronized clocks.

Counterpart of optconpy_tpu/utils/profiling.py: `trace` captures a
torch.profiler trace of a block (the host's ops, and the card's kernels
when one is present) and writes it as a Chrome trace (open it with
Perfetto or chrome://tracing); `SectionTimer` accumulates named wall
times, synchronizing the card before it reads the clock (a CUDA launch
returns before its kernel ends).

`span(name)` names a stretch of the program's own work on the
profiler's clock: while a torch profiler records host operations it is
one kineto event beside the kernels (and in `trace`'s Chrome traces);
with no profiler running it is one shared null context, after a single
check. A span never synchronizes or reads the device. The names are
`SPANS`, `<layer>.<what>`:

  newton.solve          riccati/newton_kleinman.py::newton_adi_are, a
                        call (one DRE step)
  adi.iteration         riccati/lyap_adi.py::lowrank_adi, an iteration
                        (both SMW solves)
  matfree.solve         solvers/matfree.py::SaddleMatfreeCache, an
                        FGMRES solve with its gathers (solve_relres,
                        apply_full)
  krylov.fgmres_cycle   solvers/krylov.py::fgmres, a restart cycle
                        through its residual read
  krylov.arnoldi_step   solvers/krylov.py::gmres, a basis vector with
                        its Gram-Schmidt loop
  matfree.apply         the matrix-free saddle apply of a solve
  matfree.precond       its block-Jacobi and pressure-Schur
                        preconditioner
  lowrank.compress      ops/lowrank.py::compress, a call
  inverse.solve         solvers/saddle.py::SaddleShiftedInverseCache.solve,
                        one apply of a dense velocity-block inverse
                        (the dense-inverse DRE tier's GEMM)
  rollout.call          mpc/nse_rollout.py::batched_nse_closed_loop, a
                        call (one control step at B=1)
  rollout.step          a time step of the fused closed loop
  sweep.call            mpc/nse_rollout.py::nse_sweep_outputs, a call
                        (the parameter sweep's rollout, its per-bucket
                        operators included)
  sweep.step            a time step of it (every bucket's scenarios)

Counters, module-level integers beside the code, always on (the
benchmark's readers, cudabench/metrics/, take ratios of them):

  solvers/krylov.py
    fgmres_solves, fgmres_cycles   krylov.fgmres_cycles_per_solve.gains
    fgmres_capped (solves returned krylov.fgmres_capped_share.gains
      above tol at max_cycles)
  riccati/lyap_adi.py
    adi_iterations                 krylov.host_reads_per_adi.gains,
                                   krylov.mgs_launches_per_adi.gains,
                                   ns_dre.inverse_reads_per_adi.gains_ns
  utils/profiling.py
    host_reads                     krylov.host_reads_per_adi.gains
  solvers/ns_inverse.py
    sparse_calls, a Counter of the matrix-free saddle's sparse products
      by (rows, cols, nnz, width, bytes an element), counted where the
      algorithm asks for them (ns_inverse._apply_big and the
      preconditioner's J^T product), whichever kernel serves them
                                   k2_spmm.roofline_share.gains
  ops/spmm_kernel.py launches, ops/conv_kernel.py launches
                                   the kernels' launches (K2's and K1's
                                   rooflines)
  ops/arnoldi_kernel.py
    launches, launches_onchip (the launches that kept w in shared
      memory)                      krylov.mgs_launches_per_adi.gains
    launches_one_cluster (the launches whose grid was one cluster)
                                   krylov.mgs_one_cluster_share.gains
  solvers/saddle.py
    inverse_applies (SaddleShiftedInverseCache.solve calls)
                                   ns_dre.inverse_reads_per_adi.gains_ns
                                   (over lyap_adi.adi_iterations)
  parallel/param_sweep.py
    layout_real_columns, layout_padded_columns (the scenario-columns
      sweep_layout gives real scenarios and padding)
                                   sweep.padded_share.sweep

host_reads counts a device-to-host read where the read is made, in the
three functions that make the matrix-free DRE path's reads on CUDA:
solvers/krylov.py::fgmres (its residual, once a restart cycle), and
ops/lowrank.py's smw_solve (torch.linalg.solve checks the capacitance
solve on the host) and compress (the SVD checks its result on the
host). They count whichever path calls them, on any device; each DRE
cell runs one tier alone, and the dense-inverse tier reads only in
smw_solve and compress.
"""
from __future__ import annotations

import time
from contextlib import contextmanager, nullcontext
from pathlib import Path

import torch
from torch._C._profiler import _RecordFunctionFast

SPANS = (
    "newton.solve",
    "adi.iteration",
    "matfree.solve",
    "krylov.fgmres_cycle",
    "krylov.arnoldi_step",
    "matfree.apply",
    "matfree.precond",
    "lowrank.compress",
    "inverse.solve",
    "rollout.call",
    "rollout.step",
    "sweep.call",
    "sweep.step",
)
_KNOWN = frozenset(SPANS)
_NULL = nullcontext()
_profiling = torch._C._autograd._profiler_enabled

host_reads = 0  # counter: see the module's docstring


def span(name: str):
    """A context manager naming the enclosed work `name`, one of SPANS
    (else ValueError).

    With no profiler running, the shared null context. Under a profiler,
    a RecordFunctionFast event, which the profiler records only when it
    records host operations: on an H100 machine's host (torch 2.11) it
    cost 1.0 us under a device-only profile and 1.5 us under a host and
    device one, against 10.2 and 10.8 us for
    torch.profiler.record_function.
    """
    if name not in _KNOWN:
        raise ValueError(f"unknown span {name!r}; the spans are {SPANS}")
    if not _profiling():
        return _NULL
    return _RecordFunctionFast(name)


@contextmanager
def trace(logdir: str | Path = "data/profile"):
    """Profile the enclosed block; yields the torch.profiler.profile. On
    exit the trace is written to `logdir`/trace_<ns clock>.json, and its
    path is the profile's `trace_path`."""
    from torch.profiler import ProfilerActivity, profile

    Path(logdir).mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.trace_path = str(Path(logdir) / f"trace_{time.time_ns()}.json")
    prof.export_chrome_trace(prof.trace_path)


def _synchronize(result) -> None:
    """Wait for the devices of the CUDA tensors in `result` (a tensor or
    a (nested) tuple/list/dict of them)."""
    if isinstance(result, torch.Tensor):
        if result.is_cuda:
            torch.cuda.synchronize(result.device)
    elif isinstance(result, dict):
        for v in result.values():
            _synchronize(v)
    elif isinstance(result, (tuple, list)):
        for v in result:
            _synchronize(v)


class SectionTimer:
    """Accumulating named section timer with device synchronization."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextmanager
    def section(self, name: str, result=None):
        """Time the block under `name`. result: the tensors (or a
        container of them) the block fills in, whose devices are
        synchronized before the clock is read; when None, the current
        CUDA device is (once CUDA is initialized)."""
        t0 = time.perf_counter()
        yield
        if result is not None:
            _synchronize(result)
        elif torch.cuda.is_initialized():
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> dict:
        return {
            k: {"total_s": round(v, 4), "calls": self.counts[k]}
            for k, v in sorted(
                self.totals.items(), key=lambda kv: -kv[1]
            )
        }
