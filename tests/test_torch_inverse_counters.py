"""The dense-inverse DRE tier's counters and span on the CPU (port only).

solvers/saddle.py counts each SaddleShiftedInverseCache.solve (one apply
of a velocity block) and records it as the span inverse.solve; an ADI
iteration's SMW solve applies the block twice. The Stokes cavity nx=5 in
float64.
"""
import numpy as np
import pytest
import threadpoolctl
import torch
from torch.profiler import ProfilerActivity, profile

from optconpy_tpu_torch.models.cavity import cavity_stokes_setup
from optconpy_tpu_torch.riccati import (
    build_dre_cache_dae_ns,
    dre_backward_sweep,
    dre_shift_schedule_dae,
    lyap_adi,
)
from optconpy_tpu_torch.solvers import saddle
from optconpy_tpu_torch.solvers.saddle import SaddleShiftedInverseCache
from optconpy_tpu_torch.utils import profiling

CPU = torch.device("cpu")
F64 = torch.float64
DT = 0.02
N_SHIFTS, N_ADI, R_MAX = 3, 6, 12


@pytest.fixture(scope="module", autouse=True)
def _one_host_thread():
    """One torch and one BLAS thread for the module (several test
    workers share the cores)."""
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(1):
        yield


@pytest.fixture(scope="module")
def cavity():
    ops, sys, _ = cavity_stokes_setup(nx=5, device=CPU, dtype=F64)
    sched = dre_shift_schedule_dae(ops["A"], ops["M"], ops["J"], DT,
                                   num_shifts=N_SHIFTS, n_adi=N_ADI)
    return sys, sched


@pytest.fixture(scope="module")
def ns_cache(cavity):
    """The NS stack of the cavity's shifts, certified at 5e-4."""
    sys, (sig, _, _) = cavity
    return build_dre_cache_dae_ns(sys, DT, sig, certify_tol=5e-4)[0]


def _inverse_cache(n=7, shifts=2, dtype=F64):
    rng = np.random.default_rng(5)
    inv = torch.as_tensor(rng.standard_normal((shifts, n, n))).to(dtype)
    return SaddleShiftedInverseCache(inv, n)


@pytest.mark.parametrize("dtype, width", [(F64, 3), (torch.float32, 1),
                                          (torch.float32, None)])
def test_solve_counts_one_apply(dtype, width):
    cache = _inverse_cache(dtype=dtype)
    n = cache.n
    rhs = torch.ones((n, width) if width else (n,), dtype=dtype)
    a0 = saddle.inverse_applies
    out = cache.solve(1, rhs)
    assert torch.equal(out, cache.inv[1] @ rhs)
    assert saddle.inverse_applies - a0 == 1


def test_smw_solve_applies_the_block_twice():
    cache = _inverse_cache()
    rng = np.random.default_rng(6)
    u, v = (torch.as_tensor(1e-2 * rng.standard_normal((cache.n, 2)))
            for _ in range(2))
    rhs = torch.as_tensor(rng.standard_normal((cache.n, 4)))
    a0 = saddle.inverse_applies
    cache.solve_smw(0, u, v, rhs)
    assert saddle.inverse_applies - a0 == 2


def test_two_applies_an_adi_iteration(cavity, ns_cache):
    sys, (_, sseq, iseq) = cavity
    a0, i0 = saddle.inverse_applies, lyap_adi.adi_iterations
    dre_backward_sweep(sys, ns_cache, 1e-2, DT, 2, sseq, iseq, n_newton=1,
                       r_max=R_MAX)
    iters = lyap_adi.adi_iterations - i0
    assert iters == 2 * N_ADI
    assert saddle.inverse_applies - a0 == 2 * iters


def test_inverse_span_records_nothing_without_a_profiler(monkeypatch):
    """No profiler: the shared null context; under a host profile one
    inverse.solve event a solve. No path synchronizes the device."""
    def no_sync(*_, **__):
        raise AssertionError("a span synchronized")

    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    assert profiling.span("inverse.solve") is profiling._NULL
    cache = _inverse_cache()
    rhs = torch.ones((cache.n, 2), dtype=F64)
    cache.solve(0, rhs)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        cache.solve(0, rhs)
        cache.solve_smw(1, rhs, 1e-3 * rhs, rhs)
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names.count("inverse.solve") == 3
