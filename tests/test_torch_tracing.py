"""The port's spans and counters (utils/profiling.py) on the CPU.

Spans: with no profiler running, span() is one shared null context; under
torch.profiler with host activity each span is one kineto event, nested
by interval as the code nests (an Arnoldi step inside an FGMRES cycle
inside a matrix-free solve inside an ADI iteration), and the aten ops
issued inside a span lie inside its interval (one clock). Counters: exact
on small solves (FGMRES cycles, capped solves, host reads where each is
made, ADI iterations, the matrix-free saddle's sparse products by width
and element size).
Matrix-free solves on the cavity nx=4 in float64, where the SpMM kernel
takes its plain version.
"""
from collections import Counter
from types import SimpleNamespace

import numpy as np
import pytest
import threadpoolctl
import torch
from torch.profiler import ProfilerActivity, profile

from optconpy_tpu_torch.models.cavity import cavity_stokes_setup
from optconpy_tpu_torch.mpc import batched_nse_closed_loop
from optconpy_tpu_torch.mpc.nse_rollout import NSEFusedCache
from optconpy_tpu_torch.ops.lowrank import compress, smw_solve
from optconpy_tpu_torch.riccati import lyap_adi
from optconpy_tpu_torch.riccati.shifts import (
    spectral_interval_dae,
    wachspress_shifts,
)
from optconpy_tpu_torch.solvers import krylov, ns_inverse
from optconpy_tpu_torch.solvers.matfree import SaddleMatfreeCache
from optconpy_tpu_torch.utils import profiling
from optconpy_tpu_torch.utils.profiling import SPANS, span

CPU = torch.device("cpu")
F64 = torch.float64
M_KRYLOV = 6
COUNTERS = ("fgmres_solves", "fgmres_cycles", "fgmres_capped")


@pytest.fixture(scope="module", autouse=True)
def _one_host_thread():
    """One torch and one BLAS thread for the module (several test
    workers share the cores)."""
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(1):
        yield


def _counters() -> dict:
    out = {k: getattr(krylov, k) for k in COUNTERS}
    out["adi_iterations"] = lyap_adi.adi_iterations
    out["host_reads"] = profiling.host_reads
    return out


def _delta(before: dict) -> dict:
    return {k: v - before[k] for k, v in _counters().items()}


def _events(prof):
    """(name, start_ns, end_ns) of every host event of a profile."""
    return [(e.name(), e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events()]


def _inside(inner, outers) -> bool:
    return any(s <= inner[1] and inner[2] <= e for _, s, e in outers)


@pytest.fixture(scope="module")
def cavity():
    ops, sys, _ = cavity_stokes_setup(nx=4, device=CPU, dtype=F64)
    a_min, a_max = spectral_interval_dae(ops["A"], ops["M"], ops["J"])
    sig = wachspress_shifts(a_min, a_max, 3)
    mf = SaddleMatfreeCache.build(
        ops["A"].T.tocsr(), ops["M"], ops["J"], sig, device=CPU, dtype=F64,
        block=32, m_krylov=M_KRYLOV, max_cycles=40, tol=1e-9)
    return sys, sig, mf


@pytest.fixture(scope="module")
def traced(cavity):
    """Three ADI iterations on the matrix-free cache and one compression
    under a host profile; the events and the counters' deltas."""
    sys, sig, mf = cavity
    rng = np.random.default_rng(0)
    k = torch.as_tensor(1e-2 * rng.standard_normal((sys.m_in, sys.n)))
    w = torch.as_tensor(rng.standard_normal((sys.n, 2)))
    sigma = torch.as_tensor(np.asarray(sig)[[0, 1, 2]])
    before = _counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        z = lyap_adi.lowrank_adi(mf, k.T, sys.b, sys.mass, w, sigma,
                                 [0, 1, 2])
        compress(z, out_rank=4)
    return _events(prof), _delta(before)


@pytest.mark.parametrize("name", SPANS)
def test_span_without_profiler_is_the_shared_null_context(name):
    assert span(name) is span(SPANS[0]) is profiling._NULL
    with span(name):
        pass  # and it records nothing: no profiler holds an event


@pytest.mark.parametrize("name", ["krylov.unknown", "krylov", "",
                                  "Newton.solve"])
def test_span_rejects_a_name_outside_spans(name):
    with pytest.raises(ValueError, match="unknown span"):
        span(name)


@pytest.mark.parametrize("inner, outer", [
    ("krylov.arnoldi_step", "krylov.fgmres_cycle"),
    ("krylov.fgmres_cycle", "matfree.solve"),
    ("matfree.solve", "adi.iteration"),
    ("matfree.apply", "krylov.fgmres_cycle"),
    ("matfree.precond", "krylov.arnoldi_step"),
])
def test_spans_nest_by_interval(traced, inner, outer):
    events, _ = traced
    inners = [e for e in events if e[0] == inner]
    outers = [e for e in events if e[0] == outer]
    assert inners and outers
    assert all(_inside(e, outers) for e in inners)


@pytest.mark.parametrize("name, count", [
    ("adi.iteration", lambda d: d["adi_iterations"]),
    # two solves an SMW solve, one SMW solve an ADI iteration
    ("matfree.solve", lambda d: 2 * d["adi_iterations"]),
    ("krylov.fgmres_cycle", lambda d: d["fgmres_cycles"]),
    ("krylov.arnoldi_step", lambda d: d["fgmres_cycles"] * M_KRYLOV),
    # gmres applies the operator to x0, at each Arnoldi step and to x
    ("matfree.apply", lambda d: d["fgmres_cycles"] * (M_KRYLOV + 2)),
    ("matfree.precond", lambda d: d["fgmres_cycles"] * M_KRYLOV),
    ("lowrank.compress", lambda d: 1),
])
def test_each_span_is_one_event(traced, name, count):
    events, delta = traced
    assert delta["adi_iterations"] == 3
    assert delta["fgmres_solves"] == 6
    assert sum(e[0] == name for e in events) == count(delta)


def test_host_reads_of_adi_and_compression(traced):
    """A read a restart cycle, one an SMW solve (one an ADI iteration)
    and one the compression."""
    _, d = traced
    assert d["host_reads"] == d["fgmres_cycles"] + d["adi_iterations"] + 1


@pytest.mark.parametrize("site", ["compress", "smw_solve"])
def test_host_reads_are_counted_where_made(site):
    """compress and smw_solve count their read themselves, whoever calls
    them: a dense inverse here, no Krylov solve."""
    rng = np.random.default_rng(4)
    z = torch.as_tensor(rng.standard_normal((12, 5)))
    before = _counters()
    if site == "compress":
        compress(z, out_rank=3)
    else:
        smw_solve(lambda r: 0.5 * r, z[:, :2], z[:, 2:4], z[:, 4:])
    d = _delta(before)
    assert d["host_reads"] == 1
    assert d["fgmres_solves"] == 0


def test_aten_ops_lie_inside_their_span(traced):
    """Every aten::addcmul of the run is a Gram-Schmidt update, issued
    inside an Arnoldi step: it lies inside one of their intervals."""
    events, _ = traced
    steps = [e for e in events if e[0] == "krylov.arnoldi_step"]
    ops = [e for e in events if e[0] == "aten::addcmul"]
    assert len(ops) >= len(steps) > 0
    assert all(_inside(e, steps) for e in ops)


def _small_system(n=40, seed=1):
    rng = np.random.default_rng(seed)
    a = torch.as_tensor(np.eye(n) * 4.0 + rng.standard_normal((n, n)) / n)
    b = torch.as_tensor(rng.standard_normal((n, 2)))
    return a, b


@pytest.mark.parametrize("max_cycles, tol, capped", [
    (50, 1e-10, 0),  # converges within the cap
    (1, 1e-14, 1),  # stopped by max_cycles above tol
])
def test_fgmres_counters_are_exact(max_cycles, tol, capped):
    a, b = _small_system()
    cycles = []

    def matvec(x):
        return a @ x

    before = _counters()
    _, rel = krylov.fgmres(matvec, b, m=3, tol=tol, max_cycles=max_cycles)
    d = _delta(before)
    # the loop's own count: cycles until rel <= tol or the cap
    x = None
    rel_k = np.inf
    while len(cycles) < max_cycles and rel_k > tol:
        bs = b / b.norm(dim=0)
        x, res = krylov.gmres(matvec, bs, x0=x, n_iter=3)
        rel_k = float(res.max())
        cycles.append(rel_k)
    assert d["fgmres_solves"] == 1
    assert d["fgmres_cycles"] == len(cycles) >= 1
    assert d["host_reads"] == d["fgmres_cycles"]
    assert d["fgmres_capped"] == capped == int(rel > tol)


class _FakeShifted:
    """solve_smw on a diagonal: enough for lowrank_adi's loop."""

    def solve_smw(self, i, u, v, rhs):
        return rhs / (2.0 + i)


@pytest.mark.parametrize("idx_seq", [[0], [0, 1, 0], [1, 0, 1, 0, 1]])
def test_adi_iterations_count_idx_seq(idx_seq):
    n = 5
    mass = SimpleNamespace(matmat=lambda x: x)
    sigma = -torch.arange(1.0, len(idx_seq) + 1, dtype=F64)
    before = lyap_adi.adi_iterations
    z = lyap_adi.lowrank_adi(_FakeShifted(), None, None, mass,
                             torch.ones((n, 2), dtype=F64), sigma, idx_seq)
    assert z.shape == (n, 2 * len(idx_seq))
    assert lyap_adi.adi_iterations - before == len(idx_seq)


@pytest.mark.parametrize("width", [1, 3])
def test_sparse_calls_hold_the_solve_widths(cavity, width):
    """One matrix-free SMW solve: every product at its right-hand sides'
    width and float64's 8 bytes, the operator's at gmres's applies, J^T's
    also at each preconditioner call; one host read more than the cycles
    (the SMW capacitance solve)."""
    sys, _, mf = cavity
    rhs = torch.as_tensor(
        np.random.default_rng(2).standard_normal((sys.n, width)))
    u = torch.zeros((sys.n, width), dtype=F64)
    before = _counters()
    calls = ns_inverse.sparse_calls.copy()
    mf.solve_smw(1, u, u, rhs)
    got = ns_inverse.sparse_calls - calls
    d = _delta(before)
    ops = mf.ops
    applies = d["fgmres_cycles"] * (M_KRYLOV + 2)
    want = Counter()
    for a, count in ((ops.at, applies), (ops.m, applies), (ops.j, applies),
                     (ops.jt, applies + d["fgmres_cycles"] * M_KRYLOV)):
        want[(*a.shape, a.nnz, width, 8)] += count
    assert got == want
    assert d["fgmres_solves"] == 2
    assert d["host_reads"] == d["fgmres_cycles"] + 1


def test_rollout_spans_nest_a_step_in_the_call():
    """batched_nse_closed_loop on a fused cache: one rollout.call with a
    rollout.step per time step inside it."""
    n, m, p, nts = 6, 2, 1, 4
    rng = np.random.default_rng(3)

    def t(*shape):
        return torch.as_tensor(0.1 * rng.standard_normal(shape))

    cache = NSEFusedCache(pmat=t(n, n), inv_vv=t(n, n), gmat=t(n, m),
                          c0=t(n), vbar=t(n), dt=0.1)
    sys = SimpleNamespace(b=t(n, m), c=t(p, n), m_in=m)
    conv = SimpleNamespace(conv_inner_batch_t=lambda v: v * v)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        vs, _, _ = batched_nse_closed_loop(sys, conv, cache, t(nts + 1, m, n),
                                           t(nts + 1, n), t(3, n), 1.0, 0.1)
    events = _events(prof)
    calls = [e for e in events if e[0] == "rollout.call"]
    steps = [e for e in events if e[0] == "rollout.step"]
    assert vs.shape == (3, nts + 1, n)
    assert len(calls) == 1 and len(steps) == nts
    assert all(_inside(e, calls) for e in steps)
