"""Port dense solvers, feedforward sweep and rollouts vs the reference.

Covers the modules optcon_nse reaches below the driver, in f64 on the
CPU: the host-LU caches against scipy (ops/dense.py, solvers/shifted.py,
solvers/saddle.py, 1e-12), heat1d's operators (bitwise), the
feedforward sweep on the same gains (heat1d and the cavity, 1e-10), the
linear closed loop on heat1d for euler/cn x explicit/implicit (1e-10)
and the IMEX step tiers on the cavity (nx=6) for lu/inverse x
oseen/explicit/oseen-cn (1e-10). Inputs are made from seeds with numpy
and handed to both packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla
import threadpoolctl
import torch

from optconpy_tpu import native as j_native
from optconpy_tpu.control import build_costate_cache as j_costate
from optconpy_tpu.control import build_costate_cache_dae as j_costate_dae
from optconpy_tpu.control import feedforward_sweep as j_feedforward
from optconpy_tpu.fem.device_conv import ConvKernel as JConvKernel
from optconpy_tpu.fem.heat1d import heat1d_operators as j_heat1d
from optconpy_tpu.models.cavity import cavity_stokes_setup as j_cavity_setup
from optconpy_tpu.mpc import batched_closed_loop as j_batched_loop
from optconpy_tpu.mpc import batched_nse_closed_loop as j_nse_loop
from optconpy_tpu.mpc import build_nse_stepper as j_build_stepper
from optconpy_tpu.mpc import build_step_cache as j_step_cache
from optconpy_tpu.solvers.steady import solve_steady_nse_host as j_steady
from optconpy_tpu_torch.control import (
    build_costate_cache,
    build_costate_cache_dae,
    feedforward_sweep,
)
from optconpy_tpu_torch.fem.device_conv import ConvKernel
from optconpy_tpu_torch.fem.heat1d import heat1d_operators, initial_state
from optconpy_tpu_torch.models.cavity import cavity_stokes_setup
from optconpy_tpu_torch.mpc import (
    NSEStepCache,
    batched_closed_loop,
    batched_nse_closed_loop,
    build_nse_fused,
    build_nse_stepper,
    build_step_cache,
    closed_loop_rollout,
    nse_closed_loop_rollout,
)
from optconpy_tpu_torch.ops.dense import DenseInverse, LUSolver
from optconpy_tpu_torch.solvers.saddle import (
    SaddleInverse,
    SaddleLU,
    SaddleShiftedInverseCache,
    SaddleShiftedLUCache,
)
from optconpy_tpu_torch.solvers.shifted import (
    ShiftedInverseCache,
    ShiftedLUCache,
)
from optconpy_tpu_torch.solvers.steady import solve_steady_nse_host

CPU = torch.device("cpu")
F64 = torch.float64
DT, ALPHA, NTS, S = 0.02, 1e-2, 6, 3


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _t(x):
    return torch.as_tensor(np.asarray(x))


@pytest.fixture(scope="module", autouse=True)
def _one_host_thread():
    """One torch and one BLAS thread for the module: host BLAS/LAPACK
    work runs many times slower when busy-waiting BLAS threads share
    the cores with other test workers."""
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(1):
        yield


@pytest.fixture(scope="module")
def heat():
    j_ops, j_sys = j_heat1d(n=40)
    t_ops, t_sys = heat1d_operators(n=40, device=CPU)
    return j_ops, j_sys, t_ops, t_sys


@pytest.fixture(scope="module")
def cavity():
    with pytest.MonkeyPatch.context() as mp:
        # the reference's numpy element path, the port's only one
        mp.setattr(j_native, "available", lambda: False)
        j_ops, j_sys, j_cond = j_cavity_setup(nx=6)
        j_ops["vbar_full"], _ = j_steady(j_ops["full"], j_cond)
    t_ops, t_sys, t_cond = cavity_stokes_setup(nx=6, device=CPU)
    t_ops["vbar_full"], _ = solve_steady_nse_host(t_ops["full"], t_cond)
    return (j_ops, j_sys, j_cond), (t_ops, t_sys, t_cond)


def _gains_inputs(n, m, seed, scale):
    rng = np.random.default_rng(seed)
    return {
        "ks": scale * rng.standard_normal((NTS + 1, m, n)),
        "ws": 1e-2 * rng.standard_normal((NTS + 1, n)),
        "ystar": rng.standard_normal((NTS + 1, 2)),
    }


# --- host-LU caches against scipy -----------------------------------------

def test_heat1d_operators_bitwise(heat):
    j_ops, j_sys, t_ops, t_sys = heat
    for key in ("M", "A"):
        a, b = j_ops[key].tocsr(), t_ops[key].tocsr()
        assert np.array_equal(a.indptr, b.indptr), key
        assert np.array_equal(a.indices, b.indices), key
        assert np.array_equal(a.data, b.data), key
    for key in ("B", "C", "nodes"):
        assert np.array_equal(j_ops[key], t_ops[key]), key
    assert np.array_equal(np.asarray(j_sys.mass.data), t_sys.mass.data.numpy())
    assert np.array_equal(np.asarray(j_sys.stiff_t.cols), t_sys.stiff_t.cols.numpy())
    assert (t_sys.n, t_sys.m_in, t_sys.p_out) == (40, 2, 1)
    assert t_sys.to(dtype=torch.float32).b.dtype == torch.float32


@pytest.mark.parametrize("cls", [LUSolver, DenseInverse])
def test_dense_solver_matches_scipy(cls):
    """A matrix that needs row interchanges: wrong pivots would show."""
    rng = np.random.default_rng(1)
    a = rng.standard_normal((30, 30))
    a[[0, 7]] = a[[7, 0]] * 1e-3  # small leading pivot forces swaps
    b = rng.standard_normal((30, 4))
    solver = cls.factor(_t(a))
    ref = sla.solve(a, b)
    assert _rel(solver.apply(_t(b)), ref) <= 1e-12
    assert _rel(solver.apply(_t(b[:, 0])), ref[:, 0]) <= 1e-12
    if cls is LUSolver:
        assert solver.piv.dtype == torch.int32
        _, piv = sla.lu_factor(a)
        assert np.array_equal(solver.piv.numpy(), piv + 1)


def _saddle(f, j):
    n, n_p = f.shape[0], j.shape[0]
    big = np.zeros((n + n_p, n + n_p))
    big[:n, :n], big[:n, n:], big[n:, :n] = f, j.T, j
    return big


@pytest.mark.parametrize("cls", [SaddleLU, SaddleInverse])
def test_saddle_solver_matches_scipy(cavity, cls):
    _, (t_ops, _, _) = cavity
    f = t_ops["M"].toarray() / DT - t_ops["A"].toarray()
    j = t_ops["J"].toarray()
    rng = np.random.default_rng(2)
    rv = rng.standard_normal((f.shape[0], 3))
    rp = rng.standard_normal((j.shape[0], 3))
    ref = sla.solve(_saddle(f, j), np.concatenate([rv, rp]))
    solver = cls.build(_t(f), _t(j))
    v, p = solver.apply_full(_t(rv), _t(rp))
    assert _rel(v, ref[: f.shape[0]]) <= 1e-12
    assert _rel(p, ref[f.shape[0]:]) <= 1e-12
    ref0 = sla.solve(_saddle(f, j), np.concatenate([rv[:, 0], 0 * rp[:, 0]]))
    assert _rel(solver.apply(_t(rv[:, 0])), ref0[: f.shape[0]]) <= 1e-12
    # velocity solves stay in ker J
    assert np.abs(j @ solver.apply(_t(rv)).numpy()).max() <= 1e-10


@pytest.mark.parametrize("cls", [ShiftedLUCache, ShiftedInverseCache])
def test_shifted_cache_matches_scipy(heat, cls):
    _, _, t_ops, _ = heat
    at, m = t_ops["A"].toarray().T, t_ops["M"].toarray()
    shifts = np.array([-3.0, -40.0])
    cache = cls.build(_t(at), _t(m), shifts)
    rng = np.random.default_rng(3)
    rhs = rng.standard_normal((at.shape[0], 2))
    u, v = 1e-2 * rng.standard_normal((2, at.shape[0], 2))
    for i, s in enumerate(shifts):
        assert _rel(cache.solve(i, _t(rhs)), sla.solve(at + s * m, rhs)) <= 1e-12
        ref = sla.solve(at + s * m - u @ v.T, rhs)
        assert _rel(cache.solve_smw(i, _t(u), _t(v), _t(rhs)), ref) <= 1e-12


@pytest.mark.parametrize("cls", [SaddleShiftedLUCache, SaddleShiftedInverseCache])
def test_saddle_shifted_cache_matches_scipy(cavity, cls):
    _, (t_ops, _, _) = cavity
    at, m, j = (t_ops[k].toarray() for k in ("A", "M", "J"))
    at = at.T
    n = at.shape[0]
    shifts = np.array([-5.0, -60.0])
    cache = cls.build(_t(at), _t(m), _t(j), shifts)
    rng = np.random.default_rng(4)
    rhs = rng.standard_normal((n, 2))
    u, v = 1e-2 * rng.standard_normal((2, n, 2))
    zeros = np.zeros((j.shape[0], 2))
    for i, s in enumerate(shifts):
        ref = sla.solve(_saddle(at + s * m, j), np.concatenate([rhs, zeros]))
        assert _rel(cache.solve(i, _t(rhs)), ref[:n]) <= 1e-12
        ref = sla.solve(_saddle(at + s * m - u @ v.T, j),
                        np.concatenate([rhs, zeros]))
        assert _rel(cache.solve_smw(i, _t(u), _t(v), _t(rhs)), ref[:n]) <= 1e-12


# --- feedforward sweep -----------------------------------------------------

def test_feedforward_matches_reference_heat1d(heat):
    _, j_sys, _, t_sys = heat
    inp = _gains_inputs(t_sys.n, t_sys.m_in, 5, 1.0)
    ystar = inp["ystar"][:, :1]
    ref = j_feedforward(j_sys, j_costate(j_sys, DT), jnp.asarray(inp["ks"]),
                        jnp.asarray(ystar), DT)
    got = feedforward_sweep(t_sys, build_costate_cache(t_sys, DT),
                            _t(inp["ks"]), _t(ystar), DT)
    assert got.shape == (NTS + 1, t_sys.n)
    assert torch.all(got[NTS] == 0)
    assert _rel(got, ref) <= 1e-10


def test_feedforward_matches_reference_cavity(cavity):
    (_, j_sys, _), (_, t_sys, _) = cavity
    inp = _gains_inputs(t_sys.n, t_sys.m_in, 6, 1e3)
    ref = j_feedforward(j_sys, j_costate_dae(j_sys, DT),
                        jnp.asarray(inp["ks"]), jnp.asarray(inp["ystar"]), DT)
    got = feedforward_sweep(t_sys, build_costate_cache_dae(t_sys, DT),
                            _t(inp["ks"]), _t(inp["ystar"]), DT)
    assert torch.all(got[NTS] == 0)
    assert _rel(got, ref) <= 1e-10
    # the costate stays in ker J
    j = t_sys.jmat.todense()
    assert float((j @ got.T).abs().max() / got.abs().max()) <= 1e-10


# --- linear closed loop ----------------------------------------------------

@pytest.mark.parametrize("feedback", ["explicit", "implicit"])
@pytest.mark.parametrize("scheme", ["euler", "cn"])
def test_lti_rollout_matches_reference(heat, scheme, feedback):
    _, j_sys, _, t_sys = heat
    inp = _gains_inputs(t_sys.n, t_sys.m_in, 7, 1.0)
    rng = np.random.default_rng(8)
    v0 = initial_state(t_sys.n)[None] + 0.1 * rng.standard_normal((S, t_sys.n))
    ref = j_batched_loop(
        j_sys, j_step_cache(j_sys, DT, scheme=scheme), jnp.asarray(inp["ks"]),
        jnp.asarray(inp["ws"]), jnp.asarray(v0), ALPHA, DT,
        feedback=feedback, scheme=scheme,
    )
    cache = build_step_cache(t_sys, DT, scheme=scheme)
    got = batched_closed_loop(
        t_sys, cache, _t(inp["ks"]), _t(inp["ws"]), _t(v0), ALPHA, DT,
        feedback=feedback, scheme=scheme,
    )
    shapes = [(S, NTS + 1, t_sys.n), (S, NTS, 2), (S, NTS + 1, 1)]
    for name, g, r, shape in zip(("vs", "us", "ys"), got, ref, shapes):
        assert tuple(g.shape) == shape, name
        assert _rel(g, r) <= 1e-10, (name, _rel(g, r))
    one = closed_loop_rollout(
        t_sys, cache, _t(inp["ks"]), _t(inp["ws"]), _t(v0[1]), ALPHA, DT,
        feedback=feedback, scheme=scheme,
    )
    for g, r in zip(one, ref):
        assert _rel(g, np.asarray(r)[1]) <= 1e-10


def test_lti_rollout_refuses_unknown_modes(heat):
    *_, t_sys = heat
    inp = _gains_inputs(t_sys.n, t_sys.m_in, 9, 1.0)
    cache = build_step_cache(t_sys, DT)
    args = (_t(inp["ks"]), _t(inp["ws"]), _t(initial_state(t_sys.n)), ALPHA, DT)
    with pytest.raises(ValueError, match="scheme"):
        closed_loop_rollout(t_sys, cache, *args, scheme="rk4")
    with pytest.raises(ValueError, match="feedback"):
        closed_loop_rollout(t_sys, cache, *args, feedback="lagged")


# --- IMEX step tiers on the cavity ----------------------------------------

@pytest.mark.parametrize("scheme", ["oseen", "explicit", "oseen-cn"])
@pytest.mark.parametrize("solver, feedback", [
    ("lu", "implicit"), ("inverse", "explicit"),
])
def test_nse_stepper_rollout_matches_reference(cavity, solver, feedback,
                                               scheme):
    (j_ops, j_sys, j_cond), (t_ops, t_sys, t_cond) = cavity
    n, m = t_sys.b.shape
    inp = _gains_inputs(n, m, 10, 1e2)
    rng = np.random.default_rng(11)
    vbar = t_cond.restrict(t_ops["vbar_full"])
    v0 = vbar[None] + 1e-2 * rng.standard_normal((S, n))
    j_conv = JConvKernel.build(j_ops["full"], j_cond, dtype=jnp.float64)
    j_cache = j_build_stepper(j_ops, j_cond, DT, dtype=jnp.float64,
                              scheme=scheme, solver=solver)
    ref = j_nse_loop(j_sys, j_conv, j_cache, jnp.asarray(inp["ks"]),
                     jnp.asarray(inp["ws"]), jnp.asarray(v0), ALPHA, DT,
                     feedback=feedback)
    conv = ConvKernel.build(t_ops["full"], t_cond, device=CPU)
    cache = build_nse_stepper(t_ops, t_cond, DT, device=CPU, dtype=F64,
                              scheme=scheme, solver=solver)
    assert isinstance(cache, NSEStepCache)
    assert (cache.rhs_half is not None) == (scheme == "oseen-cn")
    assert np.array_equal(cache.l1_imp.numpy(), np.asarray(j_cache.l1_imp))
    got = batched_nse_closed_loop(t_sys, conv, cache, _t(inp["ks"]),
                                  _t(inp["ws"]), _t(v0), ALPHA, DT,
                                  feedback=feedback)
    for name, g, r in zip(("vs", "us", "ys"), got, ref):
        assert tuple(g.shape) == tuple(r.shape), name
        assert _rel(g, r) <= 1e-10, (name, _rel(g, r))
    one = nse_closed_loop_rollout(t_sys, conv, cache, _t(inp["ks"]),
                                  _t(inp["ws"]), _t(v0[2]), ALPHA, DT,
                                  feedback=feedback)
    for g, r in zip(one, ref):
        assert _rel(g, np.asarray(r)[2]) <= 1e-10


def test_fused_explicit_scheme_matches_stepper(cavity):
    """build_nse_fused(scheme='explicit') and the explicit-scheme step
    cache run the same recurrence; the fused step re-associates the
    products, so they agree to 1e-8 (the reference driver's fused-vs-lu
    tier check allows 1e-9 on its own outputs)."""
    _, (t_ops, t_sys, t_cond) = cavity
    n, m = t_sys.b.shape
    inp = _gains_inputs(n, m, 12, 1e2)
    v0 = np.tile(t_cond.restrict(t_ops["vbar_full"]), (S, 1))
    conv = ConvKernel.build(t_ops["full"], t_cond, device=CPU)
    args = (_t(inp["ks"]), _t(inp["ws"]), _t(v0), ALPHA, DT)
    fused = build_nse_fused(t_ops, t_cond, DT, device=CPU, dtype=F64,
                            scheme="explicit")
    step = build_nse_stepper(t_ops, t_cond, DT, device=CPU, dtype=F64,
                             scheme="explicit", solver="lu")
    for feedback in ("explicit", "implicit"):
        got = batched_nse_closed_loop(t_sys, conv, fused, *args,
                                      feedback=feedback)
        ref = batched_nse_closed_loop(t_sys, conv, step, *args,
                                      feedback=feedback)
        for g, r in zip(got, ref):
            assert _rel(g, r) <= 1e-8
    with pytest.raises(ValueError, match="IMEX scheme"):
        build_nse_fused(t_ops, t_cond, DT, device=CPU, scheme="oseen-cn")
