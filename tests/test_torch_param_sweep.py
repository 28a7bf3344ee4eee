"""Port the config-5 parameter sweep (parallel/param_sweep.py, the sweep
rollouts and the Newton-Schulz bucket chain of mpc/nse_rollout.py) vs the
reference, in f64 on the CPU where the kernels take their plain versions.

On the reference test's cavity sweep (tests/test_param_sweep.py: nx=5,
nu in {1.0, 0.5}, dt 0.02, 6 steps, alpha 1e-8):

  * dre_shift_schedule_dae(interval=): 1e-12;
  * nse_closed_loop_outputs, implicit and explicit feedback on the Euler
    Oseen stepper and implicit on CNAB2 (oseen-cn): ys, u_sq, v_final
    1e-10;
  * build_sweep_gains_and_caches on the 'lu' stepper tier and
    sweep_rollout: ks 1e-8, ys, u_sq, v_final 1e-10; the sweep against
    each bucket alone (1e-13, the reference test's bound);
  * the gains of the 'inverse' (1e-8) and 'matfree' (1e-6, 2 DRE steps;
    the reference packs with kind="ell": its windowed Pallas SpMM
    accumulates in f32) DRE tiers;
  * masked_sweep_stats vs the reference's sharded_sweep_rollout on a
    1-device CPU mesh, ragged counts and per-bucket targets, padded rows
    of garbage or NaN: 1e-12; the NaN rows change no statistic;
  * assign_re_buckets, ties and the config-5 draw included: exact.

The Newton-Schulz chain on cavity buckets nu in {1.0, 0.9, 0.8} (close
enough for the chain's 4 passes from the previous bucket): inverses vs
the reference's chain 1e-6 (its seed is cast to bf16) and vs a host splu
inverse 1e-8, l1_imp vs the reference 1e-12; every bucket packed in
bucket 0's ordering; a jump too large to certify raises RuntimeError.

Each reference result is computed once in a module fixture.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import threadpoolctl
import torch

import optconpy_tpu.riccati as j_riccati
from optconpy_tpu import native as j_native
from optconpy_tpu.fem.device_conv import ConvKernel as JConvKernel
from optconpy_tpu.models.cavity import cavity_stokes_setup as j_cavity_setup
from optconpy_tpu.mpc.nse_rollout import build_nse_stepper as j_build_stepper
from optconpy_tpu.mpc.nse_rollout import (
    build_sweep_steppers_ns_chain as j_chain,
)
from optconpy_tpu.mpc.nse_rollout import nse_closed_loop_outputs as j_outputs
from optconpy_tpu.parallel import assign_re_buckets as j_assign
from optconpy_tpu.parallel import build_sweep_gains_and_caches as j_gains
from optconpy_tpu.parallel import scenario_mesh
from optconpy_tpu.parallel import sharded_sweep_rollout as j_sharded
from optconpy_tpu.parallel import sweep_rollout as j_sweep
from optconpy_tpu.riccati import dre_shift_schedule_dae as j_schedule
from optconpy_tpu.solvers.steady import solve_steady_nse_host as j_steady
from optconpy_tpu_torch.fem.device_conv import ConvKernel, FusedConvKernel
from optconpy_tpu_torch.models.cavity import cavity_stokes_setup
from optconpy_tpu_torch.mpc import nse_rollout
from optconpy_tpu_torch.mpc.nse_rollout import (
    NSEStepCache,
    build_nse_stepper,
    build_sweep_steppers_ns_chain,
    nse_closed_loop_outputs,
)
from optconpy_tpu_torch.ops import conv_kernel
from optconpy_tpu_torch.ops.spmm_kernel import rcm_permutation
from optconpy_tpu_torch.parallel import (
    assign_re_buckets,
    build_sweep_gains_and_caches,
    masked_sweep_stats,
    sweep_rollout,
)
from optconpy_tpu_torch.riccati import dre_shift_schedule_dae
from optconpy_tpu_torch.solvers.saddle import SaddleInverse, SaddleLU
from optconpy_tpu_torch.solvers.steady import solve_steady_nse_host

CPU = torch.device("cpu")
F64 = torch.float64

# tests/test_param_sweep.py's sweep.
NUS = [1.0, 0.5]
DT = 0.02
NTS = 6
ALPHA = 1e-8
GAINS = dict(num_shifts=6, n_adi=12, nts_gain=4, r_max=16)
CHAIN_NUS = [1.0, 0.9, 0.8]


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.fixture(scope="module", autouse=True)
def _one_host_thread():
    """One torch and one BLAS thread for the module: host BLAS/LAPACK
    work runs many times slower when busy-waiting BLAS threads share
    the cores with other test workers."""
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(1):
        yield


def _setups(nus, nx=5):
    """Both packages' cavity at each viscosity about its steady flow (the
    reference on its numpy element path, the port's only one)."""
    j_set, t_set = [], []
    for nu in nus:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(j_native, "available", lambda: False)
            j_ops, j_sys, j_cond = j_cavity_setup(nx=nx, nu=nu)
        j_ops["vbar_full"], _ = j_steady(j_ops["full"], j_cond)
        j_set.append((j_ops, j_sys, j_cond))
        t_ops, t_sys, t_cond = cavity_stokes_setup(nx=nx, device=CPU, nu=nu)
        t_ops["vbar_full"], _ = solve_steady_nse_host(t_ops["full"], t_cond)
        t_set.append((t_ops, t_sys, t_cond))
    return j_set, t_set


@pytest.fixture(scope="module")
def sweep():
    """The reference test's sweep fixture in both packages: setups, the
    'lu' tier's stacked caches and gains, the shared convection."""
    j_set, t_set = _setups(NUS)
    j_stack, j_ks = j_gains(j_set, DT, ALPHA, dtype=jnp.float64,
                            solver="lu", **GAINS)
    t_stack, t_ks = build_sweep_gains_and_caches(t_set, DT, ALPHA, dtype=F64,
                                                 solver="lu", **GAINS)
    j_sys = j_set[0][1].astype(jnp.float64)
    j_conv = JConvKernel.build(j_set[0][0]["full"], j_set[0][2],
                               dtype=jnp.float64)
    t_sys = t_set[0][1]
    conv = ConvKernel.build(t_set[0][0]["full"], t_set[0][2], device=CPU,
                            dtype=F64)
    vbars = t_stack.vbar.numpy()
    return dict(j=(j_set, j_stack, j_ks, j_sys, j_conv),
                t=(t_set, t_stack, t_ks, t_sys, conv), vbars=vbars)


def _v0(vbars, n_s, seed):
    rng = np.random.default_rng(seed)
    return vbars[:, None, :] + 1e-3 * rng.standard_normal(
        (vbars.shape[0], n_s, vbars.shape[1]))


def test_shift_schedule_interval_overrides(sweep):
    """interval= replaces the spectral interval in both packages."""
    t_ops = sweep["t"][0][0][0]
    args = (t_ops["A"], t_ops["M"], t_ops["J"], DT)
    got = dre_shift_schedule_dae(*args, num_shifts=5, n_adi=12,
                                 interval=(0.5, 300.0))
    ref = j_schedule(*args, num_shifts=5, n_adi=12, interval=(0.5, 300.0))
    own = dre_shift_schedule_dae(*args, num_shifts=5, n_adi=12)
    assert _rel(got[0], ref[0]) <= 1e-12
    assert _rel(got[1], ref[1]) <= 1e-12
    np.testing.assert_array_equal(got[2], ref[2])
    assert _rel(got[0], own[0]) > 1e-3  # the interval was used


@pytest.mark.parametrize("scheme, feedback", [
    ("oseen", "implicit"), ("oseen", "explicit"), ("oseen-cn", "implicit"),
])
def test_closed_loop_outputs_match_reference(sweep, scheme, feedback):
    j_set, _, j_ks, j_sys, j_conv = sweep["j"]
    t_set, _, t_ks, t_sys, conv = sweep["t"]
    (j_ops, _, j_cond), (t_ops, _, t_cond) = j_set[0], t_set[0]
    v0 = _v0(sweep["vbars"][:1], 1, 3)[0, 0]
    j_cache = j_build_stepper(j_ops, j_cond, DT, dtype=jnp.float64,
                              scheme=scheme)
    cache = build_nse_stepper(t_ops, t_cond, DT, device=CPU, dtype=F64,
                              scheme=scheme)
    ref = j_outputs(j_sys, j_conv, j_cache, j_ks[0], jnp.asarray(v0), ALPHA,
                    DT, NTS, feedback=feedback)
    got = nse_closed_loop_outputs(t_sys, conv, cache, t_ks[0],
                                  torch.as_tensor(v0), ALPHA, DT, NTS,
                                  feedback=feedback)
    assert tuple(got[0].shape) == (NTS + 1, t_sys.p_out)
    assert tuple(got[1].shape) == (NTS,)
    for name, a, b in zip(("ys", "u_sq", "v_final"), got, ref):
        assert _rel(a, b) <= 1e-10, name


@pytest.fixture(scope="module")
def sweep_runs(sweep):
    """The reference test's 2 x 4 rollout through both packages."""
    _, j_stack, j_ks, j_sys, j_conv = sweep["j"]
    _, t_stack, t_ks, t_sys, conv = sweep["t"]
    v0 = _v0(sweep["vbars"], 4, 0)
    ref = j_sweep(j_sys, j_conv, j_stack, j_ks, jnp.asarray(v0), ALPHA, DT,
                  NTS)
    got = sweep_rollout(t_sys, conv, t_stack, t_ks, torch.as_tensor(v0),
                        ALPHA, DT, NTS)
    return v0, got, ref


def test_sweep_rollout_matches_reference(sweep, sweep_runs):
    _, _, j_ks, _, _ = sweep["j"]
    _, _, t_ks, t_sys, _ = sweep["t"]
    _, got, ref = sweep_runs
    assert _rel(t_ks, j_ks) <= 1e-8
    assert tuple(got[0].shape) == (len(NUS), 4, NTS + 1, t_sys.p_out)
    assert tuple(got[1].shape) == (len(NUS), 4, NTS)
    for name, a, b in zip(("ys", "u_sq", "v_final"), got, ref):
        assert np.isfinite(a.numpy()).all(), name
        assert _rel(a, b) <= 1e-10, name


def test_sweep_rollout_per_bucket_consistency(sweep, sweep_runs):
    """The stacked sweep == each bucket alone (the reference test's
    bound)."""
    t_set, _, t_ks, t_sys, conv = sweep["t"]
    v0, got, _ = sweep_runs
    for r, (ops, _, cond) in enumerate(t_set):
        cache = build_nse_stepper(ops, cond, DT, device=CPU, dtype=F64)
        ys, u_sq, v_fin = nse_closed_loop_outputs(
            t_sys, conv, cache, t_ks[r], torch.as_tensor(v0[r, 1]), ALPHA,
            DT, NTS)
        np.testing.assert_allclose(got[0][r, 1].numpy(), ys.numpy(), rtol=0,
                                   atol=1e-13)
        np.testing.assert_allclose(got[2][r, 1].numpy(), v_fin.numpy(),
                                   rtol=0, atol=1e-13)


def test_sweep_hands_the_convection_its_contiguous_batch_last_state(
        sweep, sweep_runs):
    """One convection call a step, on the contiguous (n, R*S) state that
    the kernel's contract takes (its CUDA wrapper refuses any other
    layout); through FusedConvKernel's wrapper the outputs are the plain
    convection's, bit for bit."""
    t_set, t_stack, t_ks, t_sys, _ = sweep["t"]
    v0, got, _ = sweep_runs
    fused = FusedConvKernel.build(t_set[0][0]["full"], t_set[0][2],
                                  device=CPU, dtype=F64)
    wrapper, seen = conv_kernel.conv_inner, []

    def recording(v_t, conv):
        seen.append((tuple(v_t.shape), v_t.is_contiguous()))
        return wrapper(v_t, conv)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(conv_kernel, "conv_inner", recording)
        ys, _, _ = sweep_rollout(t_sys, fused, t_stack, t_ks,
                                 torch.as_tensor(v0), ALPHA, DT, NTS)
    assert seen == [((t_sys.n, v0.shape[0] * v0.shape[1]), True)] * NTS
    assert torch.equal(ys, got[0])


@pytest.mark.parametrize("solver_cls", [SaddleLU, SaddleInverse])
def test_stacked_saddle_solvers_solve_each_bucket(sweep, solver_cls):
    """A stacked solver applies each bucket's own solve, and its velocity
    block is the inverse's."""
    t_set = sweep["t"][0]
    rng = np.random.default_rng(5)
    solvers = []
    for ops, _, _ in t_set:
        f = torch.as_tensor(ops["M"].toarray() / DT - ops["A"].toarray())
        j = torch.as_tensor(ops["J"].toarray())
        solvers.append(solver_cls.build(f, j))
    stacked = solver_cls.stack(solvers)
    n, n_p = t_set[0][0]["M"].shape[0], t_set[0][0]["J"].shape[0]
    rv = torch.as_tensor(rng.standard_normal((len(solvers), n, 3)))
    rp = torch.as_tensor(rng.standard_normal((len(solvers), n_p, 3)))
    v, p = stacked.apply_full(rv, rp)
    w = stacked.velocity_block()
    for r, s in enumerate(solvers):
        v_r, p_r = s.apply_full(rv[r], rp[r])
        assert _rel(v[r], v_r) <= 1e-13
        assert _rel(p[r], p_r) <= 1e-13
        eye = torch.eye(n, dtype=F64)
        assert _rel(w[r], s.apply(eye)) <= 1e-13


@pytest.mark.parametrize("dre_solver, nts_gain, tol", [
    ("inverse", GAINS["nts_gain"], 1e-8), ("matfree", 2, 1e-6),
])
def test_sweep_gains_match_reference(sweep, dre_solver, nts_gain, tol):
    """The DRE tiers' gains; the matrix-free sweep over 2 of the 4 DRE
    steps (the reference's FGMRES compiles and the port's host-bound
    solves are most of this file's time)."""
    j_set = sweep["j"][0]
    t_set = sweep["t"][0]
    kw = dict(GAINS, nts_gain=nts_gain, solver="lu", dre_solver=dre_solver)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_riccati, "build_dre_cache_dae_matfree", functools.partial(
            j_riccati.build_dre_cache_dae_matfree, kind="ell"))
        _, j_ks = j_gains(j_set, DT, ALPHA, dtype=jnp.float64, **kw)
    info = {}
    _, ks = build_sweep_gains_and_caches(t_set, DT, ALPHA, dtype=F64,
                                         info=info, **kw)
    assert _rel(ks, j_ks) <= tol
    assert len(info["buckets"]) == len(NUS)
    assert all(b["dre_sweep_s"] >= 0.0 for b in info["buckets"])
    if dre_solver == "matfree":
        assert all(b["fgmres"]["solves"] > 0 for b in info["buckets"])


def test_sweep_inverse_stacks_cached_by_key(sweep, tmp_path):
    """With cache_keys, each bucket's inverse stack is stored under its key
    and a restart loads it: the same gains, bit for bit."""
    t_set = sweep["t"][0]
    kw = dict(GAINS, solver="lu", cache_keys=[f"nu{nu}" for nu in NUS],
              cache_dir=str(tmp_path))
    _, ks = build_sweep_gains_and_caches(t_set, DT, ALPHA, dtype=F64, **kw)
    assert len(list(tmp_path.glob("dreinv_*.npy"))) == len(NUS)
    _, again = build_sweep_gains_and_caches(t_set, DT, ALPHA, dtype=F64,
                                            **kw)
    assert torch.equal(ks, again)
    assert torch.equal(ks, sweep["t"][2])  # the fixture's, uncached


def _ragged(vbars, counts, s_max, pad, seed):
    """v0 with `counts` real rows a bucket and padded rows `pad`, and the
    0/1 mask (the reference test's ragged layout)."""
    rng = np.random.default_rng(seed)
    v0 = np.broadcast_to(vbars[:, None, :],
                         (len(counts), s_max, vbars.shape[1])).copy()
    mask = np.zeros((len(counts), s_max))
    for r, c in enumerate(counts):
        v0[r, :c] += 1e-3 * rng.standard_normal((c, vbars.shape[1]))
        if pad == "nan":
            v0[r, c:] = np.nan
        else:
            v0[r, c:] += 1e3 * rng.standard_normal((s_max - c, vbars.shape[1]))
        mask[r, :c] = 1.0
    return v0, mask


@pytest.mark.parametrize("pad", ["garbage", "nan"])
def test_masked_stats_match_sharded_reference(sweep, pad):
    """The statistics of ragged buckets against the reference's
    sharded_sweep_rollout on one CPU device: padded rows (garbage or NaN)
    count nowhere; NaN rows leave the statistics of real-only padding."""
    _, j_stack, j_ks, j_sys, j_conv = sweep["j"]
    _, t_stack, t_ks, t_sys, conv = sweep["t"]
    counts = [6, 3]
    vbars = sweep["vbars"]
    v0, mask = _ragged(vbars, counts, 8, pad, 3)
    ystar = np.random.default_rng(4).standard_normal((len(NUS), t_sys.p_out))
    mesh = scenario_mesh(jax.devices("cpu")[:1])
    _, ref = j_sharded(mesh, j_sys, j_conv, j_stack, j_ks, jnp.asarray(v0),
                       ALPHA, DT, NTS, ystar=jnp.asarray(ystar),
                       mask=jnp.asarray(mask))
    ys, u_sq, _ = sweep_rollout(t_sys, conv, t_stack, t_ks,
                                torch.as_tensor(v0), ALPHA, DT, NTS)
    got = masked_sweep_stats(ys, u_sq, ALPHA, DT, torch.as_tensor(ystar),
                             torch.as_tensor(mask))
    np.testing.assert_array_equal(got["scenarios"].numpy(),
                                  np.asarray(counts, float))
    for key in ("mean_cost", "max_abs_y", "tracking_err_T"):
        assert np.isfinite(got[key].numpy()).all(), key
        assert _rel(got[key], ref[key]) <= 1e-12, key
    if pad == "nan":
        v0_real = v0.copy()
        for r, c in enumerate(counts):
            v0_real[r, c:] = vbars[r]
        ys, u_sq, _ = sweep_rollout(t_sys, conv, t_stack, t_ks,
                                    torch.as_tensor(v0_real), ALPHA, DT, NTS)
        clean = masked_sweep_stats(ys, u_sq, ALPHA, DT,
                                   torch.as_tensor(ystar),
                                   torch.as_tensor(mask))
        for key in got:
            assert torch.equal(got[key], clean[key]), key


def test_assign_re_buckets_matches_reference():
    buckets = np.array([60.0, 90.0, 120.0, 150.0])
    res = np.array([61.0, 149.0, 100.0, 80.0, 75.0, 135.0, 60.0, 150.0])
    got = assign_re_buckets(res, buckets)
    np.testing.assert_array_equal(got, [0, 3, 1, 1, 0, 2, 0, 3])  # ties low
    np.testing.assert_array_equal(got, j_assign(res, buckets))
    # scripts/sweep_config5.py's draw: 8,192 Re over 8 buckets
    buckets = np.linspace(60.0, 150.0, 8)
    draw = np.random.default_rng(0).uniform(60.0, 150.0, 8192)
    got = assign_re_buckets(draw, buckets)
    np.testing.assert_array_equal(got, j_assign(draw, buckets))
    np.testing.assert_array_equal(
        np.bincount(got, minlength=8),
        [577, 1217, 1158, 1162, 1131, 1194, 1191, 562])


def _splu_inverse(ops, cond, dt, l1_inner):
    """Host f64 inverse of [[M/dt - A_stokes + L1, J^T], [J, 0]]."""
    a_st = sp.csr_matrix(cond.mat_inner(ops["full"]["A"]))
    big = sp.bmat([[ops["M"] / dt - a_st + l1_inner, ops["J"].T],
                   [ops["J"], None]], format="csc")
    return spla.splu(big).solve(np.eye(big.shape[0]))


@pytest.fixture(scope="module")
def chain():
    j_set, t_set = _setups(CHAIN_NUS)
    j_conv = JConvKernel.build(j_set[0][0]["full"], j_set[0][2],
                               dtype=jnp.float64)
    conv = ConvKernel.build(t_set[0][0]["full"], t_set[0][2], device=CPU,
                            dtype=F64)
    ref, ref_res = j_chain(j_set, DT, dtype=jnp.float64, conv=j_conv)
    got = build_sweep_steppers_ns_chain(t_set, DT, conv, dtype=F64)
    return t_set, conv, got, (ref, ref_res)


def test_ns_chain_matches_reference_and_splu(chain):
    t_set, _, (steppers, residuals, info), (ref, ref_res) = chain
    assert len(steppers) == len(CHAIN_NUS)
    assert all(r <= 1e-4 for r in residuals), residuals
    assert info["passes"] == [2, 4, 4] and info["extra_passes"] == [0, 0, 0]
    for r, (ops, _, cond) in enumerate(t_set):
        inv = steppers[r].lu.inv
        assert _rel(inv, ref[r].lu.inv) <= 1e-6
        assert _rel(steppers[r].l1_imp, ref[r].l1_imp) <= 1e-12
        for name in ("fv", "fp", "vbar"):
            assert _rel(getattr(steppers[r], name),
                        getattr(ref[r], name)) <= 1e-12, name
        l1 = nse_rollout._l1_inner(ops, cond, "oseen")
        assert _rel(inv, _splu_inverse(ops, cond, DT, l1)) <= 1e-8


def test_ns_chain_packs_buckets_in_bucket0_ordering(chain):
    """A bucket whose L1 pattern has its own RCM ordering is packed in
    bucket 0's: the previous inverse only seeds it in that ordering (in
    its own, the passes start from a scrambled inverse and the chain
    raises)."""
    t_set, conv, _, _ = chain
    l1_inner = nse_rollout._l1_inner

    def l1_far_coupling(np_ops, cond, scheme):
        """Buckets after the first: L1 with tiny couplings between distant
        dofs."""
        l1 = l1_inner(np_ops, cond, scheme)
        if np_ops is t_set[0][0]:
            return l1
        l1 = sp.lil_matrix(l1)
        n = l1.shape[0]
        for i in range(0, n // 2, 3):
            l1[i, n - 1 - i] = 1e-30
        return l1.tocsr()

    def own_perm(b):
        ops, _, cond = t_set[b]
        a_st = sp.csr_matrix(cond.mat_inner(ops["full"]["A"]))
        at = l1_far_coupling(ops, cond, "oseen") - a_st
        return rcm_permutation(ops["M"], at)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(nse_rollout, "_l1_inner", l1_far_coupling)
        perm0, perm1 = own_perm(0), own_perm(1)
        assert not np.array_equal(perm0, perm1)  # the orderings differ
        steppers, residuals, info = build_sweep_steppers_ns_chain(
            t_set[:2], DT, conv, dtype=F64)
        ops, _, cond = t_set[1]
        want = _splu_inverse(ops, cond, DT, l1_far_coupling(ops, cond,
                                                            "oseen"))
    assert info["extra_passes"] == [0, 0]
    assert _rel(steppers[1].lu.inv, want) <= 1e-8


def test_ns_chain_raises_runtime_error_when_a_bucket_misses(chain):
    """A jump from nu=0.1 to nu=1.0 leaves the passes' basin: the chain
    raises RuntimeError naming the bucket (never a bare assert, which
    python -O strips)."""
    _, conv, _, _ = chain
    _, far = _setups([0.1])
    t_set = chain[0]
    with pytest.raises(RuntimeError, match="bucket 1 did not certify"):
        build_sweep_steppers_ns_chain([far[0], t_set[0]], DT, conv,
                                      dtype=F64)


def test_stack_keeps_none_fields(sweep):
    t_set = sweep["t"][0]
    caches = [build_nse_stepper(ops, cond, DT, device=CPU, dtype=F64)
              for ops, _, cond in t_set]
    stacked = NSEStepCache.stack(caches)
    assert stacked.rhs_half is None
    assert tuple(stacked.l1_imp.shape) == (len(t_set),) + tuple(
        caches[0].l1_imp.shape)
    assert torch.equal(stacked.lu.piv[1], caches[1].lu.piv)
