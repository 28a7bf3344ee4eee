"""Port receding-horizon MPC (mpc/receding.py) and the remainders it
pulls in, vs the reference, in f64 on the CPU where the kernels take
their plain versions.

  * ConvKernel.linearized_dense vs the reference's and the port's host
    convection_matrices (cavity nx=6): 1e-12;
  * dre_backward_sweep(k_init=) vs the reference's: 1e-10; one warm
    Newton step vs three cold ones: < 1e-6 (the reference test's bound);
  * NSShiftStack build and one refresh vs the reference's (cavity nx=4,
    3 shifts; the reference packs with kind="ell"): 1e-8; an operator
    jump that leaves the 2-pass basin, where the reference's refresh
    misses certify_tol and the port's rebuilds and matches a fresh build
    at the new operator to 1e-8;
  * receding_horizon_mpc, each tier vs the reference's: 'lu' (cavity
    nx=6, 4 scenarios, 3 macros) vs, us, ks 1e-8; 'matfree' and
    'dense_ns' (the reference's test_dense_ns_matches_matfree_receding
    setup, nx=4) ks 1e-6 and vs 1e-8, and dense_ns vs matfree in the
    port; the reference's regulation test and frozen-linearization
    gain/cost oracle with its bounds; checkpoint resume (1e-12) and the
    refusal of a foreign config; the preconditioner re-inversion (a
    forced staleness case, and every macro); the full-rebuild variant;
    the profile keys and the per-macro solve records.

Each reference result is computed once in a module fixture.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import threadpoolctl
import torch

from optconpy_tpu import native as j_native
from optconpy_tpu.fem.device_conv import ConvKernel as JConvKernel
from optconpy_tpu.models.cavity import cavity_stokes_setup as j_cavity_setup
from optconpy_tpu.mpc import RHConfig as JRHConfig
from optconpy_tpu.mpc import receding_horizon_mpc as j_receding
from optconpy_tpu.riccati import build_dre_cache_dae as j_build_dre
from optconpy_tpu.riccati import dre_backward_sweep as j_dre_sweep
from optconpy_tpu.solvers.ns_inverse import NSShiftStack as JNSShiftStack
from optconpy_tpu.solvers.steady import solve_steady_nse_host as j_steady
from optconpy_tpu_torch.fem.device_conv import ConvKernel
from optconpy_tpu_torch.fem.taylor_hood import convection_matrices
from optconpy_tpu_torch.models.cavity import cavity_stokes_setup
from optconpy_tpu_torch.mpc import (
    RHConfig,
    batched_nse_closed_loop,
    build_nse_stepper,
    receding_horizon_mpc,
)
from optconpy_tpu_torch.riccati import (
    build_dre_cache_dae,
    dre_backward_sweep,
    dre_shift_schedule_dae,
)
from optconpy_tpu_torch.solvers.ns_inverse import NSShiftStack
from optconpy_tpu_torch.solvers.steady import solve_steady_nse_host
from optconpy_tpu_torch.utils import MetricsLogger

CPU = torch.device("cpu")
F64 = torch.float64

# tests/test_receding_mpc.py: the regulation setup (nx=6) and the
# dense_ns-vs-matfree setup (nx=4).
LU_CFG = dict(horizon=8, apply=4, dt=0.02, alpha=1e-8, r_max=24)
LU_SHIFTS, LU_ADI, LU_S, LU_MACROS = 8, 16, 4, 3
NS_CFG = dict(horizon=3, apply=3, dt=0.02, alpha=1e-6, n_newton=1, r_max=8,
              warm_n_adi=4, fgmres_tol=1e-10, fgmres_cycles=12)
NS_SHIFTS, NS_ADI, NS_S, NS_MACROS = 3, 6, 4, 3


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


def _cavities(nx):
    """Both packages' cavity about its steady NSE flow (the reference on
    its numpy element path, the port's only one)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_native, "available", lambda: False)
        j_ops, j_sys, j_cond = j_cavity_setup(nx=nx)
    j_ops["vbar_full"], _ = j_steady(j_ops["full"], j_cond)
    t_ops, t_sys, t_cond = cavity_stokes_setup(nx=nx, device=CPU)
    t_ops["vbar_full"], _ = solve_steady_nse_host(t_ops["full"], t_cond)
    return (j_ops, j_sys.astype(jnp.float64), j_cond), (t_ops, t_sys, t_cond)


def _v0(t_ops, t_cond, n_s, amp, seed):
    vbar = t_cond.restrict(t_ops["vbar_full"])
    rng = np.random.default_rng(seed)
    return vbar, vbar[None] + amp * rng.standard_normal((n_s, vbar.shape[0]))


@pytest.fixture(scope="module")
def cav6():
    (j_ops, j_sys, j_cond), (t_ops, t_sys, t_cond) = _cavities(6)
    sig, sseq, iseq = dre_shift_schedule_dae(
        t_ops["A"], t_ops["M"], t_ops["J"], LU_CFG["dt"],
        num_shifts=LU_SHIFTS, n_adi=LU_ADI,
    )
    conv = ConvKernel.build(t_ops["full"], t_cond, device=CPU, dtype=F64)
    j_conv = JConvKernel.build(j_ops["full"], j_cond, dtype=jnp.float64)
    return dict(j=(j_ops, j_sys, j_cond, j_conv),
                t=(t_ops, t_sys, t_cond, conv), sched=(sig, sseq, iseq))


@pytest.fixture(scope="module")
def lu_runs(cav6):
    """The reference's regulation run on the 'lu' tier in both packages."""
    j_ops, j_sys, j_cond, j_conv = cav6["j"]
    t_ops, t_sys, t_cond, conv = cav6["t"]
    sig, sseq, iseq = cav6["sched"]
    vbar, v0 = _v0(t_ops, t_cond, LU_S, 1e-2, 0)
    got = receding_horizon_mpc(
        t_sys, conv, t_ops, t_cond, RHConfig(**LU_CFG), sig, sseq, iseq,
        torch.as_tensor(v0), n_macro=LU_MACROS, profile=True,
    )
    ref = j_receding(
        j_sys, j_conv, j_ops, j_cond, JRHConfig(**LU_CFG), sig, sseq, iseq,
        jnp.asarray(v0), n_macro=LU_MACROS,
    )
    return vbar, v0, got, ref


def test_linearized_dense_matches_reference_and_host(cav6):
    """Dense re-linearization == the reference's == host
    convection_matrices (L1, L1 + L2); the slot sums repeat bit for
    bit."""
    j_ops, _, _, j_conv = cav6["j"]
    t_ops, _, _, conv = cav6["t"]
    v_full = t_ops["vbar_full"]
    l1_h, l2_h = convection_matrices(t_ops["full"], v_full)
    for include_l2, host in ((False, l1_h), (True, l1_h + l2_h)):
        got = conv.linearized_dense(torch.as_tensor(v_full),
                                    include_l2=include_l2)
        ref = j_conv.linearized_dense(jnp.asarray(v_full),
                                      include_l2=include_l2)
        assert np.abs(got.numpy() - np.asarray(ref)).max() < 1e-12
        assert np.abs(got.numpy() - host.toarray()).max() < 1e-12
        again = conv.linearized_dense(torch.as_tensor(v_full),
                                      include_l2=include_l2)
        assert torch.equal(got, again)


@pytest.fixture(scope="module")
def warm_sweeps(cav6):
    """tests/test_receding_mpc.py:68-90: a 3-Newton cold sweep, then one
    Newton step warm-started from its gain, in both packages."""
    j_ops, j_sys, _, _ = cav6["j"]
    _, t_sys, _, _ = cav6["t"]
    sig, sseq, iseq = cav6["sched"]
    dt, alpha, nts = LU_CFG["dt"], LU_CFG["alpha"], 8
    cache = build_dre_cache_dae(t_sys, dt, sig)
    _, ks_cold = dre_backward_sweep(t_sys, cache, alpha, dt, nts, sseq, iseq,
                                    n_newton=3, r_max=24)
    _, ks_warm = dre_backward_sweep(t_sys, cache, alpha, dt, nts, sseq, iseq,
                                    n_newton=1, r_max=24, k_init=ks_cold[0])
    j_cache = j_build_dre(j_sys, dt, sig)
    _, j_warm = j_dre_sweep(
        j_sys, j_cache, alpha, dt, nts, jnp.asarray(sseq), jnp.asarray(iseq),
        n_newton=1, r_max=24, k_init=jnp.asarray(ks_cold[0].numpy()),
    )
    return ks_cold, ks_warm, j_warm


def test_dre_k_init_matches_reference(warm_sweeps):
    ks_cold, ks_warm, j_warm = warm_sweeps
    assert _rel(ks_warm, np.asarray(j_warm)) < 1e-10
    # the terminal entry is k_init itself
    assert torch.equal(ks_warm[-1], ks_cold[0])


def test_warm_start_reduces_newton_need(warm_sweeps):
    """A 1-Newton sweep warm-started from the 3-Newton gain reaches the
    same gain (the reference measured 2.9e-9; bound 1e-6)."""
    ks_cold, ks_warm, _ = warm_sweeps
    k_ref, k_warm = ks_cold[0].numpy(), ks_warm[0].numpy()
    assert np.linalg.norm(k_warm - k_ref) / np.linalg.norm(k_ref) < 1e-6


def test_lu_tier_matches_reference(lu_runs):
    _, _, got, ref = lu_runs
    for key in ("vs", "us", "ks"):
        assert got[key].shape == tuple(ref[key].shape), key
        assert _rel(got[key], np.asarray(ref[key])) < 1e-8, key


def test_receding_horizon_regulates(cav6, lu_runs):
    """The MPC loop drives the perturbed scenarios toward the steady
    state faster than the same loop with no Newton step (zero gains);
    everything finite (tests/test_receding_mpc.py:49)."""
    t_ops, t_sys, t_cond, conv = cav6["t"]
    sig, sseq, iseq = cav6["sched"]
    vbar, v0, got, _ = lu_runs
    vs = got["vs"].numpy()
    assert np.isfinite(vs).all()
    assert vs.shape[1] == LU_MACROS * LU_CFG["apply"] + 1
    d0 = np.linalg.norm(vs[:, 0] - vbar[None], axis=1).mean()
    d_t = np.linalg.norm(vs[:, -1] - vbar[None], axis=1).mean()
    open_loop = receding_horizon_mpc(
        t_sys, conv, t_ops, t_cond, RHConfig(**LU_CFG, n_newton=0), sig,
        sseq, iseq, torch.as_tensor(v0), n_macro=LU_MACROS,
    )["vs"].numpy()
    d_t0 = np.linalg.norm(open_loop[:, -1] - vbar[None], axis=1).mean()
    assert d_t < d_t0
    assert d_t < d0


def test_receding_gains_and_cost_quantitative(cav6):
    """tests/test_receding_mpc.py:123: with a frozen linearization every
    macro gain is within 5e-3 of the quasi-steady full-horizon DRE gain,
    and the receding cost within 1% of the full-horizon LQR rollout's."""
    t_ops, t_sys, t_cond, conv = cav6["t"]
    sig, sseq, iseq = cav6["sched"]
    dt, alpha, apply, n_macro = LU_CFG["dt"], LU_CFG["alpha"], 4, 3
    vbar, v0 = _v0(t_ops, t_cond, LU_S, 1e-2, 0)
    out = receding_horizon_mpc(
        t_sys, conv, t_ops, t_cond,
        RHConfig(**LU_CFG, n_newton=1, relinearize=False), sig, sseq, iseq,
        torch.as_tensor(v0), n_macro=n_macro,
    )
    cache = build_dre_cache_dae(t_sys, dt, sig)
    _, ks_q = dre_backward_sweep(t_sys, cache, alpha, dt, 40, sseq, iseq,
                                 n_newton=3, r_max=24)
    kq = ks_q[0].numpy()
    for i, k_rh in enumerate(out["ks"].numpy()):
        rel = np.linalg.norm(k_rh - kq) / np.linalg.norm(kq)
        assert rel < 5e-3, (i, rel)
    nts = n_macro * apply
    _, ks_full = dre_backward_sweep(t_sys, cache, alpha, dt, nts, sseq, iseq,
                                    n_newton=3, r_max=24)
    stepper = build_nse_stepper(t_ops, t_cond, dt, device=CPU, dtype=F64)
    vs_opt, us_opt, _ = batched_nse_closed_loop(
        t_sys, conv, stepper, ks_full, torch.zeros((nts + 1, t_sys.n),
                                                   dtype=F64),
        torch.as_tensor(v0), alpha, dt, feedback="implicit",
    )

    def cost(vs, us):
        d = vs - torch.as_tensor(vbar)[None, None]
        md = t_sys.mass.matmat(d.reshape(-1, t_sys.n).T).T.reshape(d.shape)
        mdm = (d * md).sum(dim=(1, 2)).numpy()
        return float(mdm.mean() * dt
                     + alpha * (us.numpy() ** 2).sum(axis=(1, 2)).mean() * dt)

    j_rh, j_opt = cost(out["vs"], out["us"]), cost(vs_opt, us_opt)
    assert j_rh < 1.01 * j_opt, (j_rh, j_opt)


@pytest.fixture(scope="module")
def cav4():
    (j_ops, j_sys, j_cond), (t_ops, t_sys, t_cond) = _cavities(4)
    sig, sseq, iseq = dre_shift_schedule_dae(
        t_ops["A"], t_ops["M"], t_ops["J"], NS_CFG["dt"],
        num_shifts=NS_SHIFTS, n_adi=NS_ADI,
    )
    conv = ConvKernel.build(t_ops["full"], t_cond, device=CPU, dtype=F64)
    j_conv = JConvKernel.build(j_ops["full"], j_cond, dtype=jnp.float64)
    return dict(j=(j_ops, j_sys, j_cond, j_conv),
                t=(t_ops, t_sys, t_cond, conv), sched=(sig, sseq, iseq))


def _at_about(t_ops, t_cond, v_full, dt):
    """The DRE pencil's Atil^T linearized about v_full (host)."""
    l1, l2 = convection_matrices(t_ops["full"], v_full)
    a = sp.csr_matrix(t_cond.mat_inner(t_ops["full"]["A"] - l1 - l2))
    return (a.T - sp.csr_matrix(t_ops["M"]) / (2.0 * dt)).tocsr()


@pytest.fixture(scope="module")
def ns_stacks(cav4):
    """NSShiftStack about the steady flow, and refreshed about 1.5x it,
    in both packages."""
    t_ops, _, t_cond, _ = cav4["t"]
    sig = cav4["sched"][0]
    m, j = sp.csr_matrix(t_ops["M"]), sp.csr_matrix(t_ops["J"])
    at0 = _at_about(t_ops, t_cond, t_ops["vbar_full"], NS_CFG["dt"])
    at1 = _at_about(t_ops, t_cond, 1.5 * t_ops["vbar_full"], NS_CFG["dt"])
    st = NSShiftStack(at0, m, j, sig, device=CPU, dtype=F64)
    j_st = JNSShiftStack(at0, m, j, sig, dtype=jnp.float64, kind="ell")
    built = (st.vv.clone(), np.asarray(j_st.vv))
    st.refresh(at1)
    j_st.refresh(at1, certify=True)
    return built, st, j_st, (at0, m, j, sig)


def test_ns_shift_stack_matches_reference(ns_stacks):
    (vv0, j_vv0), st, j_st, _ = ns_stacks
    assert _rel(vv0, j_vv0) < 1e-8
    assert _rel(st.vv, np.asarray(j_st.vv)) < 1e-8
    assert _rel(st.cache().inv, np.asarray(j_st.cache().inv)) < 1e-8
    # a small drift: two passes certify, nothing rebuilt
    assert all(st.certified) and st.rebuilds == 0
    assert st.extra_passes == [0] * len(st.sig)
    assert max(st.residuals) <= st.certify_tol


def test_refresh_past_the_basin_rebuilds(cav4, ns_stacks):
    """Re-linearizing about 100x the steady flow leaves the 2-pass basin:
    the reference's refresh reports residuals above its certify_tol (it
    would feed them to the gains); the port's refresh ends certified,
    rebuilds at least one shift from the ladder, at the production
    certify_tol 5e-4 and at 1e-9, where it equals a fresh stack at the
    new operator (certified there means converged)."""
    t_ops, _, t_cond, _ = cav4["t"]
    at0, m, j, sig = ns_stacks[3]
    at_far = _at_about(t_ops, t_cond, 100.0 * t_ops["vbar_full"],
                       NS_CFG["dt"])
    j_st = JNSShiftStack(at0, m, j, sig, dtype=jnp.float64, kind="ell")
    j_st.refresh(at_far, certify=True)
    assert max(j_st.residuals) > 5e-4
    st = NSShiftStack(at0, m, j, sig, device=CPU, dtype=F64)
    assert st.certify_tol == 5e-4
    st.refresh(at_far)
    assert all(st.certified) and max(st.residuals) <= 5e-4
    assert st.rebuilds >= 1
    st = NSShiftStack(at0, m, j, sig, device=CPU, dtype=F64,
                      certify_tol=1e-9)
    st.refresh(at_far)
    assert all(st.certified) and max(st.residuals) <= 1e-9
    assert st.rebuilds >= 1
    fresh = NSShiftStack(at_far, m, j, sig, device=CPU, dtype=F64,
                         certify_tol=1e-9)
    assert _rel(st.vv, fresh.vv) < 1e-8


@pytest.fixture(scope="module")
def ns_runs(cav4):
    """The reference's dense_ns-vs-matfree receding setup in both
    packages (the reference packs with kind="ell")."""
    j_ops, j_sys, j_cond, j_conv = cav4["j"]
    t_ops, t_sys, t_cond, conv = cav4["t"]
    sig, sseq, iseq = cav4["sched"]
    _, v0 = _v0(t_ops, t_cond, NS_S, 1e-3, 0)
    runs = {}
    for solver in ("matfree", "dense_ns"):
        met = MetricsLogger()
        got = receding_horizon_mpc(
            t_sys, conv, t_ops, t_cond, RHConfig(**NS_CFG, solver=solver),
            sig, sseq, iseq, torch.as_tensor(v0), n_macro=NS_MACROS,
            metrics=met,
        )
        ref = j_receding(
            j_sys, j_conv, j_ops, j_cond,
            JRHConfig(**NS_CFG, solver=solver, kind="ell"), sig, sseq, iseq,
            jnp.asarray(v0), n_macro=NS_MACROS,
        )
        runs[solver] = (got, ref, met)
    return runs


@pytest.mark.parametrize("solver", ["matfree", "dense_ns"])
def test_ns_and_matfree_tiers_match_reference(ns_runs, solver):
    got, ref, _ = ns_runs[solver]
    assert np.isfinite(got["vs"].numpy()).all()
    assert _rel(got["ks"], np.asarray(ref["ks"])) < 1e-6
    assert _rel(got["vs"], np.asarray(ref["vs"])) < 1e-8
    assert _rel(got["us"], np.asarray(ref["us"])) < 1e-6


def test_dense_ns_matches_matfree(ns_runs):
    """tests/test_receding_mpc.py:296, within the port."""
    mf, ns = ns_runs["matfree"][0], ns_runs["dense_ns"][0]
    assert _rel(ns["ks"], mf["ks"]) < 1e-6
    assert _rel(ns["vs"], mf["vs"]) < 1e-8


def test_macro_records(ns_runs):
    """Each macro records its solves: the matfree tier the probe and the
    FGMRES records of its DRE sweep and rollout (none above tol here),
    the dense_ns tier its certified refresh; the metrics stream gets
    the same."""
    for solver, (got, _, met) in ns_runs.items():
        recs = got["macros"]
        assert [r["macro"] for r in recs] == list(range(NS_MACROS))
        logged = [r for r in met.records if r["event"] == "mpc_macro_step"]
        assert len(logged) == NS_MACROS
        for rec in recs:
            if solver == "matfree":
                assert rec["fgmres_probe_relres"] <= NS_CFG["fgmres_tol"]
                for stage in ("fgmres_dre", "fgmres_rollout"):
                    assert rec[stage]["solves"] > 0
                    assert rec[stage]["above_tol"] == 0
                    assert rec[stage]["worst_relres"] <= NS_CFG["fgmres_tol"]
            else:
                assert rec["ns_refresh_worst_residual"] <= 5e-4
                assert rec["ns_refresh_rebuilds"] == 0
        assert logged[-1]["max_gain"] == recs[-1]["max_gain"]


@pytest.mark.parametrize("how", ["stale probe", "every macro"])
def test_preconditioner_reinversion(cav4, how):
    """'stale probe': one FGMRES cycle and a tol below float64's
    roundoff, so the probe exceeds relres_refresh_factor * tol and every
    later macro's refresh re-inverts the block-Jacobi preconditioner; the
    records count the solves that stopped above tol. 'every macro':
    precond_refresh_every=1 forces the re-inversion with the probe
    below its threshold."""
    t_ops, t_sys, t_cond, conv = cav4["t"]
    sig, sseq, iseq = cav4["sched"]
    _, v0 = _v0(t_ops, t_cond, 2, 1e-3, 0)
    kw = (dict(fgmres_tol=1e-17, fgmres_cycles=1) if how == "stale probe"
          else dict(precond_refresh_every=1))
    cfg = RHConfig(**dict(NS_CFG, horizon=1, apply=1, **kw),
                   solver="matfree")
    out = receding_horizon_mpc(t_sys, conv, t_ops, t_cond, cfg, sig, sseq,
                               iseq, torch.as_tensor(v0), n_macro=3)
    recs = out["macros"]
    assert [r["precond_refresh"] for r in recs] == [False, True, True]
    stale = [r["fgmres_probe_relres"] > 10 * cfg.fgmres_tol for r in recs]
    above = [r["fgmres_dre"]["above_tol"] > 0 for r in recs]
    assert stale == above == [how == "stale probe"] * 3
    assert np.isfinite(out["vs"].numpy()).all()


def test_full_rebuild_matches_refresh(cav4, ns_runs):
    """refresh_caches=False rebuilds every cache each macro (the
    reference bench's full-rebuild variant): the same controller as the
    refreshed caches, to the FGMRES tolerance."""
    t_ops, t_sys, t_cond, conv = cav4["t"]
    _, v0 = _v0(t_ops, t_cond, NS_S, 1e-3, 0)
    out = receding_horizon_mpc(
        t_sys, conv, t_ops, t_cond,
        RHConfig(**NS_CFG, solver="matfree", refresh_caches=False),
        *cav4["sched"], torch.as_tensor(v0), n_macro=NS_MACROS,
    )
    refreshed = ns_runs["matfree"][0]
    assert not any(r["precond_refresh"] for r in out["macros"])
    assert _rel(out["ks"], refreshed["ks"]) < 1e-6
    assert _rel(out["vs"], refreshed["vs"]) < 1e-8


def test_profile_keys(lu_runs):
    got = lu_runs[2]
    assert len(got["timings"]) == LU_MACROS
    stages = ("rebuild", "dre", "probe", "stepper_join", "rollout")
    for t in got["timings"]:
        launches = t.pop("launches")
        assert t.pop("stepper_refresh_s") == 0.0  # the lu tier has none
        assert set(t) == {f"{s}_s" for s in stages} | {"total_s"}
        assert all(v >= 0 for v in t.values())
        assert t["total_s"] >= t["dre_s"] + t["rollout_s"]
        # the CPU takes the kernels' plain versions: no launch
        assert set(launches) == set(stages)
        assert all(c == {"conv_p2": 0, "spmm_tile": 0}
                   for c in launches.values())


CK_CFG = dict(horizon=6, apply=3, dt=0.02, alpha=1e-6, r_max=24)


def test_receding_checkpoint_resume(cav6, tmp_path):
    """A run stopped after 2 of 3 macro steps resumes from its
    checkpoint and ends where the uninterrupted run does; a completed
    checkpoint resumes with nothing left to do."""
    t_ops, t_sys, t_cond, conv = cav6["t"]
    sig, sseq, iseq = dre_shift_schedule_dae(
        t_ops["A"], t_ops["M"], t_ops["J"], CK_CFG["dt"], num_shifts=6,
        n_adi=12,
    )
    _, v0 = _v0(t_ops, t_cond, 2, 1e-2, 3)
    args = (t_sys, conv, t_ops, t_cond, RHConfig(**CK_CFG), sig, sseq, iseq,
            torch.as_tensor(v0))
    ref = receding_horizon_mpc(*args, n_macro=3)
    ckpt = str(tmp_path / "mpc_state.npz")
    assert receding_horizon_mpc(*args, n_macro=2,
                                checkpoint=ckpt)["resumed_from"] == 0
    resumed = receding_horizon_mpc(*args, n_macro=3, checkpoint=ckpt)
    assert resumed["resumed_from"] == 2
    assert resumed["vs"].shape[1] == CK_CFG["apply"] + 1
    again = receding_horizon_mpc(*args, n_macro=3, checkpoint=ckpt)
    assert again["resumed_from"] == 3
    for out in (resumed, again):
        np.testing.assert_allclose(out["v_final"].numpy(),
                                   ref["v_final"].numpy(), rtol=0, atol=1e-12)
    # a foreign config (another dt) refuses the checkpoint
    args2 = args[:4] + (dataclasses.replace(args[4], dt=0.04),) + args[5:]
    with pytest.raises(ValueError, match="fingerprint"):
        receding_horizon_mpc(*args2, n_macro=3, checkpoint=ckpt)


def test_port_checkpoint_refuses_reference_file(cav6, tmp_path):
    """The fingerprint is salted with the package: the reference's
    checkpoint of the same config is refused."""
    j_ops, j_sys, j_cond, j_conv = cav6["j"]
    t_ops, t_sys, t_cond, conv = cav6["t"]
    sig, sseq, iseq = dre_shift_schedule_dae(
        t_ops["A"], t_ops["M"], t_ops["J"], CK_CFG["dt"], num_shifts=6,
        n_adi=12,
    )
    _, v0 = _v0(t_ops, t_cond, 2, 1e-2, 3)
    ckpt = str(tmp_path / "mpc_state.npz")
    cfg = dict(CK_CFG, horizon=2, apply=1)
    j_receding(j_sys, j_conv, j_ops, j_cond, JRHConfig(**cfg), sig, sseq,
               iseq, jnp.asarray(v0), n_macro=1, checkpoint=ckpt)
    with pytest.raises(ValueError, match="fingerprint"):
        receding_horizon_mpc(t_sys, conv, t_ops, t_cond, RHConfig(**cfg), sig,
                             sseq, iseq, torch.as_tensor(v0), n_macro=2,
                             checkpoint=ckpt)


def test_unknown_solver_raises(cav4):
    t_ops, t_sys, t_cond, conv = cav4["t"]
    with pytest.raises(ValueError, match="solver"):
        receding_horizon_mpc(t_sys, conv, t_ops, t_cond,
                             RHConfig(solver="ns"), *cav4["sched"],
                             torch.zeros((1, t_sys.n), dtype=F64), n_macro=1)

