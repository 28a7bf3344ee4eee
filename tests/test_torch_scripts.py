"""Port the config-3/3XL scripts and the gain certification
(optconpy_tpu_torch/scripts/, riccati/validate.py's reusable projector)
vs the reference's functions, in f64 on the CPU.

  * the Leray projector built once and passed to every
    dre_step_residual call: the same bits as an uncached call, one build,
    and the reference's dre_step_residual (1e-10) at the bench shape
    (cylinder Re=100, refinement 1);
  * config3_cylinder's coarse-mesh interval (projected bottom of the
    coarse mesh, ARPACK top of the fine one) vs the reference's
    spectral_interval_dae / spectral_interval (1e-10), on the cavity at
    nx=4 and nx=12; shift_interval computes it once and loads it after;
  * validate_gains.run at a small shape (the cavity nx=5): the f64 'lu'
    gains vs the reference's sweep (1e-8), each step's residual vs the
    reference's dre_step_residual of the same factors (1e-10), the f32
    gains vs f64 (1e-4), and certify raising above its bound;
  * config3xl_cylinder.run at a small shape (the cavity nx=5, f64, FGMRES
    tol 1e-11): probe relres at or below tol, the gains vs the
    reference's matrix-free DRE sweep (1e-6), the residuals vs the
    reference's (1e-10), the closed loop vs the reference's matrix-free
    rollout from the same gain and v0 (1e-7);
  * each module's main() refuses to run without a card unless asked
    for the CPU.

Each reference result is computed once in a module fixture.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import threadpoolctl
import torch

from optconpy_tpu import native as j_native
from optconpy_tpu.fem.device_conv import ConvKernel as JConv
from optconpy_tpu.models.cavity import cavity_stokes_setup as j_cavity_setup
from optconpy_tpu.models.cylinder import cylinder_setup as j_cylinder_setup
from optconpy_tpu.mpc import batched_nse_closed_loop as j_nse_loop
from optconpy_tpu.mpc import build_nse_stepper_matfree as j_build_matfree
from optconpy_tpu.riccati import build_dre_cache_dae as j_dre_cache
from optconpy_tpu.riccati import build_dre_cache_dae_matfree as j_dre_matfree
from optconpy_tpu.riccati import dre_backward_sweep as j_dre_sweep
from optconpy_tpu.riccati import dre_shift_schedule_dae as j_schedule
from optconpy_tpu.riccati.shifts import spectral_interval as j_interval
from optconpy_tpu.riccati.shifts import spectral_interval_dae as j_interval_dae
from optconpy_tpu.riccati.validate import dre_step_residual as j_residual
from optconpy_tpu.solvers.steady import solve_steady_nse_host as j_steady
from optconpy_tpu_torch.models.cavity import cavity_stokes_setup
from optconpy_tpu_torch.models.cylinder import cylinder_setup
from optconpy_tpu_torch.riccati import validate
from optconpy_tpu_torch.scripts import (
    config3_cylinder,
    config3xl_cylinder,
    validate_gains,
)
from optconpy_tpu_torch.solvers.steady import solve_steady_nse_host

CPU = torch.device("cpu")
F64 = torch.float64
SMALL = dict(nts_gain=2, n_shifts=3, n_adi=6, r_max=8)


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


def _j_cavity(nx):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_native, "available", lambda: False)
        ops, sys, cond = j_cavity_setup(nx=nx)
    ops["vbar_full"], _ = j_steady(ops["full"], cond)
    return ops, sys, cond


def _cavity(nx):
    ops, sys, cond = cavity_stokes_setup(nx=nx, device=CPU)
    ops["vbar_full"], _ = solve_steady_nse_host(ops["full"], cond)
    return ops, sys, cond


@pytest.fixture(scope="module")
def cavity5():
    return _j_cavity(5), _cavity(5)


# ---- the reusable Leray projector at the bench shape ----

@pytest.fixture(scope="module")
def bench_factors():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_native, "available", lambda: False)
        j_ops, _, _ = j_cylinder_setup(re=100.0, refinement=1)
    t_ops, t_sys, _ = cylinder_setup(re=100.0, refinement=1, device=CPU)
    rng = np.random.default_rng(0)
    n, m = t_sys.b.shape
    steps = [(rng.standard_normal((n, 8)), 1e-2 * rng.standard_normal((m, n)),
              rng.standard_normal((n, 8))) for _ in range(3)]
    return j_ops, t_ops, steps


def test_projector_built_once_and_bit_equal(bench_factors, monkeypatch):
    _, t_ops, steps = bench_factors
    uncached = [validate.dre_step_residual(t_ops, *s, 1e-2, 0.005)
                for s in steps]
    builds = []
    build = validate._leray_projector_t

    def counted(*args):
        builds.append(1)
        return build(*args)

    monkeypatch.setattr(validate, "_leray_projector_t", counted)
    pit = validate.leray_projector(t_ops)
    reused = [validate.dre_step_residual(t_ops, *s, 1e-2, 0.005, pit=pit)
              for s in steps]
    assert len(builds) == 1
    assert reused == uncached  # the same bits


def test_projector_residuals_match_reference(bench_factors):
    j_ops, t_ops, steps = bench_factors
    pit = validate.leray_projector(t_ops)
    for s in steps:
        got = validate.dre_step_residual(t_ops, *s, 1e-2, 0.005, pit=pit)
        ref = j_residual(j_ops, *s, 1e-2, 0.005)
        assert got > 0 and abs(got - ref) <= 1e-10 * ref


# ---- the coarse-mesh shift interval ----

def test_coarse_mesh_interval_matches_reference():
    (jc, _, _), (jf, _, _) = _j_cavity(4), _j_cavity(12)
    (tc, _, _), (tf, _, _) = _cavity(4), _cavity(12)
    assert tf["A"].shape[0] > 600  # the fine top takes the ARPACK path
    lo, hi = config3_cylinder.coarse_mesh_interval(tc, tf)
    j_lo, _ = j_interval_dae(jc["A"], jc["M"], jc["J"])
    _, j_hi = j_interval(jf["A"], jf["M"])
    assert 0 < lo < hi
    assert abs(lo - j_lo) <= 1e-10 * j_lo and abs(hi - j_hi) <= 1e-10 * j_hi


def test_shift_interval_computed_once_then_loaded(tmp_path, monkeypatch):
    calls = []
    coarse = _cavity(4)

    def fake_setup(**kw):
        calls.append(kw["refinement"])
        return coarse

    monkeypatch.setattr(config3_cylinder, "cylinder_setup", fake_setup)
    fine = _cavity(6)[0]
    first = config3_cylinder.shift_interval(fine, cache_dir=tmp_path)
    again = config3_cylinder.shift_interval(fine, cache_dir=tmp_path)
    assert calls == [1] and first == again
    assert first == config3_cylinder.coarse_mesh_interval(coarse[0], fine)
    sig, _, _ = config3_cylinder.schedule(first, 8)
    assert len(sig) == 8 and (np.diff(sig) < 0).all()


# ---- validate_gains ----

@pytest.fixture(scope="module")
def gains_run(cavity5):
    (j_ops, j_sys, _), t_setup = cavity5
    arrays = {}
    out = validate_gains.run(CPU, ops=t_setup, problem="cavity_nx5",
                             arrays=arrays, **SMALL)
    sig, sseq, iseq = j_schedule(j_ops["A"], j_ops["M"], j_ops["J"],
                                 validate_gains.DT, num_shifts=3, n_adi=6)
    _, j_ks = j_dre_sweep(j_sys, j_dre_cache(j_sys, validate_gains.DT, sig),
                          validate_gains.ALPHA, validate_gains.DT, 2,
                          jnp.asarray(sseq), jnp.asarray(iseq), n_newton=1,
                          r_max=8)
    return out, arrays, np.asarray(j_ks), j_ops


def test_validate_gains_f64_gains_match_reference(gains_run):
    _, arrays, j_ks, _ = gains_run
    assert _rel(arrays["ks64"], j_ks) <= 1e-8


def test_validate_gains_residuals_match_reference(gains_run):
    out, arrays, _, j_ops = gains_run
    zs, ks = arrays["zs32"].numpy(), arrays["ks32"].numpy()
    ref = [j_residual(j_ops, zs[k], ks[k], zs[k + 1], validate_gains.ALPHA,
                      validate_gains.DT) for k in range(len(ks) - 1)]
    got = arrays["residuals"]
    assert len(got) == len(out["projected_residuals"]) == SMALL["nts_gain"]
    assert np.allclose(got, ref, rtol=1e-10, atol=0)
    assert out["worst_residual"] == max(got)
    assert out["pass"] and out["residual_bound"] == 1e-3


def test_validate_gains_f32_vs_f64(gains_run):
    out, arrays, _, _ = gains_run
    ks32, ks64 = arrays["ks32"], arrays["ks64"]
    dev = float((ks32[0].double() - ks64[0]).abs().max() / ks64[0].abs().max())
    assert out["f32_vs_f64_gain_dev"] == dev and dev <= 1e-4


def test_certify_raises_above_the_bound(gains_run, cavity5):
    _, arrays, _, _ = gains_run
    t_ops = cavity5[1][0]
    zs = torch.zeros_like(arrays["zs64"])  # no factor: residual 1
    with pytest.raises(RuntimeError, match="residual bound"):
        validate_gains.certify(t_ops, zs, arrays["ks64"], log=lambda _: None)


# ---- config3xl_cylinder ----

XL = dict(nts_gain=2, nts_roll=3, n_shifts=3, n_adi=6, r_max=8, s_batch=2,
          block=64, tol=1e-11)


@pytest.fixture(scope="module")
def xl_run(cavity5):
    (j_ops, j_sys, j_cond), t_setup = cavity5
    arrays = {}
    out = config3xl_cylinder.run(CPU, ops=t_setup, problem="cavity_nx5",
                                 dtype=F64, arrays=arrays, **XL)
    dt, alpha = config3xl_cylinder.DT, config3xl_cylinder.ALPHA
    sig, sseq, iseq = j_schedule(j_ops["A"], j_ops["M"], j_ops["J"], dt,
                                 num_shifts=3, n_adi=6)
    mf = dict(block=64, tol=1e-11, kind="ell")
    j_zs, j_ks = j_dre_sweep(
        j_sys, j_dre_matfree(j_sys, dt, sig, dtype=jnp.float64, max_cycles=8,
                             **mf),
        alpha, dt, 2, jnp.asarray(sseq), jnp.asarray(iseq), n_newton=1,
        r_max=8)
    j_stepper = j_build_matfree(j_ops, j_cond, dt, dtype=jnp.float64,
                                max_cycles=10, **mf)
    n, m = j_sys.b.shape
    ks_roll = jnp.broadcast_to(jnp.asarray(arrays["ks"][0].numpy()),
                               (XL["nts_roll"] + 1, m, n))
    j_vs, _, _ = j_nse_loop(
        j_sys, JConv.build(j_ops["full"], j_cond, dtype=jnp.float64),
        j_stepper, ks_roll, jnp.zeros((XL["nts_roll"] + 1, n)),
        jnp.asarray(arrays["vs"][:, 0].numpy()), alpha, dt,
        feedback="implicit")
    return out, arrays, np.asarray(j_zs), np.asarray(j_ks), np.asarray(j_vs), j_ops


def test_xl_probe_and_sweep_records(xl_run):
    out, arrays, _, _, _, _ = xl_run
    assert len(out["fgmres_relres_per_shift"]) == XL["n_shifts"]
    assert max(arrays["relres"]) <= XL["tol"]
    for rec in (out["fgmres_dre_first"], out["fgmres_dre_warm"]):
        assert rec["solves"] > 0 and rec["above_tol"] == 0
    assert out["n_state"] == arrays["ks"].shape[2]
    assert out["finite"] and out["rollout_steps"] == XL["s_batch"] * XL["nts_roll"]


def test_xl_gains_match_reference(xl_run):
    _, arrays, j_zs, j_ks, _, _ = xl_run
    assert np.abs(j_ks).max() > 0
    assert _rel(arrays["ks"], j_ks) <= 1e-6


def test_xl_checks_match_reference(xl_run, cavity5):
    out, arrays, _, _, _, j_ops = xl_run
    zs, ks = arrays["zs"].numpy(), arrays["ks"].numpy()
    dt, alpha = config3xl_cylinder.DT, config3xl_cylinder.ALPHA
    ref = [j_residual(j_ops, zs[k], ks[k], zs[k + 1], alpha, dt)
           for k in (0, XL["nts_gain"] // 2)]
    assert np.allclose(out["projected_residuals"], ref, rtol=1e-10, atol=0)
    jz = np.asarray(j_ops["J"] @ zs[0])
    assert out["feasibility_JZ"] == pytest.approx(
        np.abs(jz).max() / np.abs(zs[0]).max(), rel=1e-8)
    assert out["feasibility_JZ"] < config3xl_cylinder.FEASIBILITY_BOUND


def test_xl_rollout_matches_reference(xl_run):
    _, arrays, _, _, j_vs, _ = xl_run
    vs = arrays["vs"].numpy()
    assert vs.shape == j_vs.shape and np.isfinite(vs).all()
    assert _rel(vs, j_vs) <= 1e-7


# ---- config3_cylinder.run ----

C3 = dict(problem="cavity_nx5", nts_gain=2, nts_roll=3, n_shifts=4,
          ns_shifts=3, n_adi=6, r_max=8, s_batch=2, warm=1, dtype=F64)
C3_KEYS = {  # the reference's CONFIG3 record, less its compile-time rate
    "config", "problem", "n_state", "solver", "feasibility_JZ",
    "energy_ratio_T", "energy_ratio_bound", "worst_dre_residual",
    "residual_bound", "ns_build_s", "ns_shifts", "ns_stack_residuals",
    "adi_iters_per_s_warm_dense_ns", "dre_sweep_warm_dense_ns_s",
    "dense_ns_warm_samples_s", "gain_parity_dense_vs_matfree",
    "adi_iters_per_s_warm_matfree", "cpu_adi_iters_per_s", "cpu_sampling",
    "host_loadavg_1min", "fgmres_tol", "fgmres_tol_derivation",
    "adi_warm_vs_cpu_dense_ns", "adi_warm_vs_cpu_matfree", "dre_sweep_s",
    "dre_sweep_warm_s", "rollout_s", "finite",
}


def test_config3_run_at_small_shape(cavity5, monkeypatch):
    """run() on the cavity: the cavity's feedback cannot halve its
    perturbation energy in 3 steps, so the script's energy check raises;
    with the bound lifted for this stand-in, the record carries the
    reference's keys and its checks hold."""
    t_setup = cavity5[1]
    iv = config3_cylinder.coarse_mesh_interval(_cavity(4)[0], t_setup[0])
    quiet = dict(log=lambda _: None)
    with pytest.raises(RuntimeError, match="energy ratio"):
        config3_cylinder.run(CPU, ops=t_setup, interval=iv, **C3, **quiet)
    monkeypatch.setattr(config3_cylinder, "ENERGY_RATIO_BOUND", 2.0)
    arrays = {}
    out = config3_cylinder.run(CPU, ops=t_setup, interval=iv, arrays=arrays,
                               **C3, **quiet)
    assert C3_KEYS <= set(out)
    assert out["energy_ratio_T"] > 0.5 and out["finite"]
    assert len(arrays["sig"]) == 4 and len(arrays["sig8"]) == 3
    assert out["feasibility_JZ"] < config3_cylinder.FEASIBILITY_BOUND
    assert out["worst_dre_residual"] < config3_cylinder.RESIDUAL_BOUND
    ks, ks_mf = arrays["ks"], arrays["ks_mf"]
    assert out["gain_parity_dense_vs_matfree"] == float(
        (ks[0] - ks_mf[0]).abs().max() / ks_mf[0].abs().max())
    assert out["fgmres_matfree_dre"]["above_tol"] == 0


# ---- the command line ----

@pytest.mark.parametrize(
    "module", [validate_gains, config3_cylinder, config3xl_cylinder],
    ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_main_refuses_without_a_card(module, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        module.main([])
