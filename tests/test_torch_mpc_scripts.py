"""Port the config-4 and config-5 scripts (scripts/bench_receding.py and
scripts/sweep_config5.py) vs the reference's functions, in f64 on the
CPU where the kernels take their plain versions. Neither reference
script's main() runs here: both write the reference's records.

  * bench_receding.run on the cavity (nx=4, 4 scenarios, 3 macros, no
    warm-up) with the script's three RHConfigs (full rebuild, refreshed
    matfree, dense_ns): each variant's ks vs the reference's
    receding_horizon_mpc with the same configs on the same inputs (1e-6;
    vs 1e-8; the reference packs with kind="ell": its windowed Pallas
    SpMM accumulates in f32), the gain deviations vs those recomputed
    from the reference's ks (within twice the ks bound), the record's
    keys against RECEDING_r05.json's (but its device-idle estimate);
  * sweep_config5.run on the cavity buckets nu 1.0 and 0.5 (nx=5; 12
    drawn scenarios padded to 8, 6 steps, 2 DRE steps): its statistics
    vs the reference's build_sweep_gains_and_caches and
    sharded_sweep_rollout on a one-device CPU mesh with the same
    draw (gains 1e-6; counts exact; statistics within 10x the larger
    Newton-Schulz chain residual of the two packages, about 6e-6 after
    the jump nu 1.0 -> 0.5), the record's keys against SWEEP_r05.json's.

Each reference result is computed once in a module fixture.
"""
import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import threadpoolctl
import torch

import optconpy_tpu.riccati as j_riccati
from optconpy_tpu import native as j_native
from optconpy_tpu.fem.device_conv import ConvKernel as JConvKernel
from optconpy_tpu.models.cavity import cavity_stokes_setup as j_cavity_setup
from optconpy_tpu.mpc import RHConfig as JRHConfig
from optconpy_tpu.mpc import receding_horizon_mpc as j_receding
from optconpy_tpu.parallel import build_sweep_gains_and_caches as j_gains
from optconpy_tpu.parallel import scenario_mesh
from optconpy_tpu.parallel import sharded_sweep_rollout as j_sharded
from optconpy_tpu.solvers.steady import solve_steady_nse_host as j_steady
from optconpy_tpu_torch.models.cavity import cavity_stokes_setup
from optconpy_tpu_torch.scripts import bench_receding, sweep_config5
from optconpy_tpu_torch.solvers.steady import solve_steady_nse_host

CPU = torch.device("cpu")
F64 = torch.float64
ROOT = Path(__file__).resolve().parents[1]
RH_MACROS, RH_S = 3, 4
SW_NUS = [1.0, 0.5]
SW_SHAPE = dict(buckets=2, s_total=12, pad=8, nts=6, nts_gain=2)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _quiet(_msg):
    pass


@pytest.fixture(scope="module", autouse=True)
def _one_host_thread():
    """One torch and one BLAS thread for the module: host BLAS/LAPACK
    work runs many times slower when busy-waiting BLAS threads share
    the cores with other test workers."""
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(1):
        yield


def _cavity(nx, nu=1.0):
    """Both packages' cavity about its steady flow (the reference on its
    numpy element path, the port's only one)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_native, "available", lambda: False)
        j_ops, j_sys, j_cond = j_cavity_setup(nx=nx, nu=nu)
    j_ops["vbar_full"], _ = j_steady(j_ops["full"], j_cond)
    t_ops, t_sys, t_cond = cavity_stokes_setup(nx=nx, nu=nu, device=CPU)
    t_ops["vbar_full"], _ = solve_steady_nse_host(t_ops["full"], t_cond)
    return (j_ops, j_sys.astype(jnp.float64), j_cond), (t_ops, t_sys, t_cond)


# Keys of the reference's records the port leaves out on purpose: the
# device's idle time is the device trace's to give (utils.profiling.trace
# and the spans it records), not an estimate from host stage clocks.
RECORD_DROPPED = {"steady_device_idle_frac"}


def _record_keys(name):
    with open(ROOT / name) as fh:
        return set(json.load(fh))


@pytest.fixture(scope="module")
def receding():
    """bench_receding.run on the cavity, and the reference's macro loop
    with the same three configs on the same schedule and batch."""
    (j_ops, j_sys, j_cond), t_setup = _cavity(4)
    arrays = {}
    out = bench_receding.run(CPU, ops=t_setup, problem="cavity_nx4",
                             n_macro=RH_MACROS, warmup=0, s_batch=RH_S,
                             dtype=F64, log=_quiet, arrays=arrays)
    j_conv = JConvKernel.build(j_ops["full"], j_cond, dtype=jnp.float64)
    ref = {}
    for name, kw in bench_receding.VARIANTS.items():
        cfg = JRHConfig(**bench_receding.RH, **kw, kind="ell")
        ref[name] = j_receding(
            j_sys, j_conv, j_ops, j_cond, cfg, *arrays["sched"],
            jnp.asarray(arrays["v0"]), n_macro=RH_MACROS)
    return out, arrays, ref


@pytest.mark.parametrize("variant", list(bench_receding.VARIANTS))
def test_bench_receding_variant_matches_reference(receding, variant):
    out, arrays, ref = receding
    got = arrays[variant]
    assert got["ks"].shape == tuple(ref[variant]["ks"].shape)
    assert _rel(got["ks"], np.asarray(ref[variant]["ks"])) < 1e-6
    assert _rel(got["vs"], np.asarray(ref[variant]["vs"])) < 1e-8
    rec = {"full": out["full_rebuild_variant"],
           "fast": out["matfree_refresh_variant"], "dense_ns": out}[variant]
    assert 0.0 < rec["perturbation_decay"] < 1.0
    assert len(rec["timings"]) == len(rec["macros"]) == RH_MACROS
    assert rec["warmup_macros"] == 0


def test_bench_receding_record_and_gain_deviations(receding):
    """The record has every key of the reference's RECEDING_r05.json but
    RECORD_DROPPED, and its gain deviations are the reference's
    recomputed from its ks."""
    out, _, ref = receding
    with open(ROOT / "RECEDING_r05.json") as fh:
        record = json.load(fh)
    assert set(record) - RECORD_DROPPED <= set(out)
    assert not RECORD_DROPPED & set(out)
    for key in ("matfree_refresh_variant", "full_rebuild_variant"):
        assert set(record[key]) - RECORD_DROPPED <= set(out[key]), key
        assert not RECORD_DROPPED & set(out[key]), key
    ks = {k: np.asarray(v["ks"]) for k, v in ref.items()}
    for fast, key in (("fast", "gain_rel_dev_fast_vs_full"),
                      ("dense_ns", "gain_rel_dev_dense_ns_vs_full")):
        dev = np.abs(ks[fast] - ks["full"]).max() / np.abs(ks["full"]).max()
        assert abs(out[key] - dev) <= 2e-6, (key, out[key], dev)
    assert out["speedup_vs_full_rebuild"] == (
        out["full_rebuild_variant"]["s_per_macro_step"]
        / out["s_per_macro_step"])
    assert (out["scenarios"], out["n_macro"]) == (RH_S, RH_MACROS)
    json.dumps(out)  # what main() prints


def test_bench_receding_refuses_too_few_macros():
    with pytest.raises(ValueError, match="n_macro"):
        bench_receding.run(CPU, ops=(None, None, None), n_macro=2)


@pytest.fixture(scope="module")
def sweep():
    """sweep_config5.run on two cavity buckets, and the reference's gains
    and sharded sweep on its draw (the reference's matrix-free DRE packs
    with kind="ell")."""
    j_set, t_set = zip(*(_cavity(5, nu) for nu in SW_NUS))
    arrays = {}
    out = sweep_config5.run(CPU, setups=list(t_set), problem="cavity_nx5",
                            dtype=F64, log=_quiet, arrays=arrays, **SW_SHAPE)
    j_conv = JConvKernel.build(j_set[0][0]["full"], j_set[0][2],
                               dtype=jnp.float64)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_riccati, "build_dre_cache_dae_matfree", functools.partial(
            j_riccati.build_dre_cache_dae_matfree, kind="ell"))
        j_info = {}
        j_stack, j_ks = j_gains(list(j_set), sweep_config5.DT,
                                sweep_config5.ALPHA, dtype=jnp.float64,
                                nts_gain=SW_SHAPE["nts_gain"], conv=j_conv,
                                info=j_info, **sweep_config5.GAINS)
    mesh = scenario_mesh(jax.devices("cpu")[:1])
    _, ref = j_sharded(
        mesh, j_set[0][1].astype(jnp.float64), j_conv, j_stack, j_ks,
        jnp.asarray(arrays["v0"].numpy()), sweep_config5.ALPHA,
        sweep_config5.DT, SW_SHAPE["nts"],
        ystar=jnp.asarray(arrays["ystar"].numpy()),
        mask=jnp.asarray(arrays["mask"].numpy()))
    return out, arrays, ref, np.asarray(j_ks), j_info["ns_residuals"]


def test_sweep_config5_stats_match_reference(sweep):
    """Gains 1e-6 (the matrix-free DRE at the FGMRES tolerance); counts
    exact; statistics within 10x the larger Newton-Schulz chain residual
    of the two packages: each stepper inverse is only as exact as its
    chain's certification (the reference's bucket 1 after the nu jump
    1.0 -> 0.5 about 5e-6, the port's about 6e-6), and the outputs of the
    two chains differ by about a third of that."""
    out, arrays, ref, j_ks, j_res = sweep
    assert _rel(arrays["ks"], j_ks) < 1e-6
    np.testing.assert_array_equal(arrays["stats"]["scenarios"].numpy(),
                                  np.asarray(ref["scenarios"]))
    np.testing.assert_array_equal(out["scenarios_per_bucket"],
                                  arrays["counts"])
    assert sum(out["scenarios_per_bucket"]) == SW_SHAPE["s_total"]
    chain_res = max(out["ns_chain_residuals"] + [float(r) for r in j_res])
    assert chain_res <= 1e-4  # both chains certified
    for key in ("mean_cost", "max_abs_y", "tracking_err_T"):
        assert np.isfinite(arrays["stats"][key].numpy()).all(), key
        assert _rel(arrays["stats"][key], np.asarray(ref[key])) <= (
            10 * chain_res), key
    np.testing.assert_allclose(out["tracking_cost_per_bucket"],
                               arrays["stats"]["mean_cost"].numpy(), rtol=0)


def test_sweep_config5_record(sweep):
    out = sweep[0]
    assert _record_keys("SWEEP_r05.json") <= set(out)
    assert out["s_max_padded"] % SW_SHAPE["pad"] == 0
    assert out["live_device_array_gib"] is None  # no card
    assert out["device"] == "cpu" and out["finite"]
    assert len(out["ns_chain_residuals"]) == len(SW_NUS)
    json.dumps(out)  # what main() prints


def test_sweep_config5_refuses_a_bucket_count_mismatch():
    with pytest.raises(ValueError, match="setups"):
        sweep_config5.run(CPU, setups=[None], buckets=2, s_total=4, pad=2)


@pytest.mark.parametrize("script", [bench_receding, sweep_config5])
def test_main_refuses_without_a_card_and_writes_nothing(script, tmp_path,
                                                        monkeypatch):
    """python -m ... runs on the card unless --device says otherwise; no
    file appears without --out."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        script.main([])
    assert not list(tmp_path.iterdir())
