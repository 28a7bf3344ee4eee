"""Port driver (optconpy_tpu_torch.optcont.optcon_nse) vs the reference.

Both packages run the reference driver tests' configs end to end on the
CPU: the driven cavity CFG of tests/test_optcont_driver.py (config 2,
Stokes-linearized gains, 'inverse' DRE tier, 'lu' step tier, implicit
feedback) and HEAT_CFG of tests/test_round2_fixes.py (config 1, the LTI
path), both f64: gains, ys, us and cost agree to 1e-8 relative. The
cavity on the 'fused' step tier in f32 agrees to 1e-4. The rest pins the
driver's own behaviour: the config hash, y* families, the uncontrolled
baseline, checkpoint resume under the port's salt, VTK export, artifacts
never shared between the packages, and the refusals (TF32 precision, no
card, an uncertified Newton-Schulz stack). The matrix-free step and DRE
tiers agree with the reference driver on the cavity CFG, cut to 2 steps,
to 1e-7 (f64, FGMRES tolerance 1e-11).
"""
import dataclasses
import json

import numpy as np
import pytest
import threadpoolctl
import torch

from optconpy_tpu import native as j_native
from optconpy_tpu import utils as ju
from optconpy_tpu.optcont import get_ystarvec as j_ystar
from optconpy_tpu.optcont import optcon_nse as j_optcon
from optconpy_tpu.utils.cache import load_arrays as j_load_arrays
from optconpy_tpu.utils.cache import save_arrays as j_save_arrays
from optconpy_tpu_torch import optcont
from optconpy_tpu_torch import utils as tu
from optconpy_tpu_torch.optcont import get_ystarvec, optcon_nse
from optconpy_tpu_torch.utils.cache import code_salt, save_arrays

CPU = torch.device("cpu")


def _configs(u):
    """CFG (tests/test_optcont_driver.py) and HEAT_CFG
    (tests/test_round2_fixes.py) built from one package's utils."""
    cavity = u.OptConConfig(
        problem=u.ProblemConfig(name="drivencavity", nx=6),
        time=u.TimeConfig(t0=0.0, t_end=0.4, nts=20),
        cost=u.CostConfig(alpha=1e-8, ystar="steady_offset", ystar_amp=0.01),
        solver=u.SolverConfig(
            num_shifts=8, n_adi=20, n_newton=2, r_max=30, dtype="float64"
        ),
    )
    heat = u.OptConConfig(
        problem=u.ProblemConfig(name="heat1d", n_dof=64),
        time=u.TimeConfig(t0=0.0, t_end=1.0, nts=50),
        cost=u.CostConfig(alpha=1e-2, ystar="zero"),
        solver=u.SolverConfig(
            num_shifts=8, n_adi=20, n_newton=3, r_max=30, dtype="float64",
            feedback="explicit",
        ),
    )
    return {"cavity": cavity, "heat": heat}


J_CFGS, T_CFGS = _configs(ju), _configs(tu)


def _solver(cfg, **kw):
    return dataclasses.replace(cfg, solver=dataclasses.replace(cfg.solver, **kw))


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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each package's driver on each config, one cache directory each."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        # the reference's numpy element path, the port's only one
        mp.setattr(j_native, "available", lambda: False)
        for name in J_CFGS:
            j_dir = tmp_path_factory.mktemp(f"ref_{name}")
            t_dir = tmp_path_factory.mktemp(f"port_{name}")
            out[name] = (
                j_optcon(J_CFGS[name], cache_dir=str(j_dir)),
                optcon_nse(T_CFGS[name], cache_dir=str(t_dir), device=CPU),
                t_dir,
            )
    return out


# --- config and target ------------------------------------------------------

@pytest.mark.parametrize("name", ["cavity", "heat", "default"])
def test_config_hash_matches_reference(name):
    j_cfg = J_CFGS.get(name, ju.OptConConfig())
    t_cfg = T_CFGS.get(name, tu.OptConConfig())
    assert t_cfg.to_json() == j_cfg.to_json()
    assert t_cfg.hash() == j_cfg.hash()
    assert tu.config_from_json(t_cfg.to_json()) == t_cfg
    # any field change changes the hash (cache-key safety)
    d = json.loads(t_cfg.to_json())
    d["cost"]["alpha"] *= 2
    assert tu.config_from_json(json.dumps(d)).hash() != t_cfg.hash()
    assert _solver(t_cfg, n_adi=t_cfg.solver.n_adi + 1).hash() != t_cfg.hash()


@pytest.mark.parametrize("family", ["zero", "const", "steady_offset", "sin"])
def test_ystar_families_bitwise(family):
    times = np.linspace(0.0, 1.3, 17)
    y_ref = np.array([0.3, -1.7, 2.0])
    j_cost = ju.CostConfig(ystar=family, ystar_amp=0.7, ystar_freq=1.9)
    t_cost = tu.CostConfig(ystar=family, ystar_amp=0.7, ystar_freq=1.9)
    got = get_ystarvec(t_cost, times, 3, y_ref=y_ref)
    assert got.shape == (17, 3)
    assert np.array_equal(got, j_ystar(j_cost, times, 3, y_ref=y_ref))
    with pytest.raises(ValueError, match="ystar"):
        get_ystarvec(tu.CostConfig(ystar="ramp"), times, 3)


# --- parity -----------------------------------------------------------------

@pytest.mark.parametrize("name", ["cavity", "heat"])
def test_driver_matches_reference(runs, name):
    ref, got, _ = runs[name]
    assert isinstance(got.gains, torch.Tensor)
    assert got.gains.device == CPU and got.gains.dtype == torch.float64
    assert got.ys.shape == ref.ys.shape and got.us.shape == ref.us.shape
    assert np.array_equal(got.times, ref.times)
    assert np.array_equal(got.ystar, ref.ystar)
    assert _rel(got.gains, ref.gains) <= 1e-8
    assert _rel(got.ys, ref.ys) <= 1e-8
    assert _rel(got.us, ref.us) <= 1e-8
    assert abs(got.cost - ref.cost) <= 1e-8 * abs(ref.cost)
    stages = [r["event"] for r in got.extras["metrics"]]
    assert stages == ["setup", "operators", "dre_backward_sweep",
                      "feedforward_sweep", "step_build",
                      "closed_loop_rollout", "result"]


def test_fused_float32_cavity_matches_reference(tmp_path):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_native, "available", lambda: False)
        ref = j_optcon(
            _solver(J_CFGS["cavity"], dtype="float32", step_solver="fused"),
            cache_dir=str(tmp_path / "ref"),
        )
    got = optcon_nse(
        _solver(T_CFGS["cavity"], dtype="float32", step_solver="fused"),
        cache_dir=str(tmp_path / "port"), device=CPU,
    )
    assert got.gains.dtype == torch.float32
    assert _rel(got.gains, ref.gains) <= 1e-4
    assert _rel(got.ys, ref.ys) <= 1e-4
    assert _rel(got.us, ref.us) <= 1e-4
    assert abs(got.cost - ref.cost) <= 1e-4 * abs(ref.cost)


@pytest.mark.parametrize("name", ["cavity", "heat"])
def test_uncontrolled_baseline(runs, tmp_path, name):
    ref, got, _ = runs[name]
    base = optcon_nse(T_CFGS[name], cache_dir=str(tmp_path), device=CPU,
                      controlled=False)
    assert not base.us.any() and not base.gains.any()
    assert got.cost < base.cost
    assert not list(tmp_path.glob("*__gains.npz"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_native, "available", lambda: False)
        j_base = j_optcon(J_CFGS[name], cache_dir=str(tmp_path / "ref"),
                          controlled=False)
    assert _rel(base.ys, j_base.ys) <= 1e-8


# --- checkpoints and export ------------------------------------------------

def test_checkpoint_resume_loads_gains(runs):
    _, first, cache = runs["cavity"]
    key = first.extras["cache_key"]
    gains_files = list(cache.glob(f"{key}-*__gains.npz"))
    assert [f.name for f in gains_files] == [
        f"{key}-{code_salt()}__gains.npz"
    ]
    assert code_salt().startswith("torch-v")
    # the 'inverse' tier's stack lands in the caller's cache_dir too
    assert list(cache.glob(f"dreinv_*-{code_salt()}.npy"))
    again = optcon_nse(T_CFGS["cavity"], cache_dir=str(cache), device=CPU)
    assert torch.equal(again.gains, first.gains)
    dre = [r["seconds"] for r in again.extras["metrics"]
           if r["event"] == "dre_backward_sweep"]
    assert dre[0] < 1.0  # loaded, no ADI work
    np.testing.assert_array_equal(again.ys, first.ys)


def test_vtk_export(runs, tmp_path):
    _, _, cache = runs["cavity"]
    optcon_nse(T_CFGS["cavity"], cache_dir=str(cache), vtk_dir=str(tmp_path),
               device=CPU)
    vtks = sorted(tmp_path.glob("flow_*.vtk"))
    assert len(vtks) == 21  # stride max(1, 20 // 20) over 21 states
    head = vtks[0].read_text().splitlines()
    assert head[0].startswith("# vtk DataFile")
    assert any("VECTORS velocity" in line for line in head)
    series = json.loads((tmp_path / "flow.vtk.series").read_text())
    assert series["files"][-1] == {"name": "flow_00020.vtk", "time": 0.4}


def test_packages_never_load_each_others_gains(runs, tmp_path):
    """A gains artifact of one package under the shared config hash, in
    one cache_dir, is ignored by the other package."""
    ref, got, _ = runs["cavity"]
    key = got.extras["cache_key"]
    assert ref.extras["cache_key"] == key
    bogus = {"ks": np.zeros_like(ref.gains), "z0": np.zeros((1, 1))}
    j_save_arrays(key, "gains", bogus, cache_dir=str(tmp_path))
    port = optcon_nse(T_CFGS["cavity"], cache_dir=str(tmp_path), device=CPU)
    assert torch.equal(port.gains, got.gains)
    assert len(list(tmp_path.glob(f"{key}-*__gains.npz"))) == 2
    # the reference's loader (behind its load_or_comp) reads its own file
    assert not j_load_arrays(key, "gains", cache_dir=str(tmp_path))["ks"].any()
    other = tmp_path / "other"
    save_arrays(key, "gains", bogus, cache_dir=str(other))
    assert j_load_arrays(key, "gains", cache_dir=str(other)) is None


# --- refusals ---------------------------------------------------------------

def _matfree_cfg(u, tiers):
    """CFG on a matrix-free tier at the reference tests' FGMRES settings
    (1e-11, 12 cycles), over 2 of its 20 steps: each matrix-free DRE step
    is 80 FGMRES solves of 30 Arnoldi steps in each package."""
    cfg = _solver(_configs(u)["cavity"], fgmres_tol=1e-11, fgmres_cycles=12,
                  **tiers)
    return dataclasses.replace(cfg, time=u.TimeConfig(t0=0.0, t_end=0.04,
                                                      nts=2))


@pytest.fixture(scope="module")
def matfree_runs(tmp_path_factory):
    """Both packages' optcon_nse on one matrix-free tier choice, run once
    per distinct config (step_solver='matfree' alone leaves dre_solver
    at its default, 'auto')."""
    done = {}

    def run(tiers):
        t_cfg, j_cfg = _matfree_cfg(tu, tiers), _matfree_cfg(ju, tiers)
        if t_cfg.hash() not in done:
            t_dir = tmp_path_factory.mktemp("port_matfree")
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(j_native, "available", lambda: False)
                ref = j_optcon(j_cfg, cache_dir=str(
                    tmp_path_factory.mktemp("ref_matfree")))
            got = optcon_nse(t_cfg, cache_dir=str(t_dir), device=CPU)
            done[t_cfg.hash()] = ref, got, t_dir
        return done[t_cfg.hash()]

    return run


@pytest.mark.parametrize("tiers", [
    {"step_solver": "matfree"},
    {"dre_solver": "matfree"},
    {"step_solver": "matfree", "dre_solver": "auto"},
])
def test_matfree_tiers_match_reference(matfree_runs, tiers):
    """The matrix-free step and DRE tiers, and 'auto' resolving to the
    matrix-free DRE tier beside the matrix-free step tier, agree with the
    reference driver on the cavity at a tight FGMRES tolerance."""
    ref, got, t_dir = matfree_runs(tiers)
    assert got.ys.shape == ref.ys.shape == (1, 3, 2)
    assert _rel(got.gains, ref.gains) <= 1e-7
    assert _rel(got.ys, ref.ys) <= 1e-7
    assert _rel(got.us, ref.us) <= 1e-7
    assert abs(got.cost - ref.cost) <= 1e-7 * abs(ref.cost)
    # every DRE tier here is matrix-free: no splu inverse stack was built
    assert not list(t_dir.glob("dreinv_*"))


@pytest.mark.parametrize("tiers, stages", [
    ({"step_solver": "matfree"}, {"dre", "rollout"}),
    ({"dre_solver": "matfree"}, {"dre"}),
    ({"step_solver": "matfree", "dre_solver": "auto"}, {"dre", "rollout"}),
])
def test_matfree_tiers_report_fgmres(matfree_runs, tiers, stages):
    """extras["fgmres"] holds the record of each matrix-free stage's
    solves (none above tol at 1e-11, 12 cycles), and the metrics stream
    a "fgmres" record per stage."""
    _, got, _ = matfree_runs(tiers)
    rec = got.extras["fgmres"]
    assert set(rec) == stages
    for stage in stages:
        assert rec[stage]["solves"] > 0
        assert rec[stage]["above_tol"] == 0
        assert 0.0 < rec[stage]["worst_relres"] <= 1e-11
    logged = {r["stage"]: r for r in got.extras["metrics"]
              if r["event"] == "fgmres"}
    assert {k: {f: v[f] for f in rec[k]} for k, v in logged.items()} == rec


def test_matfree_under_solve_warns(tmp_path):
    """One FGMRES cycle at a tolerance below float64's roundoff: every
    solve of a nonzero rhs stops above tol; the driver counts them per
    stage and warns, naming the stage, without raising."""
    cfg = _solver(_matfree_cfg(tu, {"step_solver": "matfree",
                                    "dre_solver": "auto"}),
                  fgmres_tol=1e-17, fgmres_cycles=1)
    with pytest.warns(RuntimeWarning) as caught:
        got = optcon_nse(cfg, cache_dir=str(tmp_path), device=CPU)
    text = " ".join(str(w.message) for w in caught)
    assert "dre stage" in text and "rollout stage" in text
    for rec in got.extras["fgmres"].values():
        assert 0 < rec["above_tol"] <= rec["solves"]
        assert rec["worst_relres"] > rec["tol"]
    assert np.isfinite(got.ys).all()


@pytest.mark.parametrize("field", ["matmul_precision",
                                   "rollout_matmul_precision"])
def test_tf32_precision_raises(tmp_path, field):
    cfg = _solver(T_CFGS["heat"], **{field: "high"})
    with pytest.raises(ValueError, match="'high'"):
        optcon_nse(cfg, cache_dir=str(tmp_path), device=CPU)
    tu.setup(None)
    tu.setup("highest")
    assert torch.backends.cuda.matmul.allow_tf32 is False


def test_default_device_needs_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        optcon_nse(T_CFGS["heat"], cache_dir=str(tmp_path))
    assert not list(tmp_path.iterdir())


def test_uncertified_ns_stack_raises(tmp_path, monkeypatch):
    """An unreachable certify_tol leaves every shift uncertified (the
    build flags and returns); the driver refuses to compute gains."""
    monkeypatch.setattr(optcont, "NS_CERTIFY_TOL", 1e-30)
    cfg = _solver(T_CFGS["cavity"], dre_solver="inverse_ns", num_shifts=2,
                  n_adi=4)
    with pytest.raises(RuntimeError, match="not certified"):
        optcon_nse(cfg, cache_dir=str(tmp_path), device=CPU)
    assert not list(tmp_path.glob("*__gains.npz"))
