"""The sweep cell (sweep-re60-150-ref1.sweep-b10240) on the CPU: a whole
run past the harness's look for a card at a tiny size (2 buckets of the
configuration's Re range, 3 scenarios each padded to 4, 10 steps, the
'inverse' steppers and a 2-step DRE: a Newton-Schulz chain of the
refinement-1 wake is minutes of CPU GEMMs), judged by the cell's own
limits; the plain reference (reference/sweep.py) against the program in
float64; what the reference loads; the configuration against the
port's config-5 script; the new readers.

Faults, each planted in the timed path and each not correct while the
sound run is: a real row masked out (its bucket's count differs from the
design's), two buckets' gains swapped, explicit feedback in place of
implicit. A padded row of NaN stays correct: padding never enters a
statistic or the check."""
from __future__ import annotations

import copy
import functools
import json
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import harness
import run as runmod

CPU = torch.device("cpu")
SEED = 2**31 + 4243
CELL = "sweep-re60-150-ref1.sweep-b10240"


def tiny_cell() -> harness.Cell:
    cell = harness.load_cell(CELL)
    cell.config = copy.deepcopy(cell.config)
    cell.traffic = dict(cell.traffic)
    cell.config.update(buckets=2, scenarios=6, pad=4, steps=10)
    cell.config["gains"].update(num_shifts=2, n_adi=4, nts=2, r_max=8,
                                solver="inverse")
    return cell


@functools.cache
def prepared():
    torch.set_num_threads(4)
    cell = tiny_cell()
    driver = harness.load_module("drivers", cell.traffic["driver"])
    return cell, driver, driver.setup(cell, SEED, CPU)


def judged(plant=None):
    cell, driver, state = prepared()
    state = copy.copy(state)
    state.timings = dict(state.timings)
    if plant is not None:
        plant(state)
    out, checks = runmod.measure(cell, driver, state, SEED, 0.2, False, CPU,
                                 setup_s=0.0)
    return out, checks


def nan_padded_row(state):
    """The last row of the bucket with the fewest real scenarios, a padded
    one, set to NaN before every sweep."""
    r = int(np.argmin(state.layout.counts))
    assert state.layout.counts[r] < state.layout.s_max
    rollout = state.rollout

    def with_nan(sys, conv, stack, ks, v0, *args):
        v0 = v0.clone()
        v0[r, -1] = float("nan")
        return rollout(sys, conv, stack, ks, v0, *args)

    state.rollout = with_nan


def masked_real_row(state):
    state.mask = state.mask.clone()
    state.mask[0, 0] = 0.0


def swapped_gains(state):
    state.ks = state.ks.flip(0)


def explicit_feedback(state):
    rollout = state.rollout
    state.rollout = lambda *args: rollout(*args, feedback="explicit")


@pytest.mark.parametrize("plant, correct", [
    (None, True), (nan_padded_row, True), (masked_real_row, False),
    (swapped_gains, False), (explicit_feedback, False),
], ids=lambda p: getattr(p, "__name__", str(p)))
def test_fault_is_not_correct(plant, correct):
    out, checks = judged(plant)
    assert out["correct"] is correct, checks
    assert out["failed"] == 0
    if plant is None:
        assert out["attempted"] == out["timings"]["sweeps"] * 6 * 10


def test_a_real_row_of_nan_fails():
    """NaN on a real row is a failed operation, and not correct."""
    def nan_real_row(state):
        rollout = state.rollout

        def with_nan(sys, conv, stack, ks, v0, *args):
            v0 = v0.clone()
            v0[0, 0] = float("nan")
            return rollout(sys, conv, stack, ks, v0, *args)

        state.rollout = with_nan

    out, checks = judged(nan_real_row)
    assert out["failed"] > 0 and out["correct"] is False
    assert checks["y"]["value"] == float("inf")


@pytest.fixture(scope="module")
def f64_pair():
    """One bucket (Re 90) in float64: the program's 'inverse' stepper,
    convection and sweep rollout, and the reference's bucket problem,
    with one seeded random gain and perturbations."""
    from optconpy_tpu_torch.fem.device_conv import ConvKernel
    from optconpy_tpu_torch.models.cylinder import cylinder_setup
    from optconpy_tpu_torch.mpc.nse_rollout import (
        NSEStepCache,
        build_nse_stepper,
    )
    from optconpy_tpu_torch.parallel import masked_sweep_stats, sweep_rollout
    from reference import plain
    from reference import sweep as ref

    torch.set_num_threads(4)
    f64, dt, alpha, nts, re = torch.float64, 0.005, 1e-2, 10, 90.0
    np_ops, sys, cond = cylinder_setup(re=re, refinement=1, device=CPU,
                                       dtype=f64)
    stack = NSEStepCache.stack([build_nse_stepper(
        np_ops, cond, dt, device=CPU, dtype=f64, solver="inverse")])
    conv = ConvKernel.build(np_ops["full"], cond, device=CPU, dtype=f64)
    gen = torch.Generator().manual_seed(2024)
    n, m = sys.b.shape
    k = 0.05 * torch.randn((m, n), generator=gen, dtype=f64)
    vbar = stack.vbar[0]
    v0 = vbar + 1e-3 * torch.randn((3, n), generator=gen, dtype=f64)
    ys, u_sq, _ = sweep_rollout(sys, conv, stack, k[None], v0[None], alpha,
                                dt, nts)
    ystar = (sys.c @ vbar)[None]
    stats = masked_sweep_stats(ys, u_sq, alpha, dt, ystar,
                               torch.ones((1, 3), dtype=f64))
    prob = plain.Problem(re, 1, CPU)
    ys_ref, u_ref = ref.ImplicitLoop(prob, dt, k).run(v0, nts)
    st_ref = ref.statistics(ys_ref, u_ref, prob.c @ prob.vbar, alpha, dt)
    return (ys[0], u_sq[0], stats), (ys_ref, u_ref, st_ref)


def test_reference_loop_matches_the_program_in_f64(f64_pair):
    (ys, u_sq, stats), (ys_ref, u_ref, st_ref) = f64_pair
    from reference import plain

    assert ys.shape == ys_ref.shape == (3, 11, 2)
    assert u_sq.shape == u_ref.shape == (3, 10)
    assert float(u_ref.min()) > 0  # the feedback acts
    assert plain.rel_dev(ys, ys_ref) < 1e-9
    assert plain.rel_dev(u_sq, u_ref) < 1e-9
    for key in ("mean_cost", "tracking_err_T", "max_abs_y"):
        assert plain.rel_dev(stats[key], st_ref[key][None]) < 1e-9, key
    assert int(stats["scenarios"][0]) == st_ref["scenarios"] == 3


def test_reference_design_is_the_programs_layout():
    from optconpy_tpu_torch.parallel import assign_re_buckets, sweep_layout
    from reference import sweep as ref

    cfg = harness.load_cell(CELL).config
    re_buckets, counts = ref.design(*cfg["re_range"], cfg["buckets"],
                                    cfg["scenarios"], cfg["re_seed"])
    np.testing.assert_array_equal(counts, [577, 1217, 1158, 1162, 1131,
                                           1194, 1191, 562])
    draw = np.random.default_rng(cfg["re_seed"]).uniform(
        *cfg["re_range"], cfg["scenarios"])
    lay = sweep_layout(assign_re_buckets(draw, re_buckets), cfg["buckets"],
                       cfg["pad"])
    np.testing.assert_array_equal(lay.counts, counts)
    assert lay.counts.size * lay.s_max == 10240


def test_configuration_is_the_port_script_s():
    """The configuration's sizes are those of the port's config-5 script
    (optconpy_tpu_torch/scripts/sweep_config5.py), which mirrors the
    source's."""
    from optconpy_tpu_torch.scripts import sweep_config5 as s5

    cfg = harness.load_cell(CELL).config
    assert tuple(cfg["re_range"]) == s5.RE_RANGE
    assert (cfg["buckets"], cfg["scenarios"], cfg["pad"], cfg["refinement"],
            cfg["dt"], cfg["steps"], cfg["alpha"], cfg["re_seed"]) == (
        s5.R_BUCKETS, s5.S_TOTAL, s5.PAD, s5.REFINEMENT, s5.DT, s5.NTS,
        s5.ALPHA, s5.SEED)
    assert harness.load_cell(CELL).traffic["noise"] == s5.PERTURBATION
    g = cfg["gains"]
    assert g["nts"] == s5.NTS_GAIN and g["n_newton"] == 1
    assert {k: g[k] for k in s5.GAINS} == s5.GAINS
    assert cfg["reduced"] == [] and cfg["feedback"] == "implicit"


REFERENCE = """
import json, sys
sys.path[:0] = {paths!r}
import torch
from reference import plain, sweep
re_buckets, counts = sweep.design(60.0, 150.0, 8, 64, 0)
prob = plain.Problem(float(re_buckets[0]), 1, torch.device("cpu"))
k = torch.zeros((prob.b.shape[1], prob.n), dtype=torch.float64)
ys, u_sq = sweep.ImplicitLoop(prob, 0.005, k).run(prob.vbar[None], 1)
assert bool(torch.isfinite(ys).all()) and float(u_sq.abs().max()) == 0.0
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_the_sweep_reference_loads_nothing_of_the_program():
    paths = [str(harness.HERE), str(harness.HERE / "drivers")]
    proc = subprocess.run(
        [sys.executable, "-c", REFERENCE.format(paths=paths)],
        capture_output=True, text=True, timeout=600, cwd=harness.ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    tops = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert "reference" in tops
    assert not {"optconpy_tpu_torch", "optconpy_tpu", "jax", "jaxlib",
                "flax"} & tops


def _ctx(**kw):
    cell = harness.load_cell(CELL)
    trace = harness.Trace(**kw)
    return SimpleNamespace(trace=trace, setup={"sweep_gains_s": 41.5},
                           cell=cell)


def test_padded_share_reads_the_layout_counters(monkeypatch):
    from optconpy_tpu_torch.parallel import param_sweep

    reader = harness.load_module("metrics", "sweep.padded_share.sweep")
    monkeypatch.setattr(param_sweep, "layout_real_columns", 8192)
    monkeypatch.setattr(param_sweep, "layout_padded_columns", 2048)
    assert reader.read(_ctx()) == pytest.approx(20.0, abs=1e-12)
    # a program without the counters (the parent of this cell): no value
    monkeypatch.delattr(param_sweep, "layout_padded_columns")
    assert reader.read(_ctx()) is None


def test_k1_roofline_share_at_the_sweep_width():
    import roofline

    reader = harness.load_module("metrics", "k1_conv.roofline_share.sweep")
    cfg = harness.load_cell(CELL).config
    least, bound = roofline.bound_s(*roofline.k1_work(4396, 1155, 10240))
    assert bound == "operations"
    # 200 calls of 0.572 ms each
    kernels = [("conv_p2_kernel", 1000.0 * i, 1000.0 * i + 572.0)
               for i in range(200)]
    got = reader.read(_ctx(kernels=kernels, units={"columns": 10240},
                           counters={"k1_launches": 200}))
    assert (cfg["n"], cfg["nt"]) == (4396, 1155)
    assert got == pytest.approx(100.0 * least / 572e-6)
    assert reader.read(_ctx(kernels=kernels, units={},
                            counters={"k1_launches": 200})) is None


def test_gemm_share_idle_and_gains_seconds():
    ctx = _ctx(window_s=4.0, busy_s=3.9,
               kernels=[("sm90_xmma_gemm_f32f32", 0.0, 3.5e6),
                        ("conv_p2_kernel", 3.5e6, 3.9e6)])
    gemm = harness.load_module("metrics", "sweep_step.gemm_share.sweep")
    idle = harness.load_module("metrics", "device_idle.sweep")
    gains = harness.load_module("metrics", "setup.sweep_gains_s")
    assert gemm.read(ctx) == pytest.approx(100.0 * 3.5 / 3.9)
    assert idle.read(ctx) == pytest.approx(2.5)
    assert gains.read(ctx) == 41.5
