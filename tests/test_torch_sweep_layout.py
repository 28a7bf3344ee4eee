"""The config-5 sweep's grid (parallel/param_sweep.py::sweep_layout), its
counters, the sweep rollout's spans, and scripts/sweep_config5.run on
the layout function, in f64 on the CPU (port only: the layout has no
counterpart function in the reference, whose script builds it inline).

  * sweep_layout on the config-5 draw (seed 0, 8 buckets over Re 60-150,
    8,192 scenarios, pad 256): the counts of SWEEP_r05.json, width 1,280,
    every real scenario in its bucket's rows 0..count-1 in draw order,
    the mask the script built inline before the function existed;
    ragged, empty-bucket and unpadded designs; a bucket index outside the
    grid raises ValueError;
  * layout_real_columns and layout_padded_columns grow by the grid's
    real and padded columns on every call;
  * sweep_config5.run on two cavity buckets (nx=5, nu 1.0 and 0.5, 12
    drawn scenarios padded to 8, 6 steps, 2 DRE steps): its initial
    states and mask are, bit for bit, those of the script's former
    inline construction from the same draw;
  * nse_sweep_outputs records one sweep.call a call and one sweep.step a
    time step, each step inside its call, under a host profile, and
    nothing (the shared null context) without one.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import threadpoolctl
import torch
from torch.profiler import ProfilerActivity, profile

from optconpy_tpu_torch.models.cavity import cavity_stokes_setup
from optconpy_tpu_torch.mpc import nse_rollout
from optconpy_tpu_torch.parallel import (
    SweepLayout,
    assign_re_buckets,
    param_sweep,
    sweep_layout,
    sweep_rollout,
)
from optconpy_tpu_torch.scripts import sweep_config5
from optconpy_tpu_torch.solvers.steady import solve_steady_nse_host
from optconpy_tpu_torch.utils import profiling

CPU = torch.device("cpu")
F64 = torch.float64
ROOT = Path(__file__).resolve().parents[1]
SW_NUS = [1.0, 0.5]
SW_SHAPE = dict(buckets=2, s_total=12, pad=8, nts=6, nts_gain=2)


@pytest.fixture(scope="module", autouse=True)
def _one_host_thread():
    """One torch and one BLAS thread for the module (several test
    workers share the cores)."""
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(1):
        yield


def _config5_assignment():
    rb = np.linspace(*sweep_config5.RE_RANGE, sweep_config5.R_BUCKETS)
    rng = np.random.default_rng(sweep_config5.SEED)
    return assign_re_buckets(rng.uniform(*sweep_config5.RE_RANGE,
                                         sweep_config5.S_TOTAL), rb)


def _inline_grid(assignment, buckets, pad):
    """The script's grid as it built it inline: counts, the padded width
    and the mask of rows 0..count-1 of every bucket."""
    counts = np.bincount(assignment, minlength=buckets)
    s_max = int(-(-counts.max() // pad) * pad)
    mask = np.zeros((buckets, s_max))
    for r in range(buckets):
        mask[r, :int(counts[r])] = 1.0
    return counts, s_max, mask


def _assert_rows_in_draw_order(lay: SweepLayout, assignment):
    for r, c in enumerate(lay.counts):
        mine = np.flatnonzero(assignment == r)
        np.testing.assert_array_equal(lay.bucket[mine], r)
        np.testing.assert_array_equal(lay.row[mine], np.arange(c))


def test_layout_of_the_config5_design():
    assignment = _config5_assignment()
    lay = sweep_layout(assignment, sweep_config5.R_BUCKETS, sweep_config5.PAD)
    with open(ROOT / "SWEEP_r05.json") as fh:
        record = json.load(fh)
    np.testing.assert_array_equal(lay.counts, [577, 1217, 1158, 1162, 1131,
                                               1194, 1191, 562])
    np.testing.assert_array_equal(lay.counts, record["scenarios_per_bucket"])
    assert lay.s_max == record["s_max_padded"] == 1280
    counts, s_max, mask = _inline_grid(assignment, sweep_config5.R_BUCKETS,
                                       sweep_config5.PAD)
    np.testing.assert_array_equal(lay.counts, counts)
    assert lay.s_max == s_max
    np.testing.assert_array_equal(lay.mask, mask)
    assert lay.mask.dtype == np.float64
    _assert_rows_in_draw_order(lay, assignment)
    assert lay.mask[lay.bucket, lay.row].all()  # every scenario on a real row
    assert lay.mask.size - lay.mask.sum() == 2048  # 20.0% of 10,240


@pytest.mark.parametrize("assignment, buckets, pad, counts, s_max", [
    ([0, 1, 1, 2, 1, 0], 3, 4, [2, 3, 1], 4),  # ragged
    ([2, 2, 0, 2], 4, 2, [1, 0, 3, 0], 4),  # empty buckets
    ([1, 0, 1, 0, 1], 2, 1, [2, 3], 3),  # no padding beyond the largest
    ([0] * 9, 1, 8, [9], 16),  # one bucket, two pads wide
])
def test_layout_of_small_designs(assignment, buckets, pad, counts, s_max):
    assignment = np.asarray(assignment, np.int32)
    lay = sweep_layout(assignment, buckets, pad)
    np.testing.assert_array_equal(lay.counts, counts)
    assert lay.s_max == s_max and lay.s_max % pad == 0
    assert lay.mask.shape == (buckets, s_max)
    np.testing.assert_array_equal(lay.mask,
                                  _inline_grid(assignment, buckets, pad)[2])
    _assert_rows_in_draw_order(lay, assignment)


def test_layout_refuses_a_bucket_outside_the_grid():
    with pytest.raises(ValueError, match="bucket 3 of 3"):
        sweep_layout(np.asarray([0, 3, 1]), 3, 2)


@pytest.mark.parametrize("assignment, buckets, pad, real, padded", [
    (None, 8, 256, 8192, 2048),  # the config-5 design
    ([0, 1, 1, 2, 1, 0], 3, 4, 6, 6),
    ([1, 0, 1, 0, 1], 2, 1, 5, 1),
])
def test_layout_counters_count_real_and_padded_columns(assignment, buckets,
                                                       pad, real, padded):
    if assignment is None:
        assignment = _config5_assignment()
    r0 = param_sweep.layout_real_columns
    p0 = param_sweep.layout_padded_columns
    for calls in (1, 2):
        sweep_layout(np.asarray(assignment), buckets, pad)
        assert param_sweep.layout_real_columns - r0 == calls * real
        assert param_sweep.layout_padded_columns - p0 == calls * padded


def _quiet(_msg):
    pass


@pytest.fixture(scope="module")
def cavity_sweep():
    """sweep_config5.run on two cavity buckets, with its arrays."""
    setups = []
    for nu in SW_NUS:
        ops, sys, cond = cavity_stokes_setup(nx=5, nu=nu, device=CPU)
        ops["vbar_full"], _ = solve_steady_nse_host(ops["full"], cond)
        setups.append((ops, sys, cond))
    arrays = {}
    out = sweep_config5.run(CPU, setups=setups, problem="cavity_nx5",
                            dtype=F64, log=_quiet, arrays=arrays, **SW_SHAPE)
    return out, arrays


def test_sweep_config5_run_keeps_its_initial_states_and_mask(cavity_sweep):
    """The script's former inline grid and draw, replayed: the same
    initial states and mask, bit for bit, so every output after them is
    the same."""
    out, arrays = cavity_sweep
    rng = np.random.default_rng(sweep_config5.SEED)
    re_buckets = np.linspace(*sweep_config5.RE_RANGE, SW_SHAPE["buckets"])
    assignment = assign_re_buckets(
        rng.uniform(*sweep_config5.RE_RANGE, SW_SHAPE["s_total"]), re_buckets)
    counts, s_max, mask = _inline_grid(assignment, SW_SHAPE["buckets"],
                                       SW_SHAPE["pad"])
    n = arrays["v0"].shape[-1]
    v0 = np.empty((SW_SHAPE["buckets"], s_max, n))
    for r, (ops, _, cond) in enumerate(arrays["setups"]):
        v0[r] = cond.restrict(ops["vbar_full"])[None]
        c = int(counts[r])
        v0[r, :c] += sweep_config5.PERTURBATION * rng.standard_normal((c, n))
    assert torch.equal(arrays["v0"], torch.as_tensor(v0))
    assert torch.equal(arrays["mask"], torch.as_tensor(mask))
    np.testing.assert_array_equal(arrays["counts"], counts)
    assert out["scenarios_per_bucket"] == counts.tolist()
    assert out["s_max_padded"] == s_max
    np.testing.assert_array_equal(arrays["stats"]["scenarios"].numpy(),
                                  counts)
    assert out["finite"]


def _sweep_once(arrays, nts):
    sys = arrays["setups"][0][1]
    return sweep_rollout(sys, arrays["conv"], arrays["cache_stack"],
                         arrays["ks"], arrays["v0"], sweep_config5.ALPHA,
                         sweep_config5.DT, nts)


@pytest.mark.parametrize("calls, nts", [(1, 3), (2, 4)])
def test_sweep_spans_record_a_call_and_each_step(cavity_sweep, calls, nts):
    _, arrays = cavity_sweep
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(calls):
            ys, _, _ = _sweep_once(arrays, nts)
    events = [(e.name(), e.start_ns(), e.end_ns())
              for e in prof.profiler.kineto_results.events()]
    call_ev = [e for e in events if e[0] == "sweep.call"]
    step_ev = [e for e in events if e[0] == "sweep.step"]
    assert ys.shape[2] == nts + 1
    assert len(call_ev) == calls and len(step_ev) == calls * nts
    assert all(any(s <= e[1] and e[2] <= t for _, s, t in call_ev)
               for e in step_ev)


def test_sweep_spans_record_nothing_without_a_profiler(cavity_sweep,
                                                       monkeypatch):
    """Without a profiler every span the sweep opens is the shared null
    context: nothing is recorded."""
    _, arrays = cavity_sweep
    opened = []

    def recording(name):
        ctx = profiling.span(name)
        opened.append((name, ctx))
        return ctx

    monkeypatch.setattr(nse_rollout, "span", recording)
    _sweep_once(arrays, 3)
    assert [n for n, _ in opened] == ["sweep.call"] + ["sweep.step"] * 3
    assert all(ctx is profiling._NULL for _, ctx in opened)
