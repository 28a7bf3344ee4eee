"""The readers of the program's spans and counters on a synthetic trace
and set counters: a value where there is something to read, None where
there is not (a program without the counters or spans, no solve, no K2
kernel), and the glue readers' name filters."""
from __future__ import annotations

import collections
from types import SimpleNamespace

import pytest

import harness
import roofline
from optconpy_tpu_torch.riccati import lyap_adi
from optconpy_tpu_torch.solvers import krylov, ns_inverse
from optconpy_tpu_torch.utils import profiling

OWNERS = {"adi_iterations": lyap_adi, "host_reads": profiling}


def _owner(counter):
    return OWNERS.get(counter, krylov)


def _read(name, trace=None):
    mod = harness.load_module("metrics", name)
    return mod.read(SimpleNamespace(trace=trace or harness.Trace()))


@pytest.mark.parametrize("name, counters, want", [
    ("krylov.fgmres_cycles_per_solve.gains",
     {"fgmres_solves": 32, "fgmres_cycles": 41}, 41 / 32),
    ("krylov.fgmres_capped_share.gains",
     {"fgmres_solves": 32, "fgmres_capped": 2}, 100 * 2 / 32),
    ("krylov.fgmres_capped_share.gains",
     {"fgmres_solves": 32, "fgmres_capped": 0}, 0.0),
    ("krylov.host_reads_per_adi.gains",
     {"host_reads": 58, "adi_iterations": 16}, 58 / 16),
])
def test_counter_ratio(monkeypatch, name, counters, want):
    for k, v in counters.items():
        monkeypatch.setattr(_owner(k), k, v)
    assert _read(name) == pytest.approx(want)


@pytest.mark.parametrize("name, zero, missing", [
    ("krylov.fgmres_cycles_per_solve.gains", "fgmres_solves",
     "fgmres_cycles"),
    ("krylov.fgmres_capped_share.gains", "fgmres_solves", "fgmres_capped"),
    ("krylov.host_reads_per_adi.gains", "adi_iterations", "host_reads"),
])
def test_counter_ratio_none_without_counts(monkeypatch, name, zero, missing):
    """No solve or iteration run: None; a program without the counter
    (the parent of the counters): None."""
    monkeypatch.setattr(_owner(zero), zero, 0)
    assert _read(name) is None
    monkeypatch.setattr(_owner(zero), zero, 7)
    monkeypatch.delattr(_owner(missing), missing)
    assert _read(name) is None


def test_glue_idle_share_reads_the_dre_spans_only():
    tr = harness.Trace(window_s=2.0, idle_by_host={
        "krylov.arnoldi_step": 0.1, "krylov.fgmres_cycle": 0.05,
        "matfree.apply": 0.02, "newton.solve": 0.01, "adi.iteration": 0.01,
        "lowrank.compress": 0.01, "matfree.solve": 0.0,
        "rollout.step": 0.5, "aten::sum": 0.3, "cudaLaunchKernel": 0.2,
        "host (no traced operation)": 0.4})
    assert _read("krylov.glue_idle_share.gains", tr) == pytest.approx(10.0)


@pytest.mark.parametrize("idle", [
    {"aten::sum": 0.3, "host (no traced operation)": 0.7},
    {"rollout.call": 0.2},
    {},
])
def test_glue_idle_share_none_without_dre_spans(idle):
    tr = harness.Trace(window_s=2.0, idle_by_host=idle)
    assert _read("krylov.glue_idle_share.gains", tr) is None


def test_glue_idle_share_none_without_spans_in_the_program(monkeypatch):
    from optconpy_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "SPANS")
    tr = harness.Trace(window_s=2.0, idle_by_host={"krylov.arnoldi_step": 1})
    assert _read("krylov.glue_idle_share.gains", tr) is None


def test_realtime_glue_reads_the_rollout_spans_only():
    tr = harness.Trace(units={"steps": 512}, idle_by_host={
        "rollout.call": 0.010, "rollout.step": 0.0024,
        "krylov.arnoldi_step": 1.0, "aten::mm": 2.0,
        "host (no traced operation)": 3.0})
    assert _read("realtime.glue_idle_us_per_step", tr) == pytest.approx(
        1e6 * 0.0124 / 512)


@pytest.mark.parametrize("trace", [
    harness.Trace(units={"steps": 512},
                  idle_by_host={"aten::mm": 2.0, "krylov.fgmres_cycle": 1}),
    harness.Trace(units={}, idle_by_host={"rollout.call": 0.01}),
])
def test_realtime_glue_none_without_spans_or_steps(trace):
    assert _read("realtime.glue_idle_us_per_step", trace) is None


def _k2_trace(launches=4):
    kernels = [("spmm_tile_f32(int const*)", 0.0, 5.0),
               ("spmm_tile_f32(int const*)", 10.0, 13.0),
               ("void gemv_kernel", 20.0, 60.0)]
    return harness.Trace(kernels=kernels,
                         counters={"k2_launches": launches})


@pytest.mark.parametrize("esize, dtype", [(4, "float32"), (8, "float64")])
def test_k2_roofline_share(monkeypatch, esize, dtype):
    """The bytes of a product scale with its elements' size, its peak
    follows their precision."""
    calls = collections.Counter({(15316, 15316, 300_000, 46, esize): 3,
                                 (15316, 2080, 60_000, 4, esize): 1})
    monkeypatch.setattr(ns_inverse, "sparse_calls", calls)
    least = (3 * roofline.bound_s(esize * (300_000 + 2 * 15316 * 46),
                                  2.0 * 300_000 * 46, dtype)[0]
             + roofline.bound_s(esize * (60_000 + (15316 + 2080) * 4),
                                2.0 * 60_000 * 4, dtype)[0]) / 4
    mean_call = 8e-6 / 4  # 8 us of "spmm" kernels over 4 launches
    got = _read("k2_spmm.roofline_share.gains", _k2_trace())
    assert got == pytest.approx(100.0 * least / mean_call)


@pytest.mark.parametrize("calls, trace", [
    (collections.Counter({(10, 10, 30, 4, 4): 1}),
     harness.Trace(kernels=[("void gemv_kernel", 0.0, 1.0)],
                   counters={"k2_launches": 0})),
    (collections.Counter(), _k2_trace()),
    (None, _k2_trace()),
    (collections.Counter({(10, 10, 30, 4, 2): 1}), _k2_trace()),
])
def test_k2_roofline_share_none(monkeypatch, calls, trace):
    """No K2 kernel in the slice, no counted product, a program without
    the counter, or elements of a precision without a peak: None."""
    if calls is None:
        monkeypatch.delattr(ns_inverse, "sparse_calls")
    else:
        monkeypatch.setattr(ns_inverse, "sparse_calls", calls)
    assert _read("k2_spmm.roofline_share.gains", trace) is None
