"""The window's arithmetic: whole-step rates, the 95th percentile over all
samples, the idle share and idle gaps of a synthetic trace, K1's frozen
bound, seeds and the result line's keys."""
from __future__ import annotations

import json
from types import SimpleNamespace

import numpy as np
import pytest

import harness
import roofline


def test_p95_over_all_samples():
    samples = [1.0] * 94 + [50.0] * 6
    assert harness.p95(samples) == pytest.approx(
        float(np.percentile(samples, 95)))
    assert harness.p95(samples) > 1.0  # the tail is not trimmed
    assert harness.p95(list(range(1, 101))) == pytest.approx(95.05)


def test_whole_step_rates():
    gains = harness.load_module("drivers", "dre_matfree")
    rec = {"gains": [0] * 5, "elapsed": 12.5, "device_busy_s": 2.5}
    assert gains.end_to_end(None, rec) == {"dre_device_ms_per_step": 500.0}
    rec["device_busy_s"] = None  # tracing on, or no card: nothing read
    assert gains.end_to_end(None, rec) == {"dre_device_ms_per_step": None}
    roll = harness.load_module("drivers", "fused_rollout")
    state = SimpleNamespace(mix={"batch": 1024, "steps": 64})
    rec = {"outs": [None] * 10, "elapsed": 1.25}
    assert roll.end_to_end(state, rec) == {
        "closed_loop_solves_per_s": 10 * 1024 * 64 / 1.25}
    rt = harness.load_module("drivers", "realtime")
    rec = {"latency_s": [1e-3] * 99 + [1.0]}
    assert rt.end_to_end(None, rec)["step_latency_p95_ms"] == pytest.approx(1.0)


def test_busy_time_and_idle_gaps():
    device = [(0, 10), (5, 20), (30, 40)]  # union 30 of [0, 50]
    host = [("outer", 0, 50), ("aten::item", 21, 29), ("sync", 41, 50)]
    busy, gaps = harness.busy_and_gaps(device, host, 0, 50)
    assert busy == 30
    assert gaps == {"aten::item": 10, "sync": 10}
    tr = harness.Trace(window_s=50e-6, busy_s=30e-6,
                       kernels=[("k", s, e) for s, e in device])
    assert harness.idle_share(tr) == pytest.approx(40.0)
    assert harness.idle_share(harness.Trace(window_s=1.0)) is None


def test_host_rate_before_the_slice():
    """krylov.dre_steps_per_s.gains: the steps before the traced slice
    over their time; nothing where the slice left no such record."""
    read = harness.load_module("metrics", "krylov.dre_steps_per_s.gains").read
    tr = harness.Trace(units={"steps": 1, "steps_before": 12,
                              "seconds_before": 24.0})
    assert read(SimpleNamespace(trace=tr)) == pytest.approx(0.5)
    assert read(SimpleNamespace(trace=harness.Trace(units={"steps": 1}))) \
        is None


def test_slice_pending_until_it_ends():
    off = harness.Slice(False)
    assert not off.pending
    on = harness.Slice(True)
    assert on.pending
    on._done = ("prof", 1.0, {}, {})  # what end() leaves
    assert not on.pending


def test_device_busy_reads_nothing_when_off():
    with harness.DeviceBusy(False) as busy:
        pass
    assert busy.busy_s is None


def test_trace_sums_by_name():
    tr = harness.Trace(kernels=[("conv_p2_patch", 0, 4), ("sgemm", 4, 11),
                                ("conv_p2_patch", 10, 12)])
    assert tr.device_seconds(lambda n: "conv_p2" in n) == (6e-6, 2)
    assert tr.top_ops(1) == [["sgemm", pytest.approx(7e-6)]]


def test_k1_bound_at_the_rollout_shape():
    """The frozen count at B=1024, n=4,396, nt=1,155: 17.8 us, set by the
    operations (PERF.md's kernel table)."""
    least, by = roofline.bound_s(*roofline.k1_work(4396, 1155, 1024))
    assert by == "operations"
    assert least * 1e6 == pytest.approx(17.8, abs=0.05)


def test_k1_roofline_reader():
    reader = harness.load_module("metrics", "k1_conv.roofline_share.rollout")
    cell = SimpleNamespace(config={"n": 4396, "nt": 1155},
                           traffic={"batch": 1024})
    tr = harness.Trace(kernels=[("conv_p2_patch_kernel", 0, 60),
                                ("conv_p2_shared_dofs_kernel", 60, 71.2)],
                       counters={"k1_launches": 1})
    share = reader.read(SimpleNamespace(trace=tr, cell=cell))
    assert share == pytest.approx(100 * 17.7938 / 71.2, rel=1e-3)
    tr.counters["k1_launches"] = 0
    assert reader.read(SimpleNamespace(trace=tr, cell=cell)) is None


def test_seeds():
    big = 2**31 + 12345
    assert harness.mixed_seed(big, 3) == harness.mixed_seed(big, 3)
    assert harness.mixed_seed(big, 3) != harness.mixed_seed(big, 4)
    assert 0 <= harness.mixed_seed(-1, -7) < 2**63


def test_result_line_keys():
    checks = {"y": {"value": 1e-6, "limit": 1e-5}}
    line = harness.result_line(
        correct=True, attempted=3, failed=0,
        metrics={"setup_s": {"value": 1.5, "unit": "s"}},
        device={"platform": "gpu", "kind": "x", "count": 1,
                "memory_peak_bytes": 1}, checks=checks,
        breakdown={"device_ops": [], "idle_gaps": []})
    out = json.loads(line)
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "checks"]
    assert harness.check_lines(checks) == ["check y: 1e-06 (limit 1e-05)"]
