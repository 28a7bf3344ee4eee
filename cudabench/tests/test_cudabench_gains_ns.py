"""The dense-inverse gains cell (cyl-re60-ref2-ns.gains-ns) on the CPU:
its files found by name on one card, the driver's whole path
(`build_dre_cache_dae_ns`, the DRE steps, the window) against
reference/plain.py's DRE sweep (drivers/dre_matfree.py's check) at a CPU
size judged by the cell's own limit, a planted fault (one inverse block
scaled by 1 + 1e-3) not correct, and the readers' arithmetic on
synthetic traces and on what the driver records, None where there is
nothing to read.

The CPU cut: refinement 1 (n = 4,396), 2 shifts, 4 ADI iterations, 2 DRE
steps a sweep, rank 8. The Newton-Schulz build of its 2 shifts is about
36 dense (5,037^2) passes, 2-3 minutes of CPU GEMMs: it runs once.
"""
from __future__ import annotations

import copy
import dataclasses
import functools
from types import SimpleNamespace

import pytest
import torch

import harness
import roofline
import run as runmod
from optconpy_tpu_torch.riccati import lyap_adi
from optconpy_tpu_torch.solvers import saddle

CELL = "cyl-re60-ref2-ns.gains-ns"
CPU = torch.device("cpu")
SEED = 2**31 + 5151
TINY_GAINS = dict(num_shifts=2, n_adi=4, nts=2, r_max=8)
TINY_TRAFFIC = dict(warmup_steps=1, slice_steps=[1, 2])


def tiny_cell() -> harness.Cell:
    cell = harness.load_cell(CELL)
    cell.config = copy.deepcopy(cell.config)
    cell.traffic = dict(cell.traffic, **TINY_TRAFFIC)
    cell.config["gains"].update(TINY_GAINS)
    ref1 = harness.load_json("configs", "cyl-re100-ref1")
    cell.config.update({k: ref1[k] for k in ("refinement", "n", "n_p")})
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


def scaled_block(state):
    """One shift's inverse block scaled by 1 + 1e-3."""
    inv = state.cache.inv.clone()
    inv[0] *= 1.0 + 1e-3
    state.cache = dataclasses.replace(state.cache, inv=inv)


def test_cell_is_found_by_name_on_one_chip():
    cell = harness.load_cell(CELL)
    assert cell.chips == 1
    assert cell.traffic["driver"] == "dre_ns"
    assert cell.config["gains"]["num_shifts"] == 8
    assert cell.config["reduced"] == []
    assert {m["name"] for m in cell.end_to_end} == {
        "dre_device_ms_per_step", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "ns_dre.roofline_share.gains_ns",
        "ns_dre.inverse_reads_per_adi.gains_ns",
        "ns_dre.glue_idle_share.gains_ns", "device_idle.gains_ns",
        "setup.ns_build_s", "ns_build.passes_per_shift",
        "krylov.host_launches_per_adi.gains",
        "krylov.host_reads_per_adi.gains", "setup.host_fem_s"}
    assert set(cell.limits) == {"gain"}


def test_set_up_builds_and_certifies_the_stack():
    cell, _, state = prepared()
    build = state.timings["ns_build"]
    assert build["shifts"] == build["certified"] == 2
    assert build["worst_residual"] <= cell.config["gains"]["certify_tol"]
    assert build["ns_passes"] > build["ladder_rungs"] > 0
    assert state.timings["ns_build_s"] > 0
    assert state.timings["host_fem_s"] > 0


@pytest.mark.parametrize("plant", [None, scaled_block],
                         ids=["sound", "scaled_block"])
def test_against_the_reference(plant):
    out, checks = judged(plant)
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert out["correct"] is (plant is None), checks


class RecordingSlice:
    """A traced slice without a profiler: keeps the units the driver
    gives its end."""

    enabled, pending = True, True

    def begin(self):
        pass

    def end(self, **units):
        self.units, self.pending = units, False


def test_window_reads_two_applies_an_adi_iteration():
    cell, driver, state = prepared()
    state = copy.copy(state)
    a0, i0 = saddle.inverse_applies, lyap_adi.adi_iterations
    sl = RecordingSlice()
    rec = driver.window(state, 0.0, SEED, sl)
    iters = lyap_adi.adi_iterations - i0
    assert iters == len(rec["gains"]) * cell.config["gains"]["n_adi"]
    assert saddle.inverse_applies - a0 == 2 * iters
    assert rec["device_busy_s"] is None  # no card: nothing profiled
    first, end = cell.traffic["slice_steps"]
    assert sl.units == {"steps": end - first,
                        "adi_iters": (end - first) * cell.config["gains"]["n_adi"]}


# --- the readers ---------------------------------------------------------

def _read(name, trace=None, setup=None):
    mod = harness.load_module("metrics", name)
    return mod.read(SimpleNamespace(trace=trace or harness.Trace(),
                                    setup=setup or {},
                                    cell=harness.load_cell(CELL)))


def test_roofline_share_is_one_block_an_iteration_at_the_hbm_peak():
    """16 ADI iterations of the configuration's n = 15,316 need 16 reads
    of a 938 MB float32 block: 15.0 GB, 4.48 ms at the peak."""
    tr = harness.Trace(busy_s=0.0764, units={"adi_iters": 16})
    nbytes = 16 * 15316**2 * 4
    want = 100.0 * (nbytes / roofline.HBM_BYTES_S) / 0.0764
    got = _read("ns_dre.roofline_share.gains_ns", tr)
    assert got == pytest.approx(want)
    assert 5.8 < got < 5.9


@pytest.mark.parametrize("units, busy", [
    ({}, 0.016),
    ({"adi_iters": 0}, 0.016),
    ({"adi_iters": 16}, 0.0),
])
def test_roofline_share_none_without_a_reading(units, busy):
    tr = harness.Trace(busy_s=busy, units=units)
    assert _read("ns_dre.roofline_share.gains_ns", tr) is None


def test_inverse_reads_per_adi(monkeypatch):
    monkeypatch.setattr(saddle, "inverse_applies", 1024)
    monkeypatch.setattr(lyap_adi, "adi_iterations", 512)
    name = "ns_dre.inverse_reads_per_adi.gains_ns"
    assert _read(name) == pytest.approx(2.0)
    monkeypatch.setattr(lyap_adi, "adi_iterations", 0)
    assert _read(name) is None
    monkeypatch.setattr(lyap_adi, "adi_iterations", 512)
    monkeypatch.delattr(saddle, "inverse_applies")  # the parent: no counter
    assert _read(name) is None


@pytest.mark.parametrize("build, want", [
    ({"ns_passes": 69, "shifts": 8}, 69 / 8),
    ({"ns_passes": 0, "shifts": 0}, None),
    (None, None),
])
def test_passes_per_shift_reads_the_set_up_build(build, want):
    setup = {} if build is None else {"ns_build": build}
    got = _read("ns_build.passes_per_shift", setup=setup)
    assert got == (None if want is None else pytest.approx(want))


def test_passes_per_shift_on_the_drivers_set_up():
    _, _, state = prepared()
    build = state.timings["ns_build"]
    got = _read("ns_build.passes_per_shift", setup=state.timings)
    assert got == pytest.approx(build["ns_passes"] / 2)


def test_accepted_readers_read_what_the_driver_records():
    """krylov.host_launches_per_adi.gains, krylov.host_reads_per_adi.gains
    and setup.host_fem_s have something to read in this cell: the
    slice's adi_iters unit, the SMW solve's and the compression's host
    reads, the host FEM's seconds."""
    cell, driver, state = prepared()
    sl = RecordingSlice()
    driver.window(copy.copy(state), 0.0, SEED, sl)
    tr = harness.Trace(launches=640, units=sl.units)
    iters = sl.units["adi_iters"]
    assert _read("krylov.host_launches_per_adi.gains", tr) == 640 / iters
    assert _read("krylov.host_reads_per_adi.gains") > 0
    assert _read("setup.host_fem_s", setup=state.timings) > 0


def test_glue_idle_share_reads_the_dense_path_spans():
    tr = harness.Trace(window_s=0.1, idle_by_host={
        "inverse.solve": 0.004, "adi.iteration": 0.003,
        "newton.solve": 0.002, "lowrank.compress": 0.001,
        "matfree.apply": 0.5, "krylov.fgmres_cycle": 0.5,
        "cudaLaunchKernel": 0.02, "host (no traced operation)": 0.03})
    assert _read("ns_dre.glue_idle_share.gains_ns", tr) == pytest.approx(10.0)


@pytest.mark.parametrize("idle", [
    {"adi.iteration": 0.01},  # a program without inverse.solve
    {"aten::mm": 0.01, "host (no traced operation)": 0.02},
    {},
])
def test_glue_idle_share_without_inverse_span(idle):
    tr = harness.Trace(window_s=0.1, idle_by_host=idle)
    got = _read("ns_dre.glue_idle_share.gains_ns", tr)
    assert got == (pytest.approx(10.0) if "adi.iteration" in idle else None)


def test_device_idle_and_build_seconds():
    tr = harness.Trace(window_s=0.1, busy_s=0.02,
                       kernels=[("gemm", 0.0, 20000.0)])
    assert _read("device_idle.gains_ns", tr) == pytest.approx(80.0)
    assert _read("device_idle.gains_ns") is None
    assert _read("setup.ns_build_s", setup={"ns_build_s": 15.6}) == 15.6
    assert _read("setup.ns_build_s") is None
