"""The reader of the fused step's sparse share: the steps that applied P
through the SpMM kernel over all fused steps where the program has both
counters and took a step, None where it did not (no step, a program
without the counters or the module)."""
from __future__ import annotations

import sys
from types import SimpleNamespace

import pytest

import harness
from optconpy_tpu_torch.mpc import nse_rollout

NAME = "fused_step.sparse_share.rollout"


def _read():
    mod = harness.load_module("metrics", NAME)
    return mod.read(SimpleNamespace(trace=harness.Trace()))


def test_sparse_share_of_steps(monkeypatch):
    monkeypatch.setattr(nse_rollout, "fused_sparse_steps", 192)
    monkeypatch.setattr(nse_rollout, "fused_dense_steps", 64)
    assert _read() == pytest.approx(75.0)
    monkeypatch.setattr(nse_rollout, "fused_dense_steps", 0)
    assert _read() == pytest.approx(100.0)


def test_none_without_steps_or_counters(monkeypatch):
    monkeypatch.setattr(nse_rollout, "fused_sparse_steps", 0)
    monkeypatch.setattr(nse_rollout, "fused_dense_steps", 0)
    assert _read() is None
    monkeypatch.setattr(nse_rollout, "fused_dense_steps", 64)
    monkeypatch.delattr(nse_rollout, "fused_sparse_steps")
    assert _read() is None


def test_none_in_a_program_without_the_module(monkeypatch):
    """A program with no module mpc/nse_rollout.py."""
    import optconpy_tpu_torch.mpc as mpc

    monkeypatch.delattr(mpc, "nse_rollout")
    monkeypatch.setitem(sys.modules, "optconpy_tpu_torch.mpc.nse_rollout",
                        None)
    assert _read() is None


def test_listed_for_the_rollout_cell_alone():
    cell = harness.load_cell("cyl-re100-ref1.rollout-b1024")
    assert NAME in {m["name"] for m in cell.per_layer}
    for other in ("cyl-re60-ref2.gains-matfree", "cyl-re100-ref1.realtime-b1",
                  "sweep-re60-150-ref1.sweep-b10240"):
        assert NAME not in {m["name"] for m in harness.load_cell(other).per_layer}
