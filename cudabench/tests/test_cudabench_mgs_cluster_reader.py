"""The reader of the MGS kernel's one-cluster launches: their share of all
its launches where the program has the counter and launched the kernel,
None where it did not (no launch, a program without the counter or the
kernel)."""
from __future__ import annotations

import sys
from types import SimpleNamespace

import pytest

import harness
from optconpy_tpu_torch.ops import arnoldi_kernel

NAME = "krylov.mgs_one_cluster_share.gains"


def _read():
    mod = harness.load_module("metrics", NAME)
    return mod.read(SimpleNamespace(trace=harness.Trace()))


def test_one_cluster_share_of_launches(monkeypatch):
    monkeypatch.setattr(arnoldi_kernel, "launches", 1200)
    monkeypatch.setattr(arnoldi_kernel, "launches_one_cluster", 570)
    assert _read() == pytest.approx(47.5)


def test_none_without_launches_or_counter(monkeypatch):
    monkeypatch.setattr(arnoldi_kernel, "launches", 0)
    monkeypatch.setattr(arnoldi_kernel, "launches_one_cluster", 0)
    assert _read() is None
    monkeypatch.setattr(arnoldi_kernel, "launches", 1200)
    monkeypatch.delattr(arnoldi_kernel, "launches_one_cluster")
    assert _read() is None


def test_none_in_a_program_without_the_kernel(monkeypatch):
    """A program with no module ops/arnoldi_kernel.py."""
    import optconpy_tpu_torch.ops as ops

    monkeypatch.delattr(ops, "arnoldi_kernel")
    monkeypatch.setitem(sys.modules, "optconpy_tpu_torch.ops.arnoldi_kernel",
                        None)
    assert _read() is None


def test_listed_for_the_gains_cell_alone():
    cell = harness.load_cell("cyl-re60-ref2.gains-matfree")
    assert NAME in {m["name"] for m in cell.per_layer}
    for other in ("cyl-re100-ref1.rollout-b1024", "cyl-re100-ref1.realtime-b1",
                  "sweep-re60-150-ref1.sweep-b10240"):
        assert NAME not in {m["name"] for m in harness.load_cell(other).per_layer}
