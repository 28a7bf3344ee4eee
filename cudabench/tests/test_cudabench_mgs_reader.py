"""The reader of the MGS kernel's counters: on-chip launches per ADI
iteration where the program has the kernel and ran an iteration, None
where it did not (no iteration, a program without the kernel)."""
from __future__ import annotations

import sys
from types import SimpleNamespace

import pytest

import harness
from optconpy_tpu_torch.ops import arnoldi_kernel
from optconpy_tpu_torch.riccati import lyap_adi

NAME = "krylov.mgs_launches_per_adi.gains"


def _read():
    mod = harness.load_module("metrics", NAME)
    return mod.read(SimpleNamespace(trace=harness.Trace()))


def test_onchip_launches_per_iteration(monkeypatch):
    monkeypatch.setattr(lyap_adi, "adi_iterations", 16)
    monkeypatch.setattr(arnoldi_kernel, "launches", 1200)
    monkeypatch.setattr(arnoldi_kernel, "launches_onchip", 1190)
    assert _read() == pytest.approx(1190 / 16)


def test_none_without_iterations_or_kernel(monkeypatch):
    monkeypatch.setattr(lyap_adi, "adi_iterations", 0)
    assert _read() is None
    monkeypatch.setattr(lyap_adi, "adi_iterations", 16)
    monkeypatch.delattr(arnoldi_kernel, "launches_onchip")
    assert _read() is None


def test_none_in_a_program_without_the_kernel(monkeypatch):
    """The parent of the kernel: no module ops/arnoldi_kernel.py."""
    import optconpy_tpu_torch.ops as ops

    monkeypatch.setattr(lyap_adi, "adi_iterations", 16)
    monkeypatch.delattr(ops, "arnoldi_kernel")
    monkeypatch.setitem(sys.modules, "optconpy_tpu_torch.ops.arnoldi_kernel",
                        None)
    assert _read() is None
