"""On the card: each cell at its own size, once as the configuration
states and once as the control (TF32 on every float32 matrix product,
drivers/wake.py program_context), with a short window. The sound run
comes out correct and the control does not. calibrate.py reads the same
numbers over a dozen seeds and more; PERF.md gives the readings.

    python -m pytest cudabench/tests/test_cudabench_control.py -m cuda
"""
from __future__ import annotations

import pytest

import harness
import run as runmod

CELLS = [w for w in harness.json.loads(
    (harness.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in CELLS])
def test_control_is_not_correct(card, name):
    cell = harness.load_cell(name)
    seed = 2**31 + 271828
    sound, _ = runmod.run(cell, seed, 2.0, False, card)
    control, checks = runmod.run(cell, seed, 2.0, False, card,
                                 precision="tf32")
    assert sound["correct"], sound
    assert not control["correct"], checks
