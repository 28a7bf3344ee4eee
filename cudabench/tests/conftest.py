"""Shared pieces of the benchmark's own tests: the import path of the
harness, and tiny CPU variants of the cells (the same files, with the
shapes cut so that a CPU run takes seconds). Run them from the root:

    python -m pytest cudabench/tests -q -p no:cacheprovider
"""
from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
for p in (BENCH, BENCH / "drivers", BENCH.parent):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import harness  # noqa: E402

# The CPU cut of every cell: fewer shifts, ADI iterations, DRE steps and
# scenarios; the host 'lu' gain tier where the card builds Newton-Schulz
# stacks (hours of CPU GEMMs).
TINY_GAINS = dict(num_shifts=2, n_adi=4, nts=2, r_max=8)
TINY_TRAFFIC = {
    "fused_rollout": dict(batch=4, steps=3, warmup_batches=1,
                          check_batches=2, slice_batches=[1, 2],
                          gain_tier="lu"),
    "realtime": dict(episode_steps=3, warmup_episodes=1, check_episodes=2,
                     slice_steps=[2, 4], gain_tier="lu"),
    "dre_matfree": dict(warmup_steps=1, slice_steps=[1, 2]),
}


def tiny_cell(name: str) -> harness.Cell:
    """The cell `name` at a CPU size. The gains cell runs on refinement 1
    with a tight FGMRES tolerance (a dense float64 LU of refinement 2's
    saddle takes minutes on a CPU)."""
    cell = harness.load_cell(name)
    cell.config = copy.deepcopy(cell.config)
    cell.traffic = dict(cell.traffic)
    cell.config["gains"].update(TINY_GAINS)
    cell.traffic.update(TINY_TRAFFIC[cell.traffic["driver"]])
    if cell.traffic["driver"] == "dre_matfree":
        ref1 = harness.load_json("configs", "cyl-re100-ref1")
        cell.config.update({k: ref1[k] for k in ("re", "refinement", "n",
                                                 "n_p", "dt")})
        cell.config["assumed"] = {}
        cell.config["gains"].update(n_adi=3, fgmres_tol=1e-6,
                                    fgmres_max_cycles=20)
    return cell


@pytest.fixture
def card():
    """The first CUDA card; skips where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the program's kernels and its "
                    "TF32 tier exist only on the card")
    return torch.device("cuda", 0)
