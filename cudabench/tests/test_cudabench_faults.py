"""A whole run past the harness's look for a card, on the CPU at the tiny
sizes of conftest.py, judged by the cells' own limits: the sound program
comes out correct, and each fault that a cell can have, planted in the
timed path, comes out not correct.

Faults: a step that returns its state unchanged; half of the batch left
out, its outputs the mean over the rest (the batched cell only); an
answer altered where it is produced. The cells run on one card, so there
is no exchange between cards to leave out."""
from __future__ import annotations

import copy
import functools
import time

import pytest
import torch

import harness
import run as runmod
from conftest import tiny_cell

CPU = torch.device("cpu")
SEED = 2**31 + 4242


@functools.cache
def prepared(name):
    torch.set_num_threads(4)
    cell = tiny_cell(name)
    driver = harness.load_module("drivers", cell.traffic["driver"])
    return cell, driver, driver.setup(cell, SEED, CPU)


def judged(name, plant=None):
    cell, driver, state = prepared(name)
    state = copy.copy(state)
    state.timings = dict(state.timings)
    if plant is not None:
        plant(state)
    out, checks = runmod.measure(cell, driver, state, SEED, 0.2, False, CPU,
                                 setup_s=0.0)
    return out["correct"], checks


def unchanged_state(state):
    """The fused step maps v to v: pmat = I and every other term 0."""
    from optconpy_tpu_torch.mpc import NSEFusedCache

    f = state.fused
    n = f.pmat.shape[0]
    state.fused = NSEFusedCache(
        pmat=torch.eye(n, dtype=f.pmat.dtype), inv_vv=torch.zeros_like(
            f.inv_vv), gmat=torch.zeros_like(f.gmat),
        c0=torch.zeros_like(f.c0), vbar=f.vbar, dt=f.dt)


def half_batch(state):
    loop = state.loop

    def halved(sys, conv, fused, ks, ws, v0, alpha, dt):
        h = max(1, v0.shape[0] // 2)
        vs, us, ys = loop(sys, conv, fused, ks, ws, v0[:h], alpha, dt)
        rest = v0.shape[0] - h

        def fill(x):
            return torch.cat([x, x.mean(0, keepdim=True).expand(
                rest, *x.shape[1:])])

        return fill(vs), fill(us), fill(ys)

    state.loop = halved


def altered_answer(state):
    loop = state.loop

    def altered(*args):
        vs, us, ys = loop(*args)
        ys = ys.clone()
        ys[0, -1, 0] += 1e-3 * ys.abs().max()
        return vs, us, ys

    state.loop = altered


def unchanged_dre_step(state):
    state.step = lambda: state.k  # the gain and factor as they came in


def altered_gain(state):
    step = state.step

    def altered():
        k = step().clone()
        k[0, 0] += 1e-2 * k.abs().max()
        return k

    state.step = altered


FAULTS = {
    "cyl-re100-ref1.rollout-b1024": [unchanged_state, half_batch,
                                     altered_answer],
    "cyl-re100-ref1.realtime-b1": [unchanged_state, altered_answer],
    "cyl-re60-ref2.gains-matfree": [unchanged_dre_step, altered_gain],
}
CASES = [(cell, None) for cell in FAULTS] + [
    (cell, fault) for cell, faults in FAULTS.items() for fault in faults]


@pytest.mark.parametrize("name,fault", CASES, ids=[
    f"{c}-{f.__name__ if f else 'sound'}" for c, f in CASES])
def test_fault_is_not_correct(name, fault):
    t0 = time.perf_counter()
    correct, checks = judged(name, fault)
    assert correct is (fault is None), (checks, time.perf_counter() - t0)
