"""Closed-loop throughput: batches of scenarios through
`mpc.batched_nse_closed_loop` on the fused step (`NSEFusedCache`), back
to back; the caller waits for each batch's outputs.

Mix keys: batch, steps, noise, gain_tier, warmup_batches, check_batches,
slice_batches ([first, end) of the traced slice, in batches).
"""
from __future__ import annotations

import time

import wake

END_TO_END = ("closed_loop_solves_per_s",)


def setup(cell, seed: int, dev, precision: str = "highest"):
    from optconpy_tpu_torch.mpc import batched_nse_closed_loop

    state = wake.Wake(cell.config, cell.traffic, dev, precision)
    state.loop = batched_nse_closed_loop
    mix = cell.traffic
    with state.ctx():
        for i in range(mix["warmup_batches"]):
            run_batch(state, state.initial_states(seed, -1 - i, mix["batch"]))
    return state


def run_batch(state, v0):
    import torch

    cfg, mix = state.cfg, state.mix
    ks, ws = state.gains(mix["steps"])
    _, us, ys = state.loop(state.sys, state.conv, state.fused, ks, ws, v0,
                           cfg["alpha"], cfg["dt"])
    if state.dev.type == "cuda":
        torch.cuda.synchronize(state.dev)
    return ys, us


def window(state, seconds: float, seed: int, sl) -> dict:
    import torch

    mix = state.mix
    first, end = mix["slice_batches"]
    outs = []
    with state.ctx():
        if state.dev.type == "cuda":
            torch.cuda.synchronize(state.dev)
        t0 = time.perf_counter()
        while True:
            i = len(outs)
            if i == first:
                sl.begin()
            outs.append(run_batch(state, state.initial_states(
                seed, i, mix["batch"])))
            if i + 1 == end:
                sl.end(batches=end - first,
                       scenario_steps=(end - first) * mix["batch"]
                       * mix["steps"])
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds and not sl.open:
                break
    return {"outs": outs, "elapsed": elapsed}


def end_to_end(state, rec) -> dict:
    mix = state.mix
    solves = len(rec["outs"]) * mix["batch"] * mix["steps"]
    return {"closed_loop_solves_per_s": solves / rec["elapsed"]}


def counts(state, rec) -> tuple[int, int]:
    """Scenario-steps attempted, and those whose control or output is not
    finite."""
    import torch

    mix = state.mix
    bad = 0
    for ys, us in rec["outs"]:
        ok = torch.isfinite(us).all(dim=2) & torch.isfinite(ys[:, 1:]).all(dim=2)
        bad += int((~ok).sum())
    return len(rec["outs"]) * mix["batch"] * mix["steps"], bad


def check(state, rec, seed: int) -> dict:
    """Every scenario of `check_batches` batches drawn from the seed, each
    against the reference run from its own initial states."""
    import torch

    mix = state.mix
    picks = wake.sample(seed, len(rec["outs"]), mix["check_batches"], 7)
    v0 = torch.cat([state.initial_states(seed, i, mix["batch"])
                    for i in picks])
    ys = torch.cat([rec["outs"][i][0] for i in picks])
    us = torch.cat([rec["outs"][i][1] for i in picks])
    k0 = state.k0
    state.release()
    rec["outs"] = None
    return wake.check_closed_loop(state, k0, v0, ys, us, mix["steps"])
