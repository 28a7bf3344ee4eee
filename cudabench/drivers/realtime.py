"""Real-time step latency: one controlled flow, one control step a call
through `mpc.batched_nse_closed_loop` on the fused step, from the state
the last call left, with y and u read back to the host after every step
as a controller actuates. Every `episode_steps` steps a fresh disturbance
(a new initial state from the seed) starts the next episode.

The latency of a step runs from the call to y and u on the host.

Mix keys: episode_steps, noise, gain_tier, warmup_episodes,
check_episodes, slice_steps ([first, end) of the traced slice, in steps).
"""
from __future__ import annotations

import time

import harness
import wake

END_TO_END = ("step_latency_p95_ms",)


def setup(cell, seed: int, dev, precision: str = "highest"):
    from optconpy_tpu_torch.mpc import batched_nse_closed_loop

    state = wake.Wake(cell.config, cell.traffic, dev, precision)
    state.loop = batched_nse_closed_loop
    state.ks, state.ws = state.gains(1)
    mix = cell.traffic
    with state.ctx():
        for i in range(mix["warmup_episodes"]):
            v = state.initial_states(seed, -1 - i, 1)
            for _ in range(mix["episode_steps"]):
                v, _ = step(state, v)
    return state


def step(state, v):
    """One control step from v (1, n): the next state and [y, u] on the
    host."""
    import torch

    cfg = state.cfg
    vs, us, ys = state.loop(state.sys, state.conv, state.fused, state.ks,
                            state.ws, v, cfg["alpha"], cfg["dt"])
    return vs[:, 1], torch.cat([ys[0, 1], us[0, 0]]).cpu()


def window(state, seconds: float, seed: int, sl) -> dict:
    import torch

    mix = state.mix
    e_len = mix["episode_steps"]
    first, end = mix["slice_steps"]
    lat, episodes = [], []
    clock = time.perf_counter
    with state.ctx():
        if state.dev.type == "cuda":
            torch.cuda.synchronize(state.dev)
        t0 = clock()
        while True:
            v = state.initial_states(seed, len(episodes), 1)
            rows = []
            for _ in range(e_len):
                k = len(lat)
                if k == first:
                    sl.begin()
                t = clock()
                v, yu = step(state, v)
                lat.append(clock() - t)
                rows.append(yu)
                if k + 1 == end:
                    sl.end(steps=end - first)
            episodes.append(torch.stack(rows))
            if clock() - t0 >= seconds and not sl.open:
                break
    return {"latency_s": lat, "episodes": episodes,
            "elapsed": clock() - t0}


def end_to_end(state, rec) -> dict:
    return {"step_latency_p95_ms": 1e3 * harness.p95(rec["latency_s"])}


def diagnostics(rec) -> dict:
    """Percentiles of the step latency (ms), printed beside the result."""
    import numpy as np

    q = np.percentile(np.asarray(rec["latency_s"]) * 1e3, [50, 90, 99, 99.9])
    return {"latency_ms_p50_p90_p99_p999": [round(float(x), 4) for x in q],
            "steps": len(rec["latency_s"])}


def counts(state, rec) -> tuple[int, int]:
    """Steps attempted, and those whose y or u is not finite."""
    import torch

    bad = sum(int((~torch.isfinite(e).all(dim=1)).sum())
              for e in rec["episodes"])
    return len(rec["latency_s"]), bad


def check(state, rec, seed: int) -> dict:
    """`check_episodes` episodes drawn from the seed, against the
    reference run from their initial states."""
    import torch

    mix = state.mix
    p = state.cfg["p"]
    picks = wake.sample(seed, len(rec["episodes"]), mix["check_episodes"], 11)
    v0 = torch.cat([state.initial_states(seed, i, 1) for i in picks])
    yu = torch.stack([rec["episodes"][i] for i in picks])  # (S, E, p + m)
    ys = yu[:, :, :p]
    us = yu[:, :, p:]
    k0 = state.k0
    state.release()
    return wake.check_closed_loop(state, k0, v0, ys, us, mix["episode_steps"])
