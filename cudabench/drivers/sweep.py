"""Config 5's parameter sweep: Reynolds buckets of perturbed wakes in one
closed-loop rollout, sweeps back to back, through the package's API.

Set-up, as a user of the port runs a sweep (each stage on the harness
clock): the configuration's Reynolds draw (numpy's default_rng(re_seed))
sent to the nearest of its evenly spaced buckets
(`parallel.assign_re_buckets`) and laid out as a padded grid
(`parallel.sweep_layout`); per bucket `models.cylinder.cylinder_setup`;
one convection evaluator for the shared geometry; per bucket a t = 0 DRE
gain and the stacked steppers (`parallel.build_sweep_gains_and_caches`,
the configuration's `gains`); one warm-up sweep.

A sweep draws fresh initial states from the run's seed, each bucket's
steady state plus noise * N(0, 1) on its real rows (padded rows hold the
steady state), runs the configuration's steps with implicit feedback
under the constant gains (`parallel.sweep_rollout`), reduces the
per-bucket statistics over the real rows (`parallel.masked_sweep_stats`)
and reads them on the host before the next sweep starts.
closed_loop_solves_per_s counts the real scenario-steps of the sweeps
completed in the window over its synchronized seconds; padding is not
counted.

The check follows every real scenario of one sweep drawn from the seed
against the plain reference (reference/sweep.py) from the same initial
states: the gains, the outputs y, the squared control norms u_sq, and
the statistics, whose counts must equal the design's.

The control (precision 'tf32', calibrate.py) runs the sweeps' products
in TF32 (drivers/wake.py program_context) and builds the gains and
steppers as the configuration states: under TF32 the Newton-Schulz
chain's certification stops set-up (its float64 probe cannot reach the
chain's 1e-4 from TF32 passes).

Mix keys: noise, warmup_sweeps, slice_sweeps ([first, end) of the
traced slice, in sweeps of the window).
"""
from __future__ import annotations

import time

import numpy as np

import harness
import wake

END_TO_END = ("closed_loop_solves_per_s",)
STAT_KEYS = ("mean_cost", "tracking_err_T", "max_abs_y")
_REFERENCE = {}  # per-bucket references of one configuration (calibrate.py)


class Sweep:
    """The program's objects of the sweep cell."""

    def __init__(self, cfg: dict, mix: dict, dev, precision: str):
        import torch

        from optconpy_tpu_torch.fem.device_conv import FusedConvKernel
        from optconpy_tpu_torch.models.cylinder import cylinder_setup
        from optconpy_tpu_torch.parallel import (
            assign_re_buckets,
            build_sweep_gains_and_caches,
            sweep_layout,
            sweep_rollout,
        )

        self.cfg, self.mix, self.dev = cfg, mix, dev
        self.ctx = lambda: wake.program_context(precision)
        self.rollout = sweep_rollout
        g = cfg["gains"]
        f32 = torch.float32
        self.timings = {}
        clock = time.perf_counter
        with wake.program_context("highest"):  # the control: sweeps only
            self.re_buckets = np.linspace(*cfg["re_range"], cfg["buckets"])
            draw = np.random.default_rng(cfg["re_seed"]).uniform(
                *cfg["re_range"], cfg["scenarios"])
            self.layout = sweep_layout(
                assign_re_buckets(draw, self.re_buckets), cfg["buckets"],
                cfg["pad"])
            t = clock()
            setups = [cylinder_setup(re=float(re),
                                     refinement=cfg["refinement"],
                                     device=dev, dtype=torch.float64)
                      for re in self.re_buckets]
            self.timings["host_fem_s"] = clock() - t
            np0, sys0, cond0 = setups[0]
            t = clock()
            self.conv = FusedConvKernel.build(np0["full"], cond0,
                                              device=dev, dtype=f32)
            self.timings["conv_plan_s"] = clock() - t
            got = dict(n=sys0.n, n_p=sys0.n_p, m=sys0.m_in, p=sys0.p_out,
                       nt=self.conv.tri_dofs.shape[0])
            want = {k: cfg[k] for k in got}
            if got != want:
                raise RuntimeError(f"sizes {got} differ from the "
                                   f"configuration's {want}")
            t = clock()
            self.cache_stack, self.ks = build_sweep_gains_and_caches(
                setups, cfg["dt"], cfg["alpha"], dtype=f32,
                num_shifts=g["num_shifts"], n_adi=g["n_adi"],
                nts_gain=g["nts"], r_max=g["r_max"], solver=g["solver"],
                dre_solver=g["dre_solver"], conv=self.conv)
            self.sync()
            self.timings["sweep_gains_s"] = clock() - t
            self.sys = sys0.to(dtype=f32)
            self.ystar = torch.stack([
                s.c @ torch.as_tensor(c.restrict(o["vbar_full"])).to(dev)
                for o, s, c in setups]).to(f32)
            del setups
        self.mask = torch.as_tensor(self.layout.mask, dtype=f32).to(dev)
        self.vbar = self.cache_stack.vbar[:, None, :]  # (R, 1, n)
        self.real = int(self.layout.counts.sum())

    def sync(self) -> None:
        import torch

        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def initial_states(self, seed: int, sweep: int):
        """(R, s_max, n): each bucket's steady state, plus noise * N(0,1)
        on its real rows, drawn on the device from (seed, sweep)."""
        import torch

        r_b, s_max = self.mask.shape
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(harness.mixed_seed(seed, sweep))
        noise = torch.randn((r_b, s_max, self.vbar.shape[-1]), generator=gen,
                            device=self.dev, dtype=self.vbar.dtype)
        return self.vbar + noise.mul_(self.mask[..., None] * self.mix["noise"])

    def run(self, v0):
        """One sweep from v0; the statistics on the host."""
        from optconpy_tpu_torch.parallel import masked_sweep_stats

        cfg = self.cfg
        ys, u_sq, _ = self.rollout(self.sys, self.conv, self.cache_stack,
                                   self.ks, v0, cfg["alpha"], cfg["dt"],
                                   cfg["steps"])
        stats = masked_sweep_stats(ys, u_sq, cfg["alpha"], cfg["dt"],
                                   self.ystar, self.mask)
        return ys, u_sq, {k: v.cpu() for k, v in stats.items()}

    def release(self) -> None:
        """Drop the program's objects before the reference runs."""
        import torch

        self.sys = self.conv = self.cache_stack = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()


def setup(cell, seed: int, dev, precision: str = "highest"):
    state = Sweep(cell.config, cell.traffic, dev, precision)
    with state.ctx():
        t = time.perf_counter()
        for i in range(cell.traffic["warmup_sweeps"]):
            state.run(state.initial_states(seed, -1 - i))
        state.timings["warmup_s"] = time.perf_counter() - t
    return state


def window(state, seconds: float, seed: int, sl) -> dict:
    first, end = state.mix["slice_sweeps"]
    outs = []
    with state.ctx():
        state.sync()
        t0 = time.perf_counter()
        while True:
            i = len(outs)
            if i == first:
                sl.begin()
            outs.append(state.run(state.initial_states(seed, i)))
            if i + 1 == end:
                sl.end(sweeps=end - first,
                       scenario_steps=(end - first) * state.real
                       * state.cfg["steps"],
                       columns=state.mask.numel())
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds and not sl.open:
                break
    return {"outs": outs, "sweeps": len(outs), "elapsed": elapsed}


def end_to_end(state, rec) -> dict:
    solves = len(rec["outs"]) * state.real * state.cfg["steps"]
    return {"closed_loop_solves_per_s": solves / rec["elapsed"]}


def counts(state, rec) -> tuple[int, int]:
    """Real scenario-steps attempted, and those whose control or output
    is not finite."""
    import torch

    real = torch.as_tensor(state.layout.mask > 0, device=state.dev)
    bad = 0
    for ys, u_sq, _ in rec["outs"]:
        ok = torch.isfinite(u_sq) & torch.isfinite(ys[:, :, 1:]).all(dim=3)
        bad += int((~ok & real[..., None]).sum())
    return len(rec["outs"]) * state.real * state.cfg["steps"], bad


def reference(cfg: dict, dev):
    """The reference buckets of the configuration (reference/sweep.py),
    kept for the process."""
    from reference import sweep as ref

    key = (repr(sorted(cfg.items())), str(dev))
    if key not in _REFERENCE:
        _REFERENCE.clear()
        re_buckets, design_counts = ref.design(
            *cfg["re_range"], cfg["buckets"], cfg["scenarios"],
            cfg["re_seed"])
        buckets = [ref.Bucket(float(re), cfg["refinement"], cfg["dt"],
                              cfg["alpha"], cfg["gains"], dev)
                   for re in re_buckets]
        _REFERENCE[key] = (design_counts, buckets)
    return _REFERENCE[key]


def check(state, rec, seed: int) -> dict:
    """Every real scenario of one sweep drawn from the seed against the
    reference from its initial states, bucket by bucket: gain (each
    bucket's on its own scale, the worst), y and u_sq (over all real
    scenarios), stats (each statistic over the buckets, the worst; inf
    when a count differs from the design's), each as max |program -
    reference| / max |reference|."""
    import torch

    from reference import plain

    (pick,) = wake.sample(seed, len(rec["outs"]), 1, 11)
    ys, u_sq, stats = rec["outs"][pick]
    v0 = state.initial_states(seed, pick)
    ks = state.ks
    state.release()
    rec["outs"] = None
    design_counts, buckets = reference(state.cfg, state.dev)
    gain = 0.0
    dev = {"y": [0.0, 0.0], "u_sq": [0.0, 0.0]}  # max |a - ref|, max |ref|
    ref_stats = {k: [] for k in STAT_KEYS}
    for r, b in enumerate(buckets):
        c = int(design_counts[r])
        gain = max(gain, plain.rel_dev(ks[r], b.k))
        ys_ref, u_sq_ref, st = b.run(v0[r, :c], state.cfg["steps"])
        for k in STAT_KEYS:
            ref_stats[k].append(st[k])
        for name, a, a_ref in (("y", ys[r, :c], ys_ref),
                               ("u_sq", u_sq[r, :c], u_sq_ref)):
            diff = (a.to(torch.float64) - a_ref).abs().max()
            if not bool(torch.isfinite(a).all()):
                diff = float("inf")
            dev[name][0] = max(dev[name][0], float(diff))
            dev[name][1] = max(dev[name][1], float(a_ref.abs().max()))
    out = {"gain": gain}
    out.update({name: d / ref for name, (d, ref) in dev.items()})
    if np.array_equal(stats["scenarios"].numpy(), design_counts):
        out["stats"] = max(plain.rel_dev(stats[k], torch.stack(ref_stats[k]))
                           for k in STAT_KEYS)
    else:
        out["stats"] = float("inf")
    return out


def diagnostics(rec) -> dict:
    return {"sweeps": rec["sweeps"]}
