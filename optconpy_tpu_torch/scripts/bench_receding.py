"""Config 4: the cylinder-wake Re=100 receding-horizon macro loop, 1024
batched scenarios on one device.

Counterpart of the JAX package's scripts/bench_receding.py: the real
macro loop (re-linearize about the batch mean, rebuild or refresh the
solver caches, warm-started DRE gain update, apply window), not the
frozen-gain rollout of the bench. Three variants of mpc.receding, each
a warm-up call and then a timed call with profile=True:

  full      matfree tier, every cache rebuilt and the full ADI schedule
            every macro (the reference's full-rebuild variant);
  fast      matfree tier, caches refreshed, 8 ADI on warm macros;
  dense_ns  the Newton-Schulz-refreshed dense DRE stack (the headline).

Reports s/macro with the breakdown {rebuild, dre, probe, stepper_join,
rollout}, the steady macros' s/macro, the perturbation decay (which
must be below 1), the fast-vs-full and dense_ns-vs-full gain deviations
and the speedups over the full rebuild. The device's idle time is the
device trace's to give (utils.profiling.trace). Run:

    python -m optconpy_tpu_torch.scripts.bench_receding [--out FILE]
"""
from __future__ import annotations

import numpy as np
import torch

from ..fem.device_conv import ConvKernel, FusedConvKernel
from ..models.cylinder import cylinder_setup
from ..mpc import RHConfig, receding_horizon_mpc
from ..riccati import dre_shift_schedule_dae
from ._common import cli_main, clock, log

RE = 100.0
REFINEMENT = 1
S_BATCH = 1024
N_MACRO = 6
WARMUP = 2
DT = 0.005
ALPHA = 1e-2
NUM_SHIFTS, N_ADI = 8, 16
PERTURBATION, SEED = 1e-3, 0
RH = dict(horizon=8, apply=8, dt=DT, alpha=ALPHA, n_newton=1, r_max=32)
VARIANTS = {
    "full": dict(solver="matfree", refresh_caches=False),
    "fast": dict(solver="matfree", refresh_caches=True, warm_n_adi=8),
    "dense_ns": dict(solver="dense_ns", refresh_caches=True, warm_n_adi=8),
}
STAGES = ("rebuild", "dre", "probe", "stepper_join", "rollout")
STEADY_FROM = 2  # the steady macros: 2 onward


def configs() -> dict:
    """The RHConfig of each variant."""
    return {name: RHConfig(**RH, **kw) for name, kw in VARIANTS.items()}


def _gain_dev(ks, ks_ref) -> float:
    return float((ks.double() - ks_ref.double()).abs().max()
                 / ks_ref.double().abs().max())


def run(device, *, ops=None, problem: str | None = None,
        n_macro: int = N_MACRO, warmup: int = WARMUP,
        s_batch: int = S_BATCH, dtype=torch.float32,
        variants=tuple(VARIANTS), log=log,
        arrays: dict | None = None) -> dict:
    """Config 4's receding-horizon benchmark on `device`; returns the
    reference's RECEDING dict (the dense_ns record at the top level,
    matfree_refresh_variant, full_rebuild_variant, the gain deviations
    and speedups), each variant's record also with its per-macro
    timings and solve records, its peak device memory, and `device`.

    ops: (np_ops with vbar_full, sys, cond) of another setup with its
    `problem` name (tests pass a small one). Each variant warms up with
    `warmup` macros (the full rebuild with at most 1: it has no refresh
    to warm), then runs n_macro >= 3 macros timed. Raises RuntimeError
    naming the variant when a state is not finite or the perturbation
    does not decay. arrays, when given, receives each variant's ks and
    vs, the initial batch v0 (f64, host) and the shift schedule.
    """
    if n_macro <= STEADY_FROM:
        raise ValueError(f"n_macro must exceed {STEADY_FROM} (the steady "
                         f"macros are {STEADY_FROM} onward), got {n_macro}")
    unknown = set(variants) - set(VARIANTS)
    if unknown:
        raise ValueError(f"unknown variants {sorted(unknown)}")
    device = torch.device(device)
    stamp = clock(device)
    cuda = device.type == "cuda"
    t0 = stamp()
    if ops is None:
        ops = cylinder_setup(re=RE, refinement=REFINEMENT, device=device,
                             dtype=torch.float64)
        problem = f"cylinder_re{int(RE)}_ref{REFINEMENT}"
    np_ops, sys64, cond = ops
    sysd = sys64.to(dtype=dtype)
    conv_cls = FusedConvKernel if dtype == torch.float32 else ConvKernel
    conv = conv_cls.build(np_ops["full"], cond, device=device, dtype=dtype)
    n = sysd.n
    log(f"setup {stamp() - t0:.1f}s: n={n}")

    sched = dre_shift_schedule_dae(np_ops["A"], np_ops["M"], np_ops["J"], DT,
                                   num_shifts=NUM_SHIFTS, n_adi=N_ADI)
    vbar_np = cond.restrict(np_ops["vbar_full"])
    rng = np.random.default_rng(SEED)
    v0_np = vbar_np[None] + PERTURBATION * rng.standard_normal((s_batch, n))
    v0 = torch.as_tensor(v0_np, dtype=dtype).to(device)
    vbar = torch.as_tensor(vbar_np).to(device)
    if arrays is not None:
        arrays.update(v0=v0_np, sched=sched)
    cfgs = configs()

    def run_variant(name):
        cfg = cfgs[name]
        args = (sysd, conv, np_ops, cond, cfg, *sched, v0)
        n_warm = min(warmup, 1) if name == "full" else warmup
        t0 = stamp()
        if n_warm:
            receding_horizon_mpc(*args, n_macro=n_warm)
        log(f"[{name}] warm-up ({n_warm} macros) {stamp() - t0:.1f}s")
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        t0 = stamp()
        out = receding_horizon_mpc(*args, n_macro=n_macro, profile=True)
        t_total = stamp() - t0
        vs = out["vs"]
        if not bool(torch.isfinite(vs).all()):
            raise RuntimeError(f"[{name}] non-finite states in the macro "
                               "loop")
        tm = out["timings"]
        mean = {k: float(np.mean([t[f"{k}_s"] for t in tm]))
                for k in STAGES + ("total",)}
        for i, t in enumerate(tm):
            log(f"[{name}] macro {i}: "
                + ", ".join(f"{k} {t[f'{k}_s']:.2f}s" for k in STAGES)
                + f", total {t['total_s']:.2f}s")
        d = (vs[:, [0, -1]].double() - vbar).norm(dim=2).mean(dim=0)
        d0, d_t = float(d[0]), float(d[1])
        # Acceptance: the controlled batch decays toward the (unstable
        # at Re=100) steady wake.
        if not d_t < d0:
            raise RuntimeError(f"[{name}] the perturbation does not decay: "
                               f"dT {d_t:.4e} >= d0 {d0:.4e}")
        steady = float(np.mean([t["total_s"] for t in tm[STEADY_FROM:]]))
        rec = {
            "s_per_macro_step": mean["total"],
            "steady_state_s_per_macro": steady,
            "macro_steps_per_s": 1.0 / mean["total"],
            "breakdown_s": {k: mean[k] for k in STAGES},
            "perturbation_decay": d_t / d0,
            "wall_total_s": t_total,
            "warmup_macros": n_warm,
            "timings": tm,
            "macros": out["macros"],
            "peak_device_memory_gb": (
                torch.cuda.max_memory_allocated(device) / 1e9 if cuda
                else None),
        }
        log(f"[{name}] {rec['s_per_macro_step']:.3f} s/macro (steady "
            f"{steady:.3f}), decay {rec['perturbation_decay']:.4f}")
        return rec, out

    recs, ks = {}, {}
    for name in VARIANTS:
        if name not in variants:
            continue
        recs[name], out = run_variant(name)
        ks[name] = out["ks"]
        if arrays is not None:
            arrays[name] = {"ks": out["ks"], "vs": out["vs"]}
        del out

    def dev(a, b):
        return _gain_dev(ks[a], ks[b]) if a in ks and b in ks else None

    def speedup(key):
        if "full" in recs and "dense_ns" in recs:
            return recs["full"][key] / recs["dense_ns"][key]
        return None

    gain_dev, gain_dev_dense = dev("fast", "full"), dev("dense_ns", "full")
    if gain_dev is not None or gain_dev_dense is not None:
        log(f"fast-vs-full gain rel dev {gain_dev}; dense_ns-vs-full "
            f"{gain_dev_dense}")
    cfg = cfgs["fast"]
    return {
        "config": 4,
        "problem": problem,
        "n_state": int(n),
        "scenarios": s_batch,
        "n_macro": n_macro,
        "horizon": cfg.horizon,
        "apply": cfg.apply,
        "solver": "dense_ns (headline) / matfree / full-rebuild",
        **recs.get("dense_ns", {}),
        "matfree_refresh_variant": recs.get("fast"),
        "full_rebuild_variant": recs.get("full"),
        "warm_n_adi": cfg.warm_n_adi,
        "gain_rel_dev_fast_vs_full": gain_dev,
        "gain_rel_dev_dense_ns_vs_full": gain_dev_dense,
        "speedup_vs_full_rebuild": speedup("s_per_macro_step"),
        "steady_speedup_vs_full_rebuild": speedup(
            "steady_state_s_per_macro"),
        "dtype": str(dtype).removeprefix("torch."),
        "device": (torch.cuda.get_device_name(device) if cuda
                   else str(device)),
    }


def main(argv=None) -> dict:
    return cli_main(run, __doc__.splitlines()[0], argv)


if __name__ == "__main__":
    main()
