"""Config 5: the Re in [60, 150] parameter-sweep MPC at full scale on one
device: 8,192 scenarios drawn over 8 Reynolds buckets.

Counterpart of the JAX package's scripts/sweep_config5.py: a continuous
Re draw (seed 0) assigned to the nearest bucket, each bucket padded to a
multiple of 256 with masked rows; per bucket a linearization, a DRE gain
(matrix-free, 8 shifts x 16 ADI, rank 24) and its own steady-output
target y*; steppers from the Newton-Schulz chain (one f64 seed inverse
on the device, certified passes from bucket to bucket); the memory-lean
rollout (outputs and control energies only) and the masked statistics,
weighted by the real counts. Times the first and one warm sweep and
raises when an output is not finite or a statistic's count differs from
the draw. Run:

    python -m optconpy_tpu_torch.scripts.sweep_config5 [--out FILE]
"""
from __future__ import annotations

import numpy as np
import torch

from ..fem.device_conv import ConvKernel, FusedConvKernel
from ..models.cylinder import cylinder_setup
from ..parallel.param_sweep import (
    assign_re_buckets,
    build_sweep_gains_and_caches,
    masked_sweep_stats,
    sweep_layout,
    sweep_rollout,
)
from ._common import cli_main, clock, log

RE_RANGE, R_BUCKETS = (60.0, 150.0), 8
S_TOTAL = 8192
PAD = 256
REFINEMENT = 1
DT = 0.005
NTS = 200
NTS_GAIN = 8
ALPHA = 1e-2
SEED = 0
PERTURBATION = 1e-3
GAINS = dict(num_shifts=8, n_adi=16, r_max=24, solver="inverse_ns",
             dre_solver="matfree")


def run(device, *, setups=None, problem: str | None = None,
        re_range=RE_RANGE, buckets: int = R_BUCKETS, s_total: int = S_TOTAL,
        pad: int = PAD, nts: int = NTS, nts_gain: int = NTS_GAIN,
        dtype=torch.float32, log=log, arrays: dict | None = None) -> dict:
    """Config 5's sweep on `device`; returns the reference's SWEEP dict
    (and the first sweep's seconds, the per-bucket stage records of the
    gains, the peak device memory).

    setups: one (np_ops with vbar_full, sys, cond) per bucket of another
    problem with its `problem` name (tests pass small ones); by default
    the cylinder at refinement 1 for each bucket's Re. live_device_array_gib
    is torch.cuda.memory_allocated after the sweep: the bytes of the live
    tensors on the card, not the caching allocator's reserve (None on
    the CPU). arrays, when given, receives the setups, the convection,
    the stacked steppers, the gains ks, v0, the mask, y*, the warm
    sweep's ys and u_sq, the statistics, the counts and the gains'
    info.
    """
    device = torch.device(device)
    stamp = clock(device)
    cuda = device.type == "cuda"
    re_buckets = np.linspace(*re_range, buckets)
    log(f"Re buckets: {re_buckets}")

    # Continuous Re draw -> nearest bucket: the buckets get their real
    # unequal counts, padded to one width with mask-0 rows, and every
    # statistic is weighted by the real counts.
    rng = np.random.default_rng(SEED)
    re_draw = rng.uniform(*re_range, s_total)
    layout = sweep_layout(assign_re_buckets(re_draw, re_buckets), buckets,
                          pad)
    counts, s_max = layout.counts, layout.s_max
    log(f"scenario draw per bucket {counts}; S_max (padded) {s_max}")

    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    t0 = stamp()
    if setups is None:
        setups = [cylinder_setup(re=float(re), refinement=REFINEMENT,
                                 device=device, dtype=torch.float64)
                  for re in re_buckets]
        problem = f"cylinder_sweep_ref{REFINEMENT}"
    if len(setups) != buckets:
        raise ValueError(f"{len(setups)} setups for {buckets} buckets")
    t_setup = stamp() - t0
    np0, sys0, cond0 = setups[0]
    n = sys0.n
    log(f"setups {t_setup:.1f}s: n={n} x {buckets} buckets")

    # One convection evaluator for every bucket (same mesh and boundary
    # values), built before the gains: the 'inverse_ns' stepper tier
    # re-linearizes each bucket through it.
    conv_cls = FusedConvKernel if dtype == torch.float32 else ConvKernel
    conv = conv_cls.build(np0["full"], cond0, device=device, dtype=dtype)
    sysd = sys0.to(dtype=dtype)

    info = {}
    t0 = stamp()
    cache_stack, ks = build_sweep_gains_and_caches(
        setups, DT, ALPHA, dtype=dtype, nts_gain=nts_gain, conv=conv,
        info=info, **GAINS)
    t_gains = stamp() - t0
    ns_res = info["ns_residuals"]
    log(f"per-bucket gains and steppers {t_gains:.1f}s (NS chain "
        f"residuals {['%.1e' % r for r in ns_res]})")

    # Each bucket tracks its own steady output.
    ystar = torch.stack([
        s[1].c @ torch.as_tensor(s[2].restrict(s[0]["vbar_full"])).to(device)
        for s in setups]).to(dtype)
    # The real scenarios of the draw start at their bucket's steady state
    # plus a perturbation; padded rows repeat the steady state with mask
    # 0 (they compute but never enter a statistic).
    v0_np = np.empty((buckets, s_max, n))
    for r, (np_ops, _, cond) in enumerate(setups):
        v0_np[r] = cond.restrict(np_ops["vbar_full"])[None]
        c = int(counts[r])
        v0_np[r, :c] += PERTURBATION * rng.standard_normal((c, n))
    v0 = torch.as_tensor(v0_np, dtype=dtype).to(device)
    mask = torch.as_tensor(layout.mask, dtype=dtype).to(device)

    def sweep():
        ys, u_sq, _ = sweep_rollout(sysd, conv, cache_stack, ks, v0, ALPHA,
                                    DT, nts)
        return ys, u_sq, masked_sweep_stats(ys, u_sq, ALPHA, DT, ystar, mask)

    t0 = stamp()
    sweep()
    t_first = stamp() - t0
    t0 = stamp()
    ys, u_sq, stats = sweep()
    t_sweep = stamp() - t0
    solves = int(counts.sum()) * nts  # real solves only
    computed = buckets * s_max * nts  # padding included
    log(f"sweep first {t_first:.2f}s, warm {t_sweep:.2f}s -> "
        f"{solves / t_sweep:.0f} real solves/s ({computed / t_sweep:.0f} "
        "padded)")
    if not bool(torch.isfinite(ys).all()):
        raise RuntimeError("non-finite sweep outputs")
    stat_counts = stats["scenarios"].cpu().numpy()
    if not np.array_equal(stat_counts, counts.astype(float)):
        raise RuntimeError(f"statistics count {stat_counts.tolist()} "
                           f"scenarios, the draw {counts.tolist()}")
    mean_cost = stats["mean_cost"].double().cpu().numpy()
    err_t = stats["tracking_err_T"].double().cpu().numpy()
    for r, re in enumerate(re_buckets):
        log(f"  Re={re:.1f}: {int(stat_counts[r])} scenarios, tracking cost "
            f"{mean_cost[r]:.3e}, terminal err {err_t[r]:.3e}")
    live = torch.cuda.memory_allocated(device) / 2**30 if cuda else None
    if arrays is not None:
        arrays.update(setups=setups, conv=conv, cache_stack=cache_stack,
                      ks=ks, v0=v0, mask=mask, ystar=ystar, ys=ys, u_sq=u_sq,
                      stats=stats, counts=counts, info=info)
    return {
        "config": 5,
        "problem": problem,
        "n_state": int(n),
        "re_range": [float(r) for r in re_range],
        "re_buckets": [float(r) for r in re_buckets],
        "scenarios_total": int(counts.sum()),
        "scenarios_per_bucket": [int(c) for c in counts],
        "s_max_padded": s_max,
        "horizon_steps": nts,
        "nts_gain": nts_gain,
        "solves_per_s": solves / t_sweep,
        "padded_solves_per_s": computed / t_sweep,
        "sweep_s": t_sweep,
        "first_sweep_s": t_first,
        "setup_s": t_setup,
        "gains_s": t_gains,
        "gains_per_bucket": info["buckets"],
        "tracking_cost_per_bucket": [float(c) for c in mean_cost],
        "terminal_err_per_bucket": [float(e) for e in err_t],
        "live_device_array_gib": live,
        "peak_device_memory_gb": (
            torch.cuda.max_memory_allocated(device) / 1e9 if cuda else None),
        "stepper_tier": GAINS["solver"],
        "ns_chain_residuals": [float(r) for r in ns_res],
        "setup_note": (
            "stepper tier is the Newton-Schulz inverse chain: one f64 "
            "seed inverse of bucket 0's stepper saddle on the device, then "
            "certified NS passes (two GEMMs each) from each bucket's "
            "inverse to the next, every bucket's L1 re-linearized on the "
            "device through the shared convection evaluator"),
        "finite": True,
        "device": (torch.cuda.get_device_name(device) if cuda
                   else str(device)),
    }


def main(argv=None) -> dict:
    return cli_main(run, __doc__.splitlines()[0], argv)


if __name__ == "__main__":
    main()
