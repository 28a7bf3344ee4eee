#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port's main paths on one NVIDIA GPU.

Drives optconpy_tpu_torch (never jax) through the entry points a user
calls. Bench shape (phases 3-6, 8): cylinder wake Re=100, refinement 1
(n=4396), 6 Wachspress shifts, 32 ADI iterations, rank 32, 6 DRE steps,
one Newton step, dt=0.005, alpha=1e-2, 1024 scenarios x 64 closed-loop
steps with the t=0 gain broadcast and no feedforward. Config 3 (phases
7, 9): cylinder wake Re=60, refinement 2 (n=15,316, n_p=2,080), dt=0.01,
alpha=1e-4, 8 shifts, 16 ADI iterations, rank 40, 16 DRE steps, one
Newton step, gains from the Newton-Schulz (NS) inverse stack built on
the card. Phases:

  1. require a CUDA card; print its name and power limit;
  2. build the kernels from optconpy_tpu_torch/csrc/ (one nvcc each);
  3. convection kernel on the free-dof contract (n_free, B) vs its
     plain torch version at B=1024 and B=3 (<= 1e-5), timed beside the
     bound and the replaced kernel's time;
  4. DRE gains in f32 and f64 on the card from one f64 host splu stack
     (f32-vs-f64 gain deviation <= 1e-4); every step's f32 factors
     certified by scripts/validate_gains.py (projected DRE residual, host
     f64, below the GAINQ bound 1e-3; one Leray projector for the six);
  5. the fused closed loop through the convection kernel: one launch per
     step, finite outputs, TF32 off, solves/s from warm runs; a
     torch.profiler listing of one step (one convection kernel, no
     index_put, gather or copy beside it) and the kernel split of a warm
     rollout;
  6. in-run f64 check of 2 scenarios on the CPU with the plain versions
     (closed-loop output deviation <= 1e-4);
  7. SpMM kernel vs its plain torch version on the config-3 NS pencil
     (Atil^T, M, J, J^T) at B = 17,396, 8 and 1, f32 (<= 1e-5) and f64
     (<= 1e-12), timed beside torch.sparse.mm, the bound and the
     replaced kernel's time; (b) the Arnoldi step's MGS kernel vs its
     plain loop over 30-step cycles at config 3's saddle (n = 17,396),
     q = 4, 46 and 1,024 in f32 (<= 2e-5) and 46 in f64 (<= 1e-12), and
     at the bench shape's saddle q = 3 in f64 (phase 11 (a)'s stepper),
     a cycle's time beside the plain loop's and its bytes bound;
  8. the f32 NS stack at the bench shape's 6 shifts through the SpMM
     kernel: (a) the reference's ladder (build_dre_cache_dae_ns); (b)
     build_inverse_stack_ns with keep_full=True on the ladder NS_LADDER
     (rung ratio 2.0, 4 passes a rung, 2 at a shift, M^-1 to 5e-3): every
     shift certified, the full stack's velocity block in the original
     order bit-equal to the stack, K2 vs its plain version on the
     ladder's inputs (<= 1e-5, repeats bit for bit); for each, the
     per-shift deviation from phase 4's host stack and the gains vs
     phase 4's f64 gains (each <= 1e-4), its rungs, passes, seconds and
     K2 launches;
  9. config 3 with the shift interval of scripts/config3_cylinder.py
     (the coarse mesh's projected bottom, the fine mesh's ARPACK top):
     the f64 NS stack certified at 1e-8 and its DRE sweep,
     then the f32 stack at certify_tol 5e-4 (each shift's probe
     evaluated in f32 and in f64; the f64 one certifies) and its sweep
     (first and warm); |JZ|/|Z| <= 1e-5 and the projected DRE residual at
     steps 0 and 8 <= 1e-2 (host f64, one Leray projector for phases 9
     and 11 (b)); f32-vs-f64 gain deviation <= 1e-4;
 10. the user's entry point, optconpy_tpu_torch.optcont.optcon_nse:
     (a) config 4 (the bench shape with a feedforward and a gain for
     every one of 64 steps, y* = steady output + 0.01) in f32 on the
     fused step tier with Newton-Schulz gains, 1024 scenarios: every
     shift certified, K2 launched in the DRE stage and K1 exactly 64
     times in the rollout, finite outputs, TF32 off; (b) the same config
     in f64 on the first 2 scenarios: f32 vs f64 gains and outputs
     <= 1e-4; (c) configs 1 (heat1d) and 2 (driven cavity) on the lu
     tiers on the card against device="cpu" (<= 1e-10). Each run's stage
     seconds and closed-loop solves/s are printed; (d) the lu tiers on the
     card against the port's dense f64 golden (golden/dense_lqr.py) on
     the systems of the reference's oracle tests: the cavity (nx=6, 30
     steps; its ker-J reduced golden) and heat1d (n=64, 50 steps), DRE
     factors and gains <= 1e-5, closed-loop v, u, y <= 1e-4;
 11. the matrix-free tier (block-Jacobi / pressure-Schur FGMRES over the
     SpMM kernel), run beside the phases whose inputs it shares:
     (a) after phase 8, at the bench shape in f64: 12 ADI iterations
     through SaddleMatfreeCache (tol 1e-11) vs the same iterations
     through phase 4's host inverse stack (<= 1e-6), and the matrix-free
     stepper (tol 1e-12) vs the lu stepper, 3 scenarios x 6 steps in both
     feedback modes (v, u, y <= 1e-7); (b) after phase 9, the rest of
     scripts/config3_cylinder.py in f32 at full width: the matrix-free
     DRE sweep at 12 shifts (FGMRES tol 1.05e-4, 8 cycles), first and 1
     warm repeat (the script's 3 cut for time), vs phase 9's f64 NS
     gains (<= 1e-3) and its f32 NS gains (the script's parity,
     printed), the projected DRE residual at step 0 (<= 1e-2), the CPU splu ADI baseline (12 factors, median of
     3, load average), K1 at B=16 vs plain (<= 1e-5), and the matrix-free
     closed loop from phase 9's f32 NS gain, 16 scenarios x 100 steps,
     implicit feedback, controlled and uncontrolled (energy ratio at T <
     0.5, K1 101 launches a rollout), with profiler listings of one ADI
     solve and one rollout step; (c) inside phase 10, the cavity on the
     matrix-free step and DRE tiers over 1 of its 20 steps, card vs CPU
     (<= 1e-8);
     (d) after phase 3,
     QuadConvKernel at B=1024 in f32 (4 SpMM launches a call) vs
     ConvKernel's plain version (<= 1e-5), timed beside K1;
 12. receding-horizon MPC (mpc/receding.py), after phase 11 (a): (a)
     scripts/bench_receding.run, config 4's macro loop (8 shifts, 16 ADI,
     horizon 8, apply 8, 1024 scenarios, f32, K1 in the rollout) in the
     script's three variants: full (the matfree tier with every cache
     rebuilt and the full ADI schedule every macro), fast (refreshed
     FGMRES caches, 8 ADI on warm macros) and dense_ns (the NS-refreshed
     dense DRE stack, every refresh certified in f64 at 5e-4); 3 macros
     after a 2-macro warm-up (the full rebuild's: 1), whose every SpMM
     input, a (pack, width, dtype) at a time, is held against the plain
     version (<= 1e-5 f32 and 1e-12 f64, repeats bit for bit), and whose
     first K1 input too (<= 1e-5): each variant's s/macro, steady
     s/macro, breakdown by stage, perturbation decay (< 1), K1 and K2
     launches by macro and stage, peak memory, the refresh residuals or
     FGMRES records of each macro; fast vs full,
     dense_ns vs full and dense_ns vs fast gains on every macro (<= 1e-4);
     the speedups of dense_ns over the full rebuild;
     dense_ns in f64 for the first 2 macros on the same scenarios: gains
     and outputs C v (<= 1e-4). (b) the lu tier on the reference test's
     cavity, card vs CPU (vs, us, ks <= 1e-10);
 13. the config-5 Re-bucket parameter sweep through
     scripts/sweep_config5.run at its shape: 8 buckets over Re 60-150,
     8,192 drawn Re values (seed 0) in ragged buckets padded to 1,280,
     200 steps, f32, TF32 off; per-bucket gains (matrix-free DRE, 8
     shifts x 16 ADI, rank 24; 4 steps of the script's 8) and the
     Newton-Schulz stepper chain, every bucket certified in f64 at 1e-4
     (every SpMM input the gains and the chain hand the kernel held
     against its plain version, a repeat bit for bit); the first and last
     bucket's f32 gains vs f64 NS-tier gains (<= 1e-4); the script's
     first and one warm sweep (bit-equal outputs), real and padded
     solves/s, peak and live memory, launches (K1 one a step, K2 none);
     K1 on the sweep's own first-step X at B = 10,240 vs plain (<= 1e-5,
     repeats bit for bit); the script's masked statistics (exact counts,
     finite, unchanged with NaN padded rows) beside SWEEP_r05.json's (the
     JAX package on a TPU, labelled so); the f32 sweep vs f64 on the
     host-LU stepper tier for 2 real scenarios of the first and last
     bucket (<= 1e-4), and the same scenarios in f32 on f32 host-LU
     steppers (<= 1e-4; K1 one launch a step) beside f32 host-inverse
     steppers (printed: the f32 gaps without the chain's inverses); a
     profiler listing of a warm sweep (GEMM and K1 shares,
     device busy, no copy kernel a step);
 14. (a) config 3XL through scripts/config3xl_cylinder.run at the
     reference's shape (refinement 3, n=31,282, n_p=4,145, 8 shifts, 4 DRE
     steps x 16 ADI, rank 40, FGMRES tol 5e-5, f32): |JZ|/|Z| <= 1e-4, the
     projected DRE residual at steps 0 and 2 <= 1e-2, a finite 8 x 20
     closed loop, FGMRES records, warm ADI iters/s, the CPU splu baseline,
     peak memory; K1 and K2 held against their plain versions on the
     path's own inputs (<= 1e-5, repeats bit for bit). (b) the scenario
     sharding (parallel/): a world-size-1 NCCL group on the card runs
     sharded_nse_rollout on phase 5's fused stepper (ys bit-equal to
     phase 5's, statistics equal to phase 5's outputs') and, after phase
     13, sharded_sweep_rollout on its buckets (ys bit-equal to its warm
     sweep, statistics equal to masked_sweep_stats); then the dry run
     (parallel/dryrun.py) on 2 spawned gloo ranks sharing the card, whose
     statistics must agree across the ranks;
 15. (a) solve_are_stabilized (riccati/are.py: the reduction onto ker J,
     the Bernoulli initial gain, Newton-ADI from it) on the unstable
     cavity of tests/test_bernoulli_are.py (f64, lu tier, the reference's
     8 shifts x 24 ADI, 8 Newton steps, rank 40), card vs CPU (<= 1e-10)
     and vs the dense reduced CARE golden of golden_are (< 1e-6), 2 unstable modes, the
     converged gain Hurwitz; the dt=inf DRE step residual checked to be
     the projected ARE residual; (b) the Re=60 wake (refinement 1,
     n=4396): the reduction, the Bernoulli K0 (2 unstable modes, Hurwitz)
     and the closed-loop interval timed on the host, then the same solve
     on the lu tier in f64 and f32 and the matfree tier in f32 (K2 on every
     FGMRES operator product, held against its plain version on the
     path's inputs): each gain's reduced closed loop Hurwitz, lu f32 vs
     f64 <= 1e-4, matfree vs lu <= 10x the FGMRES tol, the projected ARE
     residuals, the FGMRES record, stage times and peak memory; (c)
     scripts/bench_precision.run at 1024 x 64 and the 500-step horizon
     curve: 'highest' (strict FP32) <= 1e-4 from f64 at every horizon,
     'high' (TF32) and 'default' (bf16-rounded operands, emulated, not
     timed) reported, K1 held on the run's first X, TF32 off afterwards;
     (d) after phase 6, the NaN sanitizer (setup(debug_nans=True)) raising
     on a CUDA 0/0 and on K1's NaN, NaN flowing with it off, and one
     fused step traced (utils.profiling.trace). Phase 15's stages are
     timed by utils.SectionTimer and summed at its end.

Every failed check raises, so the exit code is non-zero. The last three
lines are the kernels JSON (each kernel's launches on every path it
serves), the card's name and power limit, and
{"ok": true, "device": {...}}.

Usage: python3 chip_smoke.py
"""
from __future__ import annotations

import hashlib
import json
import statistics
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager

import numpy as np

RE = 100.0
REFINEMENT = 1
S_BATCH = 1024
NTS = 64
DT = 0.005
ALPHA = 1e-2
NTS_GAIN = 6
R_MAX = 32
N_SHIFTS = 6
N_ADI = 32
N_NEWTON = 1
SEED = 0
S_REF = 2  # scenarios of the in-run f64 check

KERNEL_TOL = 1e-5  # f32 kernel vs f32 plain version, relative
GAIN_TOL = 1e-4  # f32 vs f64 gains, relative (the reference's GAINQ bound)
ROLLOUT_TOL = 1e-4  # f32 closed-loop outputs vs the f64 recurrence

# Config 3 (scripts/config3_cylinder.py:29-37, 148 of the JAX package).
C3_RE = 60.0
C3_REFINEMENT = 2
C3_DT = 0.01
C3_ALPHA = 1e-4
C3_SHIFTS = 8
C3_ADI = 16
C3_R_MAX = 40
C3_NTS = 16
C3_CERTIFY_F64 = 1e-8
C3_CERTIFY_F32 = 5e-4  # the reference's certify_tol
FEAS_TOL = 1e-5  # |J Z| / |Z| of the f32 factors (the reference's bound)
DRE_RES_TOL = 1e-2  # projected DRE step residual (the reference's bound)
SPMM_TOL = {"float32": 1e-5, "float64": 1e-12}  # kernel vs plain, relative
# Phase 7 (b): the MGS kernel vs its plain loop, relative; the sums run in
# another order (by block, then across blocks), so rounding only.
MGS_TOL = {"float32": 2e-5, "float64": 1e-12}
# Phase 8 (b): a Newton-Schulz ladder other than the reference's defaults
# (rung ratio 1.6, 3 passes a rung, 1 at a shift, M^-1 to 1e-2).
NS_LADDER = dict(rung_ratio=2.0, passes_per_rung=4, extra_passes_at_shift=2,
                 minv_tol=5e-3)

# Phase 10: the driver. Config 4 is the bench shape through optcon_nse,
# with a gain and a feedforward for every step, explicit feedback as the
# bench's loop; (b) repeats it in f64 on the first S_REF scenarios.
YSTAR_AMP = 0.01
DRIVER_TOL = 1e-10  # lu tiers, card vs CPU, f64
# (d) the lu tiers against the dense golden, on the systems and at the
# bounds of the reference's oracle tests: tests/test_cavity_lqr.py:35-38
# (config 2) and tests/test_heat_lqr.py:33-46 (config 1).
GOLDEN_CAVITY = dict(nx=6, alpha=1e-2, nts=30, dt=0.02)
GOLDEN_HEAT = dict(n=64, alpha=1e-4, nts=50, dt=1.0 / 50)
GOLDEN_DRE_TOL = 1e-5  # DRE factors and gains (test_cavity_lqr.py:170)
GOLDEN_LOOP_TOL = 1e-4  # closed-loop v, u, y (test_cavity_lqr.py:205-206)

# Phase 11: the matrix-free tier. (a) at the bench shape in f64 against
# the dense tiers (the reference's tests/test_matfree.py bounds); (b) at
# config 3 in f32 (scripts/config3_cylinder.py: FGMRES tolerance a
# quarter of the ADI truncation floor 4.2e-4, 8 cycles in the DRE and 10
# in the rollout, 16 scenarios x 100 steps, energy ratio < 0.5); (c) the
# cavity driver on the matrix-free tiers, card vs CPU.
MATFREE_WIDTHS = (46, 16, 4)  # the ADI block p + r_max + m, the rollout, SMW
MF_BLOCK = 512
MF_ADI_ITERS = 12
MF_ADI_TOL, MF_ADI_DEV = 1e-11, 1e-6  # FGMRES tolerance, vs the inverse stack
MF_ADI_CYCLES = 20
MF_STEP_TOL, MF_STEP_CYCLES, MF_STEP_DEV = 1e-12, 15, 1e-7
MF_STEP_S, MF_STEP_NTS = 3, 6
C3_FGMRES_TOL = 4.2e-4 / 4.0
C3_DRE_CYCLES, C3_ROLL_CYCLES = 8, 10
C3_MF_SHIFTS = 12  # the script's matrix-free tier (config3_cylinder.py:36)
C3_MF_WARM = 1  # warm repeats of the 12-shift sweep (the script: 3)
C3_ROLL_S, C3_ROLL_NTS = 16, 100
MF_GAIN_TOL = 1e-3  # f32 matrix-free vs f64 NS gains: 10x the FGMRES tol
ENERGY_RATIO_MAX = 0.5
MF_DRIVER_TOL = 1e-8  # cavity matfree tiers, card vs CPU, f64
MF_DRIVER_FGMRES = 1e-11
MF_DRIVER_NTS = 1  # of config 2's 20 steps

# Phase 12: receding-horizon MPC, config 4, through
# scripts/bench_receding.run at the shape of RECEDING_r05.json: 8 shifts,
# 16 ADI iterations (8 on warm macros of the refreshed variants), horizon
# 8, apply 8, one Newton step, rank 32, 1024 scenarios, the script's three
# variants; 3 macros (the script's 6, cut for time since phase 15) after a
# 2-macro warm-up call (the full rebuild's 1: it has no refresh to warm).
RH_SHIFTS, RH_ADI = 8, 16
RH_CFG = dict(horizon=8, apply=8, dt=DT, alpha=ALPHA, n_newton=1, r_max=32)
RH_MACROS, RH_WARMUP, RH_F64_MACROS = 3, 2, 2
RH_GAIN_TOL = 1e-4  # fast, dense_ns vs full and dense_ns vs fast, every macro
RH_NS_CERTIFY = 5e-4  # every NS refresh, evaluated in f64
# (b) the lu tier: the cavity of tests/test_receding_mpc.py:21-28 and its
# 3-macro config (:55), 4 scenarios, f64, card vs CPU.
RH_LU_CFG = dict(horizon=8, apply=4, dt=0.02, alpha=1e-8, r_max=24)
RH_LU_TOL = 1e-10

# Phase 13: the config-5 parameter sweep through scripts/sweep_config5.run
# at its shape (SWEEP_r05.json): 8 Re buckets over [60, 150], 8,192 Re
# values drawn uniformly (seed 0) and assigned to the nearest bucket, each
# bucket padded to a multiple of 256; gains from 4 DRE steps (the
# script's 8, cut for time since phase 15) of 16 ADI iterations (8
# shifts, rank 24, one Newton step) on the matrix-free tier, steppers from
# the Newton-Schulz chain certified at 1e-4, 200 steps, f32; the script's
# first and one warm sweep. The f64 check runs the first and the last
# bucket's first 2 real scenarios on the host-LU stepper tier.
SW_RE = (60.0, 150.0)
SW_BUCKETS = 8
SW_SCENARIOS = 8192
SW_PAD = 256
SW_NTS = 200
SW_GAINS = dict(num_shifts=8, n_adi=16, nts_gain=4, r_max=24)
SW_CERTIFY = 1e-4
SW_REF_S = 2
SW_RECORD = "SWEEP_r05.json"  # the JAX package's run on a TPU v5 lite

# Phase 14: (a) config 3XL at the shape of scripts/config3xl_cylinder.py
# (its module's constants); (b) the sharding: world size 1 on the card
# through NCCL, then the dry run on DRY_RANKS gloo ranks sharing it.
XL_N, XL_NP = 31282, 4145
DRY_RANKS = 2
DRY_TIMEOUT_S = 300

# Phase 15: (a) the stabilized ARE on tests/test_bernoulli_are.py's
# unstable cavity (nx=5, A + c M with 2 unstable ker-J modes; f64, lu
# tier, the reference's defaults 8 shifts, 24 ADI, 8 Newton steps, rank
# 40), card vs CPU and vs the dense reduced CARE golden; (b) the wake at
# Re=60, refinement 1, the same defaults on the lu tier in f64 and f32
# and the matfree tier in f32; (c) scripts/bench_precision.py at its
# shape; (d) the NaN sanitizer, the section timer and a profiler trace.
ARE_ALPHA = 1e-2
ARE_CARD_TOL = 1e-10  # cavity, card vs CPU, f64
ARE_GOLDEN_TOL = 1e-6  # vs the golden (test_bernoulli_are.py:71)
WAKE_RE, WAKE_REFINEMENT = 60.0, 1
WAKE_N, WAKE_NP = 4396, 641
WAKE_F32_TOL = 1e-4  # lu f32 vs f64 gains: the north-star gain bound
# The reference's defaults leave the wake's closed loop unstable: real
# shifts damp the Bernoulli closed loop's -0.195 +- 16.86i pair by about
# 1% an ADI iteration, so 24 iterations resolve little of it (max Re
# +0.026, ARE residual 0.90 on an H100); phase 15 (b) prints that run.
# The tiers run 192 iterations over shifts from WAKE_A_MIN up: the
# matrix-free preconditioner (block Jacobi, L_p pressure Schur) leaves
# FGMRES far above tol at |shift| < 3 (relres 0.90 at 0.33 after 20
# cycles, with the whole velocity block exact still 3.5e-4), and every
# tier solves with the same shifts (wake_are_knobs.py measures both).
# The matfree tier runs WAKE_MF_NEWTON Newton step against an lu f64 run
# of the same: at about 0.09 s an FGMRES solve, 8 steps (3,072 solves)
# would not fit the time limit.
WAKE_DEFAULTS = dict(n_shifts=8, n_adi=24, n_newton=8, r_max=40)
WAKE_ARE = dict(n_shifts=8, n_adi=192, n_newton=8, r_max=40)
WAKE_A_MIN = 20.0
WAKE_MF_NEWTON = 1
WAKE_MATFREE = dict(block=512, tol=1e-5, max_cycles=20)
PREC_TOL = 1e-4  # 'highest' vs f64 at every horizon: the rollout bound
TRACE_DIR = "data/profile"  # gitignored

# Times of the kernels this port replaced, on an NVIDIA H100 80GB HBM3 at
# 700 W (PERF.md), printed beside this run's: the first convection kernel
# at B=1024 (us) and the row-ELL SpMM at B = 17,396 (ms), and the host
# setup times with the native element library.
EARLIER_CONV_US = 106.3
EARLIER_SPMM_MS = {
    ("at", "float32"): 3.4616, ("m", "float32"): 2.0242,
    ("j", "float32"): 1.0503, ("jt", "float32"): 1.0580,
    ("at", "float64"): 5.7508, ("m", "float64"): 2.8947,
    ("j", "float64"): 2.8446, ("jt", "float64"): 1.1309,
}
EARLIER_SETUP_S = {"bench": 3.2, "config 3": 9.0}

# Peaks of one H100 SXM at 700 W (NVIDIA's data sheet): HBM3 bytes/s and
# non-tensor-core flop/s by type.
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


def rel_err(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def sync_time(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def event_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, flops: float, dtype: str):
    """Least time for the work on this card and what sets it."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def kernel_split(fn):
    """Run fn once under torch.profiler. Returns {kernel name: [calls,
    device us]} for the device activity it traced, the wall seconds of
    the window (fn ends in a synchronize) and the host's reads of device
    values in it (aten::_local_scalar_dense, each a synchronize)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows, host_reads = {}, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            row = rows.setdefault(e.name, [0, 0.0])
            row[0] += 1
            row[1] += e.time_range.elapsed_us()
        elif e.name == "aten::_local_scalar_dense":
            host_reads += 1
    return rows, wall, host_reads


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def fingerprint(*arrays) -> str:
    """First 12 hex digits of the sha256 of the arrays' bytes: equal
    fingerprints in two runs mean bit-equal values."""
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:12]


def pack_csr(a):
    """The pack's operator as a torch CSR tensor on its device, the
    yardstick's input: the entries it stores, without the zeros that pad
    each group to the union of its columns."""
    import torch

    from optconpy_tpu_torch.ops.spmm_kernel import GROUP

    counts = (a.eptr[1:] - a.eptr[:-1]).long()
    group = torch.repeat_interleave(
        torch.arange(counts.numel(), device=a.device), counts
    )
    rows = group[:, None] * GROUP + torch.arange(GROUP, device=a.device)
    cols = a.ecol.long()[:, None].expand(-1, GROUP)
    keep = a.evals != 0
    coo = torch.sparse_coo_tensor(
        torch.stack([rows[keep], cols[keep]]), a.evals[keep], a.shape,
        check_invariants=True,
    )
    return coo.coalesce().to_sparse_csr()


def spmm_phase(c3_ops, dev):
    """Phase 7: the SpMM kernel vs its plain version and torch.sparse.mm
    on the config-3 NS pencil's operators, at the NS width and the
    matrix-free tier's widths. Returns the JSON fields of Atil^T at the
    NS width in float32 (with its times at the matrix-free widths), and
    the largest absolute error."""
    import torch

    from optconpy_tpu_torch.ops import spmm_kernel
    from optconpy_tpu_torch.solvers.ns_inverse import SaddleOpsPack

    at_til = (c3_ops["A"].T - c3_ops["M"] / (2.0 * C3_DT)).tocsr()
    gen = torch.Generator(dev).manual_seed(SEED)
    props = torch.cuda.get_device_properties(dev)
    head, max_abs, narrow = None, 0.0, {}
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).removeprefix("torch.")
        pack, *_ = SaddleOpsPack.build(
            at_til, c3_ops["M"], c3_ops["J"], device=dev, dtype=dtype
        )
        nn = pack.n + pack.n_p
        for name in ("at", "m", "j", "jt"):
            a = getattr(pack, name)
            m_rows, n_cols = a.shape
            nnz = a.nnz
            lib_a = pack_csr(a)
            for b in (nn, 46, 16, 8, 4, 1):
                x = torch.randn((n_cols, b), generator=gen, dtype=dtype,
                                device=dev)
                y = spmm_kernel.spmm(a, x)
                ref = spmm_kernel.spmm_plain(a, x)
                torch.cuda.synchronize()
                err = rel_err(y, ref)
                abs_err = float((y - ref).abs().max())
                check(bool(torch.isfinite(y).all()), f"spmm {name} finite")
                check(err <= SPMM_TOL[dname],
                      f"spmm {name} B={b} {dname}: {err:.2e}")
                check(torch.equal(y, spmm_kernel.spmm(a, x)),
                      f"spmm {name} B={b} {dname} repeats bit for bit")
                max_abs = max(max_abs, abs_err)
                wide = b == nn
                k_ms = event_ms(lambda: spmm_kernel.spmm(a, x), 20)
                p_ms = event_ms(lambda: spmm_kernel.spmm_plain(a, x),
                                3 if wide else 20)
                l_ms = event_ms(lambda: torch.sparse.mm(lib_a, x), 20)
                lib_err = rel_err(torch.sparse.mm(lib_a, x), ref)
                check(lib_err <= SPMM_TOL[dname],
                      f"torch.sparse.mm {name} B={b} {dname}: {lib_err:.2e}")
                itemsize = x.element_size()
                bnd = bound_ms(
                    itemsize * (n_cols + m_rows) * b
                    + (itemsize + 4) * nnz + 4 * m_rows,
                    2 * nnz * b, dname,
                )
                earlier = (f"; replaced kernel "
                           f"{EARLIER_SPMM_MS[(name, dname)]:.4f} ms"
                           if wide else "")
                cpt = spmm_kernel.columns_per_lane(
                    a.eptr.shape[0] - 1, n_cols, b, x.element_size(),
                    x.data_ptr(), props.multi_processor_count,
                    props.L2_cache_size,
                )
                log(f"[7] spmm_tile {name} ({m_rows}x{n_cols}, nnz {nnz}, "
                    f"{cpt} columns a lane, {a.smem_bytes} B shared) "
                    f"B={b} {dname}: rel err {err:.2e} "
                    f"(abs {abs_err:.2e}, tol {SPMM_TOL[dname]:g}); kernel "
                    f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, torch.sparse.mm "
                    f"{l_ms:.4f} ms (rel err {lib_err:.1e}); bound "
                    f"{bnd[0]:.4f} ms ({bnd[1]}) = {bnd[0] / k_ms:.0%} of "
                    f"the kernel's time{earlier}")
                if name == "at" and b in MATFREE_WIDTHS and dtype == torch.float32:
                    narrow[b] = {"ms": k_ms, "library_ms": l_ms,
                                 "bound_ms": bnd[0], "bound_by": bnd[1]}
                if name == "at" and wide and dtype == torch.float32:
                    head = {
                        "ms": k_ms, "plain_ms": p_ms, "bound_ms": bnd[0],
                        "bound_by": bnd[1], "library_ms": l_ms,
                        "at": f"Atil^T {m_rows}x{n_cols} (nnz {nnz}) @ "
                              f"X {n_cols}x{b}, float32",
                    }
                del x, y, ref
        del pack
    head["at_matfree_widths"] = narrow
    return head, max_abs


def mgs_phase(n_c3: int, n_bench: int, dev):
    """Phase 7 (b): the Arnoldi step's MGS kernel vs its plain version
    over whole 30-step cycles, every step's H column and new basis vector
    (<= MGS_TOL), timed with CUDA events beside its bytes bound: each
    basis vector read once, w read once and v_{j+1} written once a step.
    At config 3's matrix-free saddle (n_c3) the gains cell's widths q = 4
    and 46 (float32; and float64 at 46) and q = 1,024 (float32, the
    streamed parameter set); at the bench shape's saddle (n_bench) phase
    11 (a)'s matrix-free stepper, q = MF_STEP_S in float64. Returns the
    JSON fields of q = 46 in float32 (with the others under "widths")."""
    import torch

    from optconpy_tpu_torch.ops import arnoldi_kernel as ak
    from optconpy_tpu_torch.solvers import krylov

    m = 30
    gen = torch.Generator(dev).manual_seed(SEED)
    out = {}
    for n, q, dtype in ((n_c3, 4, torch.float32), (n_c3, 46, torch.float32),
                        (n_c3, 46, torch.float64),
                        (n_c3, 1024, torch.float32),
                        (n_bench, MF_STEP_S, torch.float64)):
        dname = str(dtype).removeprefix("torch.")
        fac = krylov.BREAKDOWN_EPS * torch.finfo(dtype).eps
        r0 = torch.randn((n, q), generator=gen, dtype=dtype, device=dev)
        sb = r0.norm(dim=0).clamp_min(krylov.TINY)
        vs = torch.zeros((m + 1, n, q), dtype=dtype, device=dev)
        vs[0] = r0 / sb
        h = torch.zeros((m + 1, m, q), dtype=dtype, device=dev)
        ws = []
        for j in range(m):  # a Krylov basis of a banded nonsymmetric operator
            w = 2.5 * vs[j]
            w[1:] -= vs[j, :-1]
            w[:-1] -= 0.5 * vs[j, 1:]
            ws.append(w)
            ak.mgs_step_plain(vs, w, h, j, sb, fac)
        err = 0.0
        vk, hk = vs.clone(), h.clone()
        for j in range(m):
            ak.mgs_step(vk, ws[j], hk, j, sb, fac)
            torch.cuda.synchronize()
            err = max(err, rel_err(hk[:, j], h[:, j]),
                      rel_err(vk[j + 1], vs[j + 1]))
            vk[j + 1] = vs[j + 1]
            hk[:, j] = h[:, j]
        check(err <= MGS_TOL[dname],
              f"mgs_step n={n} q={q} {dname}: {err:.2e}")

        def cycle(step):
            for j in range(m):
                step(vk, ws[j], hk, j, sb, fac)

        k_ms = event_ms(lambda: cycle(ak.mgs_step), 5)
        p_ms = event_ms(lambda: cycle(ak.mgs_step_plain), 3)
        nbytes = sum(j + 3 for j in range(m)) * n * q * vs.element_size()
        flops = sum(4 * (j + 1) + 3 for j in range(m)) * n * q
        bnd = bound_ms(nbytes, flops, dname)
        grid, smem, onchip, vec = ak.plan(dev.index or 0, dtype, n, q)
        log(f"[7b] mgs_step n={n} q={q} {dname} (grid {grid}, {smem} B "
            f"shared, runs of {vec}, {'on chip' if onchip else 'streamed'}): "
            f"rel err "
            f"{err:.2e} (tol {MGS_TOL[dname]:g}); a 30-step cycle: kernel "
            f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {bnd[0]:.4f} ms "
            f"({bnd[1]}) = {bnd[0] / k_ms:.0%} of the kernel's time")
        out[f"n={n} q={q} {dname}"] = {
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": bnd[0],
            "bound_by": bnd[1], "onchip": onchip, "max_rel_err": err,
        }
        del vs, vk, h, hk, ws
    head = dict(out.pop(f"n={n_c3} q=46 float32"))
    head["at"] = f"a 30-step Arnoldi cycle, n={n_c3}, q=46, float32"
    head["widths"] = out
    return head


def bench_ns_phase(sys32, cache64, ks64, sig, sseq, iseq, pencil):
    """Phase 8: the f32 NS stack at the bench shape's shifts, built
    through the SpMM kernel, against phase 4's host f64 splu stack and
    its f64 gains: (a) through build_dre_cache_dae_ns (the reference's
    ladder); (b) through build_inverse_stack_ns on the same pencil
    (Atil^T, M, J) with keep_full=True and NS_LADDER. Returns K2's
    launches by path and its largest absolute error against its plain
    version on (b)'s inputs."""
    import torch

    from optconpy_tpu_torch.ops import spmm_kernel
    from optconpy_tpu_torch.riccati import (
        build_dre_cache_dae_ns,
        dre_backward_sweep,
    )
    from optconpy_tpu_torch.solvers.ns_inverse import build_inverse_stack_ns
    from optconpy_tpu_torch.solvers.saddle import SaddleShiftedInverseCache

    def held(label, cache, info, launches, t_build):
        devs = [
            rel_err(cache.inv[i].double(), cache64.inv[i])
            for i in range(len(sig))
        ]
        _, ks = dre_backward_sweep(
            sys32, cache, ALPHA, DT, NTS_GAIN, sseq, iseq,
            n_newton=N_NEWTON, r_max=R_MAX,
        )
        gain_dev = rel_err(ks.double(), ks64)
        check(launches >= 4 * info["ns_passes"],
              f"spmm_tile launches in the bench NS build {label}: "
              f"{launches}")
        check(all(info["certified"]),
              f"every shift of NS stack {label} certified: "
              f"{info['residuals']}")
        check(max(devs) <= GAIN_TOL,
              f"NS stack {label} vs the host f64 stack: {max(devs):.2e}")
        check(bool(torch.isfinite(ks).all()), f"NS-stack {label} gains finite")
        check(gain_dev <= GAIN_TOL,
              f"NS-stack {label} f32 vs f64 gains: {gain_dev:.2e}")
        log(f"[8] {label} bench-shape f32 NS stack ({len(sig)} shifts) "
            f"{t_build:.2f} s: {info['ns_passes']} NS passes, "
            f"{info['ladder_rungs']} rungs, {info['minv_passes']} M^-1 "
            f"passes, {launches} spmm_tile launches; residuals "
            f"(f64-evaluated) {[f'{r:.2e}' for r in info['residuals']]}, "
            f"f32-evaluated "
            f"{[f'{r:.2e}' for r in info['residuals_working']]} (certified "
            f"at {info['certify_tol']:g}); deviation from the host f64 "
            f"splu stack per shift {[f'{d:.2e}' for d in devs]}; gains vs "
            f"phase 4's f64 gains {gain_dev:.2e} (tol {GAIN_TOL:g})")

    # (a) the reference's ladder, through build_dre_cache_dae_ns
    spmm_kernel.launches = 0
    (cache, info), t_build = sync_time(
        lambda: build_dre_cache_dae_ns(sys32, DT, sig)
    )
    k2_a = spmm_kernel.launches
    held("(a)", cache, info, k2_a, t_build)
    del cache

    # (b) a non-default ladder keeping the full inverses; K2's inputs
    # recorded during the build
    with recorded_spmm_inputs() as seen:
        spmm_kernel.launches = 0
        (inv, info), t_build = sync_time(lambda: build_inverse_stack_ns(
            *pencil, sig, torch.float32, keep_full=True,
            device=sys32.b.device, **NS_LADDER))
        k2_b = spmm_kernel.launches
    full, n = info.pop("full_stack"), sys32.n
    check(tuple(full.shape) == (len(sig), n + sys32.n_p, n + sys32.n_p),
          f"8 (b) full stack shape {tuple(full.shape)}")
    iperm = torch.as_tensor(info["iperm"]).to(full.device)
    same = [torch.equal(full[i, :n, :n][iperm[:, None], iperm], inv[i])
            for i in range(len(sig))]
    check(all(same), f"8 (b) full stack's velocity blocks bit-equal to the "
                     f"stack: {same}")
    full_gb = full.numel() * full.element_size() / 1e9
    del full
    held(f"(b) {NS_LADDER}, keep_full=True",
         SaddleShiftedInverseCache(inv, n), info, k2_b, t_build)
    log(f"     (b) full stack {full_gb:.2f} GB, velocity blocks in the "
        f"original order bit-equal to the stack")
    del inv, info
    k2_err = check_spmm_inputs("8 (b) ladder", seen)
    del seen
    torch.cuda.empty_cache()
    return {"8a bench NS stack (f32, the reference's ladder)": k2_a,
            f"8b bench NS stack (f32, keep_full, {NS_LADDER})": k2_b}, k2_err


def config3_phase(c3_ops, sys64, sched):
    """Phase 9: config 3 on the NS tier (the NS tier of
    scripts/config3_cylinder.py, with an f64 stack beside it). Returns
    the SpMM kernel's launches in the f32 NS build, the f64 and f32 NS
    gains, and the Leray projector of config 3's operators with its
    build seconds."""
    import torch

    from optconpy_tpu_torch.ops import spmm_kernel
    from optconpy_tpu_torch.riccati import (
        build_dre_cache_dae_ns,
        dre_backward_sweep,
    )
    from optconpy_tpu_torch.riccati.validate import (
        dre_step_residual,
        leray_projector,
    )
    from optconpy_tpu_torch.scripts import config3_cylinder as c3

    sig, sseq, iseq = sched
    check((C3_RE, C3_DT, C3_ALPHA, C3_SHIFTS, C3_ADI, C3_R_MAX, C3_NTS)
          == (c3.RE, c3.DT, c3.ALPHA, c3.NS_SHIFTS, c3.N_ADI, c3.R_MAX,
              c3.NTS_GAIN), "phase 9 runs scripts/config3_cylinder.py's shape")
    sys32 = sys64.to(dtype=torch.float32)
    adi_iters = C3_NTS * C3_ADI  # one Newton step per DRE step

    def dre(sys, cache, alpha):
        return dre_backward_sweep(
            sys, cache, alpha, C3_DT, C3_NTS, sseq, iseq,
            n_newton=1, r_max=C3_R_MAX,
        )

    def build(sys, tol):
        return sync_time(lambda: build_dre_cache_dae_ns(
            sys, C3_DT, sig, certify_tol=tol, verbose=log
        ))

    log(f"[9] config 3, f64 NS stack ({C3_SHIFTS} x {sys64.n}^2):")
    torch.cuda.reset_peak_memory_stats()
    (cache, info), t_build = build(sys64, C3_CERTIFY_F64)
    res64 = info["residuals"]
    check(all(info["certified"]),
          f"f64 NS stack certified at {C3_CERTIFY_F64:g}: {info['residuals']}")
    (_, ks64), t_dre = sync_time(lambda: dre(sys64, cache, C3_ALPHA))
    log(f"    f64 build {t_build:.1f} s ({info['ns_passes']} NS passes, "
        f"{info['ladder_rungs']} rungs, minv {info['minv_passes']} passes), "
        f"every shift certified at {C3_CERTIFY_F64:g}; DRE sweep "
        f"{t_dre:.2f} s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del cache
    torch.cuda.empty_cache()

    log(f"    f32 NS stack, certify_tol {C3_CERTIFY_F32:g}:")
    torch.cuda.reset_peak_memory_stats()
    spmm_kernel.launches = 0
    (cache, info), t_build = build(sys32, C3_CERTIFY_F32)
    launches = spmm_kernel.launches
    check(launches >= 4 * info["ns_passes"],
          f"spmm_tile launches in the config-3 NS build: {launches}")
    (zs, ks), t_first = sync_time(lambda: dre(sys32, cache, C3_ALPHA))
    warm = [
        sync_time(lambda: dre(sys32, cache, C3_ALPHA * (1 + 1e-4 * r)))[1]
        for r in range(1, 4)
    ]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del cache
    check(bool(torch.isfinite(ks).all()), "config-3 f32 gains finite")
    feas = c3.feasibility(sys32, zs[0])
    check(feas <= FEAS_TOL, f"|JZ|/|Z| = {feas:.2e}")
    gain_dev = rel_err(ks.double(), ks64)
    check(gain_dev <= GAIN_TOL, f"config-3 f32 vs f64 gains: {gain_dev:.2e}")
    t0 = time.perf_counter()
    pit = leray_projector(c3_ops)
    t_pit = time.perf_counter() - t0
    residuals = {
        step: dre_step_residual(
            c3_ops, zs[step].cpu().numpy(), ks[step].cpu().numpy(),
            zs[step + 1].cpu().numpy(), C3_ALPHA, C3_DT, pit=pit,
        )
        for step in (0, C3_NTS // 2)
    }
    worst = max(residuals.values())
    check(worst <= DRE_RES_TOL, f"projected DRE residual {worst:.2e}")
    not_cert = [float(s) for s, ok in zip(sig, info["certified"]) if not ok]
    log(f"    f32 build {t_build:.1f} s ({info['ns_passes']} NS passes, "
        f"{info['ladder_rungs']} rungs, extra passes "
        f"{info['extra_passes']}); residuals evaluated in f64 "
        f"{[f'{r:.2e}' for r in info['residuals']]}, the same probes "
        f"evaluated in f32 "
        f"{[f'{r:.2e}' for r in info['residuals_working']]}; certified "
        f"{info['certified']} (shifts not certified: {not_cert}); "
        f"spmm_tile launches {launches}")
    log(f"    f32 DRE sweep first {t_first:.2f} s, warm "
        f"{[round(t, 4) for t in warm]} s -> median "
        f"{adi_iters / statistics.median(warm):.1f} ADI iters/s; peak device "
        f"memory {peak_gb:.2f} GB")
    ops = [c3_ops[k] for k in ("A", "M", "J")]
    log(f"    repeat fingerprint (sha256 of the values; equal in two runs = "
        f"bit-equal): host operators "
        f"{fingerprint(*(x for a in ops for x in (a.data, a.indices)))}, "
        f"B and C {fingerprint(c3_ops['B'], c3_ops['C'])}, shifts "
        f"{fingerprint(sig)}, f64 stack residuals {fingerprint(res64)}, "
        f"f32 stack residuals {fingerprint(info['residuals'])} (f32-evaluated "
        f"{fingerprint(info['residuals_working'])}), f64 gains "
        f"{fingerprint(ks64.cpu().numpy())}, f32 gains "
        f"{fingerprint(ks.cpu().numpy())}")
    log(f"    |JZ|/|Z| {feas:.2e} (tol {FEAS_TOL:g}); projected DRE residual "
        f"{ {k: f'{v:.2e}' for k, v in residuals.items()} } (tol "
        f"{DRE_RES_TOL:g}, host f64 {time.perf_counter() - t0:.1f} s: the "
        f"Leray projector built once in {t_pit:.1f} s for these and phase "
        f"11 (b)'s, {t_pit:.1f} s saved here); f32 vs f64 gain deviation "
        f"{gain_dev:.2e} (tol {GAIN_TOL:g})")
    return launches, ks64, ks, pit, t_pit


def driver_configs():
    """Config 4 (f32, fused, Newton-Schulz gains) and the reference driver
    tests' heat1d and cavity configs on the lu tiers (f64)."""
    from optconpy_tpu_torch.utils import (
        CostConfig,
        OptConConfig,
        ProblemConfig,
        SolverConfig,
        TimeConfig,
    )

    config4 = OptConConfig(
        problem=ProblemConfig(name="cylinderwake", re=RE,
                              refinement=REFINEMENT),
        time=TimeConfig(t0=0.0, t_end=NTS * DT, nts=NTS),
        cost=CostConfig(alpha=ALPHA, ystar="steady_offset",
                        ystar_amp=YSTAR_AMP),
        solver=SolverConfig(
            num_shifts=N_SHIFTS, n_adi=N_ADI, n_newton=N_NEWTON, r_max=R_MAX,
            dtype="float32", step_solver="fused", dre_solver="inverse_ns",
            feedback="explicit",
        ),
    )
    heat = OptConConfig(  # tests/test_round2_fixes.py HEAT_CFG
        problem=ProblemConfig(name="heat1d", n_dof=64),
        time=TimeConfig(t0=0.0, t_end=1.0, nts=50),
        cost=CostConfig(alpha=1e-2, ystar="zero"),
        solver=SolverConfig(
            num_shifts=8, n_adi=20, n_newton=3, r_max=30, dtype="float64",
            feedback="explicit", step_solver="lu", dre_solver="lu",
        ),
    )
    cavity = OptConConfig(  # tests/test_optcont_driver.py CFG
        problem=ProblemConfig(name="drivencavity", nx=6),
        time=TimeConfig(t0=0.0, t_end=0.4, nts=20),
        cost=CostConfig(alpha=1e-8, ystar="steady_offset", ystar_amp=0.01),
        solver=SolverConfig(
            num_shifts=8, n_adi=20, n_newton=2, r_max=30, dtype="float64",
            step_solver="lu", dre_solver="lu",
        ),
    )
    return config4, heat, cavity


def driver_phase(v0_np, dev):
    """Phase 10 and 11 (c): optcon_nse on the card. Returns each kernel's
    launches in the config-4 f32 run, K2's in the cavity's matrix-free
    run, and the seconds of (c)."""
    import dataclasses

    import torch

    from optconpy_tpu_torch.ops import conv_kernel, spmm_kernel
    from optconpy_tpu_torch.optcont import optcon_nse
    from optconpy_tpu_torch.utils import MetricsLogger

    class StageLog(MetricsLogger):
        """MetricsLogger that also counts each kernel's launches in every
        timed stage of the driver."""

        def __init__(self):
            super().__init__()
            self.launches = {}

        @contextmanager
        def timed(self, event, **fields):
            before = (conv_kernel.launches, spmm_kernel.launches)
            with super().timed(event, **fields):
                yield
            self.launches[event] = (conv_kernel.launches - before[0],
                                    spmm_kernel.launches - before[1])

    def run(cfg, v0, device):
        met = StageLog()
        with tempfile.TemporaryDirectory() as cache:
            res, wall = sync_time(lambda: optcon_nse(
                cfg, v0_batch=v0, cache_dir=cache, metrics=met, device=device
            ))
        secs = {r["event"]: r["seconds"] for r in met.records
                if "seconds" in r}
        s_count = 1 if v0 is None else len(v0)
        rate = s_count * cfg.time.nts / secs["closed_loop_rollout"]
        log(f"     {cfg.problem.name} {cfg.solver.dtype} {cfg.solver.step_solver}"
            f"/{cfg.solver.dre_solver} on {device}, {s_count} scenarios x "
            f"{cfg.time.nts} steps: wall {wall:.3f} s; stages "
            f"{ {k: round(v, 4) for k, v in secs.items()} } s; closed loop "
            f"{rate:.0f} solves/s; cost {res.cost:.6e}")
        return res, met, rate

    config4, heat, cavity = driver_configs()
    log(f"[10] optcon_nse on the card (config 4: n={v0_np.shape[1]}, dt "
        f"{config4.time.dt}, {NTS} steps, {N_SHIFTS} shifts, {N_ADI} ADI, "
        f"rank {R_MAX}, Newton-Schulz gains, fused step, explicit feedback)")
    conv_kernel.launches = 0
    spmm_kernel.launches = 0
    res32, met32, rate = run(config4, v0_np, dev)
    launches = {"conv_p2": conv_kernel.launches,
                "spmm_tile": spmm_kernel.launches}
    per_stage = met32.launches
    log(f"     kernel launches by stage (conv_p2, spmm_tile): {per_stage}")
    check(per_stage["closed_loop_rollout"][0] == NTS,
          f"conv_p2 launches in the driver's rollout: "
          f"{per_stage['closed_loop_rollout'][0]} != {NTS}")
    check(launches["conv_p2"] == NTS,
          f"conv_p2 launches in the driver: {launches['conv_p2']} != {NTS}")
    check(per_stage["dre_backward_sweep"][1] > 0,
          "spmm_tile launched in the driver's DRE stage")
    s_batch = len(v0_np)
    check(res32.ys.shape == (s_batch, NTS + 1, 2), "driver ys shape")
    check(res32.us.shape == (s_batch, NTS, 4), "driver us shape")
    for name, x in (("ys", res32.ys), ("us", res32.us)):
        check(bool(np.isfinite(x).all()), f"driver {name} finite")
    check(bool(torch.isfinite(res32.gains).all()), "driver gains finite")
    check(np.isfinite(res32.cost), "driver cost finite")
    check(torch.backends.cuda.matmul.allow_tf32 is False, "TF32 matmul off")
    check(torch.backends.cudnn.allow_tf32 is False, "TF32 cuDNN off")
    log(f"     config 4 f32: {rate:.0f} closed-loop solves/s through the "
        f"driver (phase 5's bare loop is the yardstick); every NS shift "
        f"certified (the driver raises otherwise)")

    cfg64 = dataclasses.replace(
        config4, solver=dataclasses.replace(config4.solver, dtype="float64")
    )
    res64, _, _ = run(cfg64, v0_np[:S_REF], dev)
    gain_dev = rel_err(res32.gains.double(), res64.gains)
    ys_dev = float(np.abs(res32.ys[:S_REF] - res64.ys).max()
                   / np.abs(res64.ys).max())
    check(gain_dev <= GAIN_TOL, f"driver f32 vs f64 gains: {gain_dev:.2e}")
    check(ys_dev <= ROLLOUT_TOL, f"driver f32 vs f64 ys: {ys_dev:.2e}")
    by_step = {k: rel_err(res32.gains[k].double(), res64.gains[k])
               for k in (0, NTS // 2, NTS - 6, NTS - 1)}
    log(f"     config 4 f32 vs f64 ({S_REF} scenarios): gains {gain_dev:.2e}, "
        f"ys {ys_dev:.2e} (tol {GAIN_TOL:g} and {ROLLOUT_TOL:g}); gains by "
        f"step {({k: f'{v:.2e}' for k, v in by_step.items()})}")

    for cfg in (heat, cavity):
        got, _, _ = run(cfg, None, dev)
        ref, _, _ = run(cfg, None, torch.device("cpu"))
        devs = {
            "gains": rel_err(got.gains.cpu(), ref.gains),
            "ys": float(np.abs(got.ys - ref.ys).max() / np.abs(ref.ys).max()),
            "us": float(np.abs(got.us - ref.us).max() / np.abs(ref.us).max()),
            "cost": abs(got.cost - ref.cost) / abs(ref.cost),
        }
        check(max(devs.values()) <= DRIVER_TOL,
              f"{cfg.problem.name} lu tiers card vs CPU: {devs}")
        log(f"     {cfg.problem.name} lu tiers, card vs CPU: "
            f"{ {k: f'{v:.2e}' for k, v in devs.items()} } "
            f"(tol {DRIVER_TOL:g})")

    # (c) of phase 11: the cavity on the matrix-free tiers ('auto' picks
    # the matrix-free DRE tier beside the matrix-free step tier), cut to
    # its first MF_DRIVER_NTS steps: each step's DRE is 80 FGMRES solves
    # of 30 Arnoldi steps, on the card and again on the host.
    mf_cfg = dataclasses.replace(
        cavity,
        time=dataclasses.replace(cavity.time, nts=MF_DRIVER_NTS,
                                 t_end=MF_DRIVER_NTS * cavity.time.dt),
        solver=dataclasses.replace(
            cavity.solver, step_solver="matfree", dre_solver="auto",
            fgmres_tol=MF_DRIVER_FGMRES, fgmres_cycles=12,
        ),
    )
    t_c = time.perf_counter()
    conv_kernel.launches = 0
    spmm_kernel.launches = 0
    with mgs_counted("11c cavity driver matfree (f64)"):
        got, met_mf, _ = run(mf_cfg, None, dev)
    mf_launches = spmm_kernel.launches
    per_stage = met_mf.launches
    check(per_stage["dre_backward_sweep"][1] > 0
          and per_stage["closed_loop_rollout"][1] > 0,
          f"spmm_tile launched in the matfree DRE and rollout: {per_stage}")
    ref, _, _ = run(mf_cfg, None, torch.device("cpu"))
    devs = {
        "gains": rel_err(got.gains.cpu(), ref.gains),
        "ys": float(np.abs(got.ys - ref.ys).max() / np.abs(ref.ys).max()),
        "us": float(np.abs(got.us - ref.us).max() / np.abs(ref.us).max()),
        "cost": abs(got.cost - ref.cost) / abs(ref.cost),
    }
    check(max(devs.values()) <= MF_DRIVER_TOL,
          f"cavity matfree tiers card vs CPU: {devs}")
    log(f"[11c] cavity on step_solver='matfree', dre_solver='auto' (fgmres "
        f"tol {MF_DRIVER_FGMRES:g}), card vs CPU: "
        f"{ {k: f'{v:.2e}' for k, v in devs.items()} } (tol "
        f"{MF_DRIVER_TOL:g}); spmm_tile launches by stage {per_stage}")
    return launches, mf_launches, time.perf_counter() - t_c

def golden_lu_phase(dev) -> dict:
    """Phase 10 (d): the host-LU tiers on the card against the port's
    dense f64 golden (golden/dense_lqr.py), on the reference's config-2
    and config-1 oracle tests' systems at their bounds: the cavity's DRE
    gains vs the reduced golden's (steps 0, 10, 29) and its closed loop's
    u and y; heat1d's DRE factors and gains (steps 0, 10, 25, 49) and its
    closed loop's v, u and y. Returns the worst deviations."""
    import torch

    from optconpy_tpu_torch.control import (
        build_costate_cache,
        build_costate_cache_dae,
        feedforward_sweep,
    )
    from optconpy_tpu_torch.fem.heat1d import heat1d_operators, initial_state
    from optconpy_tpu_torch.golden import (
        golden_closed_loop,
        golden_dre_sweep,
        golden_feedforward,
        lift_gain,
        reduce_dae,
    )
    from optconpy_tpu_torch.models import cavity_stokes_setup
    from optconpy_tpu_torch.mpc import (
        build_step_cache,
        build_step_cache_dae,
        closed_loop_rollout,
    )
    from optconpy_tpu_torch.riccati import (
        build_dre_cache,
        build_dre_cache_dae,
        dre_backward_sweep,
        dre_shift_schedule,
        dre_shift_schedule_dae,
    )

    def rel_fro(a, b) -> float:
        b = np.asarray(b)
        return float(np.linalg.norm(np.asarray(a) - b)
                     / max(np.linalg.norm(b), 1e-30))

    out, secs = {}, {}
    # config 2: the cavity (tests/test_cavity_lqr.py:35-38, 136-206)
    t0 = time.perf_counter()
    c = GOLDEN_CAVITY
    np_ops, sys, _ = cavity_stokes_setup(nx=c["nx"], device=dev)
    red = reduce_dae(np_ops)
    sig, sseq, iseq = dre_shift_schedule_dae(
        np_ops["A"], np_ops["M"], np_ops["J"], c["dt"], num_shifts=10,
        n_adi=20)
    cache = build_dre_cache_dae(sys, c["dt"], sig)
    _, ks = dre_backward_sweep(sys, cache, c["alpha"], c["dt"], c["nts"],
                               sseq, iseq, n_newton=3, r_max=50)
    torch.cuda.synchronize()
    secs["cavity card"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    gold = (red["Mt"], red["At"], red["Bt"], red["Ct"])
    xts = golden_dre_sweep(*gold, c["alpha"], c["dt"], c["nts"])
    out["cavity K"] = max(
        rel_fro(ks[k].cpu(), lift_gain(red, xts[k], c["alpha"]))
        for k in (0, 10, 29))
    q0 = np.random.default_rng(7).standard_normal(red["theta"].shape[1])
    ystar = np.tile([0.05, 0.0], (c["nts"] + 1, 1))
    wts = golden_feedforward(*gold, c["alpha"], c["dt"], xts, ystar)
    _, us_g, ys_g = golden_closed_loop(*gold, c["alpha"], c["dt"], xts, wts,
                                       q0)
    secs["cavity golden"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ws = feedforward_sweep(sys, build_costate_cache_dae(sys, c["dt"]), ks,
                           torch.as_tensor(ystar).to(dev), c["dt"])
    _, us, ys = closed_loop_rollout(
        sys, build_step_cache_dae(sys, c["dt"]), ks, ws,
        torch.as_tensor(red["theta"] @ q0).to(dev), c["alpha"], c["dt"])
    torch.cuda.synchronize()
    secs["cavity card"] += time.perf_counter() - t0
    out["cavity u"], out["cavity y"] = rel_fro(us.cpu(), us_g), rel_fro(
        ys.cpu(), ys_g)

    # config 1: heat1d (tests/test_heat_lqr.py:33-46, 134-220)
    t0 = time.perf_counter()
    h = GOLDEN_HEAT
    h_ops, hsys = heat1d_operators(n=h["n"], device=dev)
    sig, sseq, iseq = dre_shift_schedule(h_ops["A"], h_ops["M"], h["dt"],
                                         num_shifts=12, n_adi=26)
    zs, ks = dre_backward_sweep(hsys, build_dre_cache(hsys, h["dt"], sig),
                                h["alpha"], h["dt"], h["nts"], sseq, iseq,
                                n_newton=3, r_max=60)
    ystar = np.tile([0.25], (h["nts"] + 1, 1))
    ws = feedforward_sweep(hsys, build_costate_cache(hsys, h["dt"]), ks,
                           torch.as_tensor(ystar).to(dev), h["dt"])
    v0 = initial_state(h["n"])
    vs, us, ys = closed_loop_rollout(
        hsys, build_step_cache(hsys, h["dt"]), ks, ws,
        torch.as_tensor(v0).to(dev), h["alpha"], h["dt"])
    torch.cuda.synchronize()
    secs["heat1d card"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    gold = (h_ops["M"], h_ops["A"], h_ops["B"], h_ops["C"])
    xs = golden_dre_sweep(*gold, h["alpha"], h["dt"], h["nts"])
    m_d, b = h_ops["M"].toarray(), h_ops["B"]
    steps = (0, 10, 25, 49)
    out["heat1d X"] = max(
        rel_fro((zs[k] @ zs[k].T).cpu(), xs[k]) for k in steps)
    out["heat1d K"] = max(
        rel_fro(ks[k].cpu(), b.T @ xs[k] @ m_d / h["alpha"]) for k in steps)
    wg = golden_feedforward(*gold, h["alpha"], h["dt"], xs, ystar)
    vs_g, us_g, ys_g = golden_closed_loop(*gold, h["alpha"], h["dt"], xs, wg,
                                          v0)
    secs["heat1d golden"] = time.perf_counter() - t0
    for name, a, g in (("v", vs, vs_g), ("u", us, us_g), ("y", ys, ys_g)):
        out[f"heat1d {name}"] = rel_fro(a.cpu(), g)
    for key, dev_ in out.items():
        bound = GOLDEN_DRE_TOL if key[-1] in "KX" else GOLDEN_LOOP_TOL
        check(dev_ < bound, f"10d {key} vs the golden: {dev_:.2e} (bound "
                            f"{bound:g})")
    log(f"[10d] the lu tiers on the card vs the port's dense f64 golden "
        f"(golden_dre_sweep, golden_feedforward, golden_closed_loop): cavity "
        f"nx={c['nx']} (n={sys.n}, ker J {red['theta'].shape[1]}, "
        f"{c['nts']} steps) and heat1d n={h['n']} ({h['nts']} steps); "
        f"deviations { {k: f'{v:.2e}' for k, v in out.items()} } (bounds: "
        f"DRE {GOLDEN_DRE_TOL:g}, closed loop {GOLDEN_LOOP_TOL:g}); seconds "
        f"{ {k: round(v, 2) for k, v in secs.items()} }")
    return out


def profile_listing(label: str, fn, top: int = 10) -> None:
    """Print the device kernels of one call of fn (calls, device us,
    share of the wall) and its host reads of device values."""
    rows, wall, syncs = kernel_split(fn)
    busy = sum(us for _, us in rows.values())
    log(f"    profiler, {label}: wall {wall * 1e3:.2f} ms, device busy "
        f"{busy / 1e3:.2f} ms = {busy / 1e3 / (wall * 1e3):.1%}, "
        f"{sum(c for c, _ in rows.values())} kernels, {syncs} host reads; "
        f"top kernels (calls, us, share of the wall):")
    for name, (calls, us) in sorted(rows.items(),
                                    key=lambda r: -r[1][1])[:top]:
        log(f"      {calls:6d} x {us / calls:8.2f} us "
            f"{us / 1e3 / (wall * 1e3):6.1%}  {name[:100]}")


def matfree_bench_phase(np_ops, cond, sys64, cache64, sched, dev) -> dict:
    """Phase 11 (a): the matrix-free tier at the bench shape in f64: the
    ADI through SaddleMatfreeCache against the same iterations through
    the host splu inverse stack, and the matrix-free stepper against the
    'lu' stepper in both feedback modes. Returns K2's launches by path."""
    import torch

    from optconpy_tpu_torch.fem.device_conv import ConvKernel
    from optconpy_tpu_torch.mpc import (
        batched_nse_closed_loop,
        build_nse_stepper,
        build_nse_stepper_matfree,
    )
    from optconpy_tpu_torch.ops import spmm_kernel
    from optconpy_tpu_torch.riccati import (
        build_dre_cache_dae_matfree,
        lowrank_adi,
    )

    f64 = torch.float64
    sig, sseq, iseq = sched
    n, m = sys64.b.shape
    launches = {}
    (mf, t_build) = sync_time(lambda: build_dre_cache_dae_matfree(
        sys64, DT, sig, block=MF_BLOCK, max_cycles=MF_ADI_CYCLES,
        tol=MF_ADI_TOL,
    ))
    args = dict(
        smw_u=torch.zeros((n, m), dtype=f64, device=dev), smw_v=sys64.b,
        mass=sys64.mass, w=sys64.c.T,
        sigma_seq=torch.as_tensor(sseq[:MF_ADI_ITERS]).to(dev, f64),
        idx_seq=[int(i) for i in iseq[:MF_ADI_ITERS]],
    )
    spmm_kernel.launches = 0
    with mgs_counted("11a matfree ADI (bench, f64)"):
        z_mf, t_adi = sync_time(lambda: lowrank_adi(mf, **args))
    launches["11a matfree ADI (bench, f64)"] = spmm_kernel.launches
    z_inv = lowrank_adi(cache64, **args)
    adi_dev = rel_err(z_mf, z_inv)
    check(bool(torch.isfinite(z_mf).all()), "matfree ADI factor finite")
    check(launches["11a matfree ADI (bench, f64)"] > 0,
          "spmm_tile launched in the matrix-free ADI")
    check(adi_dev <= MF_ADI_DEV,
          f"matfree vs inverse-stack ADI: {adi_dev:.2e}")
    log(f"[11a] bench shape f64: SaddleMatfreeCache ({len(sig)} shifts, block "
        f"{MF_BLOCK}, tol {MF_ADI_TOL:g}, {MF_ADI_CYCLES} cycles) built in "
        f"{t_build:.2f} s; {MF_ADI_ITERS} ADI iterations {t_adi:.2f} s "
        f"({mf.stats.solves} FGMRES solves, worst relres "
        f"{mf.stats.worst_relres:.2e}, {mf.stats.above_tol} above tol, "
        f"{launches['11a matfree ADI (bench, f64)']} "
        f"spmm_tile launches); Z vs the same iterations through the host "
        f"splu inverse stack {adi_dev:.2e} (tol {MF_ADI_DEV:g})")
    del mf

    t0 = time.perf_counter()
    lu = build_nse_stepper(np_ops, cond, DT, device=dev, dtype=f64)
    mfs = build_nse_stepper_matfree(
        np_ops, cond, DT, device=dev, dtype=f64, block=MF_BLOCK,
        max_cycles=MF_STEP_CYCLES, tol=MF_STEP_TOL,
    )
    conv64 = ConvKernel.build(np_ops["full"], cond, device=dev, dtype=f64)
    t_steppers = time.perf_counter() - t0
    rng = np.random.default_rng(SEED)
    vbar = lu.vbar.cpu().numpy()
    v0 = torch.as_tensor(
        vbar[None] + 1e-3 * rng.standard_normal((MF_STEP_S, n))
    ).to(dev)
    ks = torch.as_tensor(np.broadcast_to(
        1e-3 * rng.standard_normal((m, n)), (MF_STEP_NTS + 1, m, n)
    ).copy()).to(dev)
    ws = torch.zeros((MF_STEP_NTS + 1, n), dtype=f64, device=dev)
    for feedback in ("explicit", "implicit"):
        def roll(cache):
            return batched_nse_closed_loop(sys64, conv64, cache, ks, ws, v0,
                                           ALPHA, DT, feedback=feedback)

        spmm_kernel.launches = 0
        key = f"11a matfree stepper {feedback} (bench, f64)"
        with mgs_counted(key):
            got, t_mf = sync_time(lambda: roll(mfs))
        launches[key] = spmm_kernel.launches
        ref, t_lu = sync_time(lambda: roll(lu))
        devs = {name: rel_err(a, b) for name, a, b in zip("vuy", got, ref)}
        check(launches[key] > 0, f"spmm_tile launched in the {key}")
        check(max(devs.values()) <= MF_STEP_DEV,
              f"matfree vs lu stepper ({feedback}): {devs}")
        log(f"      matfree stepper ({feedback} feedback, {MF_STEP_S} "
            f"scenarios x {MF_STEP_NTS} steps, tol {MF_STEP_TOL:g}, "
            f"{MF_STEP_CYCLES} cycles) {t_mf:.2f} s vs the lu stepper "
            f"{t_lu:.2f} s: v, u, y deviation "
            f"{ {k: f'{v:.2e}' for k, v in devs.items()} } (tol "
            f"{MF_STEP_DEV:g}); {launches[key]} spmm_tile launches")
    log(f"      steppers and f64 ConvKernel built in {t_steppers:.1f} s")
    return launches


def matfree_config3_phase(c3_ops, c3_cond, c3_sys64, sched12, ks64, ks_ns32,
                          pit, t_pit, dev):
    """Phase 11 (b): the rest of scripts/config3_cylinder.py in f32: the
    matrix-free DRE sweep at its 12 shifts (first and warm) against
    phase 9's f64 NS gains and beside its f32 NS gains, the projected DRE
    residual, the CPU splu baseline, K1 at the rollout's width, and the
    closed loop from phase 9's f32 NS gain, controlled and uncontrolled.
    Returns (K1's, K2's) launches by path."""
    import torch

    from optconpy_tpu_torch.fem.device_conv import ConvKernel, FusedConvKernel
    from optconpy_tpu_torch.mpc import (
        batched_nse_closed_loop,
        build_nse_stepper_matfree,
    )
    from optconpy_tpu_torch.ops import conv_kernel
    from optconpy_tpu_torch.riccati import build_dre_cache_dae_matfree
    from optconpy_tpu_torch.riccati.validate import dre_step_residual
    from optconpy_tpu_torch.scripts import config3_cylinder as c3

    f32 = torch.float32
    sig = sched12[0]
    sys32 = c3_sys64.to(dtype=f32)
    n, m = sys32.b.shape
    k1, k2 = {}, {}
    torch.cuda.reset_peak_memory_stats()
    mf, t_build = sync_time(lambda: build_dre_cache_dae_matfree(
        sys32, C3_DT, sig, block=MF_BLOCK, max_cycles=C3_DRE_CYCLES,
        tol=C3_FGMRES_TOL,
    ))
    key = f"11b config3_script matfree DRE sweep (f32, {len(sig)} shifts)"
    with counted_launches(c3, "dre_backward_sweep") as sweeps, \
            mgs_counted(key):
        zs, ks, t_sweep, warm = c3.timed_sweeps(
            sys32, mf, sched12, warm=C3_MF_WARM, nts=C3_NTS, r_max=C3_R_MAX)
    k2[key] = sweeps[0][1]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    adi_iters = C3_NTS * C3_ADI
    check(bool(torch.isfinite(ks).all()), "config-3 matfree gains finite")
    check(k2[key] > 0, "spmm_tile launched in the matfree DRE")
    gain_dev = rel_err(ks.double(), ks64)
    check(gain_dev <= MF_GAIN_TOL,
          f"config-3 matfree f32 vs NS f64 gains: {gain_dev:.2e}")
    parity = rel_err(ks_ns32[0], ks[0])
    feas = c3.feasibility(sys32, zs[0])
    t0 = time.perf_counter()
    res0 = dre_step_residual(c3_ops, zs[0].cpu().numpy(), ks[0].cpu().numpy(),
                             zs[1].cpu().numpy(), C3_ALPHA, C3_DT, pit=pit)
    t_res = time.perf_counter() - t0
    check(res0 <= DRE_RES_TOL, f"config-3 matfree DRE residual {res0:.2e}")
    # every sweep makes the same solves: the first's come first
    rels = np.asarray(mf.stats.relres[:mf.stats.solves // (1 + len(warm))])
    first = {"solves": len(rels), "worst": float(rels.max()),
             "median": float(np.median(rels)),
             "above_tol": int((rels > C3_FGMRES_TOL).sum())}
    log(f"[11b] config 3 f32 matrix-free, the script's tier (n={n}, "
        f"n_p={c3_sys64.n_p}, {len(sig)} shifts {np.round(sig, 1).tolist()}, "
        f"block {MF_BLOCK}, FGMRES tol {C3_FGMRES_TOL:g}, {C3_DRE_CYCLES} "
        f"cycles): build {t_build:.2f} s; DRE sweep ({C3_NTS} steps x {C3_ADI} "
        f"ADI, rank {C3_R_MAX}, one Newton step) first {t_sweep:.2f} s = "
        f"{adi_iters / t_sweep:.2f} ADI iters/s, warm "
        f"{[round(t, 2) for t in warm]} s = "
        f"{adi_iters / statistics.median(warm):.2f} ADI iters/s (median of "
        f"{C3_MF_WARM}); the first sweep's "
        f"{first['solves']} FGMRES solves: relres worst {first['worst']:.2e}, "
        f"median {first['median']:.2e}, {first['above_tol']} above tol (the "
        f"cache's record over both: {mf.stats.above_tol}); {k2[key]} "
        f"spmm_tile launches; peak device memory {peak_gb:.2f} GB")
    log(f"      gains vs phase 9's f64 NS gains {gain_dev:.2e} (tol "
        f"{MF_GAIN_TOL:g}); the script's parity, phase 9's f32 NS vs these "
        f"t=0 gains, {parity:.2e}; |JZ|/|Z| {feas:.2e}; projected DRE "
        f"residual at step 0 {res0:.2e} (tol {DRE_RES_TOL:g}, host f64 "
        f"{t_res:.1f} s with phase 9's projector: {t_pit:.1f} s saved)")
    cpu = c3.cpu_adi_baseline(c3_ops, sig, q_cols=sys32.p_out + C3_R_MAX + m,
                              n_adi=C3_ADI, adi_iters=adi_iters,
                              log=lambda _: None)
    mf_warm = adi_iters / statistics.median(warm)
    log(f"      CPU baseline (scipy splu of the {len(sig)} shifted saddles "
        f"{cpu['factor_s']:.1f} s, ADI {cpu['iter_s'] * 1e3:.1f} ms an "
        f"iteration, median of "
        f"{[round(t * 1e3, 1) for t in cpu['iter_samples_s']]} ms, load "
        f"average {cpu['loadavg_1min']}): {cpu['adi_iters_per_s']:.2f} ADI "
        f"iters/s amortized; the card's warm matrix-free rate is "
        f"{mf_warm / cpu['adi_iters_per_s']:.2f}x that")

    i_hard = int(np.argmax(np.abs(np.asarray(sig))))
    w_adi = torch.randn((n, sys32.p_out + C3_R_MAX + m), dtype=f32, device=dev,
                        generator=torch.Generator(dev).manual_seed(1))
    profile_listing(
        f"one ADI solve (SMW, shift {sig[i_hard]:.1f}, {w_adi.shape[1]} + "
        f"{m} columns)",
        lambda: mf.solve_smw(i_hard, ks[0].T.contiguous(), sys32.b, w_adi),
    )
    del mf

    conv = FusedConvKernel.build(c3_ops["full"], c3_cond, device=dev)
    rng = np.random.default_rng(SEED)
    vbar = torch.as_tensor(c3_cond.restrict(c3_ops["vbar_full"]))
    v = (vbar[:, None] + 1e-3 * torch.as_tensor(
        rng.standard_normal((n, C3_ROLL_S)))).to(dev, f32)
    out = conv_kernel.conv_inner(v, conv)
    ref = ConvKernel.conv_inner_batch_t(conv, v)
    k1_err = rel_err(out, ref)
    check(bool(torch.isfinite(out).all()), "config-3 conv_p2 finite")
    check(k1_err <= KERNEL_TOL,
          f"config-3 conv_p2 B={C3_ROLL_S}: {k1_err:.2e}")
    k1_ms = event_ms(lambda: conv_kernel.conv_inner(v, conv), 20)
    log(f"      conv_p2 at config 3 (nt={conv.tri_dofs.shape[0]}, "
        f"B={C3_ROLL_S}): rel err {k1_err:.2e} vs the plain slot sums "
        f"(tol {KERNEL_TOL:g}); {k1_ms * 1e3:.1f} us/call (events)")

    stepper, t_step = sync_time(lambda: build_nse_stepper_matfree(
        c3_ops, c3_cond, C3_DT, device=dev, dtype=f32, block=MF_BLOCK,
        max_cycles=C3_ROLL_CYCLES, tol=C3_FGMRES_TOL,
    ))
    v0 = c3.rollout_v0(stepper, C3_ROLL_S, np.random.default_rng(SEED))
    with counted_launches(c3, "batched_nse_closed_loop") as rolls, \
            mgs_counted("11b config3_script rollouts, controlled and "
                        "uncontrolled (f32)"):
        roll = c3.energy_ratio(sys32, conv, stepper, ks_ns32[0], v0,
                               nts=C3_ROLL_NTS)
    for (name, short), (l1, l2) in zip((("controlled", "c"),
                                        ("uncontrolled", "u")), rolls):
        key = f"11b config3_script rollout {name} (f32)"
        k1[key], k2[key] = l1, l2
        check(l1 == C3_ROLL_NTS + 1,
              f"conv_p2 launches in the {name} config-3 rollout: {l1}")
        check(l2 > 0, f"spmm_tile launched in the {name} rollout")
        check(roll[f"finite_{short}"], f"{name} rollout outputs finite")
        t_roll = roll[f"rollout_{short}_s"]
        log(f"      {name} closed loop ({C3_ROLL_S} scenarios x "
            f"{C3_ROLL_NTS} steps, implicit feedback, tol {C3_FGMRES_TOL:g}, "
            f"{C3_ROLL_CYCLES} cycles): {t_roll:.2f} s = "
            f"{C3_ROLL_S * C3_ROLL_NTS / t_roll:.1f} solves/s; conv_p2 {l1} "
            f"launches, spmm_tile {l2}; perturbation energy at T "
            f"{roll[f'energy_{short}']:.4e}")
    check(roll["ys_shape"] == (C3_ROLL_S, C3_ROLL_NTS + 1, sys32.p_out),
          f"config-3 rollout ys shape {roll['ys_shape']}")
    ratio = roll["ratio"]
    check(ratio < ENERGY_RATIO_MAX, f"config-3 energy ratio {ratio:.3e}")
    log(f"      stepper build {t_step:.2f} s; energy ratio controlled / "
        f"uncontrolled at T {ratio:.4e} (bound < {ENERGY_RATIO_MAX:g}; "
        f"phase 9's f32 NS gain, as the script)")
    ks_roll = ks_ns32[0].expand(2, m, n)
    ws = torch.zeros((2, n), dtype=f32, device=dev)
    profile_listing(
        f"one rollout step ({C3_ROLL_S} scenarios, implicit feedback)",
        lambda: batched_nse_closed_loop(
            sys32, conv, stepper, ks_roll, ws, v0, C3_ALPHA, C3_DT,
            feedback="implicit",
        ),
    )
    return k1, k2

@contextmanager
def recorded_spmm_inputs():
    """Inside the block, every name in the port's modules bound to the
    SpMM wrapper records, for each (pack, width, dtype) it is handed,
    the pack and a copy of the first X, then calls the wrapper. Yields
    {key: (pack, x)}: the path's own inputs, to hold the kernel against
    its plain version afterwards."""
    from optconpy_tpu_torch.ops import spmm_kernel

    wrapper, seen = spmm_kernel.spmm, {}

    def recording(a, x):
        key = (id(a), tuple(x.shape[1:]), x.dtype)
        if key not in seen:
            seen[key] = (a, x.clone())
        return wrapper(a, x)

    mods = [m for name, m in list(sys.modules.items())
            if name.startswith("optconpy_tpu_torch")
            and getattr(m, "spmm", None) is wrapper]
    for m in mods:
        m.spmm = recording
    try:
        yield seen
    finally:
        for m in mods:
            m.spmm = wrapper


def check_spmm_inputs(label: str, seen: dict) -> float:
    """The SpMM kernel vs its plain version on each recorded (pack, X) and
    on a seeded random X of the same shape: SPMM_TOL relative, and a
    repeat bit for bit. Returns the largest absolute error."""
    import torch

    from optconpy_tpu_torch.ops import spmm_kernel

    gen = torch.Generator(next(iter(seen.values()))[1].device)
    gen.manual_seed(SEED)
    worst, max_abs, cases = {}, 0.0, {}
    for (_, width, dtype), (a, x_path) in seen.items():
        dname = str(dtype).removeprefix("torch.")
        case = f"{a.shape[0]}x{a.shape[1]} B={width[0] if width else 1}"
        x_rand = torch.randn(x_path.shape, generator=gen, dtype=dtype,
                             device=x_path.device)
        for which, x in (("path", x_path), ("random", x_rand)):
            y = spmm_kernel.spmm(a, x)
            ref = spmm_kernel.spmm_plain(a, x)
            abs_err = float((y - ref).abs().max()) if y.numel() else 0.0
            scale = float(ref.abs().max()) if ref.numel() else 0.0
            err = abs_err / scale if scale > 0 else abs_err
            check(bool(torch.isfinite(y).all()),
                  f"{label} spmm {case} {dname} {which} X finite")
            check(err <= SPMM_TOL[dname],
                  f"{label} spmm {case} (nnz {a.nnz}) {dname} {which} X: "
                  f"{err:.2e}")
            check(torch.equal(y, spmm_kernel.spmm(a, x)),
                  f"{label} spmm {case} {dname} {which} X repeats bit for "
                  "bit")
            if err >= worst.get(dname, (0.0,))[0]:
                worst[dname] = (err, f"{case}, {which} X")
            max_abs = max(max_abs, abs_err)
        cases.setdefault(dname, set()).add(case)
    log(f"     {label}: spmm_tile vs plain on the path's {len(seen)} "
        f"(pack, width, dtype) inputs and a random X of each shape; worst "
        f"rel err { {k: f'{e:.2e} ({at})' for k, (e, at) in worst.items()} }"
        f" (tol {SPMM_TOL}), each repeats bit for bit; operators and widths "
        f"{ {k: sorted(v) for k, v in cases.items()} }")
    return max_abs


def receding_phase(np_ops, cond, sys64, dev):
    """Phase 12 (a): scripts/bench_receding.run, config 4's macro loop in
    f32 with its three variants (full rebuild, refreshed matfree,
    dense_ns) on phase 4's setup; both kernels held against their plain
    versions on the inputs each variant's warm-up hands them; then
    dense_ns in f64 for the first macros on the same scenarios. Returns
    each kernel's launches by path, K1's record at the first warm-up's X
    and both kernels' largest absolute errors."""
    import torch

    from optconpy_tpu_torch.fem.device_conv import ConvKernel
    from optconpy_tpu_torch.mpc import receding_horizon_mpc
    from optconpy_tpu_torch.ops import conv_kernel, spmm_kernel
    from optconpy_tpu_torch.scripts import bench_receding as br

    f64 = torch.float64
    check((br.RH, br.NUM_SHIFTS, br.N_ADI, br.S_BATCH, br.DT, br.ALPHA)
          == (RH_CFG, RH_SHIFTS, RH_ADI, S_BATCH, DT, ALPHA),
          "phase 12 runs scripts/bench_receding.py's shape")
    names = {(c.solver, c.refresh_caches): name
             for name, c in br.configs().items()}
    k1, k2, k1_recs, abs_err = {}, {}, {}, {"k1": 0.0, "k2": 0.0}

    def checked(*args, n_macro, profile=False):
        """bench_receding's receding_horizon_mpc: a warm-up call records
        and checks both kernels' inputs; a timed call counts launches."""
        name = names[(args[4].solver, args[4].refresh_caches)]
        if not profile:
            with recorded_spmm_inputs() as seen, recorded_conv_input() as xs:
                out = receding_horizon_mpc(*args, n_macro=n_macro)
            abs_err["k2"] = max(abs_err["k2"], check_spmm_inputs(
                f"12 {name} warm-up ({n_macro} macros)", seen))
            rec = check_conv_input(f"12 {name} warm-up's first", *xs[0])
            abs_err["k1"] = max(abs_err["k1"], rec.pop("max_abs_err"))
            k1_recs[name] = rec
            del seen, xs
            torch.cuda.empty_cache()
            return out
        conv_kernel.launches = 0
        spmm_kernel.launches = 0
        key = f"12 receding {name} (config 4, f32, {n_macro} macros)"
        with mgs_counted(key, expect=args[4].solver == "matfree"):
            out = receding_horizon_mpc(*args, n_macro=n_macro, profile=True)
        k1[key], k2[key] = conv_kernel.launches, spmm_kernel.launches
        return out

    log(f"[12] receding-horizon MPC, config 4 (scripts/bench_receding.run: "
        f"n={sys64.n}, {S_BATCH} scenarios, {RH_SHIFTS} shifts x {RH_ADI} "
        f"ADI, {br.RH}, variants {br.VARIANTS}), {RH_MACROS} macros after "
        f"a {RH_WARMUP}-macro warm-up (the full rebuild's: 1):")
    arrays = {}
    br.receding_horizon_mpc = checked
    try:
        out, t_run = sync_time(lambda: br.run(
            dev, ops=(np_ops, sys64, cond), problem=f"cylinder_re{int(RE)}_"
            f"ref{REFINEMENT}", n_macro=RH_MACROS, warmup=RH_WARMUP,
            s_batch=S_BATCH, log=lambda msg: log(f"      {msg}"),
            arrays=arrays))
    finally:
        br.receding_horizon_mpc = receding_horizon_mpc
    recs = {"full": out["full_rebuild_variant"],
            "fast": out["matfree_refresh_variant"], "dense_ns": out}
    n = sys64.n
    stages = br.STAGES
    for name, rec in recs.items():
        key = f"12 receding {name} (config 4, f32, {RH_MACROS} macros)"
        vs = arrays[name]["vs"]
        check(tuple(vs.shape) == (S_BATCH, RH_MACROS * RH_CFG["apply"] + 1, n),
              f"receding {name} vs shape")
        check(bool(torch.isfinite(arrays[name]["ks"]).all()),
              f"receding {name} gains finite")
        check(k1[key] == RH_MACROS * (RH_CFG["apply"] + 1),
              f"conv_p2 launches in the {name} loop: {k1[key]}")
        check(k2[key] > 0, f"spmm_tile launched in the {name} loop")
        check(rec["perturbation_decay"] < 1.0,
              f"receding {name} perturbation decay {rec['perturbation_decay']}")
        tm = rec["timings"]
        refresh_s = statistics.mean(t["stepper_refresh_s"] for t in tm[1:])
        log(f"     {name}: {RH_MACROS} macros {rec['wall_total_s']:.2f} s: "
            f"{rec['s_per_macro_step']:.4f} s/macro, steady (macros 2-"
            f"{RH_MACROS - 1}) {rec['steady_state_s_per_macro']:.4f} s/macro; "
            f"breakdown { {k: round(v, 4) for k, v in rec['breakdown_s'].items()} }"
            f" s; stepper refresh on the worker thread {refresh_s:.4f} s a warm "
            f"macro; decay dT/d0 {rec['perturbation_decay']:.4f}; peak device "
            f"memory {rec['peak_device_memory_gb']} GB; conv_p2 "
            f"{k1[key]} launches, spmm_tile {k2[key]}")
        for t, m in zip(tm, rec["macros"]):
            if name == "dense_ns":
                check(m["ns_refresh_worst_residual"] <= RH_NS_CERTIFY,
                      f"NS refresh certified: {m['ns_refresh_residuals']}")
                quality = (
                    f"NS refresh residuals (f64) "
                    f"{[f'{r:.1e}' for r in m['ns_refresh_residuals']]}, "
                    f"rebuilds {m['ns_refresh_rebuilds']}")
            else:
                quality = (
                    f"probe relres {m['fgmres_probe_relres']:.2e}; FGMRES "
                    + "; ".join(
                        f"{st} {m[f'fgmres_{st}']['solves']} solves, worst "
                        f"{m[f'fgmres_{st}']['worst_relres']:.2e}, "
                        f"{m[f'fgmres_{st}']['above_tol']} above tol"
                        for st in ("dre", "rollout"))
                    + f"; preconditioner re-inverted {m['precond_refresh']}")
            log(f"       macro {m['macro']}: {t['total_s']:.4f} s "
                f"({ {k: round(t[f'{k}_s'], 4) for k in stages} }); launches "
                f"(conv_p2, spmm_tile) by stage "
                f"{ {k: tuple(v.values()) for k, v in t['launches'].items()} }"
                f"; {quality}")
    ks = {name: arrays[name]["ks"] for name in recs}
    gdev = {f"{a} vs {b}": [rel_err(x, y) for x, y in zip(ks[a], ks[b])]
            for a, b in (("fast", "full"), ("dense_ns", "full"),
                         ("dense_ns", "fast"))}
    for pair, devs in gdev.items():
        check(max(devs) <= RH_GAIN_TOL, f"receding {pair} gains by macro: "
                                        f"{devs}")
    log(f"     gains by macro { {p: [f'{d:.2e}' for d in v] for p, v in gdev.items()} }"
        f" (tol {RH_GAIN_TOL:g}); the script's fast-vs-full "
        f"{out['gain_rel_dev_fast_vs_full']:.3e}, dense_ns-vs-full "
        f"{out['gain_rel_dev_dense_ns_vs_full']:.3e}; speedup of dense_ns "
        f"over the full rebuild {out['speedup_vs_full_rebuild']:.3f}x "
        f"(steady {out['steady_speedup_vs_full_rebuild']:.3f}x); run "
        f"{t_run:.1f} s with the kernel checks")
    vs32, ks_ns = arrays["dense_ns"]["vs"], ks["dense_ns"]
    v0_np, sched = arrays["v0"], arrays["sched"]
    del arrays, ks

    # the in-run f64 check: dense_ns in f64 on the same scenarios (the
    # plain convection: K1 takes float32 only)
    t0 = time.perf_counter()
    conv64 = ConvKernel.build(np_ops["full"], cond, device=dev, dtype=f64)
    out64 = receding_horizon_mpc(
        sys64, conv64, np_ops, cond, br.configs()["dense_ns"], *sched,
        torch.as_tensor(v0_np).to(dev), n_macro=RH_F64_MACROS,
    )
    steps = RH_F64_MACROS * RH_CFG["apply"] + 1
    g64 = rel_err(ks_ns[:RH_F64_MACROS].double(), out64["ks"])
    y32 = torch.einsum("pn,stn->stp", sys64.c, vs32[:, :steps].double())
    y64 = torch.einsum("pn,stn->stp", sys64.c, out64["vs"])
    ydev = rel_err(y32, y64)
    check(g64 <= GAIN_TOL, f"receding f32 vs f64 gains: {g64:.2e}")
    check(ydev <= ROLLOUT_TOL, f"receding f32 vs f64 outputs: {ydev:.2e}")
    log(f"     dense_ns f32 vs f64 ({RH_F64_MACROS} macros, {S_BATCH} "
        f"scenarios, {time.perf_counter() - t0:.1f} s): gains {g64:.2e}, "
        f"outputs C v {ydev:.2e} (tol {GAIN_TOL:g} and {ROLLOUT_TOL:g})")
    return k1, k2, k1_recs["full"], abs_err


def receding_lu_phase(dev):
    """Phase 12 (b): the 'lu' tier (device re-linearization, host LUs) on
    the reference test's cavity, on the card and on the CPU."""
    import torch

    from optconpy_tpu_torch.fem.device_conv import ConvKernel
    from optconpy_tpu_torch.models.cavity import cavity_stokes_setup
    from optconpy_tpu_torch.mpc import RHConfig, receding_horizon_mpc
    from optconpy_tpu_torch.riccati import dre_shift_schedule_dae
    from optconpy_tpu_torch.solvers.steady import solve_steady_nse_host

    outs, secs = [], []
    for device in (dev, torch.device("cpu")):
        ops, sys, cond = cavity_stokes_setup(nx=6, device=device)
        ops["vbar_full"], _ = solve_steady_nse_host(ops["full"], cond)
        sched = dre_shift_schedule_dae(ops["A"], ops["M"], ops["J"],
                                       RH_LU_CFG["dt"], num_shifts=8,
                                       n_adi=16)
        conv = ConvKernel.build(ops["full"], cond, device=device,
                                dtype=torch.float64)
        vbar = cond.restrict(ops["vbar_full"])
        v0 = vbar[None] + 1e-2 * np.random.default_rng(SEED).standard_normal(
            (4, sys.n))
        out, sec = sync_time(lambda: receding_horizon_mpc(
            sys, conv, ops, cond, RHConfig(**RH_LU_CFG), *sched,
            torch.as_tensor(v0), n_macro=3,
        ))
        outs.append(out)
        secs.append(sec)
    devs = {k: rel_err(outs[0][k].cpu(), outs[1][k])
            for k in ("vs", "us", "ks")}
    check(max(devs.values()) <= RH_LU_TOL,
          f"receding lu tier card vs CPU: {devs}")
    log(f"[12b] receding lu tier, cavity nx=6, 4 scenarios x 3 macros, f64: "
        f"card {secs[0]:.2f} s, CPU {secs[1]:.2f} s; card vs CPU "
        f"{ {k: f'{v:.2e}' for k, v in devs.items()} } (tol {RH_LU_TOL:g})")


@contextmanager
def recorded_conv_input():
    """Inside the block, the convection kernel's wrapper keeps a copy of
    the first X it is handed (the path's own input) and its evaluator.
    Yields a list that holds (X, conv) after the first call."""
    from optconpy_tpu_torch.ops import conv_kernel

    wrapper, seen = conv_kernel.conv_inner, []

    def recording(v_t, conv):
        if not seen:
            seen.append((v_t.clone(), conv))
        return wrapper(v_t, conv)

    conv_kernel.conv_inner = recording
    try:
        yield seen
    finally:
        conv_kernel.conv_inner = wrapper


@contextmanager
def counted_launches(module, name: str):
    """Inside the block, module.name counts the launches of both kernels
    in each of its calls. Yields the list of (conv_p2, spmm_tile) counts,
    one a call."""
    from optconpy_tpu_torch.ops import conv_kernel, spmm_kernel

    fn, counts = getattr(module, name), []

    def counting(*args, **kwargs):
        k0 = (conv_kernel.launches, spmm_kernel.launches)
        try:
            return fn(*args, **kwargs)
        finally:
            counts.append((conv_kernel.launches - k0[0],
                           spmm_kernel.launches - k0[1]))

    setattr(module, name, counting)
    try:
        yield counts
    finally:
        setattr(module, name, fn)


# The MGS kernel's launches (ops/arnoldi_kernel.py) on each matrix-free
# path, counted with the counter reset just before the path's run.
MGS_PATHS: dict = {}


@contextmanager
def mgs_counted(label: str, expect: bool = True):
    """Count the Arnoldi step kernel's launches inside the block into
    MGS_PATHS[label], from zero; with `expect`, check the path launched
    it (a matrix-free path solves by gmres)."""
    from optconpy_tpu_torch.ops import arnoldi_kernel

    arnoldi_kernel.launches = 0
    yield
    MGS_PATHS[label] = arnoldi_kernel.launches
    if expect:
        check(MGS_PATHS[label] > 0, f"mgs_step launched in {label}")


def check_conv_input(label: str, x, conv) -> dict:
    """K1 vs its plain version (the slot sums) on a path's own input X
    and evaluator: KERNEL_TOL relative and a repeat bit for bit, timed
    beside the plain version and the bound. Returns its JSON record."""
    import torch

    from optconpy_tpu_torch.fem.device_conv import ConvKernel
    from optconpy_tpu_torch.ops import conv_kernel

    n, b = x.shape
    out = conv_kernel.conv_inner(x, conv)
    ref = ConvKernel.conv_inner_batch_t(conv, x)
    err, abs_err = rel_err(out, ref), float((out - ref).abs().max())
    check(bool(torch.isfinite(out).all()), f"conv_p2 on the {label} X finite")
    check(err <= KERNEL_TOL, f"conv_p2 on the {label} X (B={b}): {err:.2e}")
    check(torch.equal(out, conv_kernel.conv_inner(x, conv)),
          f"conv_p2 repeats bit for bit on the {label} X")
    k_ms = event_ms(lambda: conv_kernel.conv_inner(x, conv), 20)
    p_ms = event_ms(lambda: ConvKernel.conv_inner_batch_t(conv, x), 3)
    nt, plan = conv.tri_dofs.shape[0], conv.plan
    plan_bytes = sum(
        t.numel() * t.element_size()
        for t in (plan.vsrc, plan.vdir, plan.pelem, plan.pnd, plan.psptr,
                  plan.pslot, plan.pdst, plan.bdst, plan.bsrc))
    bnd = bound_ms(4 * (2 * n * b + nt * 432) + plan_bytes, 1008 * nt * b,
                   "float32")
    log(f"     conv_p2 on the {label} X (n={n}, nt={nt}, B={b}): rel err "
        f"{err:.2e} (abs {abs_err:.2e}, tol {KERNEL_TOL:g}) vs the plain "
        f"slot sums, repeats bit for bit; {k_ms:.3f} ms/call (events), plain "
        f"{p_ms:.3f} ms, bound {bnd[0]:.3f} ms ({bnd[1]}) = "
        f"{bnd[0] / k_ms:.0%} of the kernel's time")
    return {"B": b, "ms": k_ms, "plain_ms": p_ms, "bound_ms": bnd[0],
            "bound_by": bnd[1], "max_abs_err": abs_err}


def sweep_phase(dev, card: str, mesh):
    """Phase 13: scripts/sweep_config5.run, the config-5 Re-bucket
    parameter sweep in f32 at the script's shape (gains cut to
    SW_GAINS' DRE steps), both kernels held against their plain versions
    on the path's inputs, and phase 14 (b)'s sharded sweep on its
    buckets over `mesh` (world size 1). Returns each kernel's launches
    by path, K1's record at the sweep's width and both kernels' largest
    absolute errors against their plain versions on the path's
    inputs."""
    import torch

    from optconpy_tpu_torch import riccati
    from optconpy_tpu_torch.fem.device_conv import ConvKernel
    from optconpy_tpu_torch.mpc import (
        NSEStepCache,
        build_nse_stepper,
        nse_sweep_outputs,
    )
    from optconpy_tpu_torch.ops import conv_kernel, spmm_kernel
    from optconpy_tpu_torch.parallel import param_sweep
    from optconpy_tpu_torch.parallel import (
        masked_sweep_stats,
        shard_scenarios,
        sharded_sweep_rollout,
        sweep_rollout,
    )
    from optconpy_tpu_torch.riccati import (
        build_dre_cache_dae_ns,
        dre_backward_sweep,
        dre_shift_schedule_dae,
    )
    from optconpy_tpu_torch.scripts import sweep_config5 as sc

    f32, f64 = torch.float32, torch.float64
    t_phase = time.perf_counter()
    check(torch.backends.cuda.matmul.allow_tf32 is False, "TF32 matmul off")
    check(torch.backends.cudnn.allow_tf32 is False, "TF32 cuDNN off")
    check((sc.RE_RANGE, sc.R_BUCKETS, sc.S_TOTAL, sc.PAD, sc.NTS, sc.DT,
           sc.ALPHA, sc.GAINS["num_shifts"], sc.GAINS["n_adi"],
           sc.GAINS["r_max"])
          == (SW_RE, SW_BUCKETS, SW_SCENARIOS, SW_PAD, SW_NTS, DT, ALPHA,
              SW_GAINS["num_shifts"], SW_GAINS["n_adi"], SW_GAINS["r_max"]),
          "phase 13 runs scripts/sweep_config5.py's shape")

    # the script's two sweeps (first, warm): launches, peak memory and
    # an output fingerprint each; K1's input recorded in the first
    sweeps = []

    def counted_sweep(*args, **kwargs):
        torch.cuda.reset_peak_memory_stats()
        conv_kernel.launches = 0
        spmm_kernel.launches = 0
        with recorded_conv_input() as xs:
            out = sweep_rollout(*args, **kwargs)
        sweeps.append({"k1": conv_kernel.launches, "k2": spmm_kernel.launches,
                       "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                       "print": fingerprint(out[0].cpu().numpy()),
                       "x": xs[0] if not sweeps else None})
        return out

    arrays = {}
    sc.sweep_rollout = counted_sweep
    try:
        with recorded_spmm_inputs() as seen, \
                counted_launches(riccati, "dre_backward_sweep") as dre_calls, \
                counted_launches(param_sweep,
                                 "build_sweep_steppers_ns_chain") as chain_calls, \
                mgs_counted(f"13 sweep gains (matfree DRE, {SW_BUCKETS} "
                            f"buckets)"):
            out, t_run = sync_time(lambda: sc.run(
                dev, re_range=SW_RE, buckets=SW_BUCKETS, s_total=SW_SCENARIOS,
                pad=SW_PAD, nts=SW_NTS, nts_gain=SW_GAINS["nts_gain"],
                log=lambda msg: log(f"      {msg}"), arrays=arrays))
    finally:
        sc.sweep_rollout = sweep_rollout
    setups, conv, cache_stack = (arrays["setups"], arrays["conv"],
                                 arrays["cache_stack"])
    ks, v0, mask_d, ystar = (arrays["ks"], arrays["v0"], arrays["mask"],
                             arrays["ystar"])
    ys, u_sq, stats = arrays["ys"], arrays["u_sq"], arrays["stats"]
    counts, info = arrays["counts"], arrays["info"]
    del arrays
    re_buckets = np.asarray(out["re_buckets"])
    s_max = out["s_max_padded"]
    sys32 = setups[0][1].to(dtype=f32)
    n = sys32.n
    steady = [f"{s[0]['steady_info']['residual']:.1e}" for s in setups]
    log(f"[13] config-5 sweep (scripts/sweep_config5.run, nts_gain "
        f"{out['nts_gain']}): {SW_BUCKETS} Re buckets "
        f"{np.round(re_buckets, 1).tolist()}, {SW_SCENARIOS} drawn Re -> "
        f"{counts.tolist()} real scenarios, padded to S_max={s_max}, "
        f"{SW_NTS} steps, n={n}; run {t_run:.1f} s with the kernel checks; "
        f"setup of the {SW_BUCKETS} buckets {out['setup_s']:.1f} s on {card} "
        f"(steady residuals {steady})")

    # --- gains and the Newton-Schulz chain ---
    k2_dres = [k2 for _, k2 in dre_calls]
    k2_dre, k2_chain = sum(k2_dres), sum(k2 for _, k2 in chain_calls)
    check(len(k2_dres) == SW_BUCKETS and len(chain_calls) == 1,
          f"one DRE sweep a bucket and one chain: {len(k2_dres)}, "
          f"{len(chain_calls)}")
    check(len(sweeps) == 2, f"the script's sweeps: {len(sweeps)}")
    res, chain = info["ns_residuals"], info["ns_chain"]
    check(bool(torch.isfinite(ks).all()), "sweep gains finite")
    check(max(res) <= SW_CERTIFY, f"NS chain certified: {res}")
    log(f"     gains and steppers {out['gains_s']:.1f} s on {card} (spmm_tile "
        f"{k2_dre} launches in the DRE sweeps, {k2_chain} in the chain); by "
        f"bucket:")
    for r, b in enumerate(info["buckets"]):
        fg = b["fgmres"]
        log(f"       Re={re_buckets[r]:.1f}: shifts {b['shifts_s']:.2f} s, "
            f"matfree DRE cache {b['dre_cache_s']:.2f} s, DRE sweep "
            f"{b['dre_sweep_s']:.2f} s ({fg['solves']} FGMRES solves, worst "
            f"relres {fg['worst_relres']:.2e}, {fg['above_tol']} above tol "
            f"{fg['tol']:g}; spmm_tile {k2_dres[r]}); chain "
            f"{chain['passes'][r]} passes ({chain['extra_passes'][r]} extra), "
            f"residual {res[r]:.2e} in f64 "
            f"({chain['residuals_working'][r]:.2e} in f32), "
            f"{({k: round(v, 3) for k, v in chain['seconds'][r].items()})} s")
    t_chain = sum(sum(c.values()) for c in chain["seconds"])
    log(f"     chain {t_chain:.2f} s of the {info['steppers_s']:.2f} s "
        f"stepper stage (certify_tol {SW_CERTIFY:g}, f64 probes)")
    k2_abs = check_spmm_inputs("13 gains and chain", seen)
    del seen
    torch.cuda.empty_cache()

    # --- f32 matfree gains vs f64 NS gains, first and last bucket ---
    gdev = {}
    for r in (0, SW_BUCKETS - 1):
        np_ops, sys64, _ = setups[r]
        sig, sseq, iseq = dre_shift_schedule_dae(
            np_ops["A"], np_ops["M"], np_ops["J"], DT,
            num_shifts=SW_GAINS["num_shifts"], n_adi=SW_GAINS["n_adi"])
        cache64, ns_info = build_dre_cache_dae_ns(
            sys64, DT, sig, certify_tol=C3_CERTIFY_F64)
        check(all(ns_info["certified"]), f"f64 NS stack bucket {r} certified")
        _, ks64 = dre_backward_sweep(
            sys64, cache64, ALPHA, DT, SW_GAINS["nts_gain"], sseq, iseq,
            n_newton=1, r_max=SW_GAINS["r_max"])
        gdev[float(re_buckets[r])] = rel_err(ks[r].double(), ks64[0])
        del cache64, ks64
    check(max(gdev.values()) <= GAIN_TOL, f"sweep f32 vs f64 gains: {gdev}")
    log(f"     f32 matfree gains vs f64 NS gains (same shifts): "
        f"{ {k: f'{v:.2e}' for k, v in gdev.items()} } (tol {GAIN_TOL:g})")
    torch.cuda.empty_cache()

    # --- the sweep: the script's first and warm calls ---
    def run(v):
        return sweep_rollout(sys32, conv, cache_stack, ks, v, ALPHA, DT,
                             SW_NTS)

    for i, sw in enumerate(sweeps):
        check(sw["k1"] == SW_NTS, f"conv_p2 launches in sweep {i}: "
                                  f"{sw['k1']}")
        check(sw["k2"] == 0, f"spmm_tile launches in sweep {i}: {sw['k2']}")
    k1_sweep = sweeps[0]["k1"]
    check(tuple(ys.shape) == (SW_BUCKETS, s_max, SW_NTS + 1, sys32.p_out),
          "sweep ys shape")
    check(tuple(u_sq.shape) == (SW_BUCKETS, s_max, SW_NTS), "sweep u_sq shape")
    for name, x in (("ys", ys), ("u_sq", u_sq)):
        check(bool(torch.isfinite(x).all()), f"sweep {name} finite")
    prints = [sw["print"] for sw in sweeps]
    check(len(set(prints)) == 1, f"first and warm sweeps bit-equal: {prints}")
    t_warm = out["sweep_s"]
    log(f"     sweep {SW_BUCKETS} x {s_max} x {SW_NTS} on {card}: first "
        f"{out['first_sweep_s']:.3f} s, warm {t_warm:.4f} s -> "
        f"{out['solves_per_s']:.0f} real solves/s, "
        f"{out['padded_solves_per_s']:.0f} padded solves/s "
        f"({t_warm / SW_NTS * 1e3:.2f} ms a step); conv_p2 {k1_sweep} "
        f"launches a sweep, spmm_tile 0; peak device memory "
        f"{[round(sw['peak_gb'], 2) for sw in sweeps]} GB; live tensors "
        f"after the sweep {out['live_device_array_gib']} GiB; ys "
        f"fingerprints {prints} (bit-equal); the run's peak "
        f"{out['peak_device_memory_gb']} GB")

    # --- K1 at the sweep's own first-step input ---
    k1_rec = check_conv_input("sweep's first-step", *sweeps[0]["x"])
    del sweeps

    # --- the script's statistics, and the same with NaN padded rows ---
    check(np.array_equal(stats["scenarios"].cpu().numpy(), counts),
          f"sweep scenario counts {stats['scenarios'].tolist()}")
    for key, x in stats.items():
        check(bool(torch.isfinite(x).all()), f"sweep statistic {key} finite")
    v0_nan = v0.clone()
    for r, c in enumerate(counts):
        v0_nan[r, int(c):] = float("nan")
    ys_n, u_n, _ = run(v0_nan)
    stats_n = masked_sweep_stats(ys_n, u_n, ALPHA, DT, ystar, mask_d)
    same = {k: torch.equal(stats[k], stats_n[k]) for k in stats}
    check(all(same.values()), f"NaN padding leaves the statistics: {same}")
    del v0_nan, ys_n, u_n
    with open(SW_RECORD) as fh:
        rec = json.load(fh)
    log(f"     statistics (masked, y* = each bucket's steady output), "
        f"identical with NaN padded rows; beside {SW_RECORD} (the JAX "
        f"package on a {rec['device']}, not this port):")
    for r in range(SW_BUCKETS):
        log(f"       Re={re_buckets[r]:.1f}: {int(counts[r])} scenarios, "
            f"tracking cost {float(stats['mean_cost'][r]):.4e} "
            f"({rec['tracking_cost_per_bucket'][r]:.4e}), terminal err "
            f"{float(stats['tracking_err_T'][r]):.4e} "
            f"({rec['terminal_err_per_bucket'][r]:.4e}), max |y| "
            f"{float(stats['max_abs_y'][r]):.4e}")

    # --- 14 (b): the sharded sweep at world size 1 ---
    conv_kernel.launches = 0
    spmm_kernel.launches = 0
    (ys_sh, stats_sh), t_sh = sync_time(lambda: sharded_sweep_rollout(
        mesh, sys32, conv, cache_stack, ks, shard_scenarios(mesh, v0, dim=1),
        ALPHA, DT, SW_NTS, ystar=ystar,
        mask_local=shard_scenarios(mesh, mask_d, dim=1)))
    k1_sh, k2_sh = conv_kernel.launches, spmm_kernel.launches
    check(k1_sh == SW_NTS and k2_sh == 0,
          f"launches in the sharded sweep: conv_p2 {k1_sh}, spmm_tile {k2_sh}")
    check(torch.equal(ys_sh, ys), "sharded sweep ys bit-equal to the sweep's")
    same = {k: torch.equal(stats_sh[k], stats[k]) for k in stats}
    check(all(same.values()),
          f"sharded sweep statistics equal masked_sweep_stats: {same}")
    log(f"[14b] sharded_sweep_rollout ({mesh.world_size} rank, NCCL) on the "
        f"{SW_BUCKETS} buckets: {t_sh:.3f} s; ys bit-equal to the sweep's, "
        f"statistics equal to masked_sweep_stats (all-reduced partials); "
        f"conv_p2 {k1_sh} launches, spmm_tile {k2_sh}")
    del ys_sh, stats_sh

    # --- f64 check on the host-LU stepper tier ---
    t0 = time.perf_counter()
    rows = [0, SW_BUCKETS - 1]
    stack64 = NSEStepCache.stack([
        build_nse_stepper(setups[r][0], setups[r][2], DT, device=dev,
                          dtype=f64, solver="lu") for r in rows])
    conv64 = ConvKernel.build(setups[0][0]["full"], setups[0][2], device=dev,
                              dtype=f64)
    ys64, _, _ = nse_sweep_outputs(
        setups[0][1], conv64, stack64, ks[rows].double(),
        v0[rows, :SW_REF_S].double(), ALPHA, DT, SW_NTS)
    ydev = rel_err(ys[rows, :SW_REF_S].double(), ys64)
    check(ydev <= ROLLOUT_TOL, f"sweep f32 vs f64 outputs: {ydev:.2e}")
    log(f"     f32 sweep vs f64 on the lu tier (buckets {rows}, "
        f"{SW_REF_S} real scenarios each, {SW_NTS} steps, "
        f"{time.perf_counter() - t0:.1f} s): ys {ydev:.2e} "
        f"(tol {ROLLOUT_TOL:g})")
    # the same scenarios in f32 on the host-built f32 steppers instead of
    # the chain's inverses: the 'lu' tier is held to the rollout bound
    v0_rows = v0[rows, :SW_REF_S].contiguous()
    tdev, k1_lu = {}, 0
    for tier in ("lu", "inverse"):
        stack32 = NSEStepCache.stack([
            build_nse_stepper(setups[r][0], setups[r][2], DT, device=dev,
                              dtype=f32, solver=tier) for r in rows])
        conv_kernel.launches = 0
        ys32, _, _ = nse_sweep_outputs(sys32, conv, stack32, ks[rows],
                                       v0_rows, ALPHA, DT, SW_NTS)
        if tier == "lu":
            k1_lu = conv_kernel.launches
        tdev[tier] = rel_err(ys32.double(), ys64)
        del stack32, ys32
    check(k1_lu == SW_NTS, f"conv_p2 launches in the f32 'lu' sweep: {k1_lu}")
    check(tdev["lu"] <= ROLLOUT_TOL,
          f"f32 'lu' sweep steppers vs f64: {tdev['lu']:.2e}")
    log(f"     the same scenarios in f32 on f32 host-built steppers (host f64 "
        f"factor cast; the 'lu' tier's set-up solves in f64) vs f64: 'lu' "
        f"ys {tdev['lu']:.2e} (tol {ROLLOUT_TOL:g}; conv_p2 {k1_lu} "
        f"launches), 'inverse' {tdev['inverse']:.2e}, the chain's "
        f"{ydev:.2e}")
    del stack64, conv64, ys64, v0_rows

    # --- where a step's time goes ---
    split, wall, _ = kernel_split(lambda: run(v0))
    busy = sum(us for _, us in split.values())

    def share(*words):
        hit = [(c, us) for name, (c, us) in split.items()
               if any(w in name.lower() for w in words)]
        return sum(c for c, _ in hit), sum(us for _, us in hit)

    gemm, k1p = share("gemm", "sm80", "sm90", "cutlass"), share("conv_p2")
    copies = share("copy")
    log(f"     profiler, one warm sweep ({SW_NTS} steps, {wall:.3f} s wall, "
        f"device busy {busy / 1e6:.3f} s = {busy / 1e6 / wall:.1%}): GEMMs "
        f"{gemm[1] / 1e6 / wall:.1%}, conv_p2 {k1p[1] / 1e6 / wall:.1%}, "
        f"{copies[0]} copy kernels ({copies[0] / SW_NTS:.3f} a step); per "
        f"step: calls, us, share of the wall")
    for name, (calls, us) in sorted(split.items(), key=lambda r: -r[1][1]):
        log(f"      {calls / SW_NTS:7.3f} x {us / calls:9.2f} us "
            f"{us / 1e6 / wall:6.1%}  {name[:110]}")
    check(share("conv_p2_patch")[0] == SW_NTS,
          f"profiled conv_p2 kernels: {share('conv_p2_patch')[0]}")
    # the state is never copied: the few copies are the sweep's set-up
    # and its outputs' final layout, none a step
    check(copies[0] < SW_NTS // 10, f"copy kernels in the sweep: {copies[0]}")
    del ys, u_sq, cache_stack, ks, v0, setups, conv
    torch.cuda.empty_cache()
    log(f"[13] phase 13 wall {time.perf_counter() - t_phase:.1f} s on {card}")
    key = f"13 sweep ({SW_BUCKETS} x {s_max} x {SW_NTS}, f32)"
    k1 = {key: k1_sweep, f"14b sharded_sweep_rollout ({SW_BUCKETS} x "
          f"{s_max} x {SW_NTS}, world size 1)": k1_sh,
          f"13 f32 'lu' steppers check ({len(rows)} x {SW_REF_S} x "
          f"{SW_NTS})": k1_lu}
    k2 = {f"13 sweep gains (matfree DRE, {SW_BUCKETS} buckets)": k2_dre,
          f"13 sweep NS chain ({SW_BUCKETS} buckets)": k2_chain}
    return k1, k2, k1_rec, k2_abs


def config3xl_phase(dev):
    """Phase 14 (a): scripts/config3xl_cylinder.run at the reference's
    shape, K1 and K2 held against their plain versions on the inputs the
    run handed them. Returns each kernel's launches by path, K1's record
    at 3XL and K2's largest absolute error."""
    from optconpy_tpu_torch.ops import conv_kernel, spmm_kernel
    from optconpy_tpu_torch.scripts import config3xl_cylinder as xl

    import torch

    t0 = time.perf_counter()
    arrays = {}
    log(f"[14a] config 3XL (scripts/config3xl_cylinder.run: Re={xl.RE:g}, "
        f"refinement {xl.REFINEMENT}, {xl.N_SHIFTS} shifts, {xl.NTS_GAIN} DRE "
        f"steps x {xl.N_ADI} ADI, rank {xl.R_MAX}, FGMRES tol {xl.FGMRES_TOL:g}"
        f", f32, {xl.S_BATCH} x {xl.NTS_ROLL} closed loop):")
    conv_kernel.launches = 0
    spmm_kernel.launches = 0
    with recorded_spmm_inputs() as seen, recorded_conv_input() as xs, \
            counted_launches(xl, "dre_backward_sweep") as sweeps, \
            counted_launches(xl, "batched_nse_closed_loop") as rolls, \
            mgs_counted("14a config3xl_cylinder (DRE sweep, probes, stepper "
                        "and rollout)"):
        out = xl.run(dev, log=lambda msg: log(f"      {msg}"), arrays=arrays)
    k1_all, k2_all = conv_kernel.launches, spmm_kernel.launches
    t_run = time.perf_counter() - t0
    check((out["n_state"], out["n_pressure"]) == (XL_N, XL_NP),
          f"3XL sizes {out['n_state']}, {out['n_pressure']}")
    check(out["feasibility_JZ"] <= xl.FEASIBILITY_BOUND,
          f"3XL |JZ|/|Z| {out['feasibility_JZ']:.2e}")
    check(out["worst_dre_residual"] <= xl.RESIDUAL_BOUND,
          f"3XL projected DRE residual {out['worst_dre_residual']:.2e}")
    check(out["finite"], "3XL closed loop finite")
    check(len(sweeps) == 2 and all(k2 > 0 for _, k2 in sweeps),
          f"spmm_tile launched in both 3XL DRE sweeps: {sweeps}")
    check(len(rolls) == 1 and rolls[0][0] == xl.NTS_ROLL + 1,
          f"conv_p2 launches in the 3XL rollout: {rolls}")
    k2_abs = check_spmm_inputs("14a 3XL", seen)
    k1_rec = check_conv_input("3XL rollout's first", *xs[0])
    del seen, xs
    mf, sys32, ks = arrays["dre_cache"], arrays["sys"], arrays["ks"]
    i_hard = int(np.argmax(np.abs(np.asarray(arrays["sig"]))))
    w_adi = torch.randn((sys32.n, sys32.p_out + xl.R_MAX + sys32.m_in),
                        dtype=sys32.b.dtype, device=dev,
                        generator=torch.Generator(dev).manual_seed(1))
    profile_listing(
        f"one 3XL ADI solve (SMW, shift {arrays['sig'][i_hard]:.1f}, "
        f"{w_adi.shape[1]} + {sys32.m_in} columns)",
        lambda: mf.solve_smw(i_hard, ks[0].T.contiguous(), sys32.b, w_adi))
    del arrays, mf, sys32, ks, w_adi
    log(f"     3XL wall {t_run:.1f} s: setup {out['setup_s']} s, shifts "
        f"{out['shifts_s']} s, cache {out['cache_build_s']} s, probes "
        f"{out['probe_s']} s (relres {out['fgmres_relres_per_shift']}); DRE "
        f"sweep first {out['dre_sweep_s']} s = {out['adi_iters_per_s_first']} "
        f"ADI iters/s, warm {out['dre_sweep_warm_s']} s = "
        f"{out['adi_iters_per_s_warm']} ADI iters/s; FGMRES first "
        f"{out['fgmres_dre_first']}, warm {out['fgmres_dre_warm']}; CPU splu "
        f"{out['cpu_splu_factor_s_per_shift']} s a factor, "
        f"{out['cpu_adi_iters_per_s']} ADI iters/s (load average "
        f"{out['host_loadavg_1min']}), the card's warm rate "
        f"{out['adi_warm_vs_cpu']}x; |JZ|/|Z| {out['feasibility_JZ']:.3e} (tol "
        f"{xl.FEASIBILITY_BOUND:g}); residuals "
        f"{[f'{r:.3e}' for r in out['projected_residuals']]} (tol "
        f"{xl.RESIDUAL_BOUND:g}; Leray projector {out['projector_s']:.1f} s, "
        f"built once: {out['projector_saved_s']:.1f} s of host time saved); "
        f"rollout {out['rollout_s']} s; peak device memory "
        f"{out['peak_device_memory_gb']:.2f} GB; launches conv_p2 {k1_all}, "
        f"spmm_tile {k2_all} (DRE sweeps {[k for _, k in sweeps]}, rollout "
        f"{rolls[0][1]})")
    k1 = {"14a config3xl rollout (f32, 8 x 20)": rolls[0][0]}
    k2 = {"14a config3xl DRE sweep first (f32)": sweeps[0][1],
          "14a config3xl DRE sweep warm (f32)": sweeps[1][1],
          "14a config3xl probes, stepper and rollout (f32)":
              k2_all - sweeps[0][1] - sweeps[1][1]}
    return k1, k2, k1_rec, k2_abs


def sharded_fused_phase(mesh, sys32, conv, fused32, ks, ws, v0, ys, us):
    """Phase 14 (b), first part: sharded_nse_rollout on phase 5's fused
    stepper over `mesh` (world size 1): ys bit-equal to phase 5's and the
    statistics those of phase 5's outputs. Returns K1's launches."""
    import torch

    from optconpy_tpu_torch.ops import conv_kernel
    from optconpy_tpu_torch.parallel import shard_scenarios, sharded_nse_rollout

    conv_kernel.launches = 0
    (ys_sh, stats), t_sh = sync_time(lambda: sharded_nse_rollout(
        mesh, sys32, conv, fused32, ks, ws, shard_scenarios(mesh, v0), ALPHA,
        DT))
    launches = conv_kernel.launches
    check(launches == NTS, f"conv_p2 launches in the sharded rollout: "
                           f"{launches}")
    check(torch.equal(ys_sh, ys), "sharded rollout ys bit-equal to phase 5's")
    cost = (ys**2).sum() * DT + ALPHA * (us**2).sum() * DT
    count = torch.tensor(float(len(v0)), dtype=ys.dtype, device=ys.device)
    want = {"mean_cost": cost / count, "max_abs_y": ys.abs().amax(),
            "scenarios": count}
    same = {k: torch.equal(stats[k], want[k]) for k in want}
    check(all(same.values()), f"sharded rollout statistics: {same}")
    log(f"[14b] {mesh.world_size}-rank NCCL group on the card: "
        f"sharded_nse_rollout on phase 5's fused stepper ({len(v0)} x {NTS}) "
        f"{t_sh:.3f} s; ys bit-equal to phase 5's, statistics equal to its "
        f"outputs' (mean cost {float(stats['mean_cost']):.6e}); conv_p2 "
        f"{launches} launches")
    return launches


def _dryrun_rank(rank: int, world: int, store: str, out_dir: str) -> None:
    """One spawned rank of phase 14 (b)'s dry run: gloo on the shared
    card, the kernels' launches counted, its record written to out_dir."""
    import os

    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    import torch

    from optconpy_tpu_torch import utils
    from optconpy_tpu_torch.ops import conv_kernel, spmm_kernel
    from optconpy_tpu_torch.parallel import init_multihost, scenario_mesh
    from optconpy_tpu_torch.parallel.dryrun import dryrun_multichip

    utils.setup()
    dev = torch.device("cuda", 0)
    init_multihost(dev, f"file://{store}", rank=rank, world_size=world,
                   backend="gloo")
    try:
        t0 = time.perf_counter()
        out = dryrun_multichip(scenario_mesh(dev))
        torch.cuda.synchronize()
        out["seconds"] = time.perf_counter() - t0
        out["launches"] = {"conv_p2": conv_kernel.launches,
                           "spmm_tile": spmm_kernel.launches}
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
            json.dump(out, fh)
    finally:
        torch.distributed.destroy_process_group()


def dryrun_phase() -> tuple[dict, dict]:
    """Phase 14 (b), last part: parallel/dryrun.py on DRY_RANKS spawned
    gloo ranks sharing the card (a file store, no port). Every stage's
    global statistics must agree across the ranks. Returns each kernel's
    launches by rank."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ctx = mp.start_processes(_dryrun_rank,
                                 args=(DRY_RANKS, f"{tmp}/store", tmp),
                                 nprocs=DRY_RANKS, join=False,
                                 start_method="spawn")
        while not ctx.join(timeout=1):  # raises when a rank failed
            if time.perf_counter() - t0 > DRY_TIMEOUT_S:
                for p in ctx.processes:
                    p.terminate()
                raise RuntimeError(f"the dry run's ranks did not finish in "
                                   f"{DRY_TIMEOUT_S} s")
        wall = time.perf_counter() - t0
        recs = []
        for r in range(DRY_RANKS):
            with open(f"{tmp}/rank{r}.json") as fh:
                recs.append(json.load(fh))
    first = recs[0]
    for rec in recs:
        check(rec["world_size"] == DRY_RANKS, f"dry run world {rec}")
        for stage in ("closed_loop", "sweep", "matfree_rollout"):
            check(rec[stage] == first[stage],
                  f"dry run {stage} statistics agree across ranks: "
                  f"{rec[stage]} vs {first[stage]}")
        check(rec["launches"]["conv_p2"] > 0 and rec["launches"]["spmm_tile"] > 0,
              f"both kernels launched in rank {rec['rank']}: {rec['launches']}")
    log(f"[14b] dry run (parallel/dryrun.py) on {DRY_RANKS} spawned gloo ranks "
        f"sharing the card: {wall:.1f} s wall (the ranks' own "
        f"{[round(r['seconds'], 1) for r in recs]} s); every stage passed on "
        f"every rank, global statistics equal across ranks: sharded_closed_loop "
        f"{first['closed_loop']}, sharded_sweep_rollout {first['sweep']}, "
        f"sharded_nse_rollout (matfree) {first['matfree_rollout']}; launches "
        f"{[r['launches'] for r in recs]}")
    k1 = {f"14b sharded dryrun rank {r['rank']} (gloo, f32)":
          r["launches"]["conv_p2"] for r in recs}
    k2 = {f"14b sharded dryrun rank {r['rank']} (gloo, f32)":
          r["launches"]["spmm_tile"] for r in recs}
    return k1, k2


@contextmanager
def timed_calls(module, name: str, seconds: dict):
    """Inside the block, module.name adds its synchronized seconds to
    seconds[name] at each call."""
    import torch

    fn = getattr(module, name)
    seconds.setdefault(name, 0.0)

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            torch.cuda.synchronize()
            seconds[name] += time.perf_counter() - t0

    setattr(module, name, timed)
    try:
        yield seconds
    finally:
        setattr(module, name, fn)


@contextmanager
def reused_bernoulli_gain(are, red, k0t, n_unstable: int):
    """Inside the block, riccati/are.py's Bernoulli gain of red's (At, Bt)
    at ARE_ALPHA is the (k0t, n_unstable) computed before: the same inputs
    give the same Schur form, so each solve skips that host work."""
    bernoulli = are.stabilizing_gain_reduced

    def reused(at, bt, alpha):
        if at is red["At"] and bt is red["Bt"] and alpha == ARE_ALPHA:
            return k0t, n_unstable
        return bernoulli(at, bt, alpha)

    are.stabilizing_gain_reduced = reused
    try:
        yield
    finally:
        are.stabilizing_gain_reduced = bernoulli


def reduced_closed_loop_max_re(red, k) -> float:
    """Largest real part of the reduced closed loop At - Bt (K Theta) of a
    full-space gain K (Theta^T M Theta = I, so K Theta is its reduced
    gain on ker J)."""
    kt = np.asarray(k, np.float64) @ red["theta"]
    return float(np.real(np.linalg.eigvals(red["At"] - red["Bt"] @ kt)).max())


def dense_are_residual(np_ops, z, alpha: float) -> float:
    """||Pi^T R(X) Pi||_2 / ||Pi^T (C^T C + alpha K^T K) Pi||_2 for
    X = Z Z^T, K = B^T X M / alpha, R the ARE residual, Pi^T = I -
    J^T (J M^-1 J^T)^-1 J M^-1, all formed densely (a small problem)."""
    m, a, j = (np_ops[k].toarray() for k in ("M", "A", "J"))
    b, c = np.asarray(np_ops["B"]), np.asarray(np_ops["C"])
    x = z @ z.T
    k = b.T @ x @ m / alpha
    mi_jt = np.linalg.solve(m, j.T)
    pit = np.eye(m.shape[0]) - j.T @ np.linalg.solve(j @ mi_jt, mi_jt.T)

    def norm(s):
        s = pit @ s @ pit.T
        return np.abs(np.linalg.eigvalsh(0.5 * (s + s.T))).max()

    r = a.T @ x @ m + m @ x @ a - m @ x @ b @ b.T @ x @ m / alpha + c.T @ c
    return norm(r) / norm(c.T @ c + alpha * k.T @ k)


def cavity_are_phase(dev, timer) -> dict:
    """Phase 15 (a): solve_are_stabilized on the unstable cavity (f64, lu
    tier, the reference's defaults) on the card and on the CPU: card vs
    CPU <= ARE_CARD_TOL, vs the dense reduced CARE golden <
    ARE_GOLDEN_TOL, 2 unstable modes, the converged gain's reduced
    closed loop Hurwitz; then the identity that phase 15 (b) reads its
    ARE residual by: dre_step_residual at dt=inf equals the dense
    projected ARE residual, and is ~0 on the golden X."""
    import torch

    from optconpy_tpu_torch.fem.dae import dae_from_scipy
    from optconpy_tpu_torch.golden import (
        golden_are,
        lift_gain,
        lift_x,
        reduce_dae,
    )
    from optconpy_tpu_torch.models import cavity_stokes_setup
    from optconpy_tpu_torch.riccati import (
        dre_step_residual,
        solve_are_stabilized,
    )

    cpu = torch.device("cpu")
    with timer.section("15a cavity ARE, card and CPU"):
        ops, _, _ = cavity_stokes_setup(nx=5, device=cpu)
        decay = np.sort(-np.real(np.linalg.eigvals(reduce_dae(ops)["At"])))
        c = 0.5 * (decay[1] + decay[2])  # destabilize the two slowest modes
        a2 = (ops["A"] + c * ops["M"]).tocsr()
        np2 = dict(ops, A=a2)
        sys2 = dae_from_scipy(ops["M"], a2, ops["J"], ops["B"], ops["C"],
                              device=cpu)
        secs, runs = [], []
        for d in (dev, cpu):
            t0 = time.perf_counter()
            runs.append(solve_are_stabilized(np2, sys2, ARE_ALPHA, device=d))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
    z, k, info = runs[0]
    z, k = z.cpu().numpy(), k.cpu()
    red2 = reduce_dae(np2)
    xt = golden_are(red2["Mt"], red2["At"], red2["Bt"], red2["Ct"], ARE_ALPHA)
    k_gold = lift_gain(red2, xt, ARE_ALPHA)
    card_dev = rel_err(k, runs[1][1])
    gold_dev = rel_err(k, torch.as_tensor(k_gold))
    max_re = reduced_closed_loop_max_re(red2, k.numpy())
    check(info["n_unstable"] == 2,
          f"cavity unstable modes {info['n_unstable']}")
    check(card_dev <= ARE_CARD_TOL, f"cavity ARE card vs CPU: {card_dev:.2e}")
    check(gold_dev < ARE_GOLDEN_TOL, f"cavity ARE vs golden: {gold_dev:.2e}")
    check(max_re < 0, f"cavity closed loop not Hurwitz: {max_re:.3e}")
    r_inf = dre_step_residual(np2, z, k.numpy(), np.zeros_like(z), ARE_ALPHA,
                              np.inf)
    r_dense = dense_are_residual(np2, z, ARE_ALPHA)
    lam, vec = np.linalg.eigh(lift_x(red2, xt))
    keep = lam > lam.max() * 1e-14
    z_gold = vec[:, keep] * np.sqrt(lam[keep])
    r_gold = dre_step_residual(np2, z_gold, k_gold, np.zeros_like(z_gold),
                               ARE_ALPHA, np.inf)
    check(abs(r_inf - r_dense) <= 1e-6 * r_dense,
          f"dt=inf step residual {r_inf:.6e} vs the ARE residual "
          f"{r_dense:.6e}")
    check(r_gold < 1e-9, f"dt=inf step residual of the golden X {r_gold:.2e}")
    log(f"[15a] stabilized ARE, unstable cavity (nx=5, n={sys2.n}, A + "
        f"{c:.3f} M, f64, lu, 8 shifts x 24 ADI, 8 Newton, rank 40): "
        f"{info['n_unstable']} unstable modes, interval "
        f"[{info['interval'][0]:.4f}, {info['interval'][1]:.2f}]; card "
        f"{secs[0]:.2f} s, CPU {secs[1]:.2f} s; card vs CPU "
        f"{card_dev:.2e} (tol {ARE_CARD_TOL:g}), vs the dense CARE golden "
        f"{gold_dev:.2e} (tol {ARE_GOLDEN_TOL:g}); reduced closed loop max "
        f"Re {max_re:.4f}; the dt=inf step residual {r_inf:.4e} = the "
        f"dense projected ARE residual {r_dense:.4e} (golden X: {r_gold:.1e})")
    return {"card_vs_cpu": card_dev, "vs_golden": gold_dev}


def wake_are_phase(dev, timer) -> tuple[dict, float]:
    """Phase 15 (b): the Re=60 wake at refinement 1. The reduction, the
    Bernoulli K0 (2 unstable modes, Hurwitz reduced closed loop) and the
    closed-loop interval once (every solve below reuses that K0: the same
    inputs, the same Schur form); solve_are_stabilized at the reference's
    defaults, printed; then at WAKE_ARE over [WAKE_A_MIN, a_max] on the
    lu tier in f64 and f32, and for WAKE_MF_NEWTON Newton steps on the lu
    tier in f64 and the matfree tier in f32 (K2 held against its plain
    version on every input that tier handed it): the reduced closed loop
    of the lu gains and the matfree gain Hurwitz, lu f32 vs f64 <=
    WAKE_F32_TOL, matfree vs lu f64 <= 10x its FGMRES tol; the projected
    ARE residual of each gain (one Leray projector). Returns K2's
    launches by path and its largest absolute error."""
    import torch

    from optconpy_tpu_torch.golden import reduce_dae
    from optconpy_tpu_torch.models.cylinder import cylinder_setup
    from optconpy_tpu_torch.ops import spmm_kernel
    from optconpy_tpu_torch.riccati import (
        are,
        dre_step_residual,
        solve_are_stabilized,
        stabilizing_gain_reduced,
    )
    from optconpy_tpu_torch.riccati.validate import leray_projector

    f32, f64 = torch.float32, torch.float64
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with timer.section("15b wake setup"):
        np_ops, sys64, _ = cylinder_setup(
            re=WAKE_RE, refinement=WAKE_REFINEMENT, device=dev, dtype=f64)
    check((sys64.n, sys64.n_p) == (WAKE_N, WAKE_NP),
          f"wake sizes {sys64.n}, {sys64.n_p}")
    secs = {}
    t0 = time.perf_counter()
    with timer.section("15b reduction"):
        red = reduce_dae(np_ops)
    secs["reduction"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with timer.section("15b Schur (Bernoulli K0)"):
        k0t, n_unstable = stabilizing_gain_reduced(red["At"], red["Bt"],
                                                   ARE_ALPHA)
    secs["schur"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with timer.section("15b interval eigvals"):
        lam = np.linalg.eigvals(red["At"] - red["Bt"] @ k0t)
    secs["interval"] = time.perf_counter() - t0
    decay = -np.real(lam)
    interval = (float(decay[decay > 0].min()), float(decay[decay > 0].max()))
    lam_open = np.linalg.eigvals(red["At"])
    check(n_unstable == 2, f"wake unstable modes {n_unstable}")
    check(decay.min() > 0, f"Bernoulli closed loop max Re {-decay.min():.3e}")
    unstable = lam_open[np.real(lam_open) > 0]
    log(f"[15b] Re={WAKE_RE:g} wake (refinement {WAKE_REFINEMENT}, n={sys64.n}"
        f", n_p={sys64.n_p}, ker J {red['At'].shape[0]}): reduction "
        f"{secs['reduction']:.1f} s, Schur {secs['schur']:.1f} s, interval "
        f"eigvals {secs['interval']:.1f} s; {n_unstable} unstable modes "
        f"{np.round(unstable, 4).tolist()}; the Bernoulli closed loop max Re "
        f"{-decay.min():.4f}, interval [{interval[0]:.4f}, {interval[1]:.2f}]")

    with reused_bernoulli_gain(are, red, k0t, n_unstable):
        t0 = time.perf_counter()
        with timer.section("15b ARE, the reference's defaults"):
            z, k, _ = solve_are_stabilized(np_ops, sys64, ARE_ALPHA,
                                           interval=interval, red=red,
                                           device=dev, **WAKE_DEFAULTS)
            zh = z.cpu().numpy()
            max_re = reduced_closed_loop_max_re(red, k.cpu().numpy())
            res = dre_step_residual(np_ops, zh, k.cpu().numpy(),
                                    np.zeros_like(zh), ARE_ALPHA, np.inf)
        log(f"     ARE lu float64 at the reference's defaults {WAKE_DEFAULTS} "
            f"and the closed loop's interval "
            f"({time.perf_counter() - t0:.1f} s): "
            f"reduced closed loop max Re {max_re:.4f} "
            f"({'Hurwitz' if max_re < 0 else 'NOT Hurwitz'}), projected ARE "
            f"residual {res:.3e}")
        shifted = (WAKE_A_MIN, interval[1])
        log(f"     the tiers: {WAKE_ARE}, interval [{shifted[0]:g}, "
            f"{shifted[1]:.2f}]; the matfree tier {WAKE_MF_NEWTON} Newton "
            f"step(s) "
            f"({WAKE_MATFREE}) against lu float64 at {WAKE_MF_NEWTON}")
        runs = {}
        full_n = WAKE_ARE["n_newton"]
        tiers = (("lu", f64, full_n), ("lu", f32, full_n),
                 ("lu", f64, WAKE_MF_NEWTON), ("matfree", f32, WAKE_MF_NEWTON))
        for cache, dtype, n_newton in tiers:
            label = (f"{cache} {str(dtype).removeprefix('torch.')}, "
                     f"{n_newton} Newton")
            kw = dict(WAKE_ARE, n_newton=n_newton)
            if cache == "matfree":
                kw["matfree_kwargs"] = WAKE_MATFREE
            stage = {}
            spmm_kernel.launches = 0
            with timed_calls(are, "newton_adi_are", stage), \
                    recorded_spmm_inputs() as seen, \
                    timer.section(f"15b ARE {label}"), \
                    mgs_counted(f"15b ARE {label} (wake Re=60)",
                                expect=cache == "matfree"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                z, k, info = solve_are_stabilized(
                    np_ops, sys64, ARE_ALPHA, interval=shifted, red=red,
                    cache=cache, dtype=dtype, device=dev, **kw)
                torch.cuda.synchronize()
                total = time.perf_counter() - t0
            launches = spmm_kernel.launches
            check(info["n_unstable"] == 2 and bool(torch.isfinite(k).all()),
                  f"wake ARE {label}: {info['n_unstable']} modes, finite gain")
            hurwitz = ""
            if cache == "matfree" or n_newton == WAKE_ARE["n_newton"]:
                t0 = time.perf_counter()
                with timer.section(f"15b Hurwitz {label}"):
                    max_re = reduced_closed_loop_max_re(
                        red, k.double().cpu().numpy())
                check(max_re < 0,
                      f"wake ARE {label}: closed loop max Re {max_re:.3e}")
                hurwitz = (f", Hurwitz check {time.perf_counter() - t0:.1f}"
                           f" s: reduced closed loop max Re {max_re:.4f}")
            runs[label] = (z, k, launches, seen)
            log(f"     ARE {label}: {total:.1f} s (cache build "
                f"{total - stage['newton_adi_are']:.1f} s, Newton "
                f"{stage['newton_adi_are']:.2f} s){hurwitz}; spmm_tile "
                f"launches {launches}"
                + (f"; FGMRES {info['fgmres']}" if "fgmres" in info else ""))
    full = f"{WAKE_ARE['n_newton']} Newton"
    part = f"{WAKE_MF_NEWTON} Newton"
    k64 = runs[f"lu float64, {full}"][1]
    f32_dev = rel_err(runs[f"lu float32, {full}"][1].double(), k64)
    mf_run = runs[f"matfree float32, {part}"]
    mf_dev = rel_err(mf_run[1].double(), runs[f"lu float64, {part}"][1])
    check(f32_dev <= WAKE_F32_TOL, f"wake lu f32 vs f64 gains: {f32_dev:.2e}")
    check(mf_dev <= 10 * WAKE_MATFREE["tol"],
          f"wake matfree vs lu gains: {mf_dev:.2e}")
    check(mf_run[2] > 0, "spmm_tile launched on the matfree tier")
    t0 = time.perf_counter()
    with timer.section("15b ARE residuals"):
        pit = leray_projector(np_ops)
        residuals = {}
        for label, (z, k, _, _) in runs.items():
            z = z.double().cpu().numpy()
            residuals[label] = dre_step_residual(
                np_ops, z, k.double().cpu().numpy(), np.zeros_like(z),
                ARE_ALPHA, np.inf, pit=pit)
    k2_abs = check_spmm_inputs("15b wake ARE matfree", mf_run[3])
    log(f"     lu f32 vs f64 gains {f32_dev:.2e} (tol {WAKE_F32_TOL:g}); "
        f"matfree f32 vs lu f64 ({part}) {mf_dev:.2e} (tol 10 x "
        f"{WAKE_MATFREE['tol']:g}); projected ARE residual by tier "
        f"{ {k: f'{r:.3e}' for k, r in residuals.items()} } "
        f"({time.perf_counter() - t0:.1f} s with one Leray projector); peak "
        f"device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return ({f"15b are_matfree (wake Re=60, f32, {part})": mf_run[2]},
            k2_abs)


def precision_phase(dev, timer) -> tuple[int, dict]:
    """Phase 15 (c): scripts/bench_precision.run at its shape, K1 held
    against its plain version on the first X the run handed it; 'highest'
    within PREC_TOL of f64 in the table and at every horizon, the other
    tiers reported; TF32 off after the phase. Returns K1's launches and
    its record on that X."""
    import torch

    from optconpy_tpu_torch.ops import conv_kernel
    from optconpy_tpu_torch.scripts import bench_precision as bp

    conv_kernel.launches = 0
    with recorded_conv_input() as xs, timer.section("15c bench_precision"):
        out = bp.run(dev, log=lambda msg: log(f"      {msg}"))
    launches = conv_kernel.launches
    h_max = max(bp.HORIZONS)
    timed = (1 + 3) * bp.NTS + h_max  # first + 3 warm rollouts, the curve
    expected = len(bp.TIMED_TIERS) * timed + bp.NTS + h_max
    check(launches == expected,
          f"conv_p2 launches in bench_precision: {launches} != {expected}")
    tiers, curve = out["tiers"], out["high_tier_horizon_curve"]
    check(tiers["highest"]["finite"], "'highest' rollout finite")
    check(tiers["highest"]["rel_dev_vs_f64"] <= PREC_TOL,
          f"'highest' vs f64: {tiers['highest']['rel_dev_vs_f64']:.2e}")
    for h, entry in curve.items():
        check(entry["highest"]["rel_dev_vs_f64"] <= PREC_TOL,
              f"'highest' vs f64 at {h} steps: "
              f"{entry['highest']['rel_dev_vs_f64']:.2e}")
    check(tiers["high"]["tf32"] and not tiers["highest"]["tf32"],
          "TF32 on in 'high' only")
    check(torch.backends.cuda.matmul.allow_tf32 is False,
          "TF32 off after the precision tiers")
    k1_rec = check_conv_input("15c bench_precision rollout's first", *xs[0])
    try:  # a bf16 GEMM with an FP32 output, for a true 'default' time
        a = torch.ones((16, 16), device=dev, dtype=torch.bfloat16)
        bf16_out = torch.mm(a, a, out_dtype=torch.float32).dtype == \
            torch.float32
    except (TypeError, RuntimeError, NotImplementedError):
        bf16_out = False
    log(f"[15c] bench_precision ({out['scenarios']} x {out['horizon_steps']}, "
        f"f64 check on {out['f64_ref_scenarios']} scenarios, curve on "
        f"{out['horizon_scenarios']}; setup {out['setup_s']:.1f} s, gain "
        f"{out['gain_s']:.1f} s, step build {out['step_build_s']:.1f} s, f64 "
        f"references {out['f64_reference_s']:.1f} s): "
        + "; ".join(
            f"{t} ({r['gemm']}): "
            + (f"{r['solves_per_s']:.0f} solves/s, {r['rollout_s']:.4f} s"
               if r["timed"] else "not timed")
            + f", vs highest {r['rel_dev_vs_highest']:.3e}, vs f64 "
              f"{r['rel_dev_vs_f64']:.3e}, finite {r['finite']}"
            for t, r in tiers.items())
        + "; horizon curve vs f64 "
        + str({h: {t: f"{e['rel_dev_vs_f64']:.3e}" for t, e in entry.items()}
               for h, entry in curve.items()})
        + f"; conv_p2 launches {launches} ({out['convection']}); TF32 off "
          f"after; torch.mm(out_dtype=float32) on bf16: {bf16_out}")
    log("PRECISION " + json.dumps(out))
    return launches, k1_rec


def sanitizer_phase(dev, sys32, conv, fused32, ks, ws, v0, timer) -> None:
    """Phase 15 (d), beside phase 5's stepper: setup(debug_nans=True)
    raises FloatingPointError on a CUDA (x - x)/(x - x) and on the NaN K1
    makes of a NaN input, and with the mode off NaN flows through; one
    fused step traced by utils.profiling.trace into TRACE_DIR."""
    import os

    import torch

    from optconpy_tpu_torch import utils
    from optconpy_tpu_torch.mpc import batched_nse_closed_loop
    from optconpy_tpu_torch.ops import conv_kernel

    x = torch.ones(8, device=dev)
    v_nan = v0[:4].T.contiguous()
    v_nan[7, 2] = float("nan")
    raised = []
    with timer.section("15d sanitizer"):
        utils.setup(debug_nans=True)
        try:
            for what, fn in (("(x - x)/(x - x)", lambda: (x - x) / (x - x)),
                             ("conv_p2 on a NaN input",
                              lambda: conv_kernel.conv_inner(v_nan, conv))):
                try:
                    fn()
                except FloatingPointError as err:
                    raised.append(f"{what}: {err}")
        finally:
            utils.setup(debug_nans=False)
        flows = bool(torch.isnan((x - x) / (x - x)).all()) and bool(
            torch.isnan(conv_kernel.conv_inner(v_nan, conv)).any())
    check(len(raised) == 2, f"the sanitizer raised on {raised}")
    check(flows, "NaN flows through with the sanitizer off")
    with timer.section("15d trace"):
        with utils.trace(TRACE_DIR) as prof:
            batched_nse_closed_loop(sys32, conv, fused32, ks[:2], ws[:2], v0,
                                    ALPHA, DT)
    size = os.path.getsize(prof.trace_path)
    check(size > 0, "trace written")
    log(f"[15d] sanitizer (setup(debug_nans=True)) raised FloatingPointError "
        f"on {raised}; off, NaN flows through; one fused step traced by "
        f"utils.profiling.trace: {prof.trace_path} ({size} bytes)")


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit(
            "chip_smoke: torch.cuda.is_available() is false; this run "
            "needs an NVIDIA GPU and does not fall back to the CPU"
        )
    from optconpy_tpu_torch import utils
    from optconpy_tpu_torch.fem.device_conv import (
        ConvKernel,
        FusedConvKernel,
        QuadConvKernel,
    )
    from optconpy_tpu_torch.models.cylinder import cylinder_setup
    from optconpy_tpu_torch.mpc import batched_nse_closed_loop, build_nse_fused
    from optconpy_tpu_torch.ops import conv_kernel, cuda_build, spmm_kernel
    from optconpy_tpu_torch.riccati import (
        dre_backward_sweep,
        dre_shift_schedule_dae,
        load_or_build_inverse_stack,
    )
    from optconpy_tpu_torch.parallel import init_multihost, scenario_mesh
    from optconpy_tpu_torch.scripts import config3_cylinder, validate_gains
    from optconpy_tpu_torch.solvers.saddle import SaddleShiftedInverseCache

    timer = utils.SectionTimer()
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    cpu = torch.device("cpu")
    f32, f64 = torch.float32, torch.float64
    card = card_line()
    log(f"[1] card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    utils.setup()

    # --- 2. build -------------------------------------------------------
    info = cuda_build.build()
    log(f"[2] kernels built from optconpy_tpu_torch/csrc/ -> "
        f"{info.path.name} in {info.seconds:.2f} s (nvcc sm_90a, one "
        f"process per source, started together); each nvcc run "
        f"{ {k: round(t, 2) for k, t in info.steps.items()} } s, "
        f"{sum(info.steps.values()):.2f} s one after another")
    for line in info.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"    ptxas: {line.strip()}")

    # --- setup (host) ---------------------------------------------------
    t0 = time.perf_counter()
    np_ops, sys64, cond = cylinder_setup(
        re=RE, refinement=REFINEMENT, device=dev, dtype=f64
    )
    sys32 = sys64.to(dtype=f32)
    conv = FusedConvKernel.build(np_ops["full"], cond, device=dev)
    n, m = sys64.b.shape
    nt = conv.tri_dofs.shape[0]
    plan = conv.plan
    log(f"    setup {time.perf_counter() - t0:.1f} s (numpy element "
        f"matrices; {EARLIER_SETUP_S['bench']} s with the native element "
        f"library): n={n} n_p={sys64.n_p} m={m} nt={nt} ns={conv.ns}; "
        f"convection plan: {plan.pelem.shape[0]} patches, "
        f"{plan.bdst.shape[0]} dofs shared between patches; steady "
        f"residual {np_ops['steady_info']['residual']:.2e}")

    # --- 3. kernel vs plain ---------------------------------------------
    rng = np.random.default_rng(SEED)
    vbar = torch.as_tensor(np_ops["vbar_full"], dtype=f32)[conv.free.cpu()]
    kernel_err, kernel_ms, kernel_dev_ms, plain_ms = 0.0, None, None, None
    plan_bytes = sum(
        t.numel() * t.element_size()
        for t in (plan.vsrc, plan.vdir, plan.pelem, plan.pnd, plan.psptr,
                  plan.pslot, plan.pdst, plan.bdst, plan.bsrc)
    )
    for b in (S_BATCH, 3):
        v = (vbar[:, None] + torch.as_tensor(
            1e-3 * rng.standard_normal((n, b)), dtype=f32
        )).to(dev)
        out = conv_kernel.conv_inner(v, conv)
        ref = ConvKernel.conv_inner_batch_t(conv, v)  # the plain slot sums
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out).all()), f"kernel output finite B={b}")
        check(tuple(out.shape) == (n, b), f"kernel output shape B={b}")
        err = rel_err(out, ref)
        abs_err = float((out - ref).abs().max())
        check(err <= KERNEL_TOL, f"kernel vs plain B={b}: {err:.2e}")
        check(torch.equal(out, conv_kernel.conv_inner(v, conv)),
              f"kernel repeats bit for bit B={b}")
        kernel_err = max(kernel_err, abs_err)
        # events over back-to-back calls, as the replaced kernel was timed
        k_ms = event_ms(lambda: conv_kernel.conv_inner(v, conv), 50)
        p_ms = event_ms(lambda: ConvKernel.conv_inner_batch_t(conv, v), 50)
        # device time of the wrapper's two kernels, without the host's
        # launch cost that back-to-back calls at small B are bound by
        rows, _, _ = kernel_split(lambda: [
            conv_kernel.conv_inner(v, conv) for _ in range(20)
        ])
        d_ms = sum(us for name, (_, us) in rows.items()
                   if "conv_p2" in name) / 20 / 1e3
        bnd = bound_ms(
            4 * (2 * n * b + nt * 432) + plan_bytes, 1008 * nt * b, "float32"
        )
        if b == S_BATCH:
            kernel_ms, kernel_dev_ms, plain_ms = k_ms, d_ms, p_ms
            conv_bound = bnd
            v_wide = v
        log(f"[3] conv_p2 B={b} (free dofs in and out): rel err {err:.2e} "
            f"(abs {abs_err:.2e}, tol {KERNEL_TOL:g}) vs the plain slot "
            f"sums; kernel {k_ms * 1e3:.1f} us/call back to back (events), "
            f"{d_ms * 1e3:.1f} us/call on the device (profiler); plain "
            f"{p_ms * 1e3:.1f} us/call (events); bound {bnd[0] * 1e3:.1f} us "
            f"({bnd[1]}) = {bnd[0] / k_ms:.0%} of the kernel's event time"
            + (f"; replaced kernel {EARLIER_CONV_US} us (events, without "
               f"its glue)" if b == S_BATCH else ""))

    # --- 11 (d). QuadConvKernel beside K1 --------------------------------
    t11 = time.perf_counter()
    quad = QuadConvKernel.build(np_ops["full"], cond, device=dev, dtype=f32)
    spmm_kernel.launches = 0
    q_out = quad.conv_inner_batch_t(v_wide)
    quad_launches = spmm_kernel.launches
    check(quad_launches == 4, f"spmm_tile launches a QuadConvKernel call: "
                              f"{quad_launches} != 4")
    check(bool(torch.isfinite(q_out).all()), "QuadConvKernel output finite")
    q_err = rel_err(q_out, ConvKernel.conv_inner_batch_t(conv, v_wide))
    check(q_err <= KERNEL_TOL, f"QuadConvKernel vs plain: {q_err:.2e}")
    q_ms = event_ms(lambda: quad.conv_inner_batch_t(v_wide), 20)
    log(f"[11d] QuadConvKernel B={S_BATCH} f32 (spmm_tile: P, Gx, Gy "
        f"{quad.p_pack.shape} at B={2 * S_BATCH}, PwT {quad.pwt_pack.shape}; "
        f"{quad_launches} launches a call): rel err {q_err:.2e} vs ConvKernel's "
        f"plain slot sums (tol {KERNEL_TOL:g}); {q_ms * 1e3:.1f} us/call "
        f"(events) against conv_p2 {kernel_ms * 1e3:.1f} us/call")
    del quad, q_out
    t11 = time.perf_counter() - t11

    # --- 4. gains -------------------------------------------------------
    t0 = time.perf_counter()
    sig, sseq, iseq = dre_shift_schedule_dae(
        np_ops["A"], np_ops["M"], np_ops["J"], DT,
        num_shifts=N_SHIFTS, n_adi=N_ADI,
    )
    t_shifts = time.perf_counter() - t0
    at_til = (np_ops["A"].T - np_ops["M"] / (2.0 * DT)).tocsr()
    t0 = time.perf_counter()
    inv64, _ = load_or_build_inverse_stack(
        at_til, np_ops["M"], np_ops["J"], sig, np.float64
    )
    t_stack = time.perf_counter() - t0
    cache64 = SaddleShiftedInverseCache(torch.from_numpy(inv64).to(dev), n)
    del inv64
    cache32 = cache64.to(dtype=f32)
    log(f"[4] shifts {t_shifts:.1f} s, host f64 inverse stack "
        f"({N_SHIFTS} x {n} x {n}) {t_stack:.1f} s")

    def dre(sys, cache, alpha):
        return dre_backward_sweep(
            sys, cache, alpha, DT, NTS_GAIN, sseq, iseq,
            n_newton=N_NEWTON, r_max=R_MAX,
        )

    (_, ks64), t_dre64 = sync_time(lambda: dre(sys64, cache64, ALPHA))
    (zs32, ks32), t_first = sync_time(lambda: dre(sys32, cache32, ALPHA))
    gain_dev = rel_err(ks32.to(f64), ks64)
    check(bool(torch.isfinite(ks32).all()), "f32 gains finite")
    check(gain_dev <= GAIN_TOL, f"f32 vs f64 gains: {gain_dev:.2e}")
    warm = [
        sync_time(lambda: dre(sys32, cache32, ALPHA * (1 + 1e-4 * r)))[1]
        for r in range(1, 4)
    ]
    adi_iters = NTS_GAIN * N_NEWTON * N_ADI
    t_warm = statistics.median(warm)
    log(f"    DRE f64 {t_dre64:.2f} s, f32 first {t_first:.2f} s, f32 warm "
        f"{[round(t, 4) for t in warm]} s -> median {adi_iters / t_warm:.1f} "
        f"ADI iters/s; f32 vs f64 gain deviation {gain_dev:.2e} "
        f"(tol {GAIN_TOL:g})")
    del cache32
    check((RE, REFINEMENT, DT, ALPHA, NTS_GAIN, R_MAX, N_SHIFTS, N_ADI,
           N_NEWTON) == (validate_gains.RE, validate_gains.REFINEMENT,
                         validate_gains.DT, validate_gains.ALPHA,
                         validate_gains.NTS_GAIN, validate_gains.R_MAX,
                         validate_gains.N_SHIFTS, validate_gains.N_ADI,
                         validate_gains.N_NEWTON),
          "phase 4 runs scripts/validate_gains.py's bench shape")
    gq = validate_gains.certify(np_ops, zs32, ks32, log=lambda _: None)
    log(f"    GAINQ (scripts/validate_gains.py): projected DRE residual of the "
        f"f32 factors by step {[f'{r:.2e}' for r in gq['residuals']]} (host "
        f"f64), worst {gq['worst']:.2e} < {validate_gains.RESIDUAL_BOUND:g}; "
        f"{gq['residual_s']:.2f} s with one Leray projector built in "
        f"{gq['projector_s']:.2f} s ({gq['saved_s']:.2f} s of host time saved "
        f"over {len(gq['residuals'])} steps)")
    del zs32

    # --- 5. rollout -----------------------------------------------------
    t0 = time.perf_counter()
    fused64 = build_nse_fused(np_ops, cond, DT, device=cpu, dtype=f64)
    fused32 = fused64.to(dev, f32)
    log(f"[5] fused step build (host f64) {time.perf_counter() - t0:.1f} s")
    k0 = ks32[0]
    ks = k0.expand(NTS + 1, m, n)
    ws = torch.zeros((NTS + 1, n), dtype=f32, device=dev)
    vbar = fused64.vbar.numpy()
    v0_np = vbar[None] + 1e-3 * rng.standard_normal((S_BATCH, n))
    v0 = torch.as_tensor(v0_np, dtype=f32).to(dev)
    check(torch.backends.cuda.matmul.allow_tf32 is False, "TF32 matmul off")
    check(torch.backends.cudnn.allow_tf32 is False, "TF32 cuDNN off")

    def rollout():
        return batched_nse_closed_loop(
            sys32, conv, fused32, ks, ws, v0, ALPHA, DT
        )

    torch.cuda.reset_peak_memory_stats()
    conv_kernel.launches = 0
    (vs, us, ys), t_cold = sync_time(rollout)
    main_launches = conv_kernel.launches
    check(main_launches == NTS,
          f"conv_p2 launches in the rollout: {main_launches} != {NTS}")
    check(tuple(ys.shape) == (S_BATCH, NTS + 1, sys32.p_out), "ys shape")
    check(tuple(us.shape) == (S_BATCH, NTS, m), "us shape")
    for name, x in (("vs", vs), ("us", us), ("ys", ys)):
        check(bool(torch.isfinite(x).all()), f"rollout {name} finite")
    warm = [sync_time(rollout)[1] for _ in range(3)]
    t_roll = statistics.median(warm)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    rows, wall, _ = kernel_split(rollout)
    busy_us = sum(us for _, us in rows.values())
    log(f"    profiler, one warm rollout ({NTS} steps, {wall * 1e3:.2f} ms "
        f"wall, device busy {busy_us / 1e3:.2f} ms = "
        f"{busy_us / 1e3 / (wall * 1e3):.1%}); per step: calls, us, share "
        f"of the wall")
    for name, (n_calls, dev_us) in sorted(rows.items(),
                                          key=lambda r: -r[1][1]):
        log(f"      {n_calls / NTS:6.3f} x {dev_us / n_calls:9.2f} us "
            f"{dev_us / 1e3 / (wall * 1e3):6.1%}  {name[:110]}")

    def calls(*words):
        return sum(c for name, (c, _) in rows.items()
                   if any(w in name.lower() for w in words))

    check(calls("conv_p2_patch") == NTS,
          f"profiled convection kernels: {calls('conv_p2_patch')} != {NTS}")
    check(calls("index", "gather", "scatter") == 0,
          "index_put, gather or scatter kernels in the rollout")
    # copies only once per rollout (the transposed initial state and the
    # final stack), none in a step
    check(calls("copy") < NTS, f"copy kernels in the rollout: {calls('copy')}")
    v0_t = v0.T.contiguous()
    gemm_ms = event_ms(lambda: fused32.pmat @ v0_t, 20)
    log(f"    rollout {S_BATCH} x {NTS}: cold {t_cold:.3f} s, warm "
        f"{[round(t, 4) for t in warm]} s -> median "
        f"{S_BATCH * NTS / t_roll:.0f} solves/s "
        f"({t_roll / NTS * 1e3:.3f} ms/step; one ({n} x {n}) @ ({n} x "
        f"{S_BATCH}) f32 GEMM {gemm_ms:.3f} ms, conv_p2 {kernel_dev_ms:.3f} ms "
        f"on the device); "
        f"conv_p2 launches {main_launches}; peak device memory "
        f"{peak_gb:.2f} GB; TF32 off")

    # --- 6. in-run f64 check on the CPU ---------------------------------
    t0 = time.perf_counter()
    conv64 = ConvKernel.build(np_ops["full"], cond, device=cpu, dtype=f64)
    _, _, ys_ref = batched_nse_closed_loop(
        sys64.to(cpu), conv64, fused64, k0.to(cpu, f64).expand(NTS + 1, m, n),
        torch.zeros((NTS + 1, n), dtype=f64),
        torch.as_tensor(v0_np[:S_REF]), ALPHA, DT,
    )
    roll_dev = rel_err(ys[:S_REF].to(cpu, f64), ys_ref)
    check(roll_dev <= ROLLOUT_TOL, f"rollout vs f64: {roll_dev:.2e}")
    log(f"[6] rollout vs f64 recurrence ({S_REF} scenarios, CPU, "
        f"{time.perf_counter() - t0:.1f} s): {roll_dev:.2e} "
        f"(tol {ROLLOUT_TOL:g})")

    # --- 15 (d). the sanitizer and a trace, on phase 5's stepper --------
    sanitizer_phase(dev, sys32, conv, fused32, ks, ws, v0, timer)

    # --- 14 (b). the sharded rollout at world size 1 ---------------------
    store = tempfile.TemporaryDirectory()
    init_multihost(dev, f"file://{store.name}/store", rank=0, world_size=1)
    mesh = scenario_mesh(dev)
    k1_sharded = sharded_fused_phase(mesh, sys32, conv, fused32, ks, ws, v0,
                                     ys, us)
    del fused64, fused32, conv, conv64

    # --- 7. SpMM kernel vs plain on the config-3 pencil -----------------
    t0 = time.perf_counter()
    c3_ops, c3_sys64, c3_cond = cylinder_setup(
        re=C3_RE, refinement=C3_REFINEMENT, device=dev, dtype=f64
    )
    t_setup3 = time.perf_counter() - t0
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        c3_iv = config3_cylinder.shift_interval(c3_ops, cache_dir=tmp)
    c3_sched = config3_cylinder.schedule(c3_iv, C3_SHIFTS, C3_ADI)
    c3_sched12 = config3_cylinder.schedule(c3_iv, C3_MF_SHIFTS, C3_ADI)
    log(f"[7] config-3 setup {t_setup3:.1f} s (numpy element matrices; "
        f"{EARLIER_SETUP_S['config 3']} s with the native element library): "
        f"n={c3_sys64.n} "
        f"n_p={c3_sys64.n_p} m={c3_sys64.m_in}, steady residual "
        f"{c3_ops['steady_info']['residual']:.2e}; shift interval of "
        f"scripts/config3_cylinder.py [{c3_iv[0]:.4f}, {c3_iv[1]:.2f}] "
        f"(refinement 1's projected bottom, refinement 2's ARPACK top) in "
        f"{time.perf_counter() - t0:.1f} s; {C3_SHIFTS} shifts "
        f"{np.round(c3_sched[0], 2).tolist()}, {C3_MF_SHIFTS} shifts "
        f"{np.round(c3_sched12[0], 2).tolist()}")
    spmm_head, spmm_err = spmm_phase(c3_ops, dev)
    mgs_head = mgs_phase(c3_sys64.n + c3_sys64.n_p, sys64.n + sys64.n_p, dev)

    # --- 8. NS stack at the bench shape ---------------------------------
    k2_ns, k2_ns_err = bench_ns_phase(sys32, cache64, ks64, sig, sseq, iseq,
                                      (at_til, np_ops["M"], np_ops["J"]))
    spmm_err = max(spmm_err, k2_ns_err)

    # --- 11 (a). the matrix-free tier at the bench shape ------------------
    t0 = time.perf_counter()
    k2_paths = matfree_bench_phase(np_ops, cond, sys64, cache64,
                                   (sig, sseq, iseq), dev)
    t11 += time.perf_counter() - t0
    k2_paths.update(k2_ns)
    del cache64, sys32

    # --- 12. receding-horizon MPC ---------------------------------------
    t12 = time.perf_counter()
    k1_rh, k2_rh, k1_receding, rh_err = receding_phase(np_ops, cond, sys64,
                                                       dev)
    spmm_err = max(spmm_err, rh_err["k2"])
    kernel_err = max(kernel_err, rh_err["k1"])
    del sys64
    torch.cuda.empty_cache()
    receding_lu_phase(dev)
    t12 = time.perf_counter() - t12
    log(f"[12] phase 12 wall {t12:.1f} s")

    # --- 9. config 3 ----------------------------------------------------
    spmm_launches, c3_ks64, c3_ks32, c3_pit, t_pit = config3_phase(
        c3_ops, c3_sys64, c3_sched)

    # --- 11 (b). config 3 on the matrix-free tier -----------------------
    t0 = time.perf_counter()
    k1_paths, k2_b = matfree_config3_phase(c3_ops, c3_cond, c3_sys64,
                                           c3_sched12, c3_ks64, c3_ks32,
                                           c3_pit, t_pit, dev)
    k2_paths.update(k2_b)
    del c3_pit
    t11 += time.perf_counter() - t0

    # --- 10. the driver ---------------------------------------------------
    rng = np.random.default_rng(SEED)
    driver_launches, k2_paths["11c cavity driver matfree (f64)"], t_c = (
        driver_phase(vbar[None] + 1e-3 * rng.standard_normal((S_BATCH, n)),
                     dev)
    )
    golden_lu_phase(dev)
    k2_paths["11d QuadConvKernel call (bench, f32)"] = quad_launches
    k1_paths.update(k1_rh)
    k2_paths.update(k2_rh)
    log(f"[11] phase 11 wall {t11 + t_c:.1f} s ((a), (b) and (d) "
        f"{t11:.1f} s, (c) {t_c:.1f} s)")

    # --- 13. the config-5 parameter sweep -------------------------------
    k1_sw, k2_sw, k1_sweep, k2_sw_err = sweep_phase(dev, card, mesh)
    k1_paths.update(k1_sw)
    k2_paths.update(k2_sw)
    k1_paths["14b sharded_nse_rollout (fused, 1024 x 64, world size 1)"] = (
        k1_sharded)
    kernel_err = max(kernel_err, k1_sweep.pop("max_abs_err"))
    spmm_err = max(spmm_err, k2_sw_err)
    torch.distributed.destroy_process_group()
    store.cleanup()

    # --- 14. config 3XL and the dry run on two ranks --------------------
    t14 = time.perf_counter()
    k1_xl, k2_xl, k1_3xl, k2_xl_err = config3xl_phase(dev)
    k1_paths.update(k1_xl)
    k2_paths.update(k2_xl)
    kernel_err = max(kernel_err, k1_3xl.pop("max_abs_err"))
    spmm_err = max(spmm_err, k2_xl_err)
    log(f"[14a] phase 14 (a) wall {time.perf_counter() - t14:.1f} s")
    k1_dry, k2_dry = dryrun_phase()
    k1_paths.update(k1_dry)
    k2_paths.update(k2_dry)

    # --- 15. the stabilized ARE and the precision tiers ------------------
    t15 = time.perf_counter()
    cavity_are_phase(dev, timer)
    k2_are, k2_are_err = wake_are_phase(dev, timer)
    k2_paths.update(k2_are)
    spmm_err = max(spmm_err, k2_are_err)
    k1_prec_launches, k1_prec = precision_phase(dev, timer)
    k1_paths["15c bench_precision (1024 x 64 x 3 tiers, the 500-step "
             "curve)"] = k1_prec_launches
    kernel_err = max(kernel_err, k1_prec.pop("max_abs_err"))
    log(f"[15] phase 15 wall {time.perf_counter() - t15:.1f} s; sections "
        f"(synchronized): {json.dumps(timer.summary())}")

    log(f"chip_smoke wall {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": [
        {
            "name": "conv_p2",
            "route": "cuda",
            "source": "optconpy_tpu_torch/csrc/conv_p2.cu",
            "replaces": "optconpy_tpu/ops/pallas_conv.py:74",
            "launches": main_launches,
            "driver_launches": driver_launches["conv_p2"],
            "launches_by_path": k1_paths,
            "max_abs_err": kernel_err,
            "ms": kernel_ms,
            "device_ms": kernel_dev_ms,
            "plain_ms": plain_ms,
            "bound_ms": conv_bound[0],
            "bound_by": conv_bound[1],
            "library_ms": None,
            "at": f"B={S_BATCH}, n={n}, nt={nt}, float32",
            "receding": k1_receding,
            "sweep": k1_sweep,
            "config3xl": k1_3xl,
            "bench_precision": k1_prec,
        },
        {
            "name": "spmm_tile",
            "route": "cuda",
            "source": "optconpy_tpu_torch/csrc/spmm_tile.cu",
            "replaces": "optconpy_tpu/ops/pallas_spmm.py:197",
            "launches": spmm_launches,
            "driver_launches": driver_launches["spmm_tile"],
            "launches_by_path": k2_paths,
            "max_abs_err": spmm_err,
            **spmm_head,
        },
        {
            "name": "mgs_step",
            "route": "cuda",
            "source": "optconpy_tpu_torch/csrc/mgs_step.cu",
            "replaces": None,
            "tpu_path": "optconpy_tpu/solvers/krylov.py:119-127 (lax.fori_loop)",
            "launches": MGS_PATHS[
                f"11b config3_script matfree DRE sweep (f32, {C3_MF_SHIFTS} "
                f"shifts)"],
            "launches_by_path": MGS_PATHS,
            **mgs_head,
        },
    ]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    sys.exit(main())
