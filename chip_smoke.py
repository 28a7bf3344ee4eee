#!/usr/bin/env python3
"""Full-shape checks of the PyTorch/CUDA port's entry points on one
NVIDIA GPU, and each hand-written kernel's time when it runs alone.

Drives optconpy_tpu_torch (never jax) through the entry points a user
calls, at the configurations' own shapes. The benchmark (cudabench/)
measures the system; the `cuda` tests (tests/test_torch_cuda.py,
tests/test_torch_arnoldi_kernel.py) hold the kernels against their plain
versions at small shapes and some full ones. This run holds each kernel
against its plain version at the main paths' full shapes and on the
paths' own inputs, reads every entry point's launch counts from its own
run, and checks what the entry points return. Bench shape (phases 3-6,
8): cylinder wake Re=100, refinement 1 (n=4396), 6 Wachspress shifts, 32
ADI iterations, rank 32, 6 DRE steps, one Newton step, dt=0.005,
alpha=1e-2, 1024 scenarios x 64 closed-loop steps with the t=0 gain
broadcast and no feedforward. Config 3 (phases 7, 9, 11 (b)): cylinder
wake Re=60, refinement 2 (n=15,316, n_p=2,080), dt=0.01, alpha=1e-4, 8
shifts, 16 ADI iterations, rank 40, 16 DRE steps, one Newton step.
Phases and what each checks:

  1. a CUDA card (its name and power limit are printed);
  2. the kernels build from optconpy_tpu_torch/csrc/;
  3. the convection kernel K1 alone on the free-dof contract at B=1024
     and B=3: its time (CUDA events and profiler device time) beside its
     plain torch version's and the bound of cudabench/roofline.py;
  4. DRE gains in f32 and f64 on the card from one f64 host splu stack:
     f32 finite and <= 1e-4 from f64; every step's f32 factors certified
     by scripts/validate_gains.py (projected DRE residual, host f64,
     below the GAINQ bound 1e-3);
  5. the fused closed loop, 1024 x 64: K1 and K2 (the step's sparse
     P = M/dt + L1) once a step, K2 held against its plain version on the
     rollout's own inputs, output shapes, finite outputs, TF32 off; a
     torch.profiler listing of one rollout with one K1 and one K2 a step
     and no index_put, gather, scatter or per-step copy kernel;
  6. 2 scenarios of it in f64 on the CPU with the plain versions
     (closed-loop outputs <= 1e-4);
  7. (a) the SpMM kernel K2 vs its plain torch version on the config-3
     NS pencil (Atil^T, M, J, J^T) at B = 17,396, 46, 16, 8, 4 and 1, f32
     (<= 1e-5) and f64 (<= 1e-12), and on phase 5's fused-step P at
     B = 1024 and 1 in f32: finite, a repeat bit for bit, and
     torch.sparse.mm within the same bound; each timed alone beside its
     plain version, torch.sparse.mm and its bound; (b) the Arnoldi
     step's MGS kernel vs its plain loop, every step of a 30-step cycle
     (H column and new basis vector, <= 2e-5 f32, <= 1e-12 f64) at config
     3's saddle (n = 17,396; q = 4, 46 and 1,024 in f32, 46 in f64) and at
     the bench shape's (n = 5,037, q = 3, f64), each cycle then timed
     alone beside the plain loop and its bytes bound;
  8. the f32 NS stack at the bench shape's 6 shifts through K2: (a) the
     reference's ladder (build_dre_cache_dae_ns); (b)
     build_inverse_stack_ns with keep_full=True on NS_LADDER: the full
     stack's velocity blocks in the original order bit-equal to the
     stack, K2 held against its plain version on the ladder's inputs;
     for each, K2 launched, every shift certified, each shift <= 1e-4
     from phase 4's host f64 stack, gains finite and <= 1e-4 from phase
     4's f64 gains;
  9. config 3 on the NS tier with the shift interval of
     scripts/config3_cylinder.py: the f64 stack certified at 1e-8; the
     f32 stack (K2 launched) and its DRE sweep: gains finite and <= 1e-4
     from f64, |JZ|/|Z| <= 1e-5, the projected DRE residual at steps 0
     and 8 <= 1e-2 (host f64, one Leray projector for phases 9 and
     11 (b));
 10. the user's entry point optcon_nse: (a) config 4 (the bench shape
     with a feedforward and a gain for each of 64 steps) in f32 on the
     fused step tier with Newton-Schulz gains, 1024 scenarios: K1 and K2
     exactly 64 launches in the rollout, K1 none elsewhere, K2 in the DRE
     stage, output shapes,
     finite gains, outputs and cost, TF32 off; (b) the same in f64 on 2
     scenarios: gains and ys <= 1e-4 from f32; (c) config 1 (heat1d) on
     the lu tiers, card vs CPU (<= 1e-10); (d) the lu tiers on the card
     vs the port's dense f64 golden (golden/dense_lqr.py) on the cavity
     (nx=6, 30 steps) and heat1d (n=64, 50 steps): DRE factors and gains
     <= 1e-5, closed-loop v, u, y <= 1e-4;
 11. the matrix-free tier: (a) at the bench shape in f64: 12 ADI
     iterations through SaddleMatfreeCache (K2 and the MGS kernel
     launched, finite, <= 1e-6 from the same iterations through phase 4's
     host inverse stack), the matrix-free stepper vs the lu stepper, 3
     scenarios x 6 steps in both feedback modes (v, u, y <= 1e-7; K2 and
     the MGS kernel launched); (b) scripts/config3_cylinder.py's
     matrix-free stages in f32: the 12-shift DRE sweep, first and 1 warm
     repeat (the script's 3 cut for time; K2 and the MGS kernel
     launched, gains finite and <= 1e-3 from phase 9's f64 NS gains, the
     projected DRE residual at step 0 <= 1e-2), K1 at B=16 vs plain
     (<= 1e-5, timed alone), and the closed loop from phase 9's f32 NS
     gain, 16 x 100, controlled and uncontrolled (K1 101 launches and K2
     launched a rollout, the MGS kernel launched, finite, output shape,
     energy ratio at T < 0.5); (c) the cavity on the matrix-free step and
     DRE tiers over 1 of its 20 steps, card vs CPU (<= 1e-8; K2 in the DRE
     and the rollout stages, the MGS kernel launched);
 12. receding-horizon MPC: (a) scripts/bench_receding.run, config 4's
     macro loop (1024 scenarios, f32) in its three variants full, fast
     and dense_ns, 3 macros (the script's 6, cut for time) after a
     2-macro warm-up (the full rebuild's: 1): K2 held against its plain
     version on every (pack, width, dtype) the warm-ups hand it and K1 on
     their first X; per variant the states' shape, finite gains, K1 9
     launches a macro, K2 launched, the MGS kernel launched in the
     matrix-free variants, perturbation decay < 1, every dense_ns NS
     refresh certified at 5e-4 in f64; fast vs full, dense_ns vs full and
     dense_ns vs fast gains on every macro <= 1e-4; dense_ns in f64 for 2
     macros on the same scenarios: gains and C v <= 1e-4; (b) the lu tier
     on the reference test's cavity, card vs CPU (vs, us, ks <= 1e-10);
 13. the config-5 sweep through scripts/sweep_config5.run at its shape (8
     Re buckets over 60-150, 8,192 scenarios padded to 8 x 1,280, 200
     steps, f32, TF32 off; gains from 4 DRE steps, the script's 8 cut for
     time): one DRE sweep a bucket and one NS chain, K2 held against its
     plain version on every input they hand it, the MGS kernel launched,
     gains finite, the chain certified at 1e-4, the first and last
     bucket's gains <= 1e-4 from f64 NS-tier gains; the script's first
     and warm sweep: K1 200 launches and K2 none each, the outputs'
     shapes, finite, bit-equal; K1 held on the sweep's first X; the
     masked statistics' counts exact, finite and unchanged with NaN
     padded rows; 2 scenarios of the first and last bucket <= 1e-4 from
     f64 on the lu stepper tier, and in f32 on f32 lu steppers (<= 1e-4,
     K1 200 launches); a profiler listing of a warm sweep with one K1 a
     step and no copy kernel a step;
 14. (a) scripts/config3xl_cylinder.run at the reference's shape
     (refinement 3, n=31,282, n_p=4,145, f32): the sizes, |JZ|/|Z| and
     the projected DRE residual within the script's bounds, a finite
     closed loop, K2 in both DRE sweeps, K1 once a step and once more in
     the rollout, the MGS kernel launched, K1 and K2 held against their
     plain versions on the run's inputs; (b) a world-size-1 NCCL group:
     sharded_nse_rollout on phase 5's fused stepper (K1 64 launches, ys
     bit-equal, statistics those of phase 5's outputs) and, in phase 13,
     sharded_sweep_rollout (K1 200 launches, K2 none, ys bit-equal,
     statistics equal to masked_sweep_stats); then the dry run
     (parallel/dryrun.py) on 2 spawned gloo ranks sharing the card: both
     kernels launched on every rank, every stage's statistics equal
     across the ranks;
 15. (a) solve_are_stabilized on the unstable cavity of
     tests/test_bernoulli_are.py (f64, lu tier, the reference's 8 shifts
     x 24 ADI, 8 Newton steps, rank 40): 2 unstable modes, card vs CPU
     <= 1e-10, vs the dense reduced CARE golden < 1e-6, the reduced
     closed loop Hurwitz, the dt=inf DRE step residual equal to the
     dense projected ARE residual and ~0 on the golden X; (b) the Re=60
     wake (refinement 1): 2 unstable modes and a Hurwitz Bernoulli closed
     loop; the ARE at 192 ADI over [20, a_max] on the lu tier in f64 and
     f32 and the matfree tier in f32 for 1 Newton step (K2 held against
     its plain version on its inputs, the MGS kernel launched): finite
     gains, the reduced closed loop Hurwitz, lu f32 vs f64 <= 1e-4,
     matfree vs lu f64 <= 10x its FGMRES tol; (c)
     scripts/bench_precision.run at 1024 x 64 with its 500-step curve:
     K1's launches, 'highest' finite and <= 1e-4 from f64 in the table and
     at every horizon, TF32 in 'high' only and off afterwards, K1 held on
     the run's first X; (d) the NaN sanitizer (setup(debug_nans=True))
     raising on a CUDA 0/0 and on K1's NaN, NaN flowing with it off, and
     one fused step traced by utils.profiling.trace.

The phases run in main()'s order, not their numbers'. Every failed check
raises, so the exit code is non-zero. The last three lines are the
kernels JSON (each kernel's name, source and the TPU kernel it replaces,
its launches on its main path, its largest absolute error against its
plain version on the paths' own inputs, and its time alone beside its
plain version's, its bound and a library call's), the card's name and
power limit, and {"ok": true, "device": {...}}.

Usage: python3 chip_smoke.py
"""
from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager, nullcontext

import numpy as np

from cudabench import roofline

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
# another order (by block, then over a cluster's blocks and over clusters),
# so rounding only.
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
# Re=60, refinement 1, on the lu tier in f64 and f32 and the matfree tier
# in f32; (c) scripts/bench_precision.py at its shape; (d) the NaN
# sanitizer and a profiler trace.
ARE_ALPHA = 1e-2
ARE_CARD_TOL = 1e-10  # cavity, card vs CPU, f64
ARE_GOLDEN_TOL = 1e-6  # vs the golden (test_bernoulli_are.py:71)
WAKE_RE, WAKE_REFINEMENT = 60.0, 1
WAKE_N, WAKE_NP = 4396, 641
WAKE_F32_TOL = 1e-4  # lu f32 vs f64 gains: the north-star gain bound
# The reference's defaults (8 shifts, 24 ADI) leave the wake's closed loop
# unstable: real shifts damp the Bernoulli closed loop's -0.195 +- 16.86i
# pair by about 1% an ADI iteration, so 24 iterations resolve little of
# it (max Re +0.026, ARE residual 0.90 on an H100). The tiers run 192
# iterations over shifts from WAKE_A_MIN up: the matrix-free
# preconditioner (block Jacobi, L_p pressure Schur) leaves FGMRES far
# above tol at |shift| < 3 (relres 0.90 at 0.33 after 20 cycles, with the
# whole velocity block exact still 3.5e-4), and every tier solves with the
# same shifts. The matfree tier runs WAKE_MF_NEWTON Newton step against
# an lu f64 run of the same: at about 0.09 s an FGMRES solve, 8 steps
# (3,072 solves) would not fit the time limit.
WAKE_ARE = dict(n_shifts=8, n_adi=192, n_newton=8, r_max=40)
WAKE_A_MIN = 20.0
WAKE_MF_NEWTON = 1
WAKE_MATFREE = dict(block=512, tol=1e-5, max_cycles=20)
PREC_TOL = 1e-4  # 'highest' vs f64 at every horizon: the rollout bound
TRACE_DIR = "data/profile"  # gitignored


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


def rel_err(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


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


def kernel_split(fn) -> dict:
    """Run fn once under torch.profiler. Returns {kernel name: [calls,
    device us]} for the device activity it traced."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            row = rows.setdefault(e.name, [0, 0.0])
            row[0] += 1
            row[1] += e.time_range.elapsed_us()
    return rows


def kernel_calls(rows: dict, *words) -> int:
    """Calls of the kernels of kernel_split's rows whose lower-case name
    holds one of the words."""
    return sum(c for name, (c, _) in rows.items()
               if any(w in name.lower() for w in words))


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


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


def spmm_phase(c3_ops, fused_p, dev) -> dict:
    """Phase 7 (a): the SpMM kernel vs its plain version and
    torch.sparse.mm on the config-3 NS pencil's operators, at the NS
    width and the matrix-free tier's widths (46 the ADI block p + r_max +
    m, 16 the rollout, 4 SMW), and on the fused step's P (the float32
    pack `fused_p`) at the rollout's width and at 1, each timed alone
    beside its plain version, torch.sparse.mm and its bound. Returns the
    JSON fields of Atil^T at the NS width in float32."""
    import torch

    from optconpy_tpu_torch.ops import spmm_kernel
    from optconpy_tpu_torch.solvers.ns_inverse import SaddleOpsPack

    at_til = (c3_ops["A"].T - c3_ops["M"] / (2.0 * C3_DT)).tocsr()
    gen = torch.Generator(dev).manual_seed(SEED)
    head = None
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).removeprefix("torch.")
        pack, *_ = SaddleOpsPack.build(
            at_til, c3_ops["M"], c3_ops["J"], device=dev, dtype=dtype
        )
        nn = pack.n + pack.n_p
        cases = [(name, getattr(pack, name), (nn, 46, 16, 8, 4, 1))
                 for name in ("at", "m", "j", "jt")]
        if dtype == fused_p.dtype:
            cases.append(("fused P", fused_p, (S_BATCH, 1)))
        for name, a, widths in cases:
            m_rows, n_cols = a.shape
            nnz = a.nnz
            lib_a = pack_csr(a)
            for b in widths:
                x = torch.randn((n_cols, b), generator=gen, dtype=dtype,
                                device=dev)
                y = spmm_kernel.spmm(a, x)
                ref = spmm_kernel.spmm_plain(a, x)
                torch.cuda.synchronize()
                err = rel_err(y, ref)
                check(bool(torch.isfinite(y).all()), f"spmm {name} finite")
                check(err <= SPMM_TOL[dname],
                      f"spmm {name} B={b} {dname}: {err:.2e}")
                check(torch.equal(y, spmm_kernel.spmm(a, x)),
                      f"spmm {name} B={b} {dname} repeats bit for bit")
                wide = b == nn
                k_ms = event_ms(lambda: spmm_kernel.spmm(a, x), 20)
                p_ms = event_ms(lambda: spmm_kernel.spmm_plain(a, x),
                                3 if wide else 20)
                l_ms = event_ms(lambda: torch.sparse.mm(lib_a, x), 20)
                lib_err = rel_err(torch.sparse.mm(lib_a, x), ref)
                check(lib_err <= SPMM_TOL[dname],
                      f"torch.sparse.mm {name} B={b} {dname}: {lib_err:.2e}")
                itemsize = x.element_size()
                bound, bound_by = roofline.bound_s(
                    itemsize * (n_cols + m_rows) * b
                    + (itemsize + 4) * nnz + 4 * m_rows,
                    2 * nnz * b, dname,
                )
                log(f"[7] spmm_tile {name} ({m_rows}x{n_cols}, nnz {nnz}) "
                    f"B={b} {dname}: rel err {err:.2e} (tol "
                    f"{SPMM_TOL[dname]:g}), torch.sparse.mm {lib_err:.1e}; "
                    f"alone {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
                    f"torch.sparse.mm {l_ms:.4f} ms; bound "
                    f"{bound * 1e3:.4f} ms ({bound_by}) = "
                    f"{bound * 1e3 / k_ms:.0%} of the kernel's time")
                if name == "at" and wide and dtype == torch.float32:
                    head = {
                        "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound * 1e3,
                        "bound_by": bound_by, "library_ms": l_ms,
                        "at": f"Atil^T {m_rows}x{n_cols} (nnz {nnz}) @ "
                              f"X {n_cols}x{b}, float32",
                    }
                del x, y, ref
        del pack
    return head


def mgs_phase(n_c3: int, n_bench: int, dev) -> tuple[dict, float]:
    """Phase 7 (b): the Arnoldi step's MGS kernel vs its plain loop over
    whole 30-step cycles of a banded nonsymmetric operator's Krylov basis,
    every step's H column and new basis vector (<= MGS_TOL), then timed
    alone with CUDA events beside the plain loop and its bytes bound: each
    basis vector read once, w read once and v_{j+1} written once a step.
    At config 3's matrix-free saddle (n_c3) the gains cell's widths q = 4
    and 46 (float32; and float64 at 46) and q = 1,024 (float32, the
    streamed parameter set); at the bench shape's saddle (n_bench) phase
    11 (a)'s matrix-free stepper, q = MF_STEP_S in float64. Returns the
    JSON fields of q = 46 in float32 and the largest absolute error."""
    import torch

    from optconpy_tpu_torch.ops import arnoldi_kernel as ak
    from optconpy_tpu_torch.solvers import krylov

    m = 30
    gen = torch.Generator(dev).manual_seed(SEED)
    head, max_abs = None, 0.0
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
            max_abs = max(max_abs, float((hk[:, j] - h[:, j]).abs().max()),
                          float((vk[j + 1] - vs[j + 1]).abs().max()))
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
        bound, bound_by = roofline.bound_s(nbytes, flops, dname)
        log(f"[7b] mgs_step at n={n} q={q} {dname}: rel err {err:.2e} (tol "
            f"{MGS_TOL[dname]:g}); a 30-step cycle alone: kernel "
            f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {bound * 1e3:.4f} ms "
            f"({bound_by}) = {bound * 1e3 / k_ms:.0%} of the kernel's time")
        if (n, q, dtype) == (n_c3, 46, torch.float32):
            head = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bound * 1e3,
                    "bound_by": bound_by,
                    "at": f"a 30-step Arnoldi cycle, n={n}, q={q}, float32"}
        del vs, vk, h, hk, ws
    return head, max_abs


def bench_ns_phase(sys32, cache64, ks64, sig, sseq, iseq, pencil) -> float:
    """Phase 8: the f32 NS stack at the bench shape's shifts, built
    through the SpMM kernel, against phase 4's host f64 splu stack and
    its f64 gains: (a) through build_dre_cache_dae_ns (the reference's
    ladder); (b) through build_inverse_stack_ns on the same pencil
    (Atil^T, M, J) with keep_full=True and NS_LADDER. Returns K2's
    largest absolute error against its plain version on (b)'s inputs."""
    import torch

    from optconpy_tpu_torch.ops import spmm_kernel
    from optconpy_tpu_torch.riccati import (
        build_dre_cache_dae_ns,
        dre_backward_sweep,
    )
    from optconpy_tpu_torch.solvers.ns_inverse import build_inverse_stack_ns
    from optconpy_tpu_torch.solvers.saddle import SaddleShiftedInverseCache

    def held(label, cache, info, launches):
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
        log(f"[8] {label} bench-shape f32 NS stack ({len(sig)} shifts): "
            f"{launches} spmm_tile launches, every shift certified at "
            f"{info['certify_tol']:g}; deviation from the host f64 splu "
            f"stack {max(devs):.2e}, gains vs phase 4's f64 gains "
            f"{gain_dev:.2e} (tol {GAIN_TOL:g} each)")

    # (a) the reference's ladder, through build_dre_cache_dae_ns
    spmm_kernel.launches = 0
    cache, info = build_dre_cache_dae_ns(sys32, DT, sig)
    held("(a)", cache, info, spmm_kernel.launches)
    del cache

    # (b) a non-default ladder keeping the full inverses; K2's inputs
    # recorded during the build
    with recorded_spmm_inputs() as seen:
        spmm_kernel.launches = 0
        inv, info = build_inverse_stack_ns(
            *pencil, sig, torch.float32, keep_full=True,
            device=sys32.b.device, **NS_LADDER)
        launches = spmm_kernel.launches
    full, n = info.pop("full_stack"), sys32.n
    check(tuple(full.shape) == (len(sig), n + sys32.n_p, n + sys32.n_p),
          f"8 (b) full stack shape {tuple(full.shape)}")
    iperm = torch.as_tensor(info["iperm"]).to(full.device)
    same = [torch.equal(full[i, :n, :n][iperm[:, None], iperm], inv[i])
            for i in range(len(sig))]
    check(all(same), f"8 (b) full stack's velocity blocks bit-equal to the "
                     f"stack: {same}")
    del full
    held(f"(b) {NS_LADDER}, keep_full=True",
         SaddleShiftedInverseCache(inv, n), info, launches)
    del inv, info
    k2_err = check_spmm_inputs("8 (b) ladder", seen)
    del seen
    torch.cuda.empty_cache()
    return k2_err


def config3_phase(c3_ops, sys64, sched):
    """Phase 9: config 3 on the NS tier (the NS tier of
    scripts/config3_cylinder.py, with an f64 stack beside it). Returns
    the SpMM kernel's launches in the f32 NS build, the f64 and f32 NS
    gains, and the Leray projector of config 3's operators."""
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

    def dre(sys, cache):
        return dre_backward_sweep(
            sys, cache, C3_ALPHA, C3_DT, C3_NTS, sseq, iseq,
            n_newton=1, r_max=C3_R_MAX,
        )

    cache, info = build_dre_cache_dae_ns(sys64, C3_DT, sig,
                                         certify_tol=C3_CERTIFY_F64)
    check(all(info["certified"]),
          f"f64 NS stack certified at {C3_CERTIFY_F64:g}: {info['residuals']}")
    _, ks64 = dre(sys64, cache)
    del cache
    torch.cuda.empty_cache()

    spmm_kernel.launches = 0
    cache, info = build_dre_cache_dae_ns(sys32, C3_DT, sig,
                                         certify_tol=C3_CERTIFY_F32)
    launches = spmm_kernel.launches
    check(launches >= 4 * info["ns_passes"],
          f"spmm_tile launches in the config-3 NS build: {launches}")
    zs, ks = dre(sys32, cache)
    del cache
    check(bool(torch.isfinite(ks).all()), "config-3 f32 gains finite")
    feas = c3.feasibility(sys32, zs[0])
    check(feas <= FEAS_TOL, f"|JZ|/|Z| = {feas:.2e}")
    gain_dev = rel_err(ks.double(), ks64)
    check(gain_dev <= GAIN_TOL, f"config-3 f32 vs f64 gains: {gain_dev:.2e}")
    pit = leray_projector(c3_ops)
    worst = max(
        dre_step_residual(
            c3_ops, zs[step].cpu().numpy(), ks[step].cpu().numpy(),
            zs[step + 1].cpu().numpy(), C3_ALPHA, C3_DT, pit=pit,
        )
        for step in (0, C3_NTS // 2)
    )
    check(worst <= DRE_RES_TOL, f"projected DRE residual {worst:.2e}")
    log(f"[9] config 3 on the NS tier ({C3_SHIFTS} x {sys64.n}^2): f64 stack "
        f"certified at {C3_CERTIFY_F64:g}; f32 stack {launches} spmm_tile "
        f"launches; |JZ|/|Z| {feas:.2e} (tol {FEAS_TOL:g}), projected DRE "
        f"residual at steps 0 and {C3_NTS // 2} {worst:.2e} (tol "
        f"{DRE_RES_TOL:g}), f32 vs f64 gains {gain_dev:.2e} (tol "
        f"{GAIN_TOL:g})")
    return launches, ks64, ks, pit


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


def driver_phase(v0_np, dev) -> None:
    """Phase 10 (a)-(c) and 11 (c): optcon_nse on the card."""
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
        """The driver's result and (conv_p2, spmm_tile) launches by
        stage."""
        met = StageLog()
        with tempfile.TemporaryDirectory() as cache:
            res = optcon_nse(cfg, v0_batch=v0, cache_dir=cache, metrics=met,
                             device=device)
        return res, met.launches

    def devs_vs(got, ref):
        return {
            "gains": rel_err(got.gains.cpu(), ref.gains),
            "ys": float(np.abs(got.ys - ref.ys).max() / np.abs(ref.ys).max()),
            "us": float(np.abs(got.us - ref.us).max() / np.abs(ref.us).max()),
            "cost": abs(got.cost - ref.cost) / abs(ref.cost),
        }

    config4, heat, cavity = driver_configs()
    conv_kernel.launches = 0
    res32, per_stage = run(config4, v0_np, dev)
    check(per_stage["closed_loop_rollout"] == (NTS, NTS),
          f"(conv_p2, spmm_tile) launches in the driver's rollout: "
          f"{per_stage['closed_loop_rollout']} != {(NTS, NTS)}")
    check(conv_kernel.launches == NTS,
          f"conv_p2 launches in the driver: {conv_kernel.launches} != {NTS}")
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
    log(f"[10] optcon_nse on the card, config 4 in f32 ({s_batch} scenarios "
        f"x {NTS} steps, fused step, Newton-Schulz gains): conv_p2 {NTS} "
        f"launches, all in the rollout; spmm_tile {NTS} in the rollout and "
        f"more in the DRE stage; "
        f"outputs finite; TF32 off")

    cfg64 = dataclasses.replace(
        config4, solver=dataclasses.replace(config4.solver, dtype="float64")
    )
    res64, _ = run(cfg64, v0_np[:S_REF], dev)
    gain_dev = rel_err(res32.gains.double(), res64.gains)
    ys_dev = float(np.abs(res32.ys[:S_REF] - res64.ys).max()
                   / np.abs(res64.ys).max())
    check(gain_dev <= GAIN_TOL, f"driver f32 vs f64 gains: {gain_dev:.2e}")
    check(ys_dev <= ROLLOUT_TOL, f"driver f32 vs f64 ys: {ys_dev:.2e}")
    log(f"     config 4 f32 vs f64 ({S_REF} scenarios): gains {gain_dev:.2e}, "
        f"ys {ys_dev:.2e} (tol {GAIN_TOL:g} and {ROLLOUT_TOL:g})")

    # config 2 (the cavity) card vs CPU on the lu tiers is
    # tests/test_torch_cuda.py::test_cavity_driver_on_card_matches_cpu
    got, _ = run(heat, None, dev)
    devs = devs_vs(got, run(heat, None, torch.device("cpu"))[0])
    check(max(devs.values()) <= DRIVER_TOL,
          f"heat1d lu tiers card vs CPU: {devs}")
    log(f"     heat1d lu tiers, card vs CPU: "
        f"{ {k: f'{v:.2e}' for k, v in devs.items()} } (tol {DRIVER_TOL:g})")

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
    with mgs_counted("11c cavity driver matfree (f64)"):
        got, per_stage = run(mf_cfg, None, dev)
    check(per_stage["dre_backward_sweep"][1] > 0
          and per_stage["closed_loop_rollout"][1] > 0,
          f"spmm_tile launched in the matfree DRE and rollout: {per_stage}")
    devs = devs_vs(got, run(mf_cfg, None, torch.device("cpu"))[0])
    check(max(devs.values()) <= MF_DRIVER_TOL,
          f"cavity matfree tiers card vs CPU: {devs}")
    log(f"[11c] cavity on step_solver='matfree', dre_solver='auto' (fgmres "
        f"tol {MF_DRIVER_FGMRES:g}), card vs CPU: "
        f"{ {k: f'{v:.2e}' for k, v in devs.items()} } (tol "
        f"{MF_DRIVER_TOL:g}); spmm_tile in the DRE and rollout stages")


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

    out = {}
    # config 2: the cavity (tests/test_cavity_lqr.py:35-38, 136-206)
    c = GOLDEN_CAVITY
    np_ops, sys, _ = cavity_stokes_setup(nx=c["nx"], device=dev)
    red = reduce_dae(np_ops)
    sig, sseq, iseq = dre_shift_schedule_dae(
        np_ops["A"], np_ops["M"], np_ops["J"], c["dt"], num_shifts=10,
        n_adi=20)
    cache = build_dre_cache_dae(sys, c["dt"], sig)
    _, ks = dre_backward_sweep(sys, cache, c["alpha"], c["dt"], c["nts"],
                               sseq, iseq, n_newton=3, r_max=50)
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
    ws = feedforward_sweep(sys, build_costate_cache_dae(sys, c["dt"]), ks,
                           torch.as_tensor(ystar).to(dev), c["dt"])
    _, us, ys = closed_loop_rollout(
        sys, build_step_cache_dae(sys, c["dt"]), ks, ws,
        torch.as_tensor(red["theta"] @ q0).to(dev), c["alpha"], c["dt"])
    out["cavity u"], out["cavity y"] = rel_fro(us.cpu(), us_g), rel_fro(
        ys.cpu(), ys_g)

    # config 1: heat1d (tests/test_heat_lqr.py:33-46, 134-220)
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
    for name, a, g in (("v", vs, vs_g), ("u", us, us_g), ("y", ys, ys_g)):
        out[f"heat1d {name}"] = rel_fro(a.cpu(), g)
    for key, dev_ in out.items():
        bound = GOLDEN_DRE_TOL if key[-1] in "KX" else GOLDEN_LOOP_TOL
        check(dev_ < bound, f"10d {key} vs the golden: {dev_:.2e} (bound "
                            f"{bound:g})")
    log(f"[10d] the lu tiers on the card vs the port's dense f64 golden: "
        f"cavity nx={c['nx']} ({c['nts']} steps) and heat1d n={h['n']} "
        f"({h['nts']} steps); deviations "
        f"{ {k: f'{v:.2e}' for k, v in out.items()} } (bounds: DRE "
        f"{GOLDEN_DRE_TOL:g}, closed loop {GOLDEN_LOOP_TOL:g})")
    return out


def matfree_bench_phase(np_ops, cond, sys64, cache64, sched, dev) -> None:
    """Phase 11 (a): the matrix-free tier at the bench shape in f64: the
    ADI through SaddleMatfreeCache against the same iterations through
    the host splu inverse stack, and the matrix-free stepper against the
    'lu' stepper in both feedback modes."""
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
    mf = build_dre_cache_dae_matfree(
        sys64, DT, sig, block=MF_BLOCK, max_cycles=MF_ADI_CYCLES,
        tol=MF_ADI_TOL,
    )
    args = dict(
        smw_u=torch.zeros((n, m), dtype=f64, device=dev), smw_v=sys64.b,
        mass=sys64.mass, w=sys64.c.T,
        sigma_seq=torch.as_tensor(sseq[:MF_ADI_ITERS]).to(dev, f64),
        idx_seq=[int(i) for i in iseq[:MF_ADI_ITERS]],
    )
    spmm_kernel.launches = 0
    with mgs_counted("11a matfree ADI (bench, f64)"):
        z_mf = lowrank_adi(mf, **args)
    k2 = spmm_kernel.launches
    del mf
    z_inv = lowrank_adi(cache64, **args)
    adi_dev = rel_err(z_mf, z_inv)
    check(bool(torch.isfinite(z_mf).all()), "matfree ADI factor finite")
    check(k2 > 0, "spmm_tile launched in the matrix-free ADI")
    check(adi_dev <= MF_ADI_DEV,
          f"matfree vs inverse-stack ADI: {adi_dev:.2e}")
    log(f"[11a] bench shape f64: {MF_ADI_ITERS} ADI iterations through "
        f"SaddleMatfreeCache (block {MF_BLOCK}, tol {MF_ADI_TOL:g}) vs the "
        f"host splu inverse stack {adi_dev:.2e} (tol {MF_ADI_DEV:g}); "
        f"spmm_tile and mgs_step launched")

    lu = build_nse_stepper(np_ops, cond, DT, device=dev, dtype=f64)
    mfs = build_nse_stepper_matfree(
        np_ops, cond, DT, device=dev, dtype=f64, block=MF_BLOCK,
        max_cycles=MF_STEP_CYCLES, tol=MF_STEP_TOL,
    )
    conv64 = ConvKernel.build(np_ops["full"], cond, device=dev, dtype=f64)
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
            got = roll(mfs)
        k2 = spmm_kernel.launches
        ref = roll(lu)
        devs = {name: rel_err(a, b) for name, a, b in zip("vuy", got, ref)}
        check(k2 > 0, f"spmm_tile launched in the {key}")
        check(max(devs.values()) <= MF_STEP_DEV,
              f"matfree vs lu stepper ({feedback}): {devs}")
        log(f"      matfree stepper ({feedback} feedback, {MF_STEP_S} "
            f"scenarios x {MF_STEP_NTS} steps, tol {MF_STEP_TOL:g}) vs the lu "
            f"stepper: v, u, y deviation "
            f"{ {k: f'{v:.2e}' for k, v in devs.items()} } (tol "
            f"{MF_STEP_DEV:g}); spmm_tile and mgs_step launched")


def matfree_config3_phase(c3_ops, c3_cond, c3_sys64, sched12, ks64, ks_ns32,
                          pit, dev) -> int:
    """Phase 11 (b): the rest of scripts/config3_cylinder.py in f32: the
    matrix-free DRE sweep at its 12 shifts (first and warm) against
    phase 9's f64 NS gains, the projected DRE residual, K1 at the
    rollout's width, and the closed loop from phase 9's f32 NS gain,
    controlled and uncontrolled. Returns the MGS kernel's launches in the
    DRE sweeps (the gains cell's path)."""
    import torch

    from optconpy_tpu_torch.fem.device_conv import ConvKernel, FusedConvKernel
    from optconpy_tpu_torch.mpc import build_nse_stepper_matfree
    from optconpy_tpu_torch.ops import arnoldi_kernel, conv_kernel
    from optconpy_tpu_torch.riccati import build_dre_cache_dae_matfree
    from optconpy_tpu_torch.riccati.validate import dre_step_residual
    from optconpy_tpu_torch.scripts import config3_cylinder as c3

    f32 = torch.float32
    sig = sched12[0]
    sys32 = c3_sys64.to(dtype=f32)
    n = sys32.n
    mf = build_dre_cache_dae_matfree(
        sys32, C3_DT, sig, block=MF_BLOCK, max_cycles=C3_DRE_CYCLES,
        tol=C3_FGMRES_TOL,
    )
    with counted_launches(c3, "dre_backward_sweep") as sweeps, \
            mgs_counted("11b config3_script matfree DRE sweep"):
        zs, ks, _, _ = c3.timed_sweeps(
            sys32, mf, sched12, warm=C3_MF_WARM, nts=C3_NTS, r_max=C3_R_MAX)
    mgs_launches = arnoldi_kernel.launches
    del mf
    check(bool(torch.isfinite(ks).all()), "config-3 matfree gains finite")
    check(sweeps[0][1] > 0, "spmm_tile launched in the matfree DRE")
    gain_dev = rel_err(ks.double(), ks64)
    check(gain_dev <= MF_GAIN_TOL,
          f"config-3 matfree f32 vs NS f64 gains: {gain_dev:.2e}")
    res0 = dre_step_residual(c3_ops, zs[0].cpu().numpy(), ks[0].cpu().numpy(),
                             zs[1].cpu().numpy(), C3_ALPHA, C3_DT, pit=pit)
    check(res0 <= DRE_RES_TOL, f"config-3 matfree DRE residual {res0:.2e}")
    log(f"[11b] config 3 f32 matrix-free DRE sweep ({len(sig)} shifts, "
        f"FGMRES tol {C3_FGMRES_TOL:g}, first and {C3_MF_WARM} warm): gains "
        f"vs phase 9's f64 NS gains {gain_dev:.2e} (tol {MF_GAIN_TOL:g}); "
        f"projected DRE residual at step 0 {res0:.2e} (tol "
        f"{DRE_RES_TOL:g}); spmm_tile and mgs_step ({mgs_launches}) "
        f"launched")

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
        f"(tol {KERNEL_TOL:g}); alone {k1_ms * 1e3:.1f} us/call (events)")

    stepper = build_nse_stepper_matfree(
        c3_ops, c3_cond, C3_DT, device=dev, dtype=f32, block=MF_BLOCK,
        max_cycles=C3_ROLL_CYCLES, tol=C3_FGMRES_TOL,
    )
    v0 = c3.rollout_v0(stepper, C3_ROLL_S, np.random.default_rng(SEED))
    with counted_launches(c3, "batched_nse_closed_loop") as rolls, \
            mgs_counted("11b config3_script rollouts, controlled and "
                        "uncontrolled (f32)"):
        roll = c3.energy_ratio(sys32, conv, stepper, ks_ns32[0], v0,
                               nts=C3_ROLL_NTS)
    for (name, short), (l1, l2) in zip((("controlled", "c"),
                                        ("uncontrolled", "u")), rolls):
        check(l1 == C3_ROLL_NTS + 1,
              f"conv_p2 launches in the {name} config-3 rollout: {l1}")
        check(l2 > 0, f"spmm_tile launched in the {name} rollout")
        check(roll[f"finite_{short}"], f"{name} rollout outputs finite")
    check(roll["ys_shape"] == (C3_ROLL_S, C3_ROLL_NTS + 1, sys32.p_out),
          f"config-3 rollout ys shape {roll['ys_shape']}")
    ratio = roll["ratio"]
    check(ratio < ENERGY_RATIO_MAX, f"config-3 energy ratio {ratio:.3e}")
    log(f"      closed loop ({C3_ROLL_S} scenarios x {C3_ROLL_NTS} steps, "
        f"implicit feedback), controlled and uncontrolled: conv_p2 "
        f"{C3_ROLL_NTS + 1} launches each, spmm_tile and mgs_step launched, "
        f"finite; energy ratio at T {ratio:.4e} (bound < "
        f"{ENERGY_RATIO_MAX:g}; phase 9's f32 NS gain, as the script)")
    return mgs_launches


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
    worst, max_abs = {}, 0.0
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
            worst[dname] = max(worst.get(dname, 0.0), err)
            max_abs = max(max_abs, abs_err)
    log(f"     {label}: spmm_tile vs plain on the path's {len(seen)} "
        f"(pack, width, dtype) inputs and a random X of each shape, each "
        f"repeating bit for bit; worst rel err "
        f"{ {k: f'{e:.2e}' for k, e in worst.items()} } (tol {SPMM_TOL})")
    return max_abs


def receding_phase(np_ops, cond, sys64, dev) -> tuple[float, float]:
    """Phase 12 (a): scripts/bench_receding.run, config 4's macro loop in
    f32 with its three variants (full rebuild, refreshed matfree,
    dense_ns) on phase 4's setup; both kernels held against their plain
    versions on the inputs each variant's warm-up hands them; then
    dense_ns in f64 for the first macros on the same scenarios. Returns
    K1's and K2's largest absolute errors on those inputs."""
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
    launches, abs_err = {}, {"k1": 0.0, "k2": 0.0}

    def checked(*args, n_macro, profile=False):
        """bench_receding's receding_horizon_mpc: a warm-up call records
        and checks both kernels' inputs; a timed call counts launches."""
        name = names[(args[4].solver, args[4].refresh_caches)]
        if not profile:
            with recorded_spmm_inputs() as seen, recorded_conv_input() as xs:
                out = receding_horizon_mpc(*args, n_macro=n_macro)
            abs_err["k2"] = max(abs_err["k2"], check_spmm_inputs(
                f"12 {name} warm-up ({n_macro} macros)", seen))
            abs_err["k1"] = max(abs_err["k1"], check_conv_input(
                f"12 {name} warm-up's first", *xs[0]))
            del seen, xs
            torch.cuda.empty_cache()
            return out
        conv_kernel.launches = 0
        spmm_kernel.launches = 0
        with (mgs_counted(f"12 receding {name}")
              if args[4].solver == "matfree" else nullcontext()):
            out = receding_horizon_mpc(*args, n_macro=n_macro, profile=True)
        launches[name] = (conv_kernel.launches, spmm_kernel.launches)
        return out

    log(f"[12] receding-horizon MPC, config 4 (scripts/bench_receding.run: "
        f"{S_BATCH} scenarios, variants {br.VARIANTS}), {RH_MACROS} macros "
        f"after a {RH_WARMUP}-macro warm-up (the full rebuild's: 1):")
    arrays = {}
    br.receding_horizon_mpc = checked
    try:
        out = br.run(
            dev, ops=(np_ops, sys64, cond), problem=f"cylinder_re{int(RE)}_"
            f"ref{REFINEMENT}", n_macro=RH_MACROS, warmup=RH_WARMUP,
            s_batch=S_BATCH, log=lambda msg: log(f"      {msg}"),
            arrays=arrays)
    finally:
        br.receding_horizon_mpc = receding_horizon_mpc
    recs = {"full": out["full_rebuild_variant"],
            "fast": out["matfree_refresh_variant"], "dense_ns": out}
    n = sys64.n
    for name, rec in recs.items():
        k1, k2 = launches[name]
        vs = arrays[name]["vs"]
        check(tuple(vs.shape) == (S_BATCH, RH_MACROS * RH_CFG["apply"] + 1, n),
              f"receding {name} vs shape")
        check(bool(torch.isfinite(arrays[name]["ks"]).all()),
              f"receding {name} gains finite")
        check(k1 == RH_MACROS * (RH_CFG["apply"] + 1),
              f"conv_p2 launches in the {name} loop: {k1}")
        check(k2 > 0, f"spmm_tile launched in the {name} loop")
        check(rec["perturbation_decay"] < 1.0,
              f"receding {name} perturbation decay {rec['perturbation_decay']}")
        if name == "dense_ns":
            for m in rec["macros"]:
                check(m["ns_refresh_worst_residual"] <= RH_NS_CERTIFY,
                      f"NS refresh certified: {m['ns_refresh_residuals']}")
        log(f"     {name}: conv_p2 {k1} launches, spmm_tile launched, decay "
            f"dT/d0 {rec['perturbation_decay']:.4f}")
    ks = {name: arrays[name]["ks"] for name in recs}
    gdev = {f"{a} vs {b}": [rel_err(x, y) for x, y in zip(ks[a], ks[b])]
            for a, b in (("fast", "full"), ("dense_ns", "full"),
                         ("dense_ns", "fast"))}
    for pair, devs in gdev.items():
        check(max(devs) <= RH_GAIN_TOL, f"receding {pair} gains by macro: "
                                        f"{devs}")
    log(f"     gains by macro { {p: [f'{d:.2e}' for d in v] for p, v in gdev.items()} }"
        f" (tol {RH_GAIN_TOL:g}); every dense_ns NS refresh certified at "
        f"{RH_NS_CERTIFY:g}")
    vs32, ks_ns = arrays["dense_ns"]["vs"], ks["dense_ns"]
    v0_np, sched = arrays["v0"], arrays["sched"]
    del arrays, ks

    # the in-run f64 check: dense_ns in f64 on the same scenarios (the
    # plain convection: K1 takes float32 only)
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
        f"scenarios): gains {g64:.2e}, outputs C v {ydev:.2e} (tol "
        f"{GAIN_TOL:g} and {ROLLOUT_TOL:g})")
    return abs_err["k1"], abs_err["k2"]


def receding_lu_phase(dev) -> None:
    """Phase 12 (b): the 'lu' tier (device re-linearization, host LUs) on
    the reference test's cavity, on the card and on the CPU."""
    import torch

    from optconpy_tpu_torch.fem.device_conv import ConvKernel
    from optconpy_tpu_torch.models.cavity import cavity_stokes_setup
    from optconpy_tpu_torch.mpc import RHConfig, receding_horizon_mpc
    from optconpy_tpu_torch.riccati import dre_shift_schedule_dae
    from optconpy_tpu_torch.solvers.steady import solve_steady_nse_host

    outs = []
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
        outs.append(receding_horizon_mpc(
            sys, conv, ops, cond, RHConfig(**RH_LU_CFG), *sched,
            torch.as_tensor(v0), n_macro=3,
        ))
    devs = {k: rel_err(outs[0][k].cpu(), outs[1][k])
            for k in ("vs", "us", "ks")}
    check(max(devs.values()) <= RH_LU_TOL,
          f"receding lu tier card vs CPU: {devs}")
    log(f"[12b] receding lu tier, cavity nx=6, 4 scenarios x 3 macros, f64, "
        f"card vs CPU { {k: f'{v:.2e}' for k, v in devs.items()} } (tol "
        f"{RH_LU_TOL:g})")


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


@contextmanager
def mgs_counted(label: str):
    """Inside the block, the Arnoldi step kernel's launch counter
    (ops/arnoldi_kernel.py) runs from zero; after it, check that the
    path launched the kernel (a matrix-free path solves by gmres)."""
    from optconpy_tpu_torch.ops import arnoldi_kernel

    arnoldi_kernel.launches = 0
    yield
    check(arnoldi_kernel.launches > 0, f"mgs_step launched in {label}")


def check_conv_input(label: str, x, conv) -> float:
    """K1 vs its plain version (the slot sums) on a path's own input X
    and evaluator: KERNEL_TOL relative and a repeat bit for bit; then
    K1's time alone on that X beside the plain version's and the bound.
    Returns the largest absolute error."""
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
    nt = conv.tri_dofs.shape[0]
    bound, bound_by = roofline.bound_s(*roofline.k1_work(n, nt, b))
    log(f"     conv_p2 on the {label} X (n={n}, nt={nt}, B={b}): rel err "
        f"{err:.2e} (abs {abs_err:.2e}, tol {KERNEL_TOL:g}) vs the plain "
        f"slot sums, repeats bit for bit; alone {k_ms:.3f} ms/call "
        f"(events), plain {p_ms:.3f} ms, bound {bound * 1e3:.3f} ms "
        f"({bound_by})")
    return abs_err


def sweep_phase(dev, mesh) -> tuple[float, float]:
    """Phase 13: scripts/sweep_config5.run, the config-5 Re-bucket
    parameter sweep in f32 at the script's shape (gains cut to
    SW_GAINS' DRE steps), both kernels held against their plain versions
    on the path's inputs, and phase 14 (b)'s sharded sweep on its
    buckets over `mesh` (world size 1). Returns K1's and K2's largest
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
    check(torch.backends.cuda.matmul.allow_tf32 is False, "TF32 matmul off")
    check(torch.backends.cudnn.allow_tf32 is False, "TF32 cuDNN off")
    check((sc.RE_RANGE, sc.R_BUCKETS, sc.S_TOTAL, sc.PAD, sc.NTS, sc.DT,
           sc.ALPHA, sc.GAINS["num_shifts"], sc.GAINS["n_adi"],
           sc.GAINS["r_max"])
          == (SW_RE, SW_BUCKETS, SW_SCENARIOS, SW_PAD, SW_NTS, DT, ALPHA,
              SW_GAINS["num_shifts"], SW_GAINS["n_adi"], SW_GAINS["r_max"]),
          "phase 13 runs scripts/sweep_config5.py's shape")

    # the script's two sweeps (first, warm): launches and outputs each;
    # K1's input recorded in the first
    sweeps = []

    def counted_sweep(*args, **kwargs):
        conv_kernel.launches = 0
        spmm_kernel.launches = 0
        with recorded_conv_input() as xs:
            out = sweep_rollout(*args, **kwargs)
        sweeps.append({"k1": conv_kernel.launches, "k2": spmm_kernel.launches,
                       "ys": out[0].clone(),
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
            out = sc.run(
                dev, re_range=SW_RE, buckets=SW_BUCKETS, s_total=SW_SCENARIOS,
                pad=SW_PAD, nts=SW_NTS, nts_gain=SW_GAINS["nts_gain"],
                log=lambda msg: log(f"      {msg}"), arrays=arrays)
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

    # --- gains and the Newton-Schulz chain ---
    check(len(dre_calls) == SW_BUCKETS and len(chain_calls) == 1,
          f"one DRE sweep a bucket and one chain: {len(dre_calls)}, "
          f"{len(chain_calls)}")
    check(len(sweeps) == 2, f"the script's sweeps: {len(sweeps)}")
    res = info["ns_residuals"]
    check(bool(torch.isfinite(ks).all()), "sweep gains finite")
    check(max(res) <= SW_CERTIFY, f"NS chain certified: {res}")
    log(f"[13] config-5 sweep (scripts/sweep_config5.run, nts_gain "
        f"{out['nts_gain']}): {SW_BUCKETS} Re buckets, {SW_SCENARIOS} drawn "
        f"Re -> {counts.tolist()} real scenarios padded to {s_max}, "
        f"{SW_NTS} steps; one DRE sweep a bucket, the NS chain certified "
        f"(worst {max(res):.2e}, tol {SW_CERTIFY:g})")
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
    check(tuple(ys.shape) == (SW_BUCKETS, s_max, SW_NTS + 1, sys32.p_out),
          "sweep ys shape")
    check(tuple(u_sq.shape) == (SW_BUCKETS, s_max, SW_NTS), "sweep u_sq shape")
    for name, x in (("ys", ys), ("u_sq", u_sq)):
        check(bool(torch.isfinite(x).all()), f"sweep {name} finite")
    check(torch.equal(sweeps[0]["ys"], sweeps[1]["ys"]),
          "first and warm sweeps bit-equal")
    log(f"     sweep {SW_BUCKETS} x {s_max} x {SW_NTS}, first and warm: "
        f"conv_p2 {SW_NTS} launches and spmm_tile none each, outputs "
        f"finite, bit-equal")

    # --- K1 at the sweep's own first-step input ---
    k1_abs = check_conv_input("sweep's first-step", *sweeps[0]["x"])
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
    log("     statistics (masked): counts exact, finite, identical with NaN "
        "padded rows")

    # --- 14 (b): the sharded sweep at world size 1 ---
    conv_kernel.launches = 0
    spmm_kernel.launches = 0
    ys_sh, stats_sh = sharded_sweep_rollout(
        mesh, sys32, conv, cache_stack, ks, shard_scenarios(mesh, v0, dim=1),
        ALPHA, DT, SW_NTS, ystar=ystar,
        mask_local=shard_scenarios(mesh, mask_d, dim=1))
    k1_sh, k2_sh = conv_kernel.launches, spmm_kernel.launches
    check(k1_sh == SW_NTS and k2_sh == 0,
          f"launches in the sharded sweep: conv_p2 {k1_sh}, spmm_tile {k2_sh}")
    check(torch.equal(ys_sh, ys), "sharded sweep ys bit-equal to the sweep's")
    same = {k: torch.equal(stats_sh[k], stats[k]) for k in stats}
    check(all(same.values()),
          f"sharded sweep statistics equal masked_sweep_stats: {same}")
    log(f"[14b] sharded_sweep_rollout ({mesh.world_size} rank, NCCL) on the "
        f"{SW_BUCKETS} buckets: ys bit-equal to the sweep's, statistics "
        f"equal to masked_sweep_stats; conv_p2 {k1_sh} launches, spmm_tile "
        f"{k2_sh}")
    del ys_sh, stats_sh

    # --- f64 check on the host-LU stepper tier ---
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
    # the same scenarios in f32 on the host-built f32 'lu' steppers instead
    # of the chain's inverses, held to the rollout bound
    stack32 = NSEStepCache.stack([
        build_nse_stepper(setups[r][0], setups[r][2], DT, device=dev,
                          dtype=f32, solver="lu") for r in rows])
    conv_kernel.launches = 0
    ys32, _, _ = nse_sweep_outputs(sys32, conv, stack32, ks[rows],
                                   v0[rows, :SW_REF_S].contiguous(), ALPHA,
                                   DT, SW_NTS)
    k1_lu = conv_kernel.launches
    lu_dev = rel_err(ys32.double(), ys64)
    check(k1_lu == SW_NTS, f"conv_p2 launches in the f32 'lu' sweep: {k1_lu}")
    check(lu_dev <= ROLLOUT_TOL, f"f32 'lu' sweep steppers vs f64: {lu_dev:.2e}")
    log(f"     f32 sweep vs f64 on the lu tier (buckets {rows}, {SW_REF_S} "
        f"real scenarios each): ys {ydev:.2e}; the same in f32 on f32 'lu' "
        f"steppers {lu_dev:.2e} (tol {ROLLOUT_TOL:g} each)")
    del stack64, stack32, conv64, ys64, ys32

    # --- a warm sweep's device kernels ---
    split = kernel_split(lambda: run(v0))
    k1_calls, copies = (kernel_calls(split, "conv_p2_patch"),
                        kernel_calls(split, "copy"))
    check(k1_calls == SW_NTS, f"profiled conv_p2 kernels: {k1_calls}")
    # the state is never copied: the few copies are the sweep's set-up
    # and its outputs' final layout, none a step
    check(copies < SW_NTS // 10, f"copy kernels in the sweep: {copies}")
    log(f"     profiler, one warm sweep: {k1_calls} conv_p2 kernels, "
        f"{copies} copy kernels")
    del ys, u_sq, cache_stack, ks, v0, setups, conv
    torch.cuda.empty_cache()
    return k1_abs, k2_abs


def config3xl_phase(dev) -> tuple[float, float]:
    """Phase 14 (a): scripts/config3xl_cylinder.run at the reference's
    shape, K1 and K2 held against their plain versions on the inputs the
    run handed them. Returns K1's and K2's largest absolute errors."""
    from optconpy_tpu_torch.scripts import config3xl_cylinder as xl

    log(f"[14a] config 3XL (scripts/config3xl_cylinder.run: Re={xl.RE:g}, "
        f"refinement {xl.REFINEMENT}, {xl.N_SHIFTS} shifts, {xl.NTS_GAIN} DRE "
        f"steps x {xl.N_ADI} ADI, rank {xl.R_MAX}, FGMRES tol {xl.FGMRES_TOL:g}"
        f", f32, {xl.S_BATCH} x {xl.NTS_ROLL} closed loop):")
    with recorded_spmm_inputs() as seen, recorded_conv_input() as xs, \
            counted_launches(xl, "dre_backward_sweep") as sweeps, \
            counted_launches(xl, "batched_nse_closed_loop") as rolls, \
            mgs_counted("14a config3xl_cylinder (DRE sweep, probes, stepper "
                        "and rollout)"):
        out = xl.run(dev, log=lambda msg: log(f"      {msg}"))
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
    log(f"     3XL: |JZ|/|Z| {out['feasibility_JZ']:.3e} (tol "
        f"{xl.FEASIBILITY_BOUND:g}), worst projected DRE residual "
        f"{out['worst_dre_residual']:.3e} (tol {xl.RESIDUAL_BOUND:g}); closed "
        f"loop finite, conv_p2 {rolls[0][0]} launches; spmm_tile in both DRE "
        f"sweeps")
    k2_abs = check_spmm_inputs("14a 3XL", seen)
    k1_abs = check_conv_input("3XL rollout's first", *xs[0])
    return k1_abs, k2_abs


def sharded_fused_phase(mesh, sys32, conv, fused32, ks, ws, v0, ys,
                        us) -> None:
    """Phase 14 (b), first part: sharded_nse_rollout on phase 5's fused
    stepper over `mesh` (world size 1): ys bit-equal to phase 5's and the
    statistics those of phase 5's outputs."""
    import torch

    from optconpy_tpu_torch.ops import conv_kernel
    from optconpy_tpu_torch.parallel import shard_scenarios, sharded_nse_rollout

    conv_kernel.launches = 0
    ys_sh, stats = sharded_nse_rollout(
        mesh, sys32, conv, fused32, ks, ws, shard_scenarios(mesh, v0), ALPHA,
        DT)
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
        f"sharded_nse_rollout on phase 5's fused stepper ({len(v0)} x {NTS}): "
        f"ys bit-equal to phase 5's, statistics equal to its outputs'; "
        f"conv_p2 {launches} launches")


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
        out = dryrun_multichip(scenario_mesh(dev))
        torch.cuda.synchronize()
        out["launches"] = {"conv_p2": conv_kernel.launches,
                           "spmm_tile": spmm_kernel.launches}
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
            json.dump(out, fh)
    finally:
        torch.distributed.destroy_process_group()


def dryrun_phase() -> None:
    """Phase 14 (b), last part: parallel/dryrun.py on DRY_RANKS spawned
    gloo ranks sharing the card (a file store, no port). Both kernels
    launch on every rank, and every stage's global statistics agree
    across the ranks."""
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
        f"sharing the card: both kernels launched on every rank, global "
        f"statistics equal across ranks: sharded_closed_loop "
        f"{first['closed_loop']}, sharded_sweep_rollout {first['sweep']}, "
        f"sharded_nse_rollout (matfree) {first['matfree_rollout']}")


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


def cavity_are_phase(dev) -> None:
    """Phase 15 (a): solve_are_stabilized on the unstable cavity (f64, lu
    tier, the reference's defaults) on the card and on the CPU: card vs
    CPU <= ARE_CARD_TOL, vs the dense reduced CARE golden <
    ARE_GOLDEN_TOL, 2 unstable modes, the converged gain's reduced
    closed loop Hurwitz; then the identity that the dt=inf DRE step
    residual is the dense projected ARE residual, and ~0 on the golden
    X."""
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
    ops, _, _ = cavity_stokes_setup(nx=5, device=cpu)
    decay = np.sort(-np.real(np.linalg.eigvals(reduce_dae(ops)["At"])))
    c = 0.5 * (decay[1] + decay[2])  # destabilize the two slowest modes
    a2 = (ops["A"] + c * ops["M"]).tocsr()
    np2 = dict(ops, A=a2)
    sys2 = dae_from_scipy(ops["M"], a2, ops["J"], ops["B"], ops["C"],
                          device=cpu)
    runs = [solve_are_stabilized(np2, sys2, ARE_ALPHA, device=d)
            for d in (dev, cpu)]
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
        f"{c:.3f} M, f64, lu): {info['n_unstable']} unstable modes; card vs "
        f"CPU {card_dev:.2e} (tol {ARE_CARD_TOL:g}), vs the dense CARE golden "
        f"{gold_dev:.2e} (tol {ARE_GOLDEN_TOL:g}); reduced closed loop max "
        f"Re {max_re:.4f}; the dt=inf step residual {r_inf:.4e} = the "
        f"dense projected ARE residual {r_dense:.4e} (golden X: {r_gold:.1e})")


def wake_are_phase(dev) -> float:
    """Phase 15 (b): the Re=60 wake at refinement 1. The reduction, the
    Bernoulli K0 (2 unstable modes, Hurwitz reduced closed loop) and the
    closed-loop interval once (every solve below reuses that K0: the same
    inputs, the same Schur form); solve_are_stabilized at WAKE_ARE over
    [WAKE_A_MIN, a_max] on the lu tier in f64 and f32, and for
    WAKE_MF_NEWTON Newton steps on the lu tier in f64 and the matfree
    tier in f32 (K2 held against its plain version on every input that
    tier handed it): the reduced closed loop of the lu gains and the
    matfree gain Hurwitz, lu f32 vs f64 <= WAKE_F32_TOL, matfree vs lu
    f64 <= 10x its FGMRES tol. Returns K2's largest absolute error."""
    import torch

    from optconpy_tpu_torch.golden import reduce_dae
    from optconpy_tpu_torch.models.cylinder import cylinder_setup
    from optconpy_tpu_torch.ops import spmm_kernel
    from optconpy_tpu_torch.riccati import (
        are,
        solve_are_stabilized,
        stabilizing_gain_reduced,
    )

    f32, f64 = torch.float32, torch.float64
    np_ops, sys64, _ = cylinder_setup(
        re=WAKE_RE, refinement=WAKE_REFINEMENT, device=dev, dtype=f64)
    check((sys64.n, sys64.n_p) == (WAKE_N, WAKE_NP),
          f"wake sizes {sys64.n}, {sys64.n_p}")
    red = reduce_dae(np_ops)
    k0t, n_unstable = stabilizing_gain_reduced(red["At"], red["Bt"],
                                               ARE_ALPHA)
    decay = -np.real(np.linalg.eigvals(red["At"] - red["Bt"] @ k0t))
    check(n_unstable == 2, f"wake unstable modes {n_unstable}")
    check(decay.min() > 0, f"Bernoulli closed loop max Re {-decay.min():.3e}")
    shifted = (WAKE_A_MIN, float(decay[decay > 0].max()))
    log(f"[15b] Re={WAKE_RE:g} wake (refinement {WAKE_REFINEMENT}, n={sys64.n}"
        f", n_p={sys64.n_p}): {n_unstable} unstable modes, the Bernoulli "
        f"closed loop Hurwitz (max Re {-decay.min():.4f}); the tiers "
        f"{WAKE_ARE} over [{shifted[0]:g}, {shifted[1]:.2f}], the matfree "
        f"tier {WAKE_MF_NEWTON} Newton step(s) ({WAKE_MATFREE}) against lu "
        f"float64 at {WAKE_MF_NEWTON}")

    with reused_bernoulli_gain(are, red, k0t, n_unstable):
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
            spmm_kernel.launches = 0
            with recorded_spmm_inputs() as seen, \
                    (mgs_counted(f"15b ARE {label} (wake Re=60)")
                     if cache == "matfree" else nullcontext()):
                _, k, info = solve_are_stabilized(
                    np_ops, sys64, ARE_ALPHA, interval=shifted, red=red,
                    cache=cache, dtype=dtype, device=dev, **kw)
            check(info["n_unstable"] == 2 and bool(torch.isfinite(k).all()),
                  f"wake ARE {label}: {info['n_unstable']} modes, finite gain")
            if cache == "matfree" or n_newton == WAKE_ARE["n_newton"]:
                max_re = reduced_closed_loop_max_re(
                    red, k.double().cpu().numpy())
                check(max_re < 0,
                      f"wake ARE {label}: closed loop max Re {max_re:.3e}")
            runs[label] = (k, spmm_kernel.launches, seen)
    full = f"{WAKE_ARE['n_newton']} Newton"
    part = f"{WAKE_MF_NEWTON} Newton"
    k64 = runs[f"lu float64, {full}"][0]
    f32_dev = rel_err(runs[f"lu float32, {full}"][0].double(), k64)
    mf_k, mf_launches, mf_seen = runs[f"matfree float32, {part}"]
    mf_dev = rel_err(mf_k.double(), runs[f"lu float64, {part}"][0])
    check(f32_dev <= WAKE_F32_TOL, f"wake lu f32 vs f64 gains: {f32_dev:.2e}")
    check(mf_dev <= 10 * WAKE_MATFREE["tol"],
          f"wake matfree vs lu gains: {mf_dev:.2e}")
    check(mf_launches > 0, "spmm_tile launched on the matfree tier")
    log(f"     every gain's reduced closed loop Hurwitz; lu f32 vs f64 gains "
        f"{f32_dev:.2e} (tol {WAKE_F32_TOL:g}); matfree f32 vs lu f64 "
        f"({part}) {mf_dev:.2e} (tol 10 x {WAKE_MATFREE['tol']:g})")
    return check_spmm_inputs("15b wake ARE matfree", mf_seen)


def precision_phase(dev) -> float:
    """Phase 15 (c): scripts/bench_precision.run at its shape, K1 held
    against its plain version on the first X the run handed it; 'highest'
    within PREC_TOL of f64 in the table and at every horizon, TF32 in
    'high' only and off after the phase. Returns K1's largest absolute
    error on that X."""
    import torch

    from optconpy_tpu_torch.ops import conv_kernel
    from optconpy_tpu_torch.scripts import bench_precision as bp

    conv_kernel.launches = 0
    with recorded_conv_input() as xs:
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
    log(f"[15c] bench_precision ({out['scenarios']} x {out['horizon_steps']}):"
        f" 'highest' vs f64 {tiers['highest']['rel_dev_vs_f64']:.3e}, at every"
        f" horizon <= {PREC_TOL:g}; TF32 in 'high' only and off after; "
        f"conv_p2 {launches} launches")
    return check_conv_input("15c bench_precision rollout's first", *xs[0])


def sanitizer_phase(dev, sys32, conv, fused32, ks, ws, v0) -> None:
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
    from optconpy_tpu_torch.fem.device_conv import ConvKernel, FusedConvKernel
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

    dev = torch.device("cuda", 0)
    cpu = torch.device("cpu")
    f32, f64 = torch.float32, torch.float64
    card = card_line()
    log(f"[1] card: {card}")
    utils.setup()

    # --- 2. build -------------------------------------------------------
    cuda_build.build()

    # --- setup (host) ---------------------------------------------------
    np_ops, sys64, cond = cylinder_setup(
        re=RE, refinement=REFINEMENT, device=dev, dtype=f64
    )
    sys32 = sys64.to(dtype=f32)
    conv = FusedConvKernel.build(np_ops["full"], cond, device=dev)
    n, m = sys64.b.shape
    nt = conv.tri_dofs.shape[0]

    # --- 3. K1 alone ----------------------------------------------------
    # tests/test_torch_cuda.py holds K1 against its plain version at these
    # widths; this phase times it
    rng = np.random.default_rng(SEED)
    vbar = torch.as_tensor(np_ops["vbar_full"], dtype=f32)[conv.free.cpu()]
    for b in (S_BATCH, 3):
        v = (vbar[:, None] + torch.as_tensor(
            1e-3 * rng.standard_normal((n, b)), dtype=f32
        )).to(dev)
        # events over back-to-back calls; then the device time of the
        # wrapper's two kernels, without the host's launch cost that
        # back-to-back calls at small B are bound by
        k_ms = event_ms(lambda: conv_kernel.conv_inner(v, conv), 50)
        p_ms = event_ms(lambda: ConvKernel.conv_inner_batch_t(conv, v), 50)
        rows = kernel_split(lambda: [
            conv_kernel.conv_inner(v, conv) for _ in range(20)
        ])
        d_ms = sum(us for name, (_, us) in rows.items()
                   if "conv_p2" in name) / 20 / 1e3
        bound, bound_by = roofline.bound_s(*roofline.k1_work(n, nt, b))
        if b == S_BATCH:
            k1_head = {"ms": k_ms, "device_ms": d_ms, "plain_ms": p_ms,
                       "bound_ms": bound * 1e3, "bound_by": bound_by,
                       "library_ms": None,
                       "at": f"B={S_BATCH}, n={n}, nt={nt}, float32"}
        log(f"[3] conv_p2 alone, B={b} (free dofs in and out): "
            f"{k_ms * 1e3:.1f} us/call back to back (events), "
            f"{d_ms * 1e3:.1f} us/call on the device (profiler); plain "
            f"{p_ms * 1e3:.1f} us/call (events); bound {bound * 1e6:.1f} us "
            f"({bound_by}) = {bound * 1e3 / d_ms:.1%} of the device time, "
            f"{bound * 1e3 / k_ms:.1%} of the events time")

    # --- 4. gains -------------------------------------------------------
    sig, sseq, iseq = dre_shift_schedule_dae(
        np_ops["A"], np_ops["M"], np_ops["J"], DT,
        num_shifts=N_SHIFTS, n_adi=N_ADI,
    )
    at_til = (np_ops["A"].T - np_ops["M"] / (2.0 * DT)).tocsr()
    inv64, _ = load_or_build_inverse_stack(
        at_til, np_ops["M"], np_ops["J"], sig, np.float64
    )
    cache64 = SaddleShiftedInverseCache(torch.from_numpy(inv64).to(dev), n)
    del inv64
    cache32 = cache64.to(dtype=f32)

    def dre(sys, cache):
        return dre_backward_sweep(
            sys, cache, ALPHA, DT, NTS_GAIN, sseq, iseq,
            n_newton=N_NEWTON, r_max=R_MAX,
        )

    _, ks64 = dre(sys64, cache64)
    zs32, ks32 = dre(sys32, cache32)
    del cache32
    gain_dev = rel_err(ks32.to(f64), ks64)
    check(bool(torch.isfinite(ks32).all()), "f32 gains finite")
    check(gain_dev <= GAIN_TOL, f"f32 vs f64 gains: {gain_dev:.2e}")
    check((RE, REFINEMENT, DT, ALPHA, NTS_GAIN, R_MAX, N_SHIFTS, N_ADI,
           N_NEWTON) == (validate_gains.RE, validate_gains.REFINEMENT,
                         validate_gains.DT, validate_gains.ALPHA,
                         validate_gains.NTS_GAIN, validate_gains.R_MAX,
                         validate_gains.N_SHIFTS, validate_gains.N_ADI,
                         validate_gains.N_NEWTON),
          "phase 4 runs scripts/validate_gains.py's bench shape")
    # raises when a step's residual is not below the GAINQ bound
    gq = validate_gains.certify(np_ops, zs32, ks32, log=lambda _: None)
    log(f"[4] DRE gains f32 vs f64 {gain_dev:.2e} (tol {GAIN_TOL:g}); GAINQ "
        f"(scripts/validate_gains.py): worst projected DRE residual of the "
        f"f32 factors {gq['worst']:.2e} < {validate_gains.RESIDUAL_BOUND:g}")
    del zs32

    # --- 5. rollout -----------------------------------------------------
    fused64 = build_nse_fused(np_ops, cond, DT, device=cpu, dtype=f64)
    fused32 = fused64.to(dev, f32)
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

    conv_kernel.launches = 0
    spmm_kernel.launches = 0
    with recorded_spmm_inputs() as seen:
        vs, us, ys = rollout()
    main_launches = conv_kernel.launches
    check(main_launches == NTS,
          f"conv_p2 launches in the rollout: {main_launches} != {NTS}")
    check(spmm_kernel.launches == NTS,
          f"spmm_tile launches in the rollout: {spmm_kernel.launches} != "
          f"{NTS}")
    rollout_k2_err = check_spmm_inputs("5 fused rollout", seen)
    del seen
    check(tuple(ys.shape) == (S_BATCH, NTS + 1, sys32.p_out), "ys shape")
    check(tuple(us.shape) == (S_BATCH, NTS, m), "us shape")
    for name, x in (("vs", vs), ("us", us), ("ys", ys)):
        check(bool(torch.isfinite(x).all()), f"rollout {name} finite")
    rows = kernel_split(rollout)
    check(kernel_calls(rows, "conv_p2_patch") == NTS,
          f"profiled convection kernels: "
          f"{kernel_calls(rows, 'conv_p2_patch')} != {NTS}")
    check(kernel_calls(rows, "spmm_tile") == NTS,
          f"profiled SpMM kernels: {kernel_calls(rows, 'spmm_tile')} != "
          f"{NTS}")
    check(kernel_calls(rows, "index", "gather", "scatter") == 0,
          "index_put, gather or scatter kernels in the rollout")
    # copies only once per rollout (the transposed initial state and the
    # final stack), none in a step
    copies = kernel_calls(rows, "copy")
    check(copies < NTS, f"copy kernels in the rollout: {copies}")
    log(f"[5] fused closed loop {S_BATCH} x {NTS}: conv_p2 {main_launches} "
        f"and spmm_tile {NTS} launches, one each a step in the profiler's "
        f"listing, no index_put, "
        f"gather or scatter kernel, {copies} copy kernels; outputs finite; "
        f"TF32 off")

    # --- 6. in-run f64 check on the CPU ---------------------------------
    conv64 = ConvKernel.build(np_ops["full"], cond, device=cpu, dtype=f64)
    _, _, ys_ref = batched_nse_closed_loop(
        sys64.to(cpu), conv64, fused64, k0.to(cpu, f64).expand(NTS + 1, m, n),
        torch.zeros((NTS + 1, n), dtype=f64),
        torch.as_tensor(v0_np[:S_REF]), ALPHA, DT,
    )
    roll_dev = rel_err(ys[:S_REF].to(cpu, f64), ys_ref)
    check(roll_dev <= ROLLOUT_TOL, f"rollout vs f64: {roll_dev:.2e}")
    log(f"[6] rollout vs f64 recurrence ({S_REF} scenarios, CPU): "
        f"{roll_dev:.2e} (tol {ROLLOUT_TOL:g})")

    # --- 15 (d). the sanitizer and a trace, on phase 5's stepper --------
    sanitizer_phase(dev, sys32, conv, fused32, ks, ws, v0)

    # --- 14 (b). the sharded rollout at world size 1 ---------------------
    store = tempfile.TemporaryDirectory()
    init_multihost(dev, f"file://{store.name}/store", rank=0, world_size=1)
    mesh = scenario_mesh(dev)
    sharded_fused_phase(mesh, sys32, conv, fused32, ks, ws, v0, ys, us)
    fused_p = fused32.ppack
    del fused64, fused32, conv, conv64

    # --- 7. K2 and the MGS kernel on config 3's operators ---------------
    c3_ops, c3_sys64, c3_cond = cylinder_setup(
        re=C3_RE, refinement=C3_REFINEMENT, device=dev, dtype=f64
    )
    with tempfile.TemporaryDirectory() as tmp:
        c3_iv = config3_cylinder.shift_interval(c3_ops, cache_dir=tmp)
    c3_sched = config3_cylinder.schedule(c3_iv, C3_SHIFTS, C3_ADI)
    c3_sched12 = config3_cylinder.schedule(c3_iv, C3_MF_SHIFTS, C3_ADI)
    spmm_head = spmm_phase(c3_ops, fused_p, dev)
    del fused_p
    mgs_head, mgs_err = mgs_phase(c3_sys64.n + c3_sys64.n_p,
                                  sys64.n + sys64.n_p, dev)

    # --- 8. NS stack at the bench shape ---------------------------------
    spmm_err = max(rollout_k2_err, bench_ns_phase(
        sys32, cache64, ks64, sig, sseq, iseq,
        (at_til, np_ops["M"], np_ops["J"])))

    # --- 11 (a). the matrix-free tier at the bench shape ------------------
    matfree_bench_phase(np_ops, cond, sys64, cache64, (sig, sseq, iseq), dev)
    del cache64, sys32

    # --- 12. receding-horizon MPC ---------------------------------------
    kernel_err, k2_err = receding_phase(np_ops, cond, sys64, dev)
    spmm_err = max(spmm_err, k2_err)
    del sys64
    torch.cuda.empty_cache()
    receding_lu_phase(dev)

    # --- 9. config 3 ----------------------------------------------------
    spmm_launches, c3_ks64, c3_ks32, c3_pit = config3_phase(
        c3_ops, c3_sys64, c3_sched)

    # --- 11 (b). config 3 on the matrix-free tier -----------------------
    mgs_launches = matfree_config3_phase(c3_ops, c3_cond, c3_sys64,
                                         c3_sched12, c3_ks64, c3_ks32,
                                         c3_pit, dev)
    del c3_pit

    # --- 10. the driver ---------------------------------------------------
    rng = np.random.default_rng(SEED)
    driver_phase(vbar[None] + 1e-3 * rng.standard_normal((S_BATCH, n)), dev)
    golden_lu_phase(dev)

    # --- 13. the config-5 parameter sweep -------------------------------
    k1_err, k2_err = sweep_phase(dev, mesh)
    kernel_err, spmm_err = max(kernel_err, k1_err), max(spmm_err, k2_err)
    torch.distributed.destroy_process_group()
    store.cleanup()

    # --- 14. config 3XL and the dry run on two ranks --------------------
    k1_err, k2_err = config3xl_phase(dev)
    kernel_err, spmm_err = max(kernel_err, k1_err), max(spmm_err, k2_err)
    dryrun_phase()

    # --- 15. the stabilized ARE and the precision tiers ------------------
    cavity_are_phase(dev)
    spmm_err = max(spmm_err, wake_are_phase(dev))
    kernel_err = max(kernel_err, precision_phase(dev))

    log(json.dumps({"kernels": [
        {
            "name": "conv_p2",
            "route": "cuda",
            "source": "optconpy_tpu_torch/csrc/conv_p2.cu",
            "replaces": "optconpy_tpu/ops/pallas_conv.py:74",
            "launches": main_launches,
            "max_abs_err": kernel_err,
            **k1_head,
        },
        {
            "name": "spmm_tile",
            "route": "cuda",
            "source": "optconpy_tpu_torch/csrc/spmm_tile.cu",
            "replaces": "optconpy_tpu/ops/pallas_spmm.py:197",
            "launches": spmm_launches,
            "max_abs_err": spmm_err,
            **spmm_head,
        },
        {
            "name": "mgs_step",
            "route": "cuda",
            "source": "optconpy_tpu_torch/csrc/mgs_step.cu",
            "replaces": None,
            "tpu_path": "optconpy_tpu/solvers/krylov.py:119-127 (lax.fori_loop)",
            "launches": mgs_launches,
            "max_abs_err": mgs_err,
            "library_ms": None,
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
