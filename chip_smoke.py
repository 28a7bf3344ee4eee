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
     (f32-vs-f64 gain deviation <= 1e-4);
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
     replaced kernel's time;
  8. the f32 NS stack at the bench shape's 6 shifts through the SpMM
     kernel: per-shift deviation from phase 4's host stack, gains vs
     phase 4's f64 gains (<= 1e-4);
  9. config 3: the f64 NS stack certified at 1e-8 and its DRE sweep,
     then the f32 stack at certify_tol 5e-4 (each shift's probe
     evaluated in f32 and in f64; the f64 one certifies) and its sweep
     (first and warm); |JZ|/|Z| <= 1e-5 and the projected DRE residual at
     steps 0 and 8 <= 1e-2 (host f64); f32-vs-f64 gain deviation <= 1e-4;
 10. the user's entry point, optconpy_tpu_torch.optcont.optcon_nse:
     (a) config 4 (the bench shape with a feedforward and a gain for
     every one of 64 steps, y* = steady output + 0.01) in f32 on the
     fused step tier with Newton-Schulz gains, 1024 scenarios: every
     shift certified, K2 launched in the DRE stage and K1 exactly 64
     times in the rollout, finite outputs, TF32 off; (b) the same config
     in f64 on the first 2 scenarios: f32 vs f64 gains and outputs
     <= 1e-4; (c) configs 1 (heat1d) and 2 (driven cavity) on the lu
     tiers on the card against device="cpu" (<= 1e-10). Each run's stage
     seconds and closed-loop solves/s are printed;
 11. the matrix-free tier (block-Jacobi / pressure-Schur FGMRES over the
     SpMM kernel), run beside the phases whose inputs it shares:
     (a) after phase 8, at the bench shape in f64: 12 ADI iterations
     through SaddleMatfreeCache (tol 1e-11) vs the same iterations
     through phase 4's host inverse stack (<= 1e-6), and the matrix-free
     stepper (tol 1e-12) vs the lu stepper, 3 scenarios x 6 steps in both
     feedback modes (v, u, y <= 1e-7); (b) after phase 9, config 3 in
     f32 at full width: the matrix-free DRE sweep (FGMRES tol 1.05e-4, 8
     cycles) vs phase 9's f64 NS gains (<= 1e-3) with the projected DRE
     residual at step 0 (<= 1e-2), K1 at B=16 vs plain (<= 1e-5), and
     the matrix-free closed loop, 16 scenarios x 100 steps, implicit
     feedback, controlled and uncontrolled (energy ratio at T < 0.5, K1
     101 launches a rollout), with profiler listings of one ADI solve and
     one rollout step; (c) inside phase 10, the cavity on the matrix-free
     step and DRE tiers over 4 of its 20 steps, card vs CPU (<= 1e-8);
     (d) after phase 3,
     QuadConvKernel at B=1024 in f32 (4 SpMM launches a call) vs
     ConvKernel's plain version (<= 1e-5), timed beside K1;
 12. receding-horizon MPC (mpc/receding.py), after phase 11 (a): (a)
     config 4's macro loop (8 shifts, 16 ADI then 8 warm, horizon 8,
     apply 8, 1024 scenarios, f32, K1 in the rollout) on the dense_ns
     tier (NS-refreshed dense DRE stack, every refresh certified in f64
     at 5e-4) and the matfree tier (refreshed FGMRES caches), 6 macros
     after a 2-macro warm-up (whose every SpMM input, a (pack, width,
     dtype) at a time, is held against the plain version, <= 1e-5 f32
     and 1e-12 f64, and repeats bit for bit): s/macro, the breakdown by
     stage, the device idle estimate, the perturbation decay (< 1), K1 and K2 launches by
     macro and stage, peak memory, each macro's refresh residuals or
     FGMRES records; dense_ns vs matfree gains on every macro (<= 1e-4);
     dense_ns in f64 for the first 2 macros on the same scenarios: gains
     and outputs C v (<= 1e-4). (b) the lu tier on the reference test's
     cavity, card vs CPU (vs, us, ks <= 1e-10);
 13. the config-5 Re-bucket parameter sweep (optconpy_tpu_torch.parallel)
     at the shape of scripts/sweep_config5.py: 8 buckets over Re 60-150,
     8,192 drawn Re values (seed 0) in ragged buckets padded to 1,280,
     200 steps, f32, TF32 off; per-bucket gains (matrix-free DRE, 8
     shifts x 16 ADI, 8 steps, rank 24) and the Newton-Schulz stepper
     chain, every bucket certified in f64 at 1e-4 (every SpMM input the
     gains and the chain hand the kernel held against its plain version,
     a repeat bit for bit); the first and last bucket's f32 gains vs
     f64 NS-tier gains (<= 1e-4); the sweep first and 3 warm (bit-equal
     outputs), real and padded solves/s, peak memory, launches (K1 one a
     step, K2 none); K1 on the sweep's own first-step X at B = 10,240 vs
     plain (<= 1e-5, repeats bit for bit); the masked statistics (exact
     counts, finite, unchanged with NaN padded rows) beside
     SWEEP_r05.json's (the JAX package on a TPU, labelled so); the f32
     sweep vs f64 on the host-LU stepper tier for 2 real scenarios of the
     first and last bucket (<= 1e-4), and the same scenarios in f32 on
     f32 host-LU and host-inverse steppers (printed: the f32 gap without
     the chain's inverses); a profiler listing of a warm sweep
     (GEMM and K1 shares, device busy, no copy kernel a step).

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

# Phase 10: the driver. Config 4 is the bench shape through optcon_nse,
# with a gain and a feedforward for every step, explicit feedback as the
# bench's loop; (b) repeats it in f64 on the first S_REF scenarios.
YSTAR_AMP = 0.01
DRIVER_TOL = 1e-10  # lu tiers, card vs CPU, f64

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
C3_ROLL_S, C3_ROLL_NTS = 16, 100
MF_GAIN_TOL = 1e-3  # f32 matrix-free vs f64 NS gains: 10x the FGMRES tol
ENERGY_RATIO_MAX = 0.5
MF_DRIVER_TOL = 1e-8  # cavity matfree tiers, card vs CPU, f64
MF_DRIVER_FGMRES = 1e-11
MF_DRIVER_NTS = 4  # of config 2's 20 steps

# Phase 12: receding-horizon MPC, config 4, the card side of
# scripts/bench_receding.py at the shape of RECEDING_r05.json: 8 shifts,
# 16 ADI iterations (8 on warm macros), horizon 8, apply 8, one Newton
# step, rank 32, 1024 scenarios, 6 macros after a 2-macro warm-up call.
RH_SHIFTS, RH_ADI = 8, 16
RH_CFG = dict(horizon=8, apply=8, dt=DT, alpha=ALPHA, n_newton=1, r_max=32,
              warm_n_adi=8)
RH_MACROS, RH_WARMUP, RH_F64_MACROS = 6, 2, 2
RH_GAIN_TOL = 1e-4  # dense_ns vs matfree gains, every macro
RH_NS_CERTIFY = 5e-4  # every NS refresh, evaluated in f64
# (b) the lu tier: the cavity of tests/test_receding_mpc.py:21-28 and its
# 3-macro config (:55), 4 scenarios, f64, card vs CPU.
RH_LU_CFG = dict(horizon=8, apply=4, dt=0.02, alpha=1e-8, r_max=24)
RH_LU_TOL = 1e-10

# Phase 13: the config-5 parameter sweep at the shape of
# scripts/sweep_config5.py (SWEEP_r05.json): 8 Re buckets over [60, 150],
# 8,192 Re values drawn uniformly (seed 0) and assigned to the nearest
# bucket, each bucket padded to a multiple of 256; gains from 8 DRE steps
# of 16 ADI iterations (8 shifts, rank 24, one Newton step) on the
# matrix-free tier, steppers from the Newton-Schulz chain certified at
# 1e-4, 200 steps, f32. The f64 check runs the first and the last bucket's
# first 2 real scenarios on the host-LU stepper tier.
SW_RE = (60.0, 150.0)
SW_BUCKETS = 8
SW_SCENARIOS = 8192
SW_PAD = 256
SW_NTS = 200
SW_GAINS = dict(num_shifts=8, n_adi=16, nts_gain=8, r_max=24)
SW_CERTIFY = 1e-4
SW_REF_S = 2
SW_WARM = 3
SW_RECORD = "SWEEP_r05.json"  # the JAX package's run on a TPU v5 lite

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
        pack, _, _ = SaddleOpsPack.build(
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


def bench_ns_phase(sys32, cache64, ks64, sig, sseq, iseq):
    """Phase 8: the f32 NS stack at the bench shape's shifts, built
    through the SpMM kernel, against phase 4's host f64 splu stack and
    its f64 gains."""
    import torch

    from optconpy_tpu_torch.ops import spmm_kernel
    from optconpy_tpu_torch.riccati import (
        build_dre_cache_dae_ns,
        dre_backward_sweep,
    )

    spmm_kernel.launches = 0
    (cache, info), t_build = sync_time(
        lambda: build_dre_cache_dae_ns(sys32, DT, sig)
    )
    launches = spmm_kernel.launches
    check(launches >= 4 * info["ns_passes"],
          f"spmm_tile launches in the bench NS build: {launches}")
    devs = [
        rel_err(cache.inv[i].double(), cache64.inv[i])
        for i in range(len(sig))
    ]
    _, ks = dre_backward_sweep(
        sys32, cache, ALPHA, DT, NTS_GAIN, sseq, iseq,
        n_newton=N_NEWTON, r_max=R_MAX,
    )
    gain_dev = rel_err(ks.double(), ks64)
    check(bool(torch.isfinite(ks).all()), "NS-stack gains finite")
    check(gain_dev <= GAIN_TOL, f"NS-stack f32 vs f64 gains: {gain_dev:.2e}")
    log(f"[8] bench-shape f32 NS stack ({len(sig)} shifts) {t_build:.2f} s: "
        f"{info['ns_passes']} NS passes, {info['ladder_rungs']} rungs, "
        f"{launches} spmm_tile launches; residuals (f64-evaluated) "
        f"{[f'{r:.2e}' for r in info['residuals']]}, f32-evaluated "
        f"{[f'{r:.2e}' for r in info['residuals_working']]} (certified "
        f"{info['certified']} at {info['certify_tol']:g}); deviation from "
        f"the host f64 splu stack per shift {[f'{d:.2e}' for d in devs]}; "
        f"gains vs phase 4's f64 gains {gain_dev:.2e} (tol {GAIN_TOL:g})")


def config3_phase(c3_ops, sys64, sched) -> int:
    """Phase 9: config 3 on the NS tier. Returns the SpMM kernel's
    launches in the f32 NS build and the f64 NS gains."""
    import torch

    from optconpy_tpu_torch.ops import spmm_kernel
    from optconpy_tpu_torch.riccati import (
        build_dre_cache_dae_ns,
        dre_backward_sweep,
    )
    from optconpy_tpu_torch.riccati.validate import dre_step_residual

    sig, sseq, iseq = sched
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
    feas = float(sys32.jmat.matmat(zs[0]).abs().max() / zs[0].abs().max())
    check(feas <= FEAS_TOL, f"|JZ|/|Z| = {feas:.2e}")
    gain_dev = rel_err(ks.double(), ks64)
    check(gain_dev <= GAIN_TOL, f"config-3 f32 vs f64 gains: {gain_dev:.2e}")
    t0 = time.perf_counter()
    residuals = {
        step: dre_step_residual(
            c3_ops, zs[step].cpu().numpy(), ks[step].cpu().numpy(),
            zs[step + 1].cpu().numpy(), C3_ALPHA, C3_DT,
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
        f"{DRE_RES_TOL:g}, host f64 {time.perf_counter() - t0:.1f} s); "
        f"f32 vs f64 gain deviation {gain_dev:.2e} (tol {GAIN_TOL:g})")
    return launches, ks64


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
        got, t_mf = sync_time(lambda: roll(mfs))
        key = f"11a matfree stepper {feedback} (bench, f64)"
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


def matfree_config3_phase(c3_ops, c3_cond, c3_sys64, sched, ks64, dev):
    """Phase 11 (b): config 3 in f32 on the matrix-free tier: the DRE
    sweep against phase 9's f64 NS gains, the projected DRE residual,
    K1 at the rollout's width, and the closed loop controlled and
    uncontrolled. Returns (K1's, K2's) launches by path."""
    import torch

    from optconpy_tpu_torch.fem.device_conv import ConvKernel, FusedConvKernel
    from optconpy_tpu_torch.mpc import (
        batched_nse_closed_loop,
        build_nse_stepper_matfree,
    )
    from optconpy_tpu_torch.ops import conv_kernel, spmm_kernel
    from optconpy_tpu_torch.riccati import (
        build_dre_cache_dae_matfree,
        dre_backward_sweep,
    )
    from optconpy_tpu_torch.riccati.validate import dre_step_residual

    f32 = torch.float32
    sig, sseq, iseq = sched
    sys32 = c3_sys64.to(dtype=f32)
    n, m = sys32.b.shape
    k1, k2 = {}, {}
    torch.cuda.reset_peak_memory_stats()
    mf, t_build = sync_time(lambda: build_dre_cache_dae_matfree(
        sys32, C3_DT, sig, block=MF_BLOCK, max_cycles=C3_DRE_CYCLES,
        tol=C3_FGMRES_TOL,
    ))
    spmm_kernel.launches = 0
    (zs, ks), t_sweep = sync_time(lambda: dre_backward_sweep(
        sys32, mf, C3_ALPHA, C3_DT, C3_NTS, sseq, iseq, n_newton=1,
        r_max=C3_R_MAX,
    ))
    k2["11b config-3 matfree DRE sweep (f32)"] = spmm_kernel.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    adi_iters = C3_NTS * C3_ADI
    check(bool(torch.isfinite(ks).all()), "config-3 matfree gains finite")
    check(spmm_kernel.launches > 0, "spmm_tile launched in the matfree DRE")
    gain_dev = rel_err(ks.double(), ks64)
    check(gain_dev <= MF_GAIN_TOL,
          f"config-3 matfree f32 vs NS f64 gains: {gain_dev:.2e}")
    feas = float(sys32.jmat.matmat(zs[0]).abs().max() / zs[0].abs().max())
    t0 = time.perf_counter()
    res0 = dre_step_residual(c3_ops, zs[0].cpu().numpy(), ks[0].cpu().numpy(),
                             zs[1].cpu().numpy(), C3_ALPHA, C3_DT)
    t_res = time.perf_counter() - t0
    check(res0 <= DRE_RES_TOL, f"config-3 matfree DRE residual {res0:.2e}")
    rels = np.asarray(mf.stats.relres)
    log(f"[11b] config 3 f32 matrix-free (n={n}, n_p={c3_sys64.n_p}, "
        f"{len(sig)} shifts, block {MF_BLOCK}, FGMRES tol {C3_FGMRES_TOL:g}, "
        f"{C3_DRE_CYCLES} cycles): build {t_build:.2f} s; DRE sweep "
        f"({C3_NTS} steps x {C3_ADI} ADI, rank {C3_R_MAX}, one Newton step) "
        f"{t_sweep:.2f} s = {adi_iters / t_sweep:.2f} ADI iters/s; "
        f"{len(rels)} FGMRES solves, relres worst {rels.max():.2e}, median "
        f"{np.median(rels):.2e}, {int((rels > C3_FGMRES_TOL).sum())} above "
        f"tol (the cache's record: {mf.stats.above_tol}); "
        f"{spmm_kernel.launches} spmm_tile launches; "
        f"peak device memory {peak_gb:.2f} GB")
    log(f"      gains vs phase 9's f64 NS gains {gain_dev:.2e} (tol "
        f"{MF_GAIN_TOL:g}); |JZ|/|Z| {feas:.2e}; projected DRE residual at "
        f"step 0 {res0:.2e} (tol {DRE_RES_TOL:g}, host f64 {t_res:.1f} s)")

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
    ks_roll = ks[0].expand(C3_ROLL_NTS + 1, m, n)
    ws = torch.zeros((C3_ROLL_NTS + 1, n), dtype=f32, device=dev)
    v0_np = vbar.numpy()[None] + 1e-3 * rng.standard_normal((C3_ROLL_S, n))
    v0 = torch.as_tensor(v0_np, dtype=f32).to(dev)
    mass64 = c3_sys64.mass
    vbar_dev = stepper.vbar.double()

    def energy_at_t(vs):
        d = (vs[:, -1, :].double() - vbar_dev).T
        return float((d * mass64.matmat(d.contiguous())).sum(0).mean())

    runs = {}
    for name, gains in (("controlled", ks_roll), ("uncontrolled",
                                                  torch.zeros_like(ks_roll))):
        conv_kernel.launches = 0
        spmm_kernel.launches = 0
        (vs, us, ys), t_roll = sync_time(lambda: batched_nse_closed_loop(
            sys32, conv, stepper, gains, ws, v0, C3_ALPHA, C3_DT,
            feedback="implicit",
        ))
        key = f"11b config-3 matfree rollout {name} (f32)"
        k1[key], k2[key] = conv_kernel.launches, spmm_kernel.launches
        check(k1[key] == C3_ROLL_NTS + 1,
              f"conv_p2 launches in the {name} config-3 rollout: {k1[key]}")
        check(k2[key] > 0, f"spmm_tile launched in the {name} rollout")
        for nm, x in (("vs", vs), ("us", us), ("ys", ys)):
            check(bool(torch.isfinite(x).all()), f"{name} rollout {nm} finite")
        check(tuple(ys.shape) == (C3_ROLL_S, C3_ROLL_NTS + 1, sys32.p_out),
              "config-3 rollout ys shape")
        runs[name] = (energy_at_t(vs), t_roll)
        log(f"      {name} closed loop ({C3_ROLL_S} scenarios x "
            f"{C3_ROLL_NTS} steps, implicit feedback, tol {C3_FGMRES_TOL:g}, "
            f"{C3_ROLL_CYCLES} cycles): {t_roll:.2f} s = "
            f"{C3_ROLL_S * C3_ROLL_NTS / t_roll:.1f} solves/s; conv_p2 "
            f"{k1[key]} launches, spmm_tile {k2[key]}; perturbation energy at "
            f"T {runs[name][0]:.4e}")
        del vs, us, ys
    ratio = runs["controlled"][0] / runs["uncontrolled"][0]
    check(ratio < ENERGY_RATIO_MAX, f"config-3 energy ratio {ratio:.3e}")
    log(f"      stepper build {t_step:.2f} s; energy ratio controlled / "
        f"uncontrolled at T {ratio:.4e} (bound < {ENERGY_RATIO_MAX:g})")
    profile_listing(
        f"one rollout step ({C3_ROLL_S} scenarios, implicit feedback)",
        lambda: batched_nse_closed_loop(
            sys32, conv, stepper, ks_roll[:2], ws[:2], v0, C3_ALPHA, C3_DT,
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
    """Phase 12 (a): config 4's receding-horizon macro loop in f32 on the
    dense_ns and matfree tiers, then dense_ns in f64 for the first macros
    on the same scenarios. The SpMM kernel is held against its plain
    version on the inputs the warm-up call hands it. Returns each
    kernel's launches by path and the kernel's largest absolute error."""
    import torch

    from optconpy_tpu_torch.fem.device_conv import ConvKernel, FusedConvKernel
    from optconpy_tpu_torch.mpc import RHConfig, receding_horizon_mpc
    from optconpy_tpu_torch.ops import conv_kernel, spmm_kernel
    from optconpy_tpu_torch.riccati import dre_shift_schedule_dae

    f32, f64 = torch.float32, torch.float64
    sys32 = sys64.to(dtype=f32)
    n = sys32.n
    t0 = time.perf_counter()
    sched = dre_shift_schedule_dae(np_ops["A"], np_ops["M"], np_ops["J"], DT,
                                   num_shifts=RH_SHIFTS, n_adi=RH_ADI)
    conv = FusedConvKernel.build(np_ops["full"], cond, device=dev)
    rng = np.random.default_rng(SEED)
    vbar_np = cond.restrict(np_ops["vbar_full"])
    v0_np = vbar_np[None] + 1e-3 * rng.standard_normal((S_BATCH, n))
    v0 = torch.as_tensor(v0_np, dtype=f32).to(dev)
    vbar = torch.as_tensor(vbar_np).to(dev)
    log(f"[12] receding-horizon MPC, config 4 (n={n}, {S_BATCH} scenarios, "
        f"{RH_SHIFTS} shifts x {RH_ADI} ADI, {RH_CFG}): shifts and K1 "
        f"{time.perf_counter() - t0:.1f} s")

    def decay(vs):
        d = (vs[:, [0, -1]].double() - vbar).norm(dim=2).mean(dim=0)
        return float(d[1] / d[0])

    outs, k1, k2, k2_abs = {}, {}, {}, 0.0
    for solver in ("dense_ns", "matfree"):
        cfg = RHConfig(**RH_CFG, solver=solver)
        args = (sys32, conv, np_ops, cond, cfg, *sched, v0)
        # the warm-up's macros build (0) and refresh (1) every cache
        with recorded_spmm_inputs() as seen:
            _, t_warm = sync_time(
                lambda: receding_horizon_mpc(*args, n_macro=RH_WARMUP))
        k2_abs = max(k2_abs, check_spmm_inputs(f"{solver} warm-up", seen))
        del seen
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        conv_kernel.launches = 0
        spmm_kernel.launches = 0
        out, t_all = sync_time(lambda: receding_horizon_mpc(
            *args, n_macro=RH_MACROS, profile=True))
        key = f"12 receding {solver} (config 4, f32, {RH_MACROS} macros)"
        k1[key], k2[key] = conv_kernel.launches, spmm_kernel.launches
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        for name in ("vs", "us", "ks"):
            check(bool(torch.isfinite(out[name]).all()),
                  f"receding {solver} {name} finite")
        check(tuple(out["vs"].shape)
              == (S_BATCH, RH_MACROS * RH_CFG["apply"] + 1, n),
              f"receding {solver} vs shape")
        check(k1[key] == RH_MACROS * (RH_CFG["apply"] + 1),
              f"conv_p2 launches in the {solver} loop: {k1[key]}")
        check(k2[key] > 0, f"spmm_tile launched in the {solver} loop")
        tm = out["timings"]
        stages = ("rebuild", "dre", "probe", "stepper_join", "rollout")
        mean = {k: statistics.mean(t[f"{k}_s"] for t in tm)
                for k in stages + ("total",)}
        steady = tm[2:]
        steady_s = statistics.mean(t["total_s"] for t in steady)
        busy = statistics.mean(t["dre_s"] + t["probe_s"] + t["rollout_s"]
                               for t in steady)
        refresh_s = statistics.mean(t["stepper_refresh_s"] for t in tm[1:])
        dec = decay(out["vs"])
        check(dec < 1.0, f"receding {solver} perturbation decay {dec:.4f}")
        log(f"     {solver}: warm-up ({RH_WARMUP} macros) {t_warm:.2f} s; "
            f"{RH_MACROS} macros {t_all:.2f} s: {mean['total']:.4f} s/macro, "
            f"steady (macros 2-{RH_MACROS - 1}) {steady_s:.4f} s/macro; "
            f"breakdown {({k: round(mean[k], 4) for k in stages})} s; device "
            f"idle estimate {max(0.0, 1.0 - busy / steady_s):.3f}; stepper "
            f"refresh on the worker thread {refresh_s:.4f} s a warm macro "
            f"(beside the DRE sweep); decay "
            f"dT/d0 {dec:.4f}; peak device memory {peak_gb:.2f} GB; conv_p2 "
            f"{k1[key]} launches, spmm_tile {k2[key]}")
        for t, rec in zip(tm, out["macros"]):
            if solver == "dense_ns":
                check(rec["ns_refresh_worst_residual"] <= RH_NS_CERTIFY,
                      f"NS refresh certified: {rec['ns_refresh_residuals']}")
                quality = (
                    f"NS refresh residuals (f64) "
                    f"{[f'{r:.1e}' for r in rec['ns_refresh_residuals']]}, "
                    f"rebuilds {rec['ns_refresh_rebuilds']}")
            else:
                quality = (
                    f"probe relres {rec['fgmres_probe_relres']:.2e}; FGMRES "
                    + "; ".join(
                        f"{st} {rec[f'fgmres_{st}']['solves']} solves, worst "
                        f"{rec[f'fgmres_{st}']['worst_relres']:.2e}, "
                        f"{rec[f'fgmres_{st}']['above_tol']} above tol"
                        for st in ("dre", "rollout"))
                    + f"; preconditioner re-inverted {rec['precond_refresh']}")
            log(f"       macro {rec['macro']}: {t['total_s']:.4f} s "
                f"({ {k: round(t[f'{k}_s'], 4) for k in stages} }); launches "
                f"(conv_p2, spmm_tile) by stage "
                f"{ {k: tuple(v.values()) for k, v in t['launches'].items()} }"
                f"; {quality}")
        outs[solver] = out
    ks_ns, ks_mf = outs["dense_ns"]["ks"], outs["matfree"]["ks"]
    gdev = [rel_err(a, b) for a, b in zip(ks_ns, ks_mf)]
    check(max(gdev) <= RH_GAIN_TOL,
          f"receding dense_ns vs matfree gains by macro: {gdev}")
    vs32 = outs["dense_ns"]["vs"]
    del outs

    # the in-run f64 check: dense_ns in f64 on the same scenarios (the
    # plain convection: K1 takes float32 only)
    t0 = time.perf_counter()
    conv64 = ConvKernel.build(np_ops["full"], cond, device=dev, dtype=f64)
    out64 = receding_horizon_mpc(
        sys64, conv64, np_ops, cond, RHConfig(**RH_CFG, solver="dense_ns"),
        *sched, torch.as_tensor(v0_np).to(dev), n_macro=RH_F64_MACROS,
    )
    steps = RH_F64_MACROS * RH_CFG["apply"] + 1
    g64 = rel_err(ks_ns[:RH_F64_MACROS].double(), out64["ks"])
    y32 = torch.einsum("pn,stn->stp", sys64.c, vs32[:, :steps].double())
    y64 = torch.einsum("pn,stn->stp", sys64.c, out64["vs"])
    ydev = rel_err(y32, y64)
    check(g64 <= GAIN_TOL, f"receding f32 vs f64 gains: {g64:.2e}")
    check(ydev <= ROLLOUT_TOL, f"receding f32 vs f64 outputs: {ydev:.2e}")
    log(f"     dense_ns vs matfree gains by macro "
        f"{[f'{d:.2e}' for d in gdev]} (tol {RH_GAIN_TOL:g}); f32 vs f64 "
        f"({RH_F64_MACROS} macros, {S_BATCH} scenarios, "
        f"{time.perf_counter() - t0:.1f} s): gains {g64:.2e}, outputs C v "
        f"{ydev:.2e} (tol {GAIN_TOL:g} and {ROLLOUT_TOL:g})")
    return k1, k2, k2_abs


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
    the first X it is handed (the path's own input). Yields a list that
    holds it after the first call."""
    from optconpy_tpu_torch.ops import conv_kernel

    wrapper, seen = conv_kernel.conv_inner, []

    def recording(v_t, conv):
        if not seen:
            seen.append(v_t.clone())
        return wrapper(v_t, conv)

    conv_kernel.conv_inner = recording
    try:
        yield seen
    finally:
        conv_kernel.conv_inner = wrapper


@contextmanager
def counted_spmm_launches(module, name: str):
    """Inside the block, module.name counts the SpMM kernel launches of
    each of its calls. Yields the list of those counts, one a call."""
    from optconpy_tpu_torch.ops import spmm_kernel

    fn, counts = getattr(module, name), []

    def counting(*args, **kwargs):
        k0 = spmm_kernel.launches
        try:
            return fn(*args, **kwargs)
        finally:
            counts.append(spmm_kernel.launches - k0)

    setattr(module, name, counting)
    try:
        yield counts
    finally:
        setattr(module, name, fn)


def sweep_phase(dev, card: str):
    """Phase 13: the config-5 Re-bucket parameter sweep in f32 at the
    shape of scripts/sweep_config5.py. Returns each kernel's launches by
    path, K1's record at the sweep's width and both kernels' largest
    absolute errors against their plain versions on the path's inputs."""
    import torch

    from optconpy_tpu_torch import riccati
    from optconpy_tpu_torch.fem.device_conv import ConvKernel, FusedConvKernel
    from optconpy_tpu_torch.models.cylinder import cylinder_setup
    from optconpy_tpu_torch.mpc import (
        NSEStepCache,
        build_nse_stepper,
        nse_sweep_outputs,
    )
    from optconpy_tpu_torch.ops import conv_kernel, spmm_kernel
    from optconpy_tpu_torch.parallel import param_sweep
    from optconpy_tpu_torch.parallel import (
        assign_re_buckets,
        build_sweep_gains_and_caches,
        masked_sweep_stats,
        sweep_rollout,
    )
    from optconpy_tpu_torch.riccati import (
        build_dre_cache_dae_ns,
        dre_backward_sweep,
        dre_shift_schedule_dae,
    )

    f32, f64 = torch.float32, torch.float64
    t_phase = time.perf_counter()
    check(torch.backends.cuda.matmul.allow_tf32 is False, "TF32 matmul off")
    check(torch.backends.cudnn.allow_tf32 is False, "TF32 cuDNN off")
    re_buckets = np.linspace(*SW_RE, SW_BUCKETS)
    rng = np.random.default_rng(SEED)
    draw = rng.uniform(*SW_RE, SW_SCENARIOS)
    counts = np.bincount(assign_re_buckets(draw, re_buckets),
                         minlength=SW_BUCKETS)
    s_max = int(-(-counts.max() // SW_PAD) * SW_PAD)
    real, padded = int(counts.sum()) * SW_NTS, SW_BUCKETS * s_max * SW_NTS

    t0 = time.perf_counter()
    setups = [cylinder_setup(re=float(re), refinement=REFINEMENT, device=dev,
                             dtype=f64) for re in re_buckets]
    t_setup = time.perf_counter() - t0
    conv = FusedConvKernel.build(setups[0][0]["full"], setups[0][2],
                                 device=dev)
    sys32 = setups[0][1].to(dtype=f32)
    n = sys32.n
    steady = [f"{s[0]['steady_info']['residual']:.1e}" for s in setups]
    log(f"[13] config-5 sweep: {SW_BUCKETS} Re buckets "
        f"{np.round(re_buckets, 1).tolist()}, {SW_SCENARIOS} drawn Re -> "
        f"{counts.tolist()} real scenarios, padded to S_max={s_max}, "
        f"{SW_NTS} steps, n={n}; setup of the {SW_BUCKETS} buckets "
        f"{t_setup:.1f} s on {card} (steady residuals {steady})")

    # --- gains and the Newton-Schulz chain ---
    torch.cuda.reset_peak_memory_stats()
    info = {}
    k2_0 = spmm_kernel.launches
    with recorded_spmm_inputs() as seen, \
            counted_spmm_launches(riccati, "dre_backward_sweep") as k2_dres, \
            counted_spmm_launches(param_sweep,
                                  "build_sweep_steppers_ns_chain") as k2_ch:
        (cache_stack, ks), t_gains = sync_time(
            lambda: build_sweep_gains_and_caches(
                setups, DT, ALPHA, dtype=f32, solver="inverse_ns",
                dre_solver="matfree", conv=conv, info=info, **SW_GAINS))
    peak_gains = torch.cuda.max_memory_allocated() / 1e9
    k2_gains = spmm_kernel.launches - k2_0
    k2_dre, k2_chain = sum(k2_dres), sum(k2_ch)
    check(len(k2_dres) == SW_BUCKETS and len(k2_ch) == 1,
          f"one DRE sweep a bucket and one chain: {len(k2_dres)}, "
          f"{len(k2_ch)}")
    res, chain = info["ns_residuals"], info["ns_chain"]
    check(bool(torch.isfinite(ks).all()), "sweep gains finite")
    check(max(res) <= SW_CERTIFY, f"NS chain certified: {res}")
    log(f"     gains and steppers {t_gains:.1f} s on {card} (peak device "
        f"memory {peak_gains:.2f} GB; spmm_tile {k2_gains} launches: "
        f"{k2_dre} in the DRE sweeps, {k2_chain} in the chain, "
        f"{k2_gains - k2_dre - k2_chain} elsewhere); by bucket:")
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

    # --- the sweep ---
    ystar = torch.stack([
        s[1].c @ torch.as_tensor(s[2].restrict(s[0]["vbar_full"])).to(dev)
        for s in setups]).to(f32)
    v0_np = np.empty((SW_BUCKETS, s_max, n))
    mask = np.zeros((SW_BUCKETS, s_max))
    for r, (np_ops, _, cond) in enumerate(setups):
        v0_np[r] = cond.restrict(np_ops["vbar_full"])[None]
        c = int(counts[r])
        v0_np[r, :c] += 1e-3 * rng.standard_normal((c, n))
        mask[r, :c] = 1.0
    v0 = torch.as_tensor(v0_np, dtype=f32).to(dev)
    mask_d = torch.as_tensor(mask, dtype=f32).to(dev)

    def run(v):
        return sweep_rollout(sys32, conv, cache_stack, ks, v, ALPHA, DT,
                             SW_NTS)

    torch.cuda.reset_peak_memory_stats()
    conv_kernel.launches = 0
    spmm_kernel.launches = 0
    with recorded_conv_input() as first_x:
        (ys, u_sq, v_fin), t_first = sync_time(lambda: run(v0))
    k1_sweep, k2_sweep = conv_kernel.launches, spmm_kernel.launches
    peak_sweep = torch.cuda.max_memory_allocated() / 1e9
    check(k1_sweep == SW_NTS, f"conv_p2 launches in the sweep: {k1_sweep}")
    check(k2_sweep == 0, f"spmm_tile launches in the sweep: {k2_sweep}")
    check(tuple(ys.shape) == (SW_BUCKETS, s_max, SW_NTS + 1, sys32.p_out),
          "sweep ys shape")
    check(tuple(u_sq.shape) == (SW_BUCKETS, s_max, SW_NTS), "sweep u_sq shape")
    for name, x in (("ys", ys), ("u_sq", u_sq), ("v_final", v_fin)):
        check(bool(torch.isfinite(x).all()), f"sweep {name} finite")
    warm, prints = [], []
    for _ in range(SW_WARM):
        (ys_w, _, _), t = sync_time(lambda: run(v0))
        warm.append(t)
        prints.append(fingerprint(ys_w.cpu().numpy()))
        del ys_w
    check(len(set(prints)) == 1, f"warm sweeps bit-equal: {prints}")
    t_warm = statistics.median(warm)
    spread = (max(warm) - min(warm)) / t_warm
    log(f"     sweep {SW_BUCKETS} x {s_max} x {SW_NTS} on {card}: first "
        f"{t_first:.3f} s, warm {[round(t, 4) for t in warm]} s -> median "
        f"{t_warm:.4f} s (spread {spread:.1%}), {real / t_warm:.0f} real "
        f"solves/s, {padded / t_warm:.0f} padded solves/s "
        f"({t_warm / SW_NTS * 1e3:.2f} ms a step); conv_p2 {k1_sweep} "
        f"launches, spmm_tile {k2_sweep}; peak device memory {peak_sweep:.2f} "
        f"GB; warm ys fingerprints {prints} (bit-equal)")

    # --- K1 at the sweep's own first-step input ---
    x1 = first_x[0]
    b = x1.shape[1]
    out = conv_kernel.conv_inner(x1, conv)
    ref = ConvKernel.conv_inner_batch_t(conv, x1)
    k1_err, k1_abs = rel_err(out, ref), float((out - ref).abs().max())
    check(k1_err <= KERNEL_TOL, f"conv_p2 at the sweep's B={b}: {k1_err:.2e}")
    check(torch.equal(out, conv_kernel.conv_inner(x1, conv)),
          f"conv_p2 repeats bit for bit at B={b}")
    k_ms = event_ms(lambda: conv_kernel.conv_inner(x1, conv), 20)
    p_ms = event_ms(lambda: ConvKernel.conv_inner_batch_t(conv, x1), 3)
    nt, plan = conv.tri_dofs.shape[0], conv.plan
    plan_bytes = sum(
        t.numel() * t.element_size()
        for t in (plan.vsrc, plan.vdir, plan.pelem, plan.pnd, plan.psptr,
                  plan.pslot, plan.pdst, plan.bdst, plan.bsrc))
    bnd = bound_ms(4 * (2 * n * b + nt * 432) + plan_bytes, 1008 * nt * b,
                   "float32")
    k1_rec = {"B": b, "ms": k_ms, "plain_ms": p_ms, "bound_ms": bnd[0],
              "bound_by": bnd[1], "max_abs_err": k1_abs}
    log(f"     conv_p2 on the sweep's first-step X (n={n}, B={b}): rel err "
        f"{k1_err:.2e} (abs {k1_abs:.2e}, tol {KERNEL_TOL:g}) vs the plain "
        f"slot sums, repeats bit for bit; {k_ms:.3f} ms/call (events), plain "
        f"{p_ms:.3f} ms, bound {bnd[0]:.3f} ms ({bnd[1]}) = "
        f"{bnd[0] / k_ms:.0%} of the kernel's time")
    del first_x, x1, out, ref

    # --- statistics, and the same with NaN padded rows ---
    stats = masked_sweep_stats(ys, u_sq, ALPHA, DT, ystar, mask_d)
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
        torch.as_tensor(v0_np[rows, :SW_REF_S]).to(dev), ALPHA, DT, SW_NTS)
    ydev = rel_err(ys[rows, :SW_REF_S].double(), ys64)
    check(ydev <= ROLLOUT_TOL, f"sweep f32 vs f64 outputs: {ydev:.2e}")
    log(f"     f32 sweep vs f64 on the lu tier (buckets {rows}, "
        f"{SW_REF_S} real scenarios each, {SW_NTS} steps, "
        f"{time.perf_counter() - t0:.1f} s): ys {ydev:.2e} "
        f"(tol {ROLLOUT_TOL:g})")
    # the same scenarios in f32 on the host-built f32 steppers instead of
    # the chain's inverses: what f32 leaves without the chain
    v0_rows = v0[rows, :SW_REF_S].contiguous()
    for tier in ("lu", "inverse"):
        stack32 = NSEStepCache.stack([
            build_nse_stepper(setups[r][0], setups[r][2], DT, device=dev,
                              dtype=f32, solver=tier) for r in rows])
        ys32, _, _ = nse_sweep_outputs(sys32, conv, stack32, ks[rows],
                                       v0_rows, ALPHA, DT, SW_NTS)
        tdev = rel_err(ys32.double(), ys64)
        log(f"     the same scenarios in f32 on f32 {tier!r} steppers (host "
            f"f64 factor cast) vs f64: ys {tdev:.2e}")
        del stack32, ys32
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
    del ys, u_sq, v_fin, cache_stack, ks, v0, setups, conv
    torch.cuda.empty_cache()
    log(f"[13] phase 13 wall {time.perf_counter() - t_phase:.1f} s on {card}")
    key = f"13 sweep ({SW_BUCKETS} x {s_max} x {SW_NTS}, f32)"
    k1 = {key: k1_sweep}
    k2 = {f"13 sweep gains (matfree DRE, {SW_BUCKETS} buckets)": k2_dre,
          f"13 sweep NS chain ({SW_BUCKETS} buckets)": k2_chain}
    return k1, k2, k1_rec, k2_abs


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
    from optconpy_tpu_torch.solvers.saddle import SaddleShiftedInverseCache

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
    (_, ks32), t_first = sync_time(lambda: dre(sys32, cache32, ALPHA))
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
    for name, (calls, us) in sorted(rows.items(), key=lambda r: -r[1][1]):
        log(f"      {calls / NTS:6.3f} x {us / calls:9.2f} us "
            f"{us / 1e3 / (wall * 1e3):6.1%}  {name[:110]}")

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

    del fused64, fused32, conv, conv64

    # --- 7. SpMM kernel vs plain on the config-3 pencil -----------------
    t0 = time.perf_counter()
    c3_ops, c3_sys64, c3_cond = cylinder_setup(
        re=C3_RE, refinement=C3_REFINEMENT, device=dev, dtype=f64
    )
    t_setup3 = time.perf_counter() - t0
    t0 = time.perf_counter()
    c3_sched = dre_shift_schedule_dae(
        c3_ops["A"], c3_ops["M"], c3_ops["J"], C3_DT,
        num_shifts=C3_SHIFTS, n_adi=C3_ADI,
    )
    log(f"[7] config-3 setup {t_setup3:.1f} s (numpy element matrices; "
        f"{EARLIER_SETUP_S['config 3']} s with the native element library): "
        f"n={c3_sys64.n} "
        f"n_p={c3_sys64.n_p} m={c3_sys64.m_in}, steady residual "
        f"{c3_ops['steady_info']['residual']:.2e}; shifts (ARPACK interval) "
        f"{time.perf_counter() - t0:.1f} s: {np.round(c3_sched[0], 2).tolist()}")
    spmm_head, spmm_err = spmm_phase(c3_ops, dev)

    # --- 8. NS stack at the bench shape ---------------------------------
    bench_ns_phase(sys32, cache64, ks64, sig, sseq, iseq)

    # --- 11 (a). the matrix-free tier at the bench shape ------------------
    t0 = time.perf_counter()
    k2_paths = matfree_bench_phase(np_ops, cond, sys64, cache64,
                                   (sig, sseq, iseq), dev)
    t11 += time.perf_counter() - t0
    del cache64, sys32

    # --- 12. receding-horizon MPC ---------------------------------------
    t12 = time.perf_counter()
    k1_rh, k2_rh, k2_rh_err = receding_phase(np_ops, cond, sys64, dev)
    spmm_err = max(spmm_err, k2_rh_err)
    del sys64
    torch.cuda.empty_cache()
    receding_lu_phase(dev)
    t12 = time.perf_counter() - t12
    log(f"[12] phase 12 wall {t12:.1f} s")

    # --- 9. config 3 ----------------------------------------------------
    spmm_launches, c3_ks64 = config3_phase(c3_ops, c3_sys64, c3_sched)

    # --- 11 (b). config 3 on the matrix-free tier -----------------------
    t0 = time.perf_counter()
    k1_paths, k2_b = matfree_config3_phase(c3_ops, c3_cond, c3_sys64,
                                           c3_sched, c3_ks64, dev)
    k2_paths.update(k2_b)
    t11 += time.perf_counter() - t0

    # --- 10. the driver ---------------------------------------------------
    rng = np.random.default_rng(SEED)
    driver_launches, k2_paths["11c cavity driver matfree (f64)"], t_c = (
        driver_phase(vbar[None] + 1e-3 * rng.standard_normal((S_BATCH, n)),
                     dev)
    )
    k2_paths["11d QuadConvKernel call (bench, f32)"] = quad_launches
    k1_paths.update(k1_rh)
    k2_paths.update(k2_rh)
    log(f"[11] phase 11 wall {t11 + t_c:.1f} s ((a), (b) and (d) "
        f"{t11:.1f} s, (c) {t_c:.1f} s)")

    # --- 13. the config-5 parameter sweep -------------------------------
    k1_sw, k2_sw, k1_sweep, k2_sw_err = sweep_phase(dev, card)
    k1_paths.update(k1_sw)
    k2_paths.update(k2_sw)
    kernel_err = max(kernel_err, k1_sweep.pop("max_abs_err"))
    spmm_err = max(spmm_err, k2_sw_err)

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
            "sweep": k1_sweep,
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
    ]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    sys.exit(main())
