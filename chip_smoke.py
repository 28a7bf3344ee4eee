#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port's main path on one NVIDIA GPU.

Drives optconpy_tpu_torch (never jax) through the entry points a user
calls, at the bench shape: cylinder wake Re=100, refinement 1 (n=4396),
6 Wachspress shifts, 32 ADI iterations, rank 32, 6 DRE steps, one Newton
step, dt=0.005, alpha=1e-2, 1024 scenarios x 64 closed-loop steps with
the t=0 gain broadcast and no feedforward. Phases:

  1. require a CUDA card; print its name and power limit;
  2. build the convection kernel from optconpy_tpu_torch/csrc/;
  3. kernel vs its plain torch version at B=1024 and B=3 (<= 1e-5), timed;
  4. DRE gains in f32 and f64 on the card from one f64 host stack
     (f32-vs-f64 gain deviation <= 1e-4);
  5. the fused closed loop through the kernel: one launch per step,
     finite outputs, TF32 off, solves/s from warm runs;
  6. in-run f64 check of 2 scenarios on the CPU with the plain versions
     (closed-loop output deviation <= 1e-4).

Every failed check raises, so the exit code is non-zero. The last three
lines are the kernels JSON, the card's name and power limit, and
{"ok": true, "device": {...}}.

Usage: python3 chip_smoke.py
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

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


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


def rel_err(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


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
    from optconpy_tpu_torch.ops import conv_kernel
    from optconpy_tpu_torch.riccati import (
        dre_backward_sweep,
        dre_shift_schedule_dae,
        load_or_build_inverse_stack,
    )
    from optconpy_tpu_torch.solvers.saddle import SaddleShiftedInverseCache

    dev = torch.device("cuda", 0)
    cpu = torch.device("cpu")
    f32, f64 = torch.float32, torch.float64
    card = card_line()
    log(f"[1] card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    utils.setup()

    def sync_time(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def event_ms(fn, reps: int) -> float:
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

    # --- 2. build -------------------------------------------------------
    info = conv_kernel.build()
    log(f"[2] kernel built from optconpy_tpu_torch/csrc/ -> "
        f"{info.path.name} in {info.seconds:.2f} s (nvcc sm_90a)")
    for line in info.log.splitlines():
        if "registers" in line or "spill" in line:
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
    log(f"    setup {time.perf_counter() - t0:.1f} s: n={n} n_p={sys64.n_p} "
        f"m={m} nt={nt} ns={conv.ns} k_s={conv.scatter_slots.shape[1]} "
        f"steady residual {np_ops['steady_info']['residual']:.2e}")

    # --- 3. kernel vs plain ---------------------------------------------
    rng = np.random.default_rng(SEED)
    vbar_full = np_ops["vbar_full"]
    kernel_err, kernel_ms, plain_ms = 0.0, None, None
    for b in (S_BATCH, 3):
        v = torch.as_tensor(
            vbar_full[:, None]
            + 1e-3 * rng.standard_normal((vbar_full.size, b)),
            dtype=f32,
        ).to(dev)
        out = conv.conv_full_batch(v)
        ref = conv_kernel.conv_full_batch_plain(
            v, conv.t0, conv.tri_dofs, conv.scatter_slots, conv.ns
        )
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out).all()), f"kernel output finite B={b}")
        err = rel_err(out, ref)
        abs_err = float((out - ref).abs().max())
        check(err <= KERNEL_TOL, f"kernel vs plain B={b}: {err:.2e}")
        kernel_err = max(kernel_err, abs_err)
        k_ms = event_ms(lambda: conv.conv_full_batch(v), 50)
        p_ms = event_ms(
            lambda: conv_kernel.conv_full_batch_plain(
                v, conv.t0, conv.tri_dofs, conv.scatter_slots, conv.ns
            ),
            50,
        )
        if b == S_BATCH:
            kernel_ms, plain_ms = k_ms, p_ms
        log(f"[3] conv_p2 B={b}: rel err {err:.2e} (abs {abs_err:.2e}, "
            f"tol {KERNEL_TOL:g}); kernel {k_ms * 1e3:.1f} us/call, "
            f"plain {p_ms * 1e3:.1f} us/call")

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
    del cache64, cache32

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
    gemm_ms = event_ms(lambda: v0 @ fused32.pmat.T, 20)
    log(f"    rollout {S_BATCH} x {NTS}: cold {t_cold:.3f} s, warm "
        f"{[round(t, 4) for t in warm]} s -> median "
        f"{S_BATCH * NTS / t_roll:.0f} solves/s "
        f"({t_roll / NTS * 1e3:.3f} ms/step; one ({S_BATCH} x {n}) @ ({n} x {n}) "
        f"f32 GEMM {gemm_ms:.3f} ms, conv_p2 {kernel_ms:.3f} ms); "
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

    log(json.dumps({"kernels": [{
        "name": "conv_p2",
        "route": "cuda",
        "source": "optconpy_tpu_torch/csrc/conv_p2.cu",
        "replaces": "optconpy_tpu/ops/pallas_conv.py:74",
        "launches": main_launches,
        "max_abs_err": kernel_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    sys.exit(main())
