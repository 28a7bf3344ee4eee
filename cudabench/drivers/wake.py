"""The program's set-up of a closed-loop cylinder cell, and the check of
its outputs against the plain reference.

Set-up, as a user of the port runs it (each stage on the harness clock):
`models.cylinder.cylinder_setup` (host FEM and steady state), the
convection kernel's plan, `riccati.dre_shift_schedule_dae`, the gain
tier's shifted-saddle cache (`build_dre_cache_dae_ns` on the card, or the
host `lu` cache for the CPU tests), `dre_backward_sweep` and its t=0 gain
broadcast over the steps, and `mpc.build_nse_fused`.
"""
from __future__ import annotations

import time
from contextlib import contextmanager

import numpy as np

import harness


def _tf32(x):
    """x rounded to TF32 (a 10-bit mantissa), to nearest even."""
    import torch

    if not (isinstance(x, torch.Tensor) and x.dtype == torch.float32):
        return x
    i = x.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & -8192
    return i.view(torch.float32).view(x.shape)


def _tf32_products():
    """A torch function mode that rounds the float32 factors of every
    matrix product to TF32, so that products cuBLAS keeps on the FP32
    units (matrix-vector products, B=1) get TF32 numerics too; the
    accumulation stays FP32, as on TF32 tensor cores."""
    import torch
    from torch.overrides import TorchFunctionMode

    factors = {
        torch.mm: (0, 1), torch.Tensor.mm: (0, 1), torch.matmul: (0, 1),
        torch.Tensor.matmul: (0, 1), torch.Tensor.__matmul__: (0, 1),
        torch.Tensor.__rmatmul__: (0, 1), torch.bmm: (0, 1),
        torch.Tensor.bmm: (0, 1), torch.addmm: (1, 2),
        torch.Tensor.addmm: (1, 2), torch.Tensor.addmm_: (1, 2),
        torch.baddbmm: (1, 2), torch.Tensor.baddbmm: (1, 2),
        torch.Tensor.baddbmm_: (1, 2),
    }

    class Tf32Products(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            which = factors.get(func)
            if which is not None:
                args = tuple(_tf32(a) if i in which else a
                             for i, a in enumerate(args))
            return func(*args, **(kwargs or {}))

    return Tf32Products()


@contextmanager
def program_context(precision: str):
    """Strict FP32 for the program ('highest'), or the control ('tf32'):
    TF32, the nearest precision below the configuration's 'float32, TF32
    off', on every float32 matrix product: the program's own TF32 tier
    (utils.matmul_precision('high')) and, for the products it leaves on
    the FP32 units, factors rounded to TF32. The hand-written kernels K1
    and K2 are untouched."""
    from optconpy_tpu_torch import utils
    from optconpy_tpu_torch.utils.runtime import matmul_precision

    utils.setup()
    if precision == "highest":
        yield
        return
    if precision != "tf32":
        raise ValueError(f"unknown precision {precision!r}")
    with matmul_precision("high"), _tf32_products():
        yield


class Wake:
    """The program's objects of one closed-loop cell."""

    def __init__(self, cfg: dict, mix: dict, dev, precision: str = "highest"):
        import torch

        from optconpy_tpu_torch.fem.device_conv import FusedConvKernel
        from optconpy_tpu_torch.models.cylinder import cylinder_setup
        from optconpy_tpu_torch.mpc import build_nse_fused
        from optconpy_tpu_torch.riccati import (
            build_dre_cache_dae,
            build_dre_cache_dae_ns,
            dre_backward_sweep,
            dre_shift_schedule_dae,
        )

        self.cfg, self.mix, self.dev = cfg, mix, dev
        self.ctx = lambda: program_context(precision)
        g = cfg["gains"]
        f32, f64 = torch.float32, torch.float64
        self.timings = {}
        clock = time.perf_counter

        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        with self.ctx():
            t = clock()
            np_ops, sys64, cond = cylinder_setup(
                re=cfg["re"], refinement=cfg["refinement"], device=dev,
                dtype=f64)
            self.timings["host_fem_s"] = clock() - t
            self.sys = sys64.to(dtype=f32)
            del sys64
            n, m = self.sys.b.shape
            t = clock()
            self.conv = FusedConvKernel.build(np_ops["full"], cond, device=dev)
            self.timings["conv_plan_s"] = clock() - t
            got = dict(n=n, n_p=self.sys.n_p, m=m, p=self.sys.p_out,
                       nt=self.conv.tri_dofs.shape[0])
            want = {k: cfg[k] for k in got if k in cfg}
            if any(got[k] != v for k, v in want.items()):
                raise RuntimeError(f"sizes {got} differ from the "
                                   f"configuration's {want}")
            t = clock()
            interval = cfg.get("assumed", {}).get("shift_interval")
            sig, sseq, iseq = dre_shift_schedule_dae(
                np_ops["A"], np_ops["M"], np_ops["J"], cfg["dt"],
                num_shifts=g["num_shifts"], n_adi=g["n_adi"],
                interval=tuple(interval) if interval else None)
            self.timings["shifts_s"] = clock() - t
            t = clock()
            if mix["gain_tier"] == "inverse_ns":
                cache, _ = build_dre_cache_dae_ns(self.sys, cfg["dt"], sig)
            else:
                cache = build_dre_cache_dae(self.sys, cfg["dt"], sig,
                                            solver=mix["gain_tier"])
            sync()
            self.timings["gain_cache_s"] = clock() - t
            t = clock()
            _, ks = dre_backward_sweep(
                self.sys, cache, cfg["alpha"], cfg["dt"], g["nts"], sseq,
                iseq, n_newton=g["n_newton"], r_max=g["r_max"],
                compress_rtol=g["compress_rtol"])
            self.k0 = ks[0].clone()
            del cache, ks
            sync()
            self.timings["dre_s"] = clock() - t
            t = clock()
            self.fused = build_nse_fused(np_ops, cond, cfg["dt"], device=dev,
                                         dtype=f32)
            sync()
            self.timings["fused_build_s"] = clock() - t
        self.vbar = self.fused.vbar.clone()
        self.n, self.m = n, m

    def gains(self, steps: int):
        """The t=0 gain broadcast over `steps` steps, and no feedforward."""
        import torch

        ks = self.k0.expand(steps + 1, self.m, self.n)
        ws = torch.zeros((steps + 1, self.n), dtype=self.k0.dtype,
                         device=self.dev)
        return ks, ws

    def initial_states(self, seed: int, stream: int, count: int):
        """vbar + noise N(0,1), drawn on the device from the seed: the
        same (seed, stream) gives the same states."""
        import torch

        gen = torch.Generator(device=self.dev)
        gen.manual_seed(harness.mixed_seed(seed, stream))
        noise = torch.randn((count, self.n), generator=gen, device=self.dev,
                            dtype=self.vbar.dtype)
        return self.vbar[None] + self.mix["noise"] * noise

    def release(self) -> None:
        """Drop the program's objects before the reference runs."""
        import torch

        for name in ("sys", "conv", "fused"):
            setattr(self, name, None)
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()


_REFERENCE = {}  # one configuration's (problem, gain, loop); calibrate.py reuses it


def reference(cfg: dict, dev):
    """The plain float64 reference's problem, t=0 gain and closed loop."""
    from reference import plain

    key = (cfg["re"], cfg["refinement"], str(dev), repr(cfg["gains"]))
    if key not in _REFERENCE:
        g = cfg["gains"]
        prob = plain.Problem(cfg["re"], cfg["refinement"], dev)
        interval = cfg.get("assumed", {}).get("shift_interval")
        sched = plain.shift_schedule(prob, cfg["dt"], g["num_shifts"],
                                     g["n_adi"], interval)
        k = plain.t0_gain(prob, cfg["alpha"], cfg["dt"], g["nts"], sched,
                          g["n_newton"], g["r_max"], g["compress_rtol"])
        _REFERENCE.clear()
        _REFERENCE[key] = (prob, k, plain.ClosedLoop(prob, cfg["dt"]))
    return _REFERENCE[key]


def check_closed_loop(wake: Wake, k0, v0, ys, us, steps: int) -> dict:
    """The numbers compared: the t=0 gain, and the outputs y and controls u
    of the scenarios v0 (S, n) over `steps` steps (us (S, steps, m); ys
    (S, steps+1, p), or (S, steps, p) without the initial output), each
    as max |program - reference| / max |reference|."""
    from reference import plain

    _, k_ref, loop = reference(wake.cfg, wake.dev)
    ys_ref, us_ref = loop.run(k_ref, v0, steps)
    return {"gain": plain.rel_dev(k0, k_ref),
            "y": plain.rel_dev(ys, ys_ref[:, -ys.shape[1]:]),
            "u": plain.rel_dev(us, us_ref)}


def sample(seed: int, population: int, count: int, salt: int) -> list[int]:
    """`count` distinct indices below `population`, drawn from the seed."""
    rng = np.random.default_rng(harness.mixed_seed(seed, salt))
    count = min(count, population)
    return sorted(int(i) for i in rng.choice(population, count,
                                             replace=False))
