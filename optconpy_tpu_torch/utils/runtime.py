"""Runtime precision policy and NaN sanitizer for the port.

TF32 keeps a 10-bit mantissa, about three decimal digits: the f32 gains
must stay within 1e-4 of the f64 gains and the closed-loop outputs
within 1e-4 of the f64 run of the same recurrence, so every float32
matmul and convolution runs in strict FP32 until a faster tier passes
those checks during the run. `matmul_precision` sets a faster tier for
one block only, for a measurement that runs its own f64 check
(scripts/bench_precision.py), and restores strict FP32 on the way out.

The sanitizer (`setup(debug_nans=True)`, or OPTCONPY_DEBUG_NANS) makes a
NaN raise FloatingPointError at the op that produced it: a dispatch mode
checks every floating output of every op (a device sync each; never for
timing), and the CUDA kernel wrappers, which bypass dispatch, check
their own outputs while it is on.
"""
from __future__ import annotations

import functools
import os
from contextlib import contextmanager

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

# Precisions setup() accepts: 'highest' is strict FP32; None means
# "follow the run's precision" (SolverConfig.rollout_matmul_precision).
# Torch's 'high' and 'medium' are TF32 and bf16 tiers, which the policy
# above forbids without an in-run f64 check.
ACCEPTED_PRECISIONS = ("highest", None)

# The tiers of matmul_precision, under the reference's names, and what
# each one runs on this package's devices.
TIERS = {
    "highest": "strict FP32 GEMMs",
    "high": "TF32 GEMMs (torch float32_matmul_precision 'high')",
    "default": "bf16-rounded operands, products accumulated in FP32 by "
               "strict FP32 GEMMs (1-pass bf16 numerics, emulated)",
}


def _strict_fp32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def setup(matmul_precision: str | None = "highest",
          debug_nans: bool | None = None) -> None:
    """Strict FP32: no TF32 in matmuls or cuDNN (idempotent). Raises
    ValueError for any precision other than 'highest' or None.

    debug_nans: the sanitizer mode (module docstring) on the calling
    thread; when None, OPTCONPY_DEBUG_NANS ('1', 'true' or 'yes')
    decides. Off, NaNs flow through unchecked.
    """
    if matmul_precision not in ACCEPTED_PRECISIONS:
        raise ValueError(
            f"matmul precision {matmul_precision!r} is not accepted: this "
            f"package runs strict FP32 ('highest'); torch's 'high' is TF32, "
            f"which needs an in-run f64 check first"
        )
    _strict_fp32()
    if debug_nans is None:
        debug_nans = os.environ.get(
            "OPTCONPY_DEBUG_NANS", ""
        ).lower() in ("1", "true", "yes")
    _set_debug_nans(bool(debug_nans))


# --- the precision context -----------------------------------------------

_BF16_OPERANDS = {
    torch.mm: (0, 1), torch.Tensor.mm: (0, 1),
    torch.matmul: (0, 1), torch.Tensor.matmul: (0, 1),
    torch.Tensor.__matmul__: (0, 1), torch.Tensor.__rmatmul__: (0, 1),
    torch.bmm: (0, 1), torch.Tensor.bmm: (0, 1),
    torch.addmm: (1, 2), torch.Tensor.addmm: (1, 2),
    torch.Tensor.addmm_: (1, 2),
    torch.baddbmm: (1, 2), torch.Tensor.baddbmm: (1, 2),
    torch.Tensor.baddbmm_: (1, 2),
}


def _bf16_rounded(x):
    if isinstance(x, torch.Tensor) and x.dtype == torch.float32:
        return x.to(torch.bfloat16).to(torch.float32)
    return x


class _Bf16Operands(TorchFunctionMode):
    """Rounds the float32 factors of every matrix product to bf16 before
    the (strict FP32) product: a product of two bf16 numbers is exact in
    FP32, so this gives 1-pass bf16 numerics with FP32 accumulation. The
    bias of addmm/baddbmm and the CUDA kernels are untouched."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        which = _BF16_OPERANDS.get(func)
        if which is not None:
            args = tuple(_bf16_rounded(a) if i in which else a
                         for i, a in enumerate(args))
        return func(*args, **kwargs)


@contextmanager
def matmul_precision(tier: str):
    """Run the block with float32 matrix products in `tier` (TIERS):
    'highest' strict FP32, 'high' TF32, 'default' bf16-rounded operands
    (a TorchFunctionMode on this thread, over mm/addmm/bmm/matmul).
    Strict FP32 is restored on exit, also when the block raises. Use it
    only where the same run checks the result against f64; setup()
    still refuses every tier but 'highest'."""
    if tier not in TIERS:
        raise ValueError(f"unknown matmul precision tier {tier!r}; one of "
                         f"{sorted(TIERS)}")
    try:
        if tier == "high":
            torch.set_float32_matmul_precision("high")
        else:
            _strict_fp32()
        if tier == "default":
            with _Bf16Operands():
                yield TIERS[tier]
        else:
            yield TIERS[tier]
    finally:
        _strict_fp32()


# --- the NaN sanitizer -------------------------------------------------------

# Ops whose output is uninitialized memory, not a computed value.
_UNINITIALIZED = {
    "aten::empty", "aten::empty_like", "aten::empty_strided",
    "aten::new_empty", "aten::new_empty_strided", "aten::resize_",
}


def check_nan(name: str, out) -> None:
    """Raise FloatingPointError when a floating tensor in `out` holds a
    NaN (the sanitizer's test; a device sync)."""
    outs = out if isinstance(out, (tuple, list)) else (out,)
    for t in outs:
        if (isinstance(t, torch.Tensor) and t.is_floating_point()
                and t.numel() and bool(torch.isnan(t).any())):
            raise FloatingPointError(f"NaN produced by {name}")


class _NanCheck(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func._schema.name
        if name not in _UNINITIALIZED:
            check_nan(name, out)
        return out


_nan_mode: _NanCheck | None = None


def _set_debug_nans(on: bool) -> None:
    global _nan_mode
    if on and _nan_mode is None:
        _nan_mode = _NanCheck()
        _nan_mode.__enter__()
    elif not on and _nan_mode is not None:
        mode, _nan_mode = _nan_mode, None
        mode.__exit__(None, None, None)


def debug_nans() -> bool:
    """Whether the sanitizer mode is on (setup(debug_nans=))."""
    return _nan_mode is not None


def in_sanitizer(fn):
    """fn for another thread: dispatch modes are per thread, so while
    the sanitizer is on the returned function runs fn under a mode of its
    own thread (the receding loop's stepper refresh uses it)."""
    if not debug_nans():
        return fn

    @functools.wraps(fn)
    def checked(*args, **kwargs):
        with _NanCheck():
            return fn(*args, **kwargs)

    return checked
