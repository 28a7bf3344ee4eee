"""The yardstick of the kernels' rooflines: the published peaks of one
NVIDIA H100 SXM (NVIDIA's data sheet, dense, 700 W) and each kernel's
operations and bytes from its shapes.

The convection kernel K1's count is a frozen copy of chip_smoke.py's
phase-3 arithmetic (`bound_ms` and its call) at commit
3a68254c7aaa53570d941aa3f88a196ecc19d430: 1008 operations per element
and scenario, the velocity in and the result out once each (4 bytes,
n x B), and the element tensor once (432 float32 values per element).
The kernel's own index tables are its implementation's, not the
algorithm's, and are not counted.
"""
from __future__ import annotations

HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}  # outside the tensor cores


def bound_s(nbytes: float, flops: float, dtype: str = "float32"):
    """The least time for the work on the card, and what sets it."""
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def k1_work(n: int, nt: int, b: int) -> tuple[float, float]:
    """(bytes, operations) of one convection call: n free velocity dofs,
    nt elements, b scenarios, float32."""
    return 4.0 * (2 * n * b + nt * 432), 1008.0 * nt * b
