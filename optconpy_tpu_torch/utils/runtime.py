"""Runtime precision policy for the port.

TF32 keeps a 10-bit mantissa, about three decimal digits: the f32 gains
must stay within 1e-4 of the f64 gains and the closed-loop outputs
within 1e-4 of the f64 run of the same recurrence, so every float32
matmul and convolution runs in strict FP32 until a faster tier passes
those checks during the run.
"""
from __future__ import annotations

import torch


def setup() -> None:
    """Strict FP32: no TF32 in matmuls or cuDNN (idempotent)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
