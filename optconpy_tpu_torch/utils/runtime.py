"""Runtime precision policy for the port.

TF32 keeps a 10-bit mantissa, about three decimal digits: the f32 gains
must stay within 1e-4 of the f64 gains and the closed-loop outputs
within 1e-4 of the f64 run of the same recurrence, so every float32
matmul and convolution runs in strict FP32 until a faster tier passes
those checks during the run.
"""
from __future__ import annotations

import torch

# Precisions setup() accepts: 'highest' is strict FP32; None means
# "follow the run's precision" (SolverConfig.rollout_matmul_precision).
# Torch's 'high' and 'medium' are TF32 and bf16 tiers, which the policy
# above forbids without an in-run f64 check.
ACCEPTED_PRECISIONS = ("highest", None)


def setup(matmul_precision: str | None = "highest") -> None:
    """Strict FP32: no TF32 in matmuls or cuDNN (idempotent). Raises
    ValueError for any precision other than 'highest' or None."""
    if matmul_precision not in ACCEPTED_PRECISIONS:
        raise ValueError(
            f"matmul precision {matmul_precision!r} is not accepted: this "
            f"package runs strict FP32 ('highest'); torch's 'high' is TF32, "
            f"which needs an in-run f64 check first"
        )
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
