"""Convection N(v)v on tensors — gather / contraction / slot-sum, no
assembly.

Counterpart of optconpy_tpu/fem/device_conv.py. The geometry is baked
into the per-element tensor T0 at setup (fem/taylor_hood.py
convection_tensor); each evaluation is a static gather, a per-element
contraction and a deterministic slot gather-sum into the scalar dofs.

ConvKernel is the plain torch path in any dtype. FusedConvKernel routes
the batched evaluation through the wrapper of the CUDA kernel
(ops/conv_kernel.py): float32 on CUDA, the plain path on the CPU.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops import conv_kernel


def _host_arrays(ops: dict, cond) -> dict:
    """Host (numpy) build of every ConvKernel array."""
    from .taylor_hood import convection_tensor

    space = ops["space"]
    ns = space.n_scalar
    dir_values = np.zeros(2 * ns)
    dir_values[cond.dirichlet] = cond.g
    # Invert the scatter map: scalar dof -> flat (e, localnode) slots,
    # padded with the sentinel nt*6 (contributes zero).
    flat = np.asarray(space.tri_dofs, np.int64).reshape(-1)
    nt6 = flat.shape[0]
    counts = np.bincount(flat, minlength=ns)
    k_s = max(int(counts.max()), 1)
    slots = np.full((ns, k_s), nt6, dtype=np.int64)
    order = np.argsort(flat, kind="stable")
    sorted_dofs = flat[order]
    group_start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.arange(nt6) - group_start[sorted_dofs]
    slots[sorted_dofs, rank] = order
    return {
        "t0": convection_tensor(ops),
        "tri_dofs": np.asarray(space.tri_dofs, np.int64),
        "free": np.asarray(cond.free, np.int64),
        "dir_values": dir_values,
        "scatter_slots": slots,
    }


@dataclass(frozen=True)
class ConvKernel:
    """Convection evaluator with BC bookkeeping.

    t0: (nt, 6, 6, 6, 2) per-element tensor;
    tri_dofs: (nt, 6) int64 scalar P2 dofs;
    free: (n_free,) int64 indices of free dofs in the FULL velocity vector;
    dir_values: (2*ns,) Dirichlet values at constrained dofs, 0 at free;
    scatter_slots: (ns, k_s) int64 flat (element*6 + localnode) slots
        accumulating into each scalar dof, padded with nt*6.
    """

    t0: torch.Tensor
    tri_dofs: torch.Tensor
    free: torch.Tensor
    dir_values: torch.Tensor
    scatter_slots: torch.Tensor
    ns: int
    n_free: int

    @classmethod
    def from_arrays(cls, arrays: dict, *, device, dtype=None):
        """Build from host arrays keyed by field name (t0, tri_dofs,
        free, dir_values, scatter_slots); dtype casts the float fields."""
        def idx(a):
            return torch.tensor(np.asarray(a, np.int64)).to(device)

        def val(a):
            return torch.tensor(np.asarray(a)).to(device=device, dtype=dtype)

        dir_values = np.asarray(arrays["dir_values"])
        return cls(
            t0=val(arrays["t0"]),
            tri_dofs=idx(arrays["tri_dofs"]),
            free=idx(arrays["free"]),
            dir_values=val(dir_values),
            scatter_slots=idx(arrays["scatter_slots"]),
            ns=dir_values.shape[0] // 2,
            n_free=int(np.asarray(arrays["free"]).shape[0]),
        )

    @classmethod
    def build(cls, ops: dict, cond, *, device, dtype=torch.float64):
        return cls.from_arrays(
            _host_arrays(ops, cond), device=device, dtype=dtype
        )

    def expand(self, v_inner: torch.Tensor) -> torch.Tensor:
        """Lift inner (free-dof) velocity to the full dof vector."""
        out = self.dir_values.clone()
        out[self.free] = v_inner
        return out

    def conv_full(self, v_full: torch.Tensor) -> torch.Tensor:
        """N(v)v on the full dof set: (2ns,) -> (2ns,) weak-form vector;
        the batched evaluation at B=1."""
        return self.conv_full_batch(v_full[:, None])[:, 0]

    def conv_inner(self, v_inner: torch.Tensor) -> torch.Tensor:
        """N(v)v restricted to free dofs, BC values included in v."""
        return self.conv_full(self.expand(v_inner))[self.free]

    def conv_full_batch(self, v_full_t: torch.Tensor) -> torch.Tensor:
        """Batch-last N(v)v: (2ns, B) -> (2ns, B), plain torch."""
        return conv_kernel.conv_full_batch_plain(
            v_full_t, self.t0, self.tri_dofs, self.scatter_slots, self.ns
        )

    def conv_inner_batch(self, v_batch: torch.Tensor) -> torch.Tensor:
        """Batched N(v)v on free dofs: (B, n_free) -> (B, n_free)."""
        b = v_batch.shape[0]
        v_full_t = self.dir_values[:, None].repeat(1, b)
        v_full_t[self.free] = v_batch.T
        return self.conv_full_batch(v_full_t)[self.free].T

    def to(self, device=None, dtype=None):
        return type(self)(
            self.t0.to(device=device, dtype=dtype),
            self.tri_dofs.to(device),
            self.free.to(device),
            self.dir_values.to(device=device, dtype=dtype),
            self.scatter_slots.to(device),
            self.ns,
            self.n_free,
        )


@dataclass(frozen=True)
class FusedConvKernel(ConvKernel):
    """ConvKernel whose evaluations go through the CUDA kernel wrapper
    (ops/conv_kernel.py): the kernel on CUDA, which takes float32 only,
    and the plain version on the CPU. A caller that wants f64 on CUDA
    builds a ConvKernel."""

    def __post_init__(self):
        if self.t0.is_cuda and self.t0.dtype != torch.float32:
            raise TypeError(
                f"FusedConvKernel on CUDA takes float32, got {self.t0.dtype}"
            )

    @classmethod
    def build(cls, ops: dict, cond, *, device, dtype=torch.float32):
        # Refuse before anything is copied to the card.
        if torch.device(device).type == "cuda" and dtype != torch.float32:
            raise TypeError(f"FusedConvKernel on CUDA takes float32, got {dtype}")
        return super().build(ops, cond, device=device, dtype=dtype)

    def conv_full_batch(self, v_full_t: torch.Tensor) -> torch.Tensor:
        return conv_kernel.conv_full_batch(
            v_full_t, self.t0, self.tri_dofs, self.scatter_slots, self.ns
        )
