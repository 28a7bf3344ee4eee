"""Convection N(v)v on tensors — gather / contraction / slot-sum, no
assembly.

Counterpart of optconpy_tpu/fem/device_conv.py. The geometry is baked
into the per-element tensor T0 at setup (fem/taylor_hood.py
convection_tensor); each evaluation is a static gather, a per-element
contraction and a deterministic slot gather-sum into the scalar dofs.

ConvKernel is the plain torch path in any dtype; it also forms the dense
linearized convection L1(v) and L2(v) for re-linearization
(linearized_parts, linearized_dense), summed in a fixed order.
FusedConvKernel routes every free-dof evaluation through the wrapper of the CUDA kernel
(ops/conv_kernel.py), over its patch plan: float32 on CUDA, ConvKernel's
plain slot sums on the CPU. On CUDA it refuses full-dof evaluations.
QuadConvKernel computes the same quadrature as four products of sparse
interpolation matrices through the SpMM kernel (ops/spmm_kernel.py).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import cached_property

import numpy as np
import torch

from ..ops import conv_kernel
from ..ops.spmm_kernel import pack_spmm, sort_rows_by_window, spmm


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
        return self.conv_inner_batch_t(v_batch.T).T

    def conv_inner_batch_t(self, v_t: torch.Tensor) -> torch.Tensor:
        """Batch-last N(v)v on free dofs: (n_free, B) -> (n_free, B)."""
        return conv_kernel.conv_inner_batch_plain(
            v_t, self.t0, self.tri_dofs, self.scatter_slots, self.free,
            self.dir_values, self.ns,
        )

    @cached_property
    def _pair_slots(self):
        """The scalar (row, col) pairs of the element couplings and, for
        each pair, the flat (element*36 + i*6 + k) entries summing into
        it, padded with nt*36 (contributes zero): (rows, cols, slots) on
        the device, built on the host once."""
        tri = self.tri_dofs.cpu().numpy()
        nt = tri.shape[0]
        keys = (tri[:, :, None] * self.ns + tri[:, None, :]).reshape(-1)
        order = np.argsort(keys, kind="stable")
        uniq, start, counts = np.unique(
            keys[order], return_index=True, return_counts=True
        )
        slots = np.full((uniq.shape[0], int(counts.max())), nt * 36,
                        dtype=np.int64)
        rank = np.arange(keys.shape[0]) - np.repeat(start, counts)
        slots[np.repeat(np.arange(uniq.shape[0]), counts), rank] = order
        dev = self.t0.device
        return (torch.as_tensor(uniq // self.ns).to(dev),
                torch.as_tensor(uniq % self.ns).to(dev),
                torch.as_tensor(slots).to(dev))

    def linearized_parts(self, v_full: torch.Tensor,
                         include_l2: bool = True):
        """Dense linearized convection (L1(v), L2(v)) on FULL dofs, each
        (2ns, 2ns): L1 u = (v.grad)u (component-diagonal), L2 u =
        (u.grad)v (component-coupling), as fem.taylor_hood's
        convection_matrices assembles them on the host; L2 is None
        without include_l2. Restrict to free dofs with mat[free][:, free]
        at the call site.

        Each coupling's element contributions are gathered through a
        padded slot table and summed in a fixed order (no atomic
        scatter), so the result repeats bit for bit on every device."""
        ns = self.ns
        rows, cols, slots = self._pair_slots
        v_loc = v_full.reshape(2, ns)[:, self.tri_dofs].permute(1, 2, 0)

        def pair_sums(loc):  # (nt, 6, 6) -> (n_pairs,)
            flat = torch.cat([loc.reshape(-1), loc.new_zeros(1)])
            return flat[slots].sum(dim=1)

        # L1[(i,a),(k,a)] = sum_{j,b} T0[e,i,j,k,b] v_loc[e,j,b]
        l1_pairs = pair_sums(torch.einsum("eijkb,ejb->eik", self.t0, v_loc))
        l1 = v_full.new_zeros((2 * ns, 2 * ns))
        for a in range(2):
            l1[rows + a * ns, cols + a * ns] = l1_pairs
        if not include_l2:
            return l1, None
        # L2[(i,a),(j,b)] = sum_k T0[e,i,j,k,b] v_loc[e,k,a]
        l2_loc = torch.einsum("eijkb,eka->eijab", self.t0, v_loc)
        l2 = torch.zeros_like(l1)
        for a in range(2):
            for b in range(2):
                l2[rows + a * ns, cols + b * ns] = pair_sums(l2_loc[..., a, b])
        return l1, l2

    def linearized_dense(self, v_full: torch.Tensor,
                         include_l2: bool = True) -> torch.Tensor:
        """L1(v) + L2(v), or L1(v) without include_l2, on FULL dofs
        (linearized_parts)."""
        l1, l2 = self.linearized_parts(v_full, include_l2)
        return l1 if l2 is None else l1.add_(l2)

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
    """ConvKernel whose free-dof evaluations (one vector or a batch) go
    through the CUDA kernel wrapper (ops/conv_kernel.py): the kernel over
    a patch plan built from the maps on CUDA, which takes float32 only,
    and ConvKernel's plain slot sums on the CPU. A caller that wants f64
    or full-dof N(v)v on CUDA builds a ConvKernel."""

    plan: conv_kernel.ConvPlan = field(default=None, compare=False)

    def __post_init__(self):
        if self.t0.is_cuda and self.t0.dtype != torch.float32:
            raise TypeError(
                f"FusedConvKernel on CUDA takes float32, got {self.t0.dtype}"
            )
        if self.plan is None:
            object.__setattr__(self, "plan", conv_kernel.ConvPlan.build(
                self.tri_dofs.cpu(), self.free.cpu(), self.dir_values.cpu(),
                self.ns, device=self.t0.device, dtype=self.t0.dtype,
            ))

    @classmethod
    def build(cls, ops: dict, cond, *, device, dtype=torch.float32):
        # Refuse before anything is copied to the card.
        if torch.device(device).type == "cuda" and dtype != torch.float32:
            raise TypeError(f"FusedConvKernel on CUDA takes float32, got {dtype}")
        return super().build(ops, cond, device=device, dtype=dtype)

    def conv_full_batch(self, v_full_t: torch.Tensor) -> torch.Tensor:
        # The kernel's contract is free dofs in and out; a full-dof
        # evaluation on the card would quietly take the plain path.
        if v_full_t.is_cuda:
            raise ValueError(
                "FusedConvKernel evaluates free dofs only on CUDA "
                "(conv_inner, conv_inner_batch); build a ConvKernel for "
                "full-dof N(v)v"
            )
        return super().conv_full_batch(v_full_t)

    def conv_inner(self, v_inner: torch.Tensor) -> torch.Tensor:
        return self.conv_inner_batch_t(v_inner[:, None].contiguous())[:, 0]

    def conv_inner_batch(self, v_batch: torch.Tensor) -> torch.Tensor:
        return self.conv_inner_batch_t(v_batch.T.contiguous()).T

    def conv_inner_batch_t(self, v_t: torch.Tensor) -> torch.Tensor:
        return conv_kernel.conv_inner(v_t, self)


@dataclass(frozen=True)
class QuadConvKernel:
    """Quadrature-interpolation convection: N(v)v as four SpMMs.

    The interpolation matrices are built on the host with the degree-5
    rule of the assembly:
        P, Gx, Gy: (NQ, ns) values and x-/y-derivatives of the P2 basis
            at every quadrature point of every element (6 nnz a row);
        PwT = P^T diag(2 A_e w_q): (ns, NQ) the weighted scatter;
        out_a = PwT @ [(P vx) (Gx v_a) + (P vy) (Gy v_a)].
    Both velocity components ride one product each as column blocks, so
    it matches ConvKernel to roundoff. Quadrature rows are sorted by
    their first column (ops/spmm_kernel.sort_rows_by_window), which
    narrows the column union of each row group. Same conv_full /
    conv_inner / conv_*_batch contract as ConvKernel, plus the batch-last
    conv_inner_batch_t; every evaluation launches the SpMM kernel four
    times on CUDA (its plain version on the CPU).
    """

    p_pack: object  # SpmmPack (NQ, ns)
    gx_pack: object
    gy_pack: object
    pwt_pack: object  # SpmmPack (ns, NQ)
    free: torch.Tensor
    dir_values: torch.Tensor
    ns: int
    n_free: int

    @classmethod
    def build(cls, ops: dict, cond, *, device, dtype=torch.float64):
        import scipy.sparse as sp

        from .taylor_hood import _QL, _QW, _p2_dlam, _p2_values

        space = ops["space"]
        ns = space.n_scalar
        nt = space.mesh.nt
        nq = _QL.shape[0]
        phi = _p2_values(_QL)  # (nq, 6)
        # gq[e, q, i, d] = dphi[q, i, l] glam[e, l, d]
        gq = np.einsum("qil,eld->eqid", _p2_dlam(_QL), space.grad_lam)
        rows = np.repeat(np.arange(nt * nq), 6)
        cols = np.broadcast_to(space.tri_dofs[:, None, :], (nt, nq, 6))
        cols = cols.reshape(-1)

        def interp(vals):
            m = sp.coo_matrix((vals.reshape(-1), (rows, cols)),
                              shape=(nt * nq, ns))
            m.sum_duplicates()
            return m.tocsr()

        p_sp = interp(np.broadcast_to(phi[None], (nt, nq, 6)))
        gx_sp = interp(gq[..., 0])
        gy_sp = interp(gq[..., 1])
        wq = (2.0 * space.area[:, None] * (0.5 * _QW)[None]).reshape(-1)
        qperm = sort_rows_by_window(p_sp)
        p_sp, gx_sp, gy_sp = (a[qperm].tocsr() for a in (p_sp, gx_sp, gy_sp))
        pwt_sp = (sp.diags(wq[qperm]) @ p_sp).T.tocsr()
        dir_values = np.zeros(2 * ns)
        dir_values[cond.dirichlet] = cond.g

        def pack(a):
            return pack_spmm(a, device=device, dtype=dtype)

        return cls(
            p_pack=pack(p_sp), gx_pack=pack(gx_sp), gy_pack=pack(gy_sp),
            pwt_pack=pack(pwt_sp),
            free=torch.as_tensor(np.asarray(cond.free, np.int64)).to(device),
            dir_values=torch.as_tensor(dir_values).to(device=device,
                                                     dtype=dtype),
            ns=ns, n_free=len(cond.free),
        )

    def expand(self, v_inner: torch.Tensor) -> torch.Tensor:
        """Lift inner (free-dof) velocity to the full dof vector."""
        out = self.dir_values.clone()
        out[self.free] = v_inner
        return out

    def conv_full_batch(self, v_full_t: torch.Tensor) -> torch.Tensor:
        """Batch-last N(v)v: (2ns, B) -> (2ns, B) weak-form vectors."""
        ns = self.ns
        b = v_full_t.shape[1]
        u = torch.cat([v_full_t[:ns], v_full_t[ns:]], dim=1)  # (ns, 2B)
        pq = spmm(self.p_pack, u)  # values at the quadrature points
        gxq = spmm(self.gx_pack, u)
        gyq = spmm(self.gy_pack, u)
        vxq, vyq = pq[:, :b], pq[:, b:]
        rx = vxq * gxq[:, :b] + vyq * gyq[:, :b]
        ry = vxq * gxq[:, b:] + vyq * gyq[:, b:]
        out = spmm(self.pwt_pack, torch.cat([rx, ry], dim=1))
        return torch.cat([out[:, :b], out[:, b:]], dim=0)

    def conv_full(self, v_full: torch.Tensor) -> torch.Tensor:
        return self.conv_full_batch(v_full[:, None])[:, 0]

    def conv_inner(self, v_inner: torch.Tensor) -> torch.Tensor:
        return self.conv_full(self.expand(v_inner))[self.free]

    def conv_inner_batch(self, v_batch: torch.Tensor) -> torch.Tensor:
        """Batched N(v)v on free dofs: (B, n_free) -> (B, n_free)."""
        return self.conv_inner_batch_t(v_batch.T).T

    def conv_inner_batch_t(self, v_t: torch.Tensor) -> torch.Tensor:
        """Batch-last N(v)v on free dofs: (n_free, B) -> (n_free, B)."""
        v_full_t = self.dir_values[:, None].repeat(1, v_t.shape[1])
        v_full_t[self.free] = v_t
        return self.conv_full_batch(v_full_t)[self.free]

    def to(self, device=None, dtype=None) -> "QuadConvKernel":
        return QuadConvKernel(
            self.p_pack.to(device, dtype), self.gx_pack.to(device, dtype),
            self.gy_pack.to(device, dtype), self.pwt_pack.to(device, dtype),
            self.free.to(device),
            self.dir_values.to(device=device, dtype=dtype),
            self.ns, self.n_free,
        )
