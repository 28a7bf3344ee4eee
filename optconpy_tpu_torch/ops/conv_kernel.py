"""Batched P2 convection N(v)v: the CUDA kernel and its plain version.

`conv_inner` is the wrapper of the hand-written Hopper kernel in
csrc/conv_p2.cu, which replaces the TPU kernel
optconpy_tpu/ops/pallas_conv.py::conv_element_blocks together with the
XLA gather and scatter around it and the inner/full dof bookkeeping of
ConvKernel.conv_inner_batch. On a CPU tensor it runs
`conv_inner_batch_plain`, the same function in plain torch over the slot
maps (independent of the kernel's patch plan); on a CUDA tensor it
launches the kernel or raises.

Contract: v_t (n_free, B) batch-last free-dof velocities -> (n_free, B)
N(v)v at the free dofs, Dirichlet values taken from the plan.

Shared layout (ConvPlan, built on the host by `build_conv_plan`). The
elements are cut into patches of at most PATCH elements that share
dofs; a block of the kernel computes one patch for one tile of columns
and sums its elements' contributions to each of the patch's dofs:
  t0:    (nt, 6, 6, 6, 2) per-element tensor T0[e, i, j, k, c];
  vsrc:  (nt, 12) int32 free row of element e's node j, component c
         (at j * 2 + c), or -1 for a Dirichlet dof;
  vdir:  (nt, 12) its Dirichlet value (0 at free dofs);
  pelem: (n_patches, PATCH) int32 the patch's elements, -1 padded;
  pnd:   (n_patches,) int32 dofs of each patch;
  psptr: (n_patches, nd + 1) int32 where each patch dof's slots start
         in pslot (nd: the most dofs of a patch; rows past pnd empty);
  pslot: (n_patches, PATCH * 6) int16 the patch-local element slots
         el * 6 + i of the patch's dofs, dof after dof, each dof's in
         element order; -1 past the patch's own;
  pdst:  (n_patches, nd, 2) int32 where the patch's sum for (dof,
         component) goes: a free row r >= 0 when every element of the dof
         lies in the patch, -1 for a Dirichlet dof, or -2 - q for row q
         of the partial-sum buffer;
  bdst:  (n_bnd,) int32 free rows of the dofs shared between patches;
  bsrc:  (n_bnd, kp) int32 their partial-sum rows in patch order, -1
         padded.

The kernel is compiled with nvcc for sm_90a at first use, from the
sources in csrc/ into build/ at the repository root (ops/cuda_build.py),
and bound with ctypes.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass, fields

import numpy as np
import torch

from . import cuda_build
from .cuda_build import check_tensor as _check

PATCH = 24  # most elements of a patch (kPatch of csrc/conv_p2.cu)
MAX_GRID_Y = 65535
COLUMNS_PER_BLOCK = 64  # kCols of csrc/conv_p2.cu

# Kernel launches made through `conv_inner` (one per call on CUDA).
launches = 0


def conv_full_batch_plain(v_full_t, t0, tri_dofs, slots, ns: int):
    """Plain torch N(v)v on the full dof set: (2ns, B) -> (2ns, B).
    Gather, einsum, unrolled k-combine, then the slot gather-sum (the
    same steps as optconpy_tpu ConvKernel.conv_full_batch)."""
    nt = tri_dofs.shape[0]
    b = v_full_t.shape[1]
    v2 = v_full_t.reshape(2, ns, b)
    v_loc = v2[:, tri_dofs.reshape(-1)].reshape(2, nt, 6, b)
    out_loc = _element_outputs(t0, v_loc)
    out_flat = torch.cat(
        [out_loc.reshape(2, nt * 6, b), out_loc.new_zeros((2, 1, b))], dim=1
    )
    return out_flat[:, slots].sum(dim=2).reshape(2 * ns, b)


def _element_outputs(t0, v_loc):
    """(2, nt, 6, B) per-element N(v)v from the nodal values v_loc
    (2, nt, 6, B) = [component, element, node, column]."""
    # w[e, i, k, :] = sum_{j, c} T0[e, i, j, k, c] v_loc[c, e, j, :]
    w = torch.einsum("eijkc,cejb->eikb", t0, v_loc)
    # out[a, e, i, :] = sum_k w[e, i, k, :] v_loc[a, e, k, :], unrolled
    # over k so no (2, nt, 6, 6, B) broadcast is materialized.
    out_loc = w[None, :, :, 0, :] * v_loc[:, :, None, 0, :]
    for k in range(1, 6):
        out_loc = out_loc + w[None, :, :, k, :] * v_loc[:, :, None, k, :]
    return out_loc


@dataclass(frozen=True)
class ConvPlan:
    """The kernel's maps (module docstring), on one device."""

    vsrc: torch.Tensor
    vdir: torch.Tensor
    pelem: torch.Tensor
    pnd: torch.Tensor
    psptr: torch.Tensor
    pslot: torch.Tensor
    pdst: torch.Tensor
    bdst: torch.Tensor
    bsrc: torch.Tensor
    n_free: int
    n_part: int  # rows of the partial-sum buffer

    @classmethod
    def build(cls, tri_dofs, free, dir_values, ns: int, *, device, dtype):
        arrays = build_conv_plan(
            np.asarray(tri_dofs), np.asarray(free), np.asarray(dir_values), ns
        )
        return cls(**{
            f.name: (
                torch.as_tensor(arrays[f.name]).to(
                    device, dtype if f.name == "vdir" else None
                )
                if f.type == "torch.Tensor" else int(arrays[f.name])
            )
            for f in fields(cls)
        })


def _patches(tri_dofs: np.ndarray, ns: int) -> list[np.ndarray]:
    """Cut the elements into patches of at most PATCH elements that share
    dofs: breadth-first growth over elements sharing a dof, each patch
    seeded at the first unassigned element in reverse Cuthill-McKee
    order of the element graph."""
    import scipy.sparse as sp
    import scipy.sparse.csgraph as csg

    nt = tri_dofs.shape[0]
    inc = sp.csr_matrix(
        (np.ones(tri_dofs.size), (np.repeat(np.arange(nt), 6),
                                  tri_dofs.reshape(-1))),
        shape=(nt, ns),
    )
    adj = (inc @ inc.T).tocsr()
    order = np.asarray(csg.reverse_cuthill_mckee(adj, symmetric_mode=True))
    done = np.zeros(nt, bool)
    patches = []
    for seed in order:
        if done[seed]:
            continue
        patch, queue = [], [seed]
        done[seed] = True
        while queue and len(patch) < PATCH:
            e = queue.pop(0)
            patch.append(e)
            for f in adj.indices[adj.indptr[e]:adj.indptr[e + 1]]:
                if not done[f] and len(patch) + len(queue) < PATCH:
                    done[f] = True
                    queue.append(f)
        patches.append(np.asarray(patch, np.int64))
    return patches


def build_conv_plan(tri_dofs, free, dir_values, ns: int) -> dict:
    """Host (numpy) build of the kernel's maps (module docstring)."""
    tri_dofs = np.asarray(tri_dofs, np.int64)
    nt = tri_dofs.shape[0]
    fmap = np.full(2 * ns, -1, np.int64)
    fmap[np.asarray(free, np.int64)] = np.arange(len(free))
    full = np.stack([tri_dofs, tri_dofs + ns], axis=2)  # (nt, 6, 2)
    vsrc = fmap[full].reshape(nt, 12)
    vdir = np.where(vsrc < 0, np.asarray(dir_values)[full].reshape(nt, 12), 0.0)
    elems_of = np.bincount(tri_dofs.reshape(-1), minlength=ns)

    patches = _patches(tri_dofs, ns)
    pelem = np.full((len(patches), PATCH), -1, np.int64)
    per_patch = []  # (dofs, slot lists) of each patch
    for p, elems in enumerate(patches):
        pelem[p, :elems.size] = elems
        local = tri_dofs[elems].reshape(-1)  # slot el * 6 + i -> dof
        dofs, first = np.unique(local, return_index=True)
        dofs = dofs[np.argsort(first)]  # in order of first appearance
        per_patch.append((dofs, [np.flatnonzero(local == s) for s in dofs]))
    nd = max(d.size for d, _ in per_patch)
    pnd = np.zeros(len(patches), np.int64)
    psptr = np.zeros((len(patches), nd + 1), np.int64)
    pslot = np.full((len(patches), PATCH * 6), -1, np.int64)
    pdst = np.full((len(patches), nd, 2), -1, np.int64)
    partials = {}  # free row -> its partial-sum rows, in patch order
    n_part = 0
    for p, (dofs, slot_lists) in enumerate(per_patch):
        pnd[p] = dofs.size
        order = np.concatenate(slot_lists)
        pslot[p, :order.size] = order
        psptr[p, 1:dofs.size + 1] = np.cumsum([sl.size for sl in slot_lists])
        psptr[p, dofs.size + 1:] = order.size
        for k, (s, sl) in enumerate(zip(dofs, slot_lists)):
            for a in range(2):
                row = fmap[a * ns + s]
                if row < 0:
                    continue
                if sl.size == elems_of[s]:
                    pdst[p, k, a] = row
                else:
                    pdst[p, k, a] = -2 - n_part
                    partials.setdefault(row, []).append(n_part)
                    n_part += 1
    kp = max((len(v) for v in partials.values()), default=1)
    bdst = np.asarray(sorted(partials), np.int64)
    bsrc = np.full((bdst.size, kp), -1, np.int64)
    for i, row in enumerate(bdst):
        bsrc[i, :len(partials[row])] = partials[row]
    i32 = np.int32
    return {
        "vsrc": vsrc.astype(i32), "vdir": vdir, "pelem": pelem.astype(i32),
        "pnd": pnd.astype(i32), "psptr": psptr.astype(i32),
        "pslot": pslot.astype(np.int16),
        "pdst": pdst.astype(i32), "bdst": bdst.astype(i32),
        "bsrc": bsrc.astype(i32), "n_free": len(free), "n_part": n_part,
    }


def conv_inner_batch_plain(v_t, t0, tri_dofs, slots, free, dir_values,
                           ns: int):
    """Plain torch N(v)v on the free dofs: (n_free, B) -> (n_free, B).
    Lift to the full dofs with the Dirichlet values, `conv_full_batch_plain`,
    restrict (optconpy_tpu ConvKernel.conv_inner_batch, batch last). It
    uses the slot maps, not the kernel's patch plan."""
    v_full_t = dir_values[:, None].repeat(1, v_t.shape[1])
    v_full_t[free] = v_t
    return conv_full_batch_plain(v_full_t, t0, tri_dofs, slots, ns)[free]


@functools.cache
def _library():
    lib = cuda_build.library()
    p = ctypes.c_void_p
    i64 = ctypes.c_int64
    lib.conv_p2_forward.argtypes = [p] * 13 + [i64] * 5 + [p]
    lib.conv_p2_forward.restype = ctypes.c_int
    lib.conv_p2_error_string.argtypes = [ctypes.c_int]
    lib.conv_p2_error_string.restype = ctypes.c_char_p
    return lib


def conv_inner(v_t, conv):
    """N(v)v on the free dofs for a batch: (n_free, B) -> (n_free, B).

    `conv` is the evaluator (fem/device_conv.py FusedConvKernel): its t0
    and plan feed the kernel, its slot maps the plain version. CPU
    tensors take the plain version. CUDA tensors launch the kernel:
    float32 values, int32 maps, contiguous, all on one device; anything
    else raises.
    """
    global launches
    t0, plan = conv.t0, conv.plan
    if v_t.device.type == "cpu":
        return conv_inner_batch_plain(
            v_t, t0, conv.tri_dofs, conv.scatter_slots, conv.free,
            conv.dir_values, conv.ns,
        )
    if v_t.device.type != "cuda":
        raise ValueError(f"no convection kernel for {v_t.device}")
    dev = v_t.device
    nt = t0.shape[0]
    b = v_t.shape[1] if v_t.ndim == 2 else 0
    if b < 1 or nt < 1:
        raise ValueError(f"empty batch or mesh: B={b}, nt={nt}")
    n_patches, nd = plan.pdst.shape[:2]
    n_bnd, kp = plan.bsrc.shape
    i32 = torch.int32
    _check("v_t", v_t, torch.float32, (plan.n_free, b), dev)
    _check("t0", t0, torch.float32, (nt, 6, 6, 6, 2), dev)
    _check("vsrc", plan.vsrc, i32, (nt, 12), dev)
    _check("vdir", plan.vdir, torch.float32, (nt, 12), dev)
    _check("pelem", plan.pelem, i32, (n_patches, PATCH), dev)
    _check("pnd", plan.pnd, i32, (n_patches,), dev)
    _check("psptr", plan.psptr, i32, (n_patches, nd + 1), dev)
    _check("pslot", plan.pslot, torch.int16, (n_patches, PATCH * 6), dev)
    _check("pdst", plan.pdst, i32, (n_patches, nd, 2), dev)
    _check("bdst", plan.bdst, i32, (n_bnd,), dev)
    _check("bsrc", plan.bsrc, i32, (n_bnd, kp), dev)
    if -(-b // COLUMNS_PER_BLOCK) > MAX_GRID_Y:
        raise ValueError(f"B={b} exceeds the kernel's column grid")
    lib = _library()
    out = torch.empty((plan.n_free, b), dtype=torch.float32, device=dev)
    part = torch.empty((plan.n_part, b), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.conv_p2_forward(
            v_t.data_ptr(), t0.data_ptr(), plan.vsrc.data_ptr(),
            plan.vdir.data_ptr(), plan.pelem.data_ptr(),
            plan.pnd.data_ptr(), plan.pslot.data_ptr(),
            plan.psptr.data_ptr(), plan.pdst.data_ptr(), plan.bdst.data_ptr(),
            plan.bsrc.data_ptr(), out.data_ptr(), part.data_ptr(),
            b, n_patches, nd, n_bnd, kp, stream,
        )
    if rc != 0:
        msg = lib.conv_p2_error_string(rc).decode()
        raise RuntimeError(f"conv_p2 launch failed: {msg} ({rc})")
    launches += 1
    return out
