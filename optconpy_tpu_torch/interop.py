"""Carry operators built by the reference package into the port.

Every function here takes plain dicts of numpy arrays and returns the
port's object on a given device and dtype, so identical operators can be
fed to both packages: a difference in device math then cannot hide
behind a difference in host builds. `flatten_arrays` produces such a
dict from any dataclass whose fields are arrays (a reference object
included) without importing the reference's framework. A convection
kernel is carried by `ConvKernel.from_arrays` (or FusedConvKernel's)
itself, which reads the same kind of dict.

Key conventions (nested dataclass fields are joined with '.'):
  DAESystem:                 mass.data, mass.cols, stiff.data, ...,
                             jmat_t.cols, b, c, fv
  ConvKernel:                t0, tri_dofs, free, dir_values, scatter_slots
  SaddleShiftedInverseCache: inv, n
  NSEFusedCache:             pmat, inv_vv, gmat, c0, vbar, dt
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .fem.dae import DAESystem
from .mpc.nse_rollout import NSEFusedCache
from .ops.sparse import ELL
from .solvers.saddle import SaddleShiftedInverseCache

_ELL_FIELDS = ("mass", "stiff", "stiff_t", "jmat", "jmat_t")


def flatten_arrays(obj, prefix: str = "") -> dict:
    """{'field' or 'outer.inner': np.ndarray} for every array or number
    field of a (nested) dataclass; tuple fields (shapes) are skipped."""
    out = {}
    for f in dataclasses.fields(obj):
        val = getattr(obj, f.name)
        key = prefix + f.name
        if dataclasses.is_dataclass(val):
            out.update(flatten_arrays(val, key + "."))
        elif isinstance(val, torch.Tensor):
            out[key] = val.detach().cpu().numpy()
        elif val is not None and not isinstance(val, tuple):
            out[key] = np.asarray(val)
    return out


def _tensor(a, device, dtype=None):
    # torch.tensor copies: arrays read from another framework may be
    # read-only views of its buffers.
    return torch.tensor(np.asarray(a)).to(device=device, dtype=dtype)


def dae_from_arrays(arrays: dict, *, device, dtype=None) -> DAESystem:
    b = np.asarray(arrays["b"])
    c = np.asarray(arrays["c"])
    n, m_in = b.shape
    n_p = np.asarray(arrays["jmat.data"]).shape[0]
    shapes = {
        "mass": (n, n), "stiff": (n, n), "stiff_t": (n, n),
        "jmat": (n_p, n), "jmat_t": (n, n_p),
    }
    ells = {
        name: ELL(
            _tensor(arrays[f"{name}.data"], device, dtype),
            _tensor(np.asarray(arrays[f"{name}.cols"], np.int64), device),
            shapes[name],
        )
        for name in _ELL_FIELDS
    }
    return DAESystem(
        **ells,
        b=_tensor(b, device, dtype),
        c=_tensor(c, device, dtype),
        fv=_tensor(arrays["fv"], device, dtype),
        n=n, n_p=n_p, m_in=m_in, p_out=c.shape[0],
    )


def inverse_cache_from_arrays(
    arrays: dict, *, device, dtype=None
) -> SaddleShiftedInverseCache:
    inv = np.asarray(arrays["inv"])
    n = int(arrays["n"]) if "n" in arrays else inv.shape[1]
    return SaddleShiftedInverseCache(_tensor(inv, device, dtype), n)


def nse_fused_from_arrays(arrays: dict, *, device, dtype=None) -> NSEFusedCache:
    return NSEFusedCache(
        **{
            k: _tensor(arrays[k], device, dtype)
            for k in ("pmat", "inv_vv", "gmat", "c0", "vbar")
        },
        dt=float(arrays["dt"]),
    )
