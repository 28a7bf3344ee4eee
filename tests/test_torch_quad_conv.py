"""Port QuadConvKernel (fem/device_conv.py) vs the reference, on the CPU.

N(v)v as four SpMMs of host-built interpolation matrices (degree-5
rule, as the assembly) must reproduce the reference's QuadConvKernel and
the port's per-element ConvKernel on the cavity (nx=6) to 1e-12, for one
vector and a batch, and change nothing beyond roundoff (1e-11) when it
replaces ConvKernel inside the port's fused closed loop (the reference's
tests/test_quad_conv.py). On the CPU the SpMM kernel takes its plain
version; tests/test_torch_cuda.py holds the kernel launches on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import threadpoolctl
import torch

from optconpy_tpu import native as j_native
from optconpy_tpu.fem.device_conv import QuadConvKernel as JQuadConvKernel
from optconpy_tpu.models.cavity import cavity_stokes_setup as j_cavity_setup
from optconpy_tpu.solvers.steady import solve_steady_nse_host as j_steady
from optconpy_tpu_torch.fem.device_conv import ConvKernel, QuadConvKernel
from optconpy_tpu_torch.models.cavity import cavity_stokes_setup
from optconpy_tpu_torch.mpc import (
    batched_nse_closed_loop_fused,
    build_nse_fused,
)
from optconpy_tpu_torch.ops import spmm_kernel
from optconpy_tpu_torch.solvers.steady import solve_steady_nse_host

CPU = torch.device("cpu")
F64 = torch.float64


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1.0)


@pytest.fixture(scope="module", autouse=True)
def _one_host_thread():
    """One torch and one BLAS thread for the module: host BLAS/LAPACK
    work runs many times slower when busy-waiting BLAS threads share
    the cores with other test workers."""
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(1):
        yield


@pytest.fixture(scope="module")
def kernels():
    with pytest.MonkeyPatch.context() as mp:
        # the reference's numpy element path, the port's only one
        mp.setattr(j_native, "available", lambda: False)
        j_ops, _, j_cond = j_cavity_setup(nx=6)
    j_ops["vbar_full"], _ = j_steady(j_ops["full"], j_cond)
    t_ops, t_sys, t_cond = cavity_stokes_setup(nx=6, device=CPU)
    t_ops["vbar_full"], _ = solve_steady_nse_host(t_ops["full"], t_cond)
    ref = ConvKernel.build(t_ops["full"], t_cond, device=CPU, dtype=F64)
    quad = QuadConvKernel.build(t_ops["full"], t_cond, device=CPU, dtype=F64)
    j_quad = JQuadConvKernel.build(j_ops["full"], j_cond, dtype=jnp.float64,
                                   kind="ell")
    return t_ops, t_sys, t_cond, ref, quad, j_quad


def test_quad_conv_matches_single(kernels):
    t_ops, _, t_cond, ref, quad, j_quad = kernels
    rng = np.random.default_rng(0)
    v = (t_cond.restrict(t_ops["vbar_full"])
         + 0.1 * rng.standard_normal(ref.n_free))
    got = quad.conv_inner(torch.as_tensor(v))
    assert got.shape == (ref.n_free,)
    assert _rel(got, ref.conv_inner(torch.as_tensor(v))) < 1e-12
    assert _rel(got, np.asarray(j_quad.conv_inner(jnp.asarray(v)))) < 1e-12


def test_quad_conv_matches_batch(kernels):
    t_ops, _, t_cond, ref, quad, j_quad = kernels
    rng = np.random.default_rng(1)
    vb = (t_cond.restrict(t_ops["vbar_full"])[None]
          + 0.1 * rng.standard_normal((5, ref.n_free)))
    before = spmm_kernel.launches
    got = quad.conv_inner_batch(torch.as_tensor(vb))
    assert spmm_kernel.launches == before  # the CPU takes the plain version
    assert got.shape == (5, ref.n_free)
    assert _rel(got, ref.conv_inner_batch(torch.as_tensor(vb))) < 1e-12
    j_got = np.asarray(j_quad.conv_inner_batch(jnp.asarray(vb)))
    assert _rel(got, j_got) < 1e-12
    got_t = quad.conv_inner_batch_t(torch.as_tensor(vb.T.copy()))
    assert torch.equal(got_t, got.T)
    v_full = quad.expand(torch.as_tensor(vb[0]))
    assert _rel(quad.conv_full(v_full), ref.conv_full(v_full)) < 1e-12


def test_quad_conv_to_float32(kernels):
    """.to() casts the packs (their shared-memory need follows the value
    size) and keeps the indices."""
    t_ops, _, t_cond, ref, quad, _ = kernels
    q32 = quad.to(dtype=torch.float32)
    for name in ("p_pack", "gx_pack", "gy_pack", "pwt_pack"):
        a, b = getattr(quad, name), getattr(q32, name)
        assert b.evals.dtype == torch.float32 and b.ecol.dtype == torch.int32
        assert torch.equal(a.ecol, b.ecol) and torch.equal(a.eptr, b.eptr)
        # bytes an entry of a tile takes: GROUP values and one int32 column
        assert b.smem_bytes * (4 * 8 + 4) == a.smem_bytes * (4 * 4 + 4)
    v = torch.as_tensor(t_cond.restrict(t_ops["vbar_full"]))
    assert _rel(q32.conv_inner(v.float()), ref.conv_inner(v)) < 1e-5


def test_quad_conv_in_fused_rollout(kernels):
    """Swapping ConvKernel for QuadConvKernel inside the port's fused
    closed loop changes nothing beyond roundoff."""
    t_ops, t_sys, t_cond, ref, quad, _ = kernels
    dt, nts, s = 0.02, 5, 3
    cache = build_nse_fused(t_ops, t_cond, dt, device=CPU, dtype=F64)
    rng = np.random.default_rng(2)
    n, m = t_sys.b.shape
    v0 = torch.as_tensor(cache.vbar.numpy()[None]
                         + 1e-2 * rng.standard_normal((s, n)))
    ks = torch.as_tensor(1e-3 * rng.standard_normal((nts + 1, m, n)))
    ws = torch.zeros((nts + 1, n), dtype=F64)
    for feedback in ("explicit", "implicit"):
        va, _, _ = batched_nse_closed_loop_fused(
            t_sys, ref, cache, ks, ws, v0, 1e-2, feedback=feedback)
        vb, _, _ = batched_nse_closed_loop_fused(
            t_sys, quad, cache, ks, ws, v0, 1e-2, feedback=feedback)
        assert _rel(vb, va) < 1e-11, feedback
