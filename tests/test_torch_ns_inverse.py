"""Port Newton-Schulz inverse stacks (solvers/ns_inverse.py), the NS DRE
cache (riccati.build_dre_cache_dae_ns) and the DRE residual check
(riccati/validate.py) vs the reference, on the driven cavity (nx=8,
n=450, n_p=80) in f64 on the CPU, where `spmm` takes its plain version.

Both stacks converge to the exact inverse, so they must agree with each
other and with the host splu stack to 1e-6 (the reference test's bound);
the DRE gains through the two caches to 1e-8; the residual check on the
same factors to 1e-12.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import threadpoolctl
import torch

from optconpy_tpu.models.cavity import cavity_stokes_setup as j_cavity_setup
from optconpy_tpu.riccati import build_dre_cache_dae_ns as j_build_ns
from optconpy_tpu.riccati import dre_backward_sweep as j_dre_sweep
from optconpy_tpu.riccati import dre_shift_schedule_dae as j_schedule
from optconpy_tpu.riccati.validate import dre_step_residual as j_residual
from optconpy_tpu import native as j_native
from optconpy_tpu_torch.models.cavity import cavity_stokes_setup
from optconpy_tpu_torch.riccati import (
    build_dre_cache_dae_ns,
    dre_backward_sweep,
    dre_shift_schedule_dae,
)
from optconpy_tpu_torch.riccati.validate import dre_step_residual
from optconpy_tpu_torch.solvers.ns_inverse import build_inverse_stack_ns
from optconpy_tpu_torch.solvers.saddle import SaddleShiftedInverseCache

CPU = torch.device("cpu")
F64 = torch.float64
DT = 0.02
ALPHA, NTS, N_SHIFTS, N_ADI, R_MAX = 1e-2, 3, 3, 6, 12


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _pencil(ops):
    m = sp.csr_matrix(ops["M"])
    at = (ops["A"].T - m / (2.0 * DT)).tocsr()
    return at, m, sp.csr_matrix(ops["J"])


@pytest.fixture(scope="module", autouse=True)
def _one_host_thread():
    """One torch and one BLAS thread for the module: host BLAS/LAPACK
    work runs many times slower when busy-waiting BLAS threads share
    the cores with other test workers."""
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(1):
        yield


@pytest.fixture(scope="module")
def cavity():
    with pytest.MonkeyPatch.context() as mp:
        # the reference's numpy element path, the port's only one
        mp.setattr(j_native, "available", lambda: False)
        j_ops, j_sys, _ = j_cavity_setup(nx=8)
    t_ops, t_sys, _ = cavity_stokes_setup(nx=8, device=CPU, dtype=F64)
    return j_ops, j_sys, t_ops, t_sys


@pytest.fixture(scope="module")
def sweeps(cavity):
    """DRE sweeps through the NS caches of both packages."""
    j_ops, j_sys, t_ops, t_sys = cavity
    sig, sseq, iseq = dre_shift_schedule_dae(
        t_ops["A"], t_ops["M"], t_ops["J"], DT,
        num_shifts=N_SHIFTS, n_adi=N_ADI,
    )
    t_cache, t_info = build_dre_cache_dae_ns(t_sys, DT, sig)
    zs, ks = dre_backward_sweep(
        t_sys, t_cache, ALPHA, DT, NTS, sseq, iseq, n_newton=1, r_max=R_MAX
    )
    j_sig, j_sseq, j_iseq = j_schedule(
        j_ops["A"], j_ops["M"], j_ops["J"], DT,
        num_shifts=N_SHIFTS, n_adi=N_ADI,
    )
    j_cache, _ = j_build_ns(j_sys, DT, j_sig, dtype=jnp.float64)
    j_zs, j_ks = j_dre_sweep(
        j_sys, j_cache, ALPHA, DT, NTS, jnp.asarray(j_sseq),
        jnp.asarray(j_iseq), n_newton=1, r_max=R_MAX,
    )
    assert np.array_equal(sig, j_sig)
    return {
        "sig": sig,
        "t": (t_cache, t_info, zs, ks),
        "j": (j_cache, j_zs, j_ks),
    }


@pytest.mark.parametrize("name", ["M", "A", "J", "B", "C", "fv", "fp"])
def test_cavity_operators_bitwise(cavity, name):
    j_ops, _, t_ops, _ = cavity
    a, b = j_ops[name], t_ops[name]
    if sp.issparse(a):
        a, b = a.toarray(), b.toarray()
    assert np.array_equal(np.asarray(a), np.asarray(b))


def test_cavity_dae_system(cavity):
    _, j_sys, _, t_sys = cavity
    assert (t_sys.n, t_sys.n_p, t_sys.m_in, t_sys.p_out) == (450, 80, 4, 2)
    assert np.array_equal(t_sys.fv.numpy(), np.asarray(j_sys.fv))
    assert np.array_equal(t_sys.mass.data.numpy(), np.asarray(j_sys.mass.data))


def test_ns_stack_matches_host_splu_and_reference(cavity, sweeps):
    _, _, t_ops, _ = cavity
    t_cache, info, _, _ = sweeps["t"]
    j_cache = sweeps["j"][0]
    sig = sweeps["sig"]
    assert t_cache.inv.shape == (N_SHIFTS, 450, 450)
    assert t_cache.inv.dtype == F64
    assert info["certified"] == [True] * N_SHIFTS, info["residuals"]
    assert all(r <= info["certify_tol"] for r in info["residuals"])
    ref = SaddleShiftedInverseCache.build_sparse_host(
        *_pencil(t_ops), sig, dtype=np.float64
    )
    for i in range(N_SHIFTS):
        assert _rel(t_cache.inv[i], ref[i]) < 1e-6, i
        assert _rel(t_cache.inv[i], j_cache.inv[i]) < 1e-6, i


def test_ns_dre_cache_solves(cavity, sweeps):
    """The cache's solve satisfies the shifted saddle system: J x = 0
    and the momentum residual lies in range(J^T)."""
    _, _, t_ops, _ = cavity
    t_cache = sweeps["t"][0]
    at, m, j = _pencil(t_ops)
    rhs = np.random.default_rng(0).standard_normal((at.shape[0], 3))
    for i, s in enumerate(sweeps["sig"]):
        x = t_cache.solve(i, torch.as_tensor(rhs)).numpy()
        assert np.abs(j @ x).max() < 1e-8 * np.abs(x).max()
        r = (at + s * m) @ x - rhs
        lam, *_ = np.linalg.lstsq(j.T.toarray(), r, rcond=None)
        assert np.abs(r - j.T @ lam).max() < 1e-6 * np.abs(rhs).max()


def test_ns_dre_gains_match_reference(sweeps):
    _, _, zs, ks = sweeps["t"]
    _, _, j_ks = sweeps["j"]
    assert zs.shape == (NTS + 1, 450, R_MAX)
    assert np.abs(np.asarray(j_ks)).max() > 0
    assert _rel(ks, j_ks) <= 1e-8


@pytest.mark.parametrize("step", [0, 1])
def test_dre_step_residual_matches_reference(cavity, sweeps, step):
    j_ops, _, t_ops, _ = cavity
    _, _, zs, ks = sweeps["t"]
    args = (zs[step].numpy(), ks[step].numpy(), zs[step + 1].numpy(),
            ALPHA, DT)
    got = dre_step_residual(t_ops, *args)
    ref = j_residual(j_ops, *args)
    assert 0.0 < got < 1e-2
    assert abs(got - ref) <= 1e-12 * ref


def test_unreachable_certify_tol_flags_not_raises(cavity):
    _, _, t_ops, _ = cavity
    inv, info = build_inverse_stack_ns(
        *_pencil(t_ops), [-400.0], device=CPU, dtype=F64, certify_tol=1e-30
    )
    assert info["certified"] == [False]
    assert 0.0 < info["residuals"][0] < 1e-8
    assert info["extra_passes"] == [6]
    assert torch.isfinite(inv).all()


def test_divergence_raises(cavity):
    _, _, t_ops, _ = cavity
    at, m, j = _pencil(t_ops)
    at = at.copy()
    at.data[0] = np.nan
    with pytest.raises(RuntimeError, match="diverged"):
        build_inverse_stack_ns(at, m, j, [-400.0], device=CPU, dtype=F64)


def test_f32_stack_certifies_in_f64(cavity):
    """An f32 stack's certification probe is evaluated in f64 as well,
    and the f64 evaluation certifies. At s = -4000 the f32 evaluation of
    v - A(s) X v (cancelling terms that grow with |s|) misses 5e-4 while
    the f64 evaluation of the same f32 iterate passes; the stored blocks
    agree with the host splu stack to f32 accuracy."""
    _, _, t_ops, _ = cavity
    sig = [-4000.0, -400.0]
    inv, info = build_inverse_stack_ns(
        *_pencil(t_ops), sig, device=CPU, dtype=torch.float32,
        certify_tol=5e-4,
    )
    assert inv.dtype == torch.float32
    res64, res32 = info["residuals"], info["residuals_working"]
    assert info["certified"] == [True, True], res64
    assert info["extra_passes"] == [0, 0]
    assert res32[0] > 5e-4 > res64[0] > 0.0
    assert 0.0 < res64[1] < 5e-4
    ref = SaddleShiftedInverseCache.build_sparse_host(
        *_pencil(t_ops), sig, dtype=np.float64
    )
    for i in range(2):
        assert _rel(inv[i].double(), ref[i]) < 1e-3, i
