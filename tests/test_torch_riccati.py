"""Port Riccati path (ops/lowrank, solvers/saddle, riccati/*) vs reference.

Cylinder wake at Re=100, refinement 1 in f64 on the CPU with a reduced
schedule (2 shifts, n_adi=4, r_max=8, nts=2, n_newton=1). The host
inverse stack must be bitwise equal; the gains K agree to 1e-8 relative
(Z is compared only through K, because SVD signs are free).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from optconpy_tpu.models.cylinder import cylinder_setup as j_cylinder_setup
from optconpy_tpu.ops import lowrank as j_lowrank
from optconpy_tpu.riccati import dre_backward_sweep as j_dre_sweep
from optconpy_tpu.riccati import dre_shift_schedule_dae as j_schedule
from optconpy_tpu.riccati import load_or_build_inverse_stack as j_stack
from optconpy_tpu.solvers.saddle import (
    SaddleShiftedInverseCache as JInverseCache,
)
from optconpy_tpu_torch import interop
from optconpy_tpu_torch.models.cylinder import (
    cylinder_setup as t_cylinder_setup,
)
from optconpy_tpu_torch.ops import lowrank as t_lowrank
from optconpy_tpu_torch.riccati import dre_backward_sweep as t_dre_sweep
from optconpy_tpu_torch.riccati import dre_shift_schedule_dae as t_schedule
from optconpy_tpu_torch.riccati import load_or_build_inverse_stack as t_stack
from optconpy_tpu_torch.riccati.dre import inverse_stack_digest
from optconpy_tpu_torch.solvers.saddle import SaddleShiftedInverseCache

CPU = torch.device("cpu")
DT, ALPHA = 0.005, 1e-2
NUM_SHIFTS, N_ADI, R_MAX, NTS, N_NEWTON = 2, 4, 8, 2, 1


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _at_til(ops):
    return (ops["A"].T - ops["M"] / (2.0 * DT)).tocsr()


@pytest.fixture(scope="module")
def riccati():
    torch.set_num_threads(1)
    j_ops, j_sys, _ = j_cylinder_setup(re=100.0, refinement=1)
    t_ops, t_sys, _ = t_cylinder_setup(re=100.0, refinement=1, device=CPU)
    j_sched = j_schedule(
        j_ops["A"], j_ops["M"], j_ops["J"], DT,
        num_shifts=NUM_SHIFTS, n_adi=N_ADI,
    )
    t_sched = t_schedule(
        t_ops["A"], t_ops["M"], t_ops["J"], DT,
        num_shifts=NUM_SHIFTS, n_adi=N_ADI,
    )
    j_inv, _ = j_stack(
        _at_til(j_ops), j_ops["M"], j_ops["J"], j_sched[0], np.float64
    )
    t_inv, src = t_stack(
        _at_til(t_ops), t_ops["M"], t_ops["J"], t_sched[0], np.float64
    )
    assert src == "built"
    return {
        "j": (j_ops, j_sys, j_sched, j_inv),
        "t": (t_ops, t_sys, t_sched, t_inv),
    }


def test_shift_schedule_bitwise(riccati):
    j_sched, t_sched = riccati["j"][2], riccati["t"][2]
    for a, b in zip(j_sched, t_sched):
        assert np.array_equal(a, b)
    assert t_sched[0].shape == (NUM_SHIFTS,) and (t_sched[0] < 0).all()


def test_inverse_stack_bitwise(riccati):
    j_inv, t_inv = riccati["j"][3], riccati["t"][3]
    assert t_inv.shape == (NUM_SHIFTS, 4396, 4396)
    assert t_inv.dtype == np.float64
    assert np.array_equal(j_inv, t_inv)


def test_inverse_stack_fingerprint_hashes_pattern(riccati):
    """Same values, nnz and shape on a different sparsity pattern must
    give another cache digest (the reference hashes values only)."""
    t_ops, _, t_sched, _ = riccati["t"]
    j = sp.csr_matrix(t_ops["J"])
    j_moved = sp.csr_matrix(
        (j.data, (j.indices + 1) % j.shape[1], j.indptr), shape=j.shape
    )
    assert j_moved.nnz == j.nnz and np.array_equal(j_moved.data, j.data)
    args = (_at_til(t_ops), t_ops["M"])
    d0 = inverse_stack_digest(*args, j, t_sched[0], np.float64, "k")
    d1 = inverse_stack_digest(*args, j_moved, t_sched[0], np.float64, "k")
    assert d0 != d1
    # indptr alone: move one entry from row 0 to row 1.
    ptr = j.indptr.copy()
    ptr[1] -= 1
    j_ptr = sp.csr_matrix((j.data, j.indices, ptr), shape=j.shape)
    d2 = inverse_stack_digest(*args, j_ptr, t_sched[0], np.float64, "k")
    assert d2 != d0


def test_inverse_stack_disk_cache_roundtrip(tmp_path):
    """A keyed build is stored and loaded back; a small saddle pencil
    (n=12, n_p=3) keeps the build cheap."""
    rng = np.random.default_rng(2)
    n = 12
    m_sp = sp.identity(n, format="csr")
    at_sp = sp.diags(
        [-4.0 * np.ones(n), np.ones(n - 1), np.ones(n - 1)], [0, 1, -1],
        format="csr",
    )
    j_sp = sp.csr_matrix(rng.standard_normal((3, n)))
    sig = np.array([-1.0, -3.0])
    args = (at_sp, m_sp, j_sp, sig, np.float64)
    first, src1 = t_stack(*args, cache_key="small", cache_dir=str(tmp_path))
    again, src2 = t_stack(*args, cache_key="small", cache_dir=str(tmp_path))
    assert (src1, src2) == ("built", "disk")
    assert np.array_equal(first, again)
    ref, _ = j_stack(*args)
    assert np.array_equal(first, ref)
    # The stored block is the velocity block of the saddle inverse.
    big = sp.bmat(
        [[at_sp + sig[1] * m_sp, j_sp.T], [j_sp, None]]
    ).toarray()
    np.testing.assert_allclose(
        first[1], np.linalg.inv(big)[:n, :n], rtol=1e-10, atol=1e-12
    )


def test_inverse_cache_solves_match_reference(riccati):
    _, _, _, j_inv = riccati["j"]
    _, t_sys, _, t_inv = riccati["t"]
    n = t_sys.n
    j_cache = JInverseCache(jnp.asarray(j_inv), n)
    t_cache = interop.inverse_cache_from_arrays(
        interop.flatten_arrays(j_cache), device=CPU
    )
    assert torch.equal(t_cache.inv, torch.as_tensor(t_inv))
    rng = np.random.default_rng(5)
    rhs = rng.standard_normal((n, 6))
    u = 1e-2 * rng.standard_normal((n, 4))
    v = 1e-2 * rng.standard_normal((n, 4))
    ref = j_cache.solve_smw(1, jnp.asarray(u), jnp.asarray(v), jnp.asarray(rhs))
    got = t_cache.solve_smw(
        1, torch.as_tensor(u), torch.as_tensor(v), torch.as_tensor(rhs)
    )
    assert _rel(got, ref) <= 1e-12


def test_lowrank_matches_reference():
    rng = np.random.default_rng(11)
    z = rng.standard_normal((300, 24))
    z[:, -3:] = 0.0  # masked trailing columns
    q_j, r_j = j_lowrank.tsqr_cholqr2(jnp.asarray(z))
    q_t, r_t = t_lowrank.tsqr_cholqr2(torch.as_tensor(z))
    assert _rel(q_t @ r_t, np.asarray(q_j) @ np.asarray(r_j)) <= 1e-12
    assert _rel(q_t @ r_t, z) <= 1e-12
    for out_rank in (16, 24, 30):
        c_j = np.asarray(j_lowrank.compress(
            jnp.asarray(z), out_rank=out_rank, rtol=t_lowrank.COMPRESS_RTOL
        ))
        c_t = t_lowrank.compress(torch.as_tensor(z), out_rank)
        assert c_t.shape == c_j.shape
        # Columns are free up to sign: compare the Gram Z Z^T.
        assert _rel(c_t @ c_t.T, c_j @ c_j.T) <= 1e-12


def test_dre_sweep_gains_match_reference(riccati):
    j_ops, j_sys, j_sched, j_inv = riccati["j"]
    t_ops, t_sys, t_sched, t_inv = riccati["t"]
    n = t_sys.n
    _, ks_j = j_dre_sweep(
        j_sys, JInverseCache(jnp.asarray(j_inv), n), ALPHA, DT, NTS,
        jnp.asarray(j_sched[1]), jnp.asarray(j_sched[2]),
        n_newton=N_NEWTON, r_max=R_MAX,
    )
    zs_t, ks_t = t_dre_sweep(
        t_sys, SaddleShiftedInverseCache(torch.as_tensor(t_inv), n),
        ALPHA, DT, NTS, t_sched[1], t_sched[2],
        n_newton=N_NEWTON, r_max=R_MAX,
    )
    assert zs_t.shape == (NTS + 1, n, R_MAX)
    assert ks_t.shape == (NTS + 1, 4, n)
    assert torch.count_nonzero(zs_t[-1]) == 0  # terminal factor
    assert np.abs(np.asarray(ks_j)).max() > 0
    assert _rel(ks_t, ks_j) <= 1e-8
