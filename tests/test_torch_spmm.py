"""Port SpMM (ops/spmm_kernel.py) vs reference (ops/pallas_spmm.py).

The host orderings must equal the reference's; the port's `spmm` on the
CPU (its plain version) must match scipy and the reference's ELL SpMM to
1e-12 in f64, and the reference's windowed Pallas kernel (interpret
mode) to 1e-6: that kernel accumulates in float32 whatever its input
dtype (`preferred_element_type=jnp.float32`, pallas_spmm.py:256). The
operators are the NS pencil's Atil^T, M, J and J^T of the cylinder wake
(Re=100, refinement 1) in RCM order. The CUDA kernel runs only on a
card: tests/test_torch_cuda.py holds its tests.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import threadpoolctl
import torch

from optconpy_tpu.models.cavity import cavity_stokes_setup as j_cavity_setup
from optconpy_tpu.ops import pallas_spmm as j_spmm
from optconpy_tpu import native as j_native
from optconpy_tpu_torch.models.cylinder import (
    cylinder_setup as t_cylinder_setup,
)
from optconpy_tpu_torch.ops import spmm_kernel

CPU = torch.device("cpu")
DT = 0.005
OPS = ("at", "m", "j", "jt")


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _pencil(ops, dt):
    m = sp.csr_matrix(ops["M"])
    at = (ops["A"].T - m / (2.0 * dt)).tocsr()
    return at, m, sp.csr_matrix(ops["J"])


def _ordered(at, m, j, rcm, sort_rows):
    """The NS pack's operators: RCM velocity order, J rows sorted."""
    perm = rcm(m, at)
    j_c = j[:, perm].tocsr()
    p_perm = sort_rows(j_c)
    j_r = j_c[p_perm].tocsr()
    ops = {
        "at": at[perm][:, perm].tocsr(),
        "m": m[perm][:, perm].tocsr(),
        "j": j_r,
        "jt": j_r.T.tocsr(),
    }
    return perm, p_perm, ops


@pytest.fixture(scope="module", autouse=True)
def _one_host_thread():
    """One torch and one BLAS thread for the module: host BLAS/LAPACK
    work runs many times slower when busy-waiting BLAS threads share
    the cores with other test workers."""
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(1):
        yield


@pytest.fixture(scope="module")
def cylinder():
    t_ops, _, _ = t_cylinder_setup(re=100.0, refinement=1, device=CPU)
    _, _, ops = _ordered(
        *_pencil(t_ops, DT), spmm_kernel.rcm_permutation,
        spmm_kernel.sort_rows_by_window,
    )
    return t_ops, ops


@pytest.fixture(scope="module")
def cavity():
    with pytest.MonkeyPatch.context() as mp:
        # the reference's numpy element path, the port's only one
        mp.setattr(j_native, "available", lambda: False)
        j_ops, _, _ = j_cavity_setup(nx=8)
    return j_ops


@pytest.mark.parametrize("problem", ["cavity", "cylinder"])
def test_orderings_equal_reference(problem, cavity, cylinder):
    ops = cavity if problem == "cavity" else cylinder[0]
    pencil = _pencil(ops, DT)
    t_perm, t_pperm, _ = _ordered(
        *pencil, spmm_kernel.rcm_permutation, spmm_kernel.sort_rows_by_window
    )
    j_perm, j_pperm, _ = _ordered(
        *pencil, j_spmm.rcm_permutation, j_spmm.sort_rows_by_window
    )
    assert np.array_equal(t_perm, j_perm)
    assert np.array_equal(t_pperm, j_pperm)
    assert sorted(t_perm) == list(range(pencil[0].shape[0]))


def test_sort_rows_puts_empty_rows_last():
    a = sp.csr_matrix(np.array([
        [0.0, 0.0, 1.0], [0.0, 0.0, 0.0], [2.0, 0.0, 3.0], [0.0, 4.0, 0.0],
    ]))
    order = spmm_kernel.sort_rows_by_window(a)
    assert np.array_equal(order, j_spmm.sort_rows_by_window(a))
    assert np.array_equal(order, [2, 3, 0, 1])


def _decode(pack):
    """The operator a pack holds, back as scipy CSR (entries that are 0
    in every row are the padding)."""
    eptr = pack.eptr.numpy()
    group = np.repeat(np.arange(eptr.size - 1), np.diff(eptr))
    vals = pack.evals.numpy()
    rows = group[:, None] * spmm_kernel.GROUP + np.arange(spmm_kernel.GROUP)
    keep = vals != 0
    cols = np.broadcast_to(pack.ecol.numpy()[:, None], vals.shape)
    return sp.csr_matrix(
        (vals[keep], (rows[keep], cols[keep])),
        shape=((eptr.size - 1) * spmm_kernel.GROUP, pack.shape[1]),
    )[:pack.shape[0]]


def _check_layout(pack, a):
    """The pack's invariants (ops/spmm_kernel.py docstring) and that it
    holds exactly `a`."""
    eptr, ecol = pack.eptr.numpy(), pack.ecol.numpy()
    assert pack.shape == a.shape and pack.nnz == a.nnz
    assert pack.smem_bytes <= spmm_kernel.SHARED_MAX
    assert pack.eptr.dtype == torch.int32 and pack.ecol.dtype == torch.int32
    n_groups = eptr.size - 1
    assert n_groups == pack.n_tiles * spmm_kernel.TILE_GROUPS
    assert n_groups * spmm_kernel.GROUP >= a.shape[0]
    assert eptr[0] == 0 and np.all(np.diff(eptr) % 4 == 0)
    assert np.all((ecol >= 0) & (ecol < a.shape[1]))
    for g in range(n_groups):  # each group's real columns sorted, distinct,
        # then the padding, which repeats the last of them
        real = np.any(pack.evals.numpy()[eptr[g]:eptr[g + 1]] != 0, axis=1)
        cols = ecol[eptr[g]:eptr[g + 1]]
        assert np.all(np.diff(cols[real]) > 0)
        if real.any():
            assert np.all(cols[~real] == cols[real][-1])
    back = _decode(pack)
    assert (abs(back - a) > 0).nnz == 0


@pytest.mark.parametrize("name", OPS)
def test_pack_layout(cylinder, name):
    _, ops = cylinder
    a = ops[name]
    pack = spmm_kernel.pack_spmm(a, device=CPU)
    _check_layout(pack, a)
    assert pack.evals.dtype == torch.float64
    p32 = spmm_kernel.pack_spmm(a, device=CPU, dtype=torch.float32)
    assert p32.evals.dtype == torch.float32
    assert torch.equal(p32.ecol, pack.ecol) and torch.equal(p32.eptr, pack.eptr)
    assert p32.smem_bytes < pack.smem_bytes


@pytest.mark.parametrize("case, want", [
    # config 3's A~^T (3,829 groups, 15,316 rows of X) and J (520 groups,
    # X the same): on an H100 (132 SMs, 50 MB of L2)
    ((3829, 15316, 17396, 4), 4),
    ((3829, 15316, 17396, 8), 2),  # float64: at most 16 bytes a lane
    ((520, 15316, 17396, 4), 1),  # J: the slab in flight would not fit
    ((3829, 2080, 17396, 8), 2),
    ((3829, 15316, 17394, 4), 2),  # B not a multiple of 4
    ((3829, 15316, 17395, 4), 1),
    ((3829, 15316, 8, 4), 4),
])
def test_columns_per_lane(case, want):
    n_groups, x_rows, b, itemsize = case
    args = (n_groups, x_rows, b, itemsize)
    assert spmm_kernel.columns_per_lane(*args, 256, 132, 50 * 2**20) == want
    # an address aligned to 8 bytes only allows 2 float32 columns
    if want == 4:
        assert spmm_kernel.columns_per_lane(*args, 8, 132, 50 * 2**20) == 2


def _ragged_operator():
    """37 x 53 with a ragged last group and tile, an empty row and one
    row spanning every column."""
    rng = np.random.default_rng(3)
    a = sp.random(37, 53, density=0.15, random_state=rng, format="lil")
    a[5, :] = 0.0
    a[36, :] = rng.standard_normal(53)
    return sp.csr_matrix(a)


@pytest.mark.parametrize("problem", ["cavity", "cylinder", "ragged"])
@pytest.mark.parametrize("name", OPS)
def test_pack_plain_apply_matches_scipy(cavity, cylinder, problem, name):
    """The host pack through the plain apply, f64, against scipy: the
    cavity and the cylinder's pencil (J the wide one), and a ragged
    operator with an empty row."""
    if problem == "ragged":
        a = _ragged_operator()
        a = {"at": a, "m": a.T.tocsr(), "j": a[:, :8], "jt": a[:8]}[name]
        a = sp.csr_matrix(a)
        assert a.shape[0] % 4 or a.shape[0] < 16
    elif problem == "cavity":
        _, _, ops = _ordered(
            *_pencil(cavity, DT), spmm_kernel.rcm_permutation,
            spmm_kernel.sort_rows_by_window,
        )
        a = ops[name]
    else:
        a = cylinder[1][name]
    pack = spmm_kernel.pack_spmm(a, device=CPU, dtype=torch.float64)
    _check_layout(pack, a)
    x = np.random.default_rng(5).standard_normal((a.shape[1], 9))
    got = spmm_kernel.spmm_plain(pack, torch.as_tensor(x)).numpy()
    assert got.shape == (a.shape[0], 9)
    ref = a @ x
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()
    empty = np.flatnonzero(np.diff(a.indptr) == 0)
    assert np.all(got[empty] == 0)


@pytest.mark.parametrize("b", [1, 8, 37])
@pytest.mark.parametrize("name", OPS)
def test_spmm_matches_scipy_and_reference(cylinder, name, b):
    _, ops = cylinder
    a = ops[name]
    rng = np.random.default_rng(b)
    x = rng.standard_normal((a.shape[1], b))
    pack = spmm_kernel.pack_spmm(a, device=CPU, dtype=torch.float64)
    before = spmm_kernel.launches
    got = spmm_kernel.spmm(pack, torch.as_tensor(x))
    assert spmm_kernel.launches == before  # the CPU takes the plain version
    assert got.shape == (a.shape[0], b) and got.dtype == torch.float64
    assert _rel(got, a @ x) <= 1e-12
    j_ell = j_spmm.pack_for_backend(a, np.float64, kind="ell")
    assert _rel(got, j_spmm.spmm(j_ell, jnp.asarray(x))) <= 1e-12
    j_win = j_spmm.windowed_dense_spmm(
        j_spmm.pack_windowed_dense(a, dtype=np.float64), jnp.asarray(x),
        interpret=True,
    )
    assert _rel(got, j_win) <= 1e-6


def test_nonfinite_x_spreads_within_its_group():
    """The documented semantics (ops/spmm_kernel.py): finite X gives A X;
    an inf in X at a column only row 0 of a group holds turns the group's
    other rows NaN too, and leaves the other groups as A X (their padding
    repeats their own last column)."""
    a = sp.csr_matrix(np.array([
        [1.0, 2.0, 0.0], [0.0, 3.0, 0.0], [0.0, 0.0, 0.0], [0.0, 4.0, 5.0],
        [0.0, 0.0, 6.0],
    ]))
    pack = spmm_kernel.pack_spmm(a, device=CPU)
    x = np.array([[np.inf], [1.0], [2.0]])
    got = spmm_kernel.spmm_plain(pack, torch.as_tensor(x)).numpy()
    assert np.isinf(got[0, 0]) and np.all(np.isnan(got[1:4, 0]))
    assert got[4, 0] == 12.0
    x[0] = 7.0
    got = spmm_kernel.spmm_plain(pack, torch.as_tensor(x)).numpy()
    assert np.array_equal(got, a @ x)


def test_spmm_refuses_other_devices(cylinder):
    _, ops = cylinder
    pack = spmm_kernel.pack_spmm(ops["m"], device=CPU)
    x = torch.zeros((ops["m"].shape[1], 2), device="meta")
    with pytest.raises(ValueError, match="no SpMM kernel"):
        spmm_kernel.spmm(pack, x)
