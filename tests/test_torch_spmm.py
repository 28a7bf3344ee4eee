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
import torch

from optconpy_tpu.models.cavity import cavity_stokes_setup as j_cavity_setup
from optconpy_tpu.ops import pallas_spmm as j_spmm
from optconpy_tpu_torch.models.cylinder import (
    cylinder_setup as t_cylinder_setup,
)
from optconpy_tpu_torch.ops import spmm_kernel
from optconpy_tpu_torch.ops.sparse import ELL, ell_to_scipy

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


@pytest.fixture(scope="module")
def cylinder():
    torch.set_num_threads(1)
    t_ops, _, _ = t_cylinder_setup(re=100.0, refinement=1, device=CPU)
    _, _, ops = _ordered(
        *_pencil(t_ops, DT), spmm_kernel.rcm_permutation,
        spmm_kernel.sort_rows_by_window,
    )
    return t_ops, ops


@pytest.fixture(scope="module")
def cavity():
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


@pytest.mark.parametrize("name", OPS)
def test_pack_layout(cylinder, name):
    _, ops = cylinder
    a = ops[name]
    pack = spmm_kernel.pack_ell(a, device=CPU)
    assert pack.shape == a.shape
    assert pack.cols.dtype == torch.int32
    assert pack.row_nnz.dtype == torch.int32
    assert pack.data.shape[1] == int(np.diff(a.indptr).max())
    assert pack.nnz == a.nnz
    # Slots past row_nnz are padding: value 0 at column 0.
    slot = torch.arange(pack.data.shape[1])[None, :]
    pad = slot >= pack.row_nnz[:, None].long()
    assert torch.all(pack.data[pad] == 0) and torch.all(pack.cols[pad] == 0)
    back = ell_to_scipy(ELL(pack.data, pack.cols.long(), pack.shape))
    assert (back != a).nnz == 0
    p32 = spmm_kernel.pack_ell(a, device=CPU, dtype=torch.float32)
    assert p32.data.dtype == torch.float32 and p32.cols.dtype == torch.int32
    assert torch.equal(p32.cols, pack.cols)


@pytest.mark.parametrize("b", [1, 8, 37])
@pytest.mark.parametrize("name", OPS)
def test_spmm_matches_scipy_and_reference(cylinder, name, b):
    _, ops = cylinder
    a = ops[name]
    rng = np.random.default_rng(b)
    x = rng.standard_normal((a.shape[1], b))
    pack = spmm_kernel.pack_ell(a, device=CPU, dtype=torch.float64)
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


def test_spmm_refuses_other_devices(cylinder):
    _, ops = cylinder
    pack = spmm_kernel.pack_ell(ops["m"], device=CPU)
    x = torch.zeros((ops["m"].shape[1], 2), device="meta")
    with pytest.raises(ValueError, match="no SpMM kernel"):
        spmm_kernel.spmm(pack, x)
