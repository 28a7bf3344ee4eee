"""Port (optconpy_tpu_torch) vs reference: host setup, ELL, runtime.

The cylinder wake at Re=100, refinement 1 is assembled by both packages
from the same numpy/scipy math, so every host operator must be bitwise
equal; the port's tensor containers must hold exactly those values.
"""
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import threadpoolctl
import torch

from optconpy_tpu.fem.device_conv import ConvKernel as JConvKernel
from optconpy_tpu.fem.taylor_hood import convection_tensor as j_conv_tensor
from optconpy_tpu.models.cylinder import cylinder_setup as j_cylinder_setup
from optconpy_tpu import native as j_native
from optconpy_tpu_torch import interop
from optconpy_tpu_torch.fem.device_conv import _host_arrays
from optconpy_tpu_torch.fem.taylor_hood import (
    convection_tensor as t_conv_tensor,
)
from optconpy_tpu_torch.models.cylinder import (
    cylinder_setup as t_cylinder_setup,
)
from optconpy_tpu_torch.ops.sparse import (
    GATHER_BUDGET_BYTES,
    chunk_columns,
    ell_from_scipy,
    ell_to_scipy,
)

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_host_thread():
    """One torch and one BLAS thread for the module: host BLAS/LAPACK
    work runs many times slower when busy-waiting BLAS threads share
    the cores with other test workers."""
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(1):
        yield


@pytest.fixture(scope="module")
def cyl():
    with pytest.MonkeyPatch.context() as mp:
        # the reference's numpy element path, the port's only one
        mp.setattr(j_native, "available", lambda: False)
        ref = j_cylinder_setup(re=100.0, refinement=1)
    port = t_cylinder_setup(re=100.0, refinement=1, device=CPU)
    return ref, port


def _csr_equal(a, b):
    a, b = sp.csr_matrix(a), sp.csr_matrix(b)
    return (
        a.shape == b.shape
        and np.array_equal(a.indptr, b.indptr)
        and np.array_equal(a.indices, b.indices)
        and np.array_equal(a.data, b.data)
    )


@pytest.mark.parametrize("name", ["M", "A", "J"])
def test_sparse_operators_bitwise(cyl, name):
    (j_ops, _, _), (t_ops, _, _) = cyl
    assert _csr_equal(j_ops[name], t_ops[name])


def test_dense_setup_arrays_bitwise(cyl):
    (j_ops, j_sys, j_cond), (t_ops, t_sys, t_cond) = cyl
    assert t_sys.b.shape == (4396, 4) and t_sys.n_p == 641
    for key in ("B", "C", "vbar_full"):
        assert np.array_equal(j_ops[key], t_ops[key]), key
    assert np.array_equal(j_cond.free, t_cond.free)
    assert np.array_equal(j_cond.g, t_cond.g)
    assert np.array_equal(
        j_conv_tensor(j_ops["full"]), t_conv_tensor(t_ops["full"])
    )


def test_conv_maps_bitwise(cyl):
    (j_ops, _, j_cond), (t_ops, _, t_cond) = cyl
    j_h = JConvKernel._host_arrays(j_ops["full"], j_cond)
    t_h = _host_arrays(t_ops["full"], t_cond)
    assert np.array_equal(j_h["tri_dofs"], t_h["tri_dofs"])
    assert np.array_equal(j_h["slots"], t_h["scatter_slots"])
    assert np.array_equal(j_h["dir_values"], t_h["dir_values"])


def test_dae_system_matches_reference(cyl):
    """The port's DAESystem holds the reference's ELL arrays exactly,
    and interop rebuilds the same object from the reference's."""
    (_, j_sys, _), (_, t_sys, _) = cyl
    j_arr = interop.flatten_arrays(j_sys)
    t_arr = interop.flatten_arrays(t_sys)
    assert set(j_arr) == set(t_arr)
    for key in j_arr:
        assert np.array_equal(j_arr[key], t_arr[key]), key
    fed = interop.dae_from_arrays(j_arr, device=CPU)
    for key, val in interop.flatten_arrays(fed).items():
        assert np.array_equal(val, t_arr[key]), key
    assert fed.mass.shape == t_sys.mass.shape
    assert fed.jmat_t.shape == t_sys.jmat_t.shape


def test_dae_system_to_casts_values_only(cyl):
    _, (_, t_sys, _) = cyl
    s32 = t_sys.to(CPU, torch.float32)
    assert s32.b.dtype == torch.float32
    assert s32.mass.data.dtype == torch.float32
    assert s32.mass.cols.dtype == torch.int64


def test_ell_roundtrip_and_dense(cyl):
    _, (t_ops, t_sys, _) = cyl
    assert _csr_equal(ell_to_scipy(t_sys.stiff), t_ops["A"])
    dense = t_sys.jmat.todense().numpy()
    np.testing.assert_array_equal(dense, t_ops["J"].toarray())


def test_ell_matmat_matches_scipy_and_reference(cyl):
    (_, j_sys, _), (t_ops, t_sys, _) = cyl
    rng = np.random.default_rng(0)
    x = rng.standard_normal((t_sys.n, 7))
    ref = t_ops["M"] @ x
    got = t_sys.mass.matmat(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-13, atol=1e-15)
    j_got = np.asarray(j_sys.mass.matmat(jnp.asarray(x)))
    np.testing.assert_allclose(got, j_got, rtol=1e-13, atol=1e-15)
    xv = x[:, 0]
    np.testing.assert_allclose(
        t_sys.mass.matvec(torch.as_tensor(xv)).numpy(), ref[:, 0],
        rtol=1e-13, atol=1e-15,
    )


def test_ell_chunk_budget_uses_itemsize(cyl):
    """The (m, k, chunk) gather stays under the budget for f64 too, and
    a chunked product equals the unchunked one."""
    _, (t_ops, t_sys, _) = cyl
    m, k = t_sys.mass.data.shape
    for itemsize in (4, 8):
        cb = chunk_columns(m, k, itemsize)
        assert cb % 128 == 0
        assert cb == 128 or m * k * itemsize * cb <= GATHER_BUDGET_BYTES
    assert chunk_columns(m, k, 8) < chunk_columns(m, k, 4)
    # Force chunking: wider than one f64 chunk of this operator.
    b = chunk_columns(m, k, 8) + 37
    rng = np.random.default_rng(1)
    x = rng.standard_normal((t_sys.n, b))
    got = t_sys.mass.matmat(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, t_ops["M"] @ x, rtol=1e-13, atol=1e-15)


def test_ell_pad_to_rounds_row_width(cyl):
    _, (t_ops, _, _) = cyl
    ell = ell_from_scipy(t_ops["J"], device=CPU, pad_to=8)
    assert ell.row_nnz % 8 == 0
    assert _csr_equal(ell_to_scipy(ell), t_ops["J"])


def test_runtime_setup_is_strict_fp32():
    from optconpy_tpu_torch.utils import setup

    setup()
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_port_never_imports_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import optconpy_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "for m in ('ops.cuda_build', 'ops.spmm_kernel', 'solvers.ns_inverse',"
        " 'riccati.validate', 'models.cavity', 'optcont', 'control',"
        " 'control.lqr', 'mpc.rollout', 'utils', 'utils.cache',"
        " 'utils.config', 'utils.metrics', 'utils.vtk', 'ops.dense',"
        " 'solvers.shifted', 'fem.heat1d', 'fem.operators', 'solvers.krylov',"
        " 'solvers.matfree', 'fem.device_conv', 'mpc.receding', 'parallel',"
        " 'parallel.param_sweep', 'parallel.mesh', 'parallel.sharded_mpc',"
        " 'parallel.dryrun', 'scripts', 'scripts.validate_gains',"
        " 'scripts.config3_cylinder', 'scripts.config3xl_cylinder'):\n"
        "    assert 'optconpy_tpu_torch.' + m in sys.modules, m\n"
        "from optconpy_tpu_torch.solvers.krylov import fgmres\n"
        "from optconpy_tpu_torch.solvers.matfree import SaddleMatfreeCache\n"
        "from optconpy_tpu_torch.fem.device_conv import QuadConvKernel\n"
        "from optconpy_tpu_torch.mpc import build_nse_stepper_matfree\n"
        "from optconpy_tpu_torch.mpc.receding import receding_horizon_mpc\n"
        "from optconpy_tpu_torch.solvers.ns_inverse import NSShiftStack\n"
        "from optconpy_tpu_torch.parallel.param_sweep import ("
        "build_sweep_gains_and_caches, masked_sweep_stats, sweep_rollout)\n"
        "from optconpy_tpu_torch.mpc.nse_rollout import ("
        "build_sweep_steppers_ns_chain, nse_closed_loop_outputs,"
        " nse_sweep_outputs)\n"
        "from optconpy_tpu_torch.riccati import ("
        "build_dre_cache_dae_krylov, build_dre_cache_dae_matfree)\n"
        "from optconpy_tpu_torch.parallel import ("
        "init_multihost, replicate, scenario_mesh, shard_scenarios,"
        " sharded_closed_loop, sharded_nse_rollout, sharded_sweep_rollout)\n"
        "from optconpy_tpu_torch.parallel.dryrun import dryrun_multichip\n"
        "from optconpy_tpu_torch.riccati.validate import leray_projector\n"
        "from optconpy_tpu_torch.scripts.config3_cylinder import ("
        "shift_interval, run)\n"
        "from optconpy_tpu_torch.scripts.config3xl_cylinder import run\n"
        "from optconpy_tpu_torch.scripts.validate_gains import certify, run\n"
        "assert 'jax' not in sys.modules\n"
        "assert not any(k.startswith('optconpy_tpu.') or k == 'optconpy_tpu'"
        " for k in sys.modules)\n"
        "print('ok', len([k for k in sys.modules"
        " if k.startswith('optconpy_tpu_torch')]))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=300, cwd=Path(__file__).resolve().parents[1],
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok ")
    assert int(out.stdout.split()[1]) >= 40


def test_port_setup_never_loads_native_library():
    """The port's cylinder setup assembles with numpy alone: it neither
    imports a native loader nor maps liboptconpy_native into the
    process, so its operators do not depend on where a library was
    built."""
    code = (
        "import sys, torch\n"
        "from optconpy_tpu_torch.models.cylinder import cylinder_setup\n"
        "ops, sys_, _ = cylinder_setup(re=100.0, refinement=1,"
        " device=torch.device('cpu'))\n"
        "assert sys_.n == 4396\n"
        "maps = open('/proc/self/maps').read()\n"
        "assert 'liboptconpy_native' not in maps\n"
        "assert not any('native' in k for k in sys.modules"
        " if k.startswith('optconpy_tpu'))\n"
        "assert 'jax' not in sys.modules\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=300, cwd=Path(__file__).resolve().parents[1],
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
