"""Port convection (fem/device_conv.py, ops/conv_kernel.py) vs reference.

The plain torch path must reproduce the reference ConvKernel in f64 and
the reference Pallas kernel (run in interpret mode, as
tests/test_quad_conv.py runs it) in f32. The CUDA kernel itself runs
only on a card: tests/test_torch_cuda.py holds its tests.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import threadpoolctl
import torch

from optconpy_tpu.fem.device_conv import ConvKernel as JConvKernel
from optconpy_tpu.models.cylinder import cylinder_setup as j_cylinder_setup
from optconpy_tpu import native as j_native
from optconpy_tpu_torch import interop
from optconpy_tpu_torch.fem.device_conv import ConvKernel, FusedConvKernel
from optconpy_tpu_torch.models.cylinder import (
    cylinder_setup as t_cylinder_setup,
)
from optconpy_tpu_torch.ops import conv_kernel

CPU = torch.device("cpu")
B = 3


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


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
        j_ops, _, j_cond = j_cylinder_setup(re=100.0, refinement=1)
    t_ops, _, t_cond = t_cylinder_setup(re=100.0, refinement=1, device=CPU)
    j_conv = JConvKernel.build(j_ops["full"], j_cond, dtype=jnp.float64)
    t_conv = ConvKernel.build(t_ops["full"], t_cond, device=CPU)
    vbar = t_cond.restrict(t_ops["vbar_full"])
    rng = np.random.default_rng(7)
    v_batch = vbar[None] + 0.1 * rng.standard_normal((B, t_conv.n_free))
    v_full_t = rng.standard_normal((2 * t_conv.ns, B))
    return j_conv, t_conv, v_batch, v_full_t


def test_conv_full_batch_matches_reference_f64(kernels):
    j_conv, t_conv, _, v_full_t = kernels
    ref = j_conv.conv_full_batch(jnp.asarray(v_full_t))
    got = t_conv.conv_full_batch(torch.as_tensor(v_full_t))
    assert got.shape == (2 * t_conv.ns, B)
    assert _rel(got, ref) <= 1e-12


def test_conv_inner_batch_matches_reference_f64(kernels):
    j_conv, t_conv, v_batch, _ = kernels
    ref = j_conv.conv_inner_batch(jnp.asarray(v_batch))
    got = t_conv.conv_inner_batch(torch.as_tensor(v_batch))
    assert got.shape == (B, t_conv.n_free)
    assert _rel(got, ref) <= 1e-12


def test_conv_single_vector_matches_reference_f64(kernels):
    j_conv, t_conv, v_batch, v_full_t = kernels
    ref = j_conv.conv_full(jnp.asarray(v_full_t[:, 0]))
    got = t_conv.conv_full(torch.as_tensor(v_full_t[:, 0]))
    assert _rel(got, ref) <= 1e-12
    ref = j_conv.conv_inner(jnp.asarray(v_batch[0]))
    got = t_conv.conv_inner(torch.as_tensor(v_batch[0]))
    assert _rel(got, ref) <= 1e-12


def test_conv_plain_f32_matches_pallas_interpret(kernels):
    """The plain f32 version against the TPU kernel's interpreter run."""
    from optconpy_tpu.ops.pallas_conv import (
        conv_full_batch_pallas,
        pack_conv_tensor,
        pad_dofs,
        remap_scatter_slots,
    )

    j_conv, t_conv, _, v_full_t = kernels
    nt = j_conv.tri_dofs.shape[0]
    t0p, nt_pad = pack_conv_tensor(np.asarray(j_conv.t0, np.float32), 64)
    dofs = pad_dofs(np.asarray(j_conv.tri_dofs), nt_pad)
    slots = remap_scatter_slots(
        np.asarray(j_conv.scatter_slots), nt, nt_pad
    )
    v32 = v_full_t.astype(np.float32)
    ref = conv_full_batch_pallas(
        jnp.asarray(v32), jnp.asarray(t0p), jnp.asarray(dofs),
        jnp.asarray(slots), ns=j_conv.ns, e_block=64, b_tile=128,
        interpret=True,
    )
    got = t_conv.to(dtype=torch.float32).conv_full_batch(torch.as_tensor(v32))
    assert got.dtype == torch.float32
    assert _rel(got, ref) <= 1e-5


def test_fused_kernel_on_cpu_takes_plain_path(kernels):
    """On the CPU every evaluation of the fused kernel (one vector, a
    batch, the full dofs) runs the plain ConvKernel's slot sums, bit for
    bit, and launches nothing."""
    _, t_conv, v_batch, v_full_t = kernels
    fused = FusedConvKernel.from_arrays(
        interop.flatten_arrays(t_conv), device=CPU, dtype=torch.float64
    )
    before = conv_kernel.launches
    v = torch.as_tensor(v_batch)
    assert torch.equal(fused.conv_inner_batch(v), t_conv.conv_inner_batch(v))
    assert torch.equal(fused.conv_inner(v[0]), t_conv.conv_inner(v[0]))
    v_full = torch.as_tensor(v_full_t)
    assert torch.equal(fused.conv_full_batch(v_full),
                       t_conv.conv_full_batch(v_full))
    assert conv_kernel.launches == before


def test_kernel_contract_plain_matches_reference_f64(kernels):
    """The plain version of the kernel's free-dof contract, batch-last
    (n_free, B), against the reference's ConvKernel.conv_inner_batch."""
    j_conv, t_conv, v_batch, _ = kernels
    fused = FusedConvKernel.from_arrays(
        interop.flatten_arrays(t_conv), device=CPU, dtype=torch.float64
    )
    v_t = torch.as_tensor(np.ascontiguousarray(v_batch.T))
    got = conv_kernel.conv_inner(v_t, fused)
    assert got.shape == (t_conv.n_free, B)
    ref = j_conv.conv_inner_batch(jnp.asarray(v_batch))
    assert _rel(got.T, ref) <= 1e-12


def test_kernel_contract_plain_f32_matches_pallas_interpret(kernels):
    """The plain f32 free-dof contract against the TPU kernel's
    interpreter run, lifted to the full dofs and restricted back as the
    reference's conv_inner_batch does."""
    from optconpy_tpu.ops.pallas_conv import (
        conv_full_batch_pallas,
        pack_conv_tensor,
        pad_dofs,
        remap_scatter_slots,
    )

    j_conv, t_conv, v_batch, _ = kernels
    nt = j_conv.tri_dofs.shape[0]
    t0p, nt_pad = pack_conv_tensor(np.asarray(j_conv.t0, np.float32), 64)
    dofs = pad_dofs(np.asarray(j_conv.tri_dofs), nt_pad)
    slots = remap_scatter_slots(np.asarray(j_conv.scatter_slots), nt, nt_pad)
    free = np.asarray(j_conv.free)
    v_full = np.repeat(np.asarray(j_conv.dir_values)[:, None], B, axis=1)
    v_full[free] = v_batch.T
    ref = conv_full_batch_pallas(
        jnp.asarray(v_full.astype(np.float32)), jnp.asarray(t0p),
        jnp.asarray(dofs), jnp.asarray(slots), ns=j_conv.ns, e_block=64,
        b_tile=128, interpret=True,
    )
    fused = FusedConvKernel.from_arrays(
        interop.flatten_arrays(t_conv), device=CPU, dtype=torch.float32
    )
    v_t = torch.as_tensor(np.ascontiguousarray(v_batch.T), dtype=torch.float32)
    got = conv_kernel.conv_inner(v_t, fused)
    assert got.dtype == torch.float32
    assert _rel(got, np.asarray(ref)[free]) <= 1e-5


def test_patch_partition(kernels):
    """Every element lies in exactly one patch; each patch's dof list
    holds every slot of its elements once; a free dof whose elements all
    lie in one patch is written there and nowhere else; every other free
    dof is listed once among the shared dofs, with one partial row from
    each patch that touches it; every free row is written."""
    _, t_conv, _, _ = kernels
    tri = t_conv.tri_dofs.numpy()
    ns, nt = t_conv.ns, tri.shape[0]
    plan = conv_kernel.build_conv_plan(
        tri, t_conv.free.numpy(), t_conv.dir_values.numpy(), ns
    )
    pelem, pslot, pdst = plan["pelem"], plan["pslot"], plan["pdst"]
    psptr = plan["psptr"]
    elems = pelem[pelem >= 0]
    assert np.array_equal(np.sort(elems), np.arange(nt))
    assert np.all((pelem >= 0).sum(1) <= conv_kernel.PATCH)
    fmap = np.full(2 * ns, -1)
    fmap[t_conv.free.numpy()] = np.arange(t_conv.n_free)
    owners = {}  # free row -> patches that write it directly
    touched = {}  # free row -> partial rows
    for p in range(pelem.shape[0]):
        n_el, n_dofs = int((pelem[p] >= 0).sum()), plan["pnd"][p]
        ends = psptr[p]
        assert ends[0] == 0 and np.all(np.diff(ends) >= 0)
        assert np.all(ends[n_dofs:] == n_el * 6)
        assert np.array_equal(np.sort(pslot[p, :n_el * 6]), np.arange(n_el * 6))
        assert np.all(pslot[p, n_el * 6:] == -1)
        for k in range(n_dofs):
            sl = pslot[p, ends[k]:ends[k + 1]]
            assert sl.size >= 1 and np.all(np.diff(sl) > 0)
            nodes = tri[pelem[p, sl // 6], sl % 6]
            s = nodes[0]
            assert np.all(nodes == s)
            for a in range(2):
                dst, row = pdst[p, k, a], fmap[a * ns + s]
                if row < 0:
                    assert dst == -1
                elif dst >= 0:
                    assert dst == row
                    owners.setdefault(row, []).append(p)
                else:
                    touched.setdefault(row, []).append(-2 - dst)
    assert all(len(v) == 1 for v in owners.values())
    assert not set(owners) & set(touched)
    bdst = plan["bdst"]
    assert np.array_equal(bdst, np.unique(bdst))
    assert set(bdst.tolist()) == set(touched)
    for row, src in zip(bdst, plan["bsrc"]):
        assert len(touched[row]) >= 2
        assert src[src >= 0].tolist() == touched[row]
    assert len(owners) + len(touched) == t_conv.n_free


def test_interop_conv_kernel_equals_port_build(kernels):
    j_conv, t_conv, _, _ = kernels
    fed = ConvKernel.from_arrays(interop.flatten_arrays(j_conv), device=CPU)
    assert (fed.ns, fed.n_free) == (t_conv.ns, t_conv.n_free)
    for key, val in interop.flatten_arrays(t_conv).items():
        assert np.array_equal(interop.flatten_arrays(fed)[key], val), key


def test_fused_kernel_refuses_f64_on_cuda():
    with pytest.raises(TypeError, match="float32"):
        FusedConvKernel.build(None, None, device="cuda", dtype=torch.float64)


def test_conv_wrapper_refuses_other_devices(kernels):
    _, t_conv, _, _ = kernels
    fused = FusedConvKernel.from_arrays(
        interop.flatten_arrays(t_conv), device=CPU, dtype=torch.float64
    )
    v = torch.empty((t_conv.n_free, 4), device="meta")
    with pytest.raises(ValueError, match="meta"):
        conv_kernel.conv_inner(v, fused)
