"""Port convection (fem/device_conv.py, ops/conv_kernel.py) vs reference.

The plain torch path must reproduce the reference ConvKernel in f64 and
the reference Pallas kernel (run in interpret mode, as
tests/test_quad_conv.py runs it) in f32. The CUDA kernel itself runs
only on a card: tests/test_torch_cuda.py holds its tests.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optconpy_tpu.fem.device_conv import ConvKernel as JConvKernel
from optconpy_tpu.models.cylinder import cylinder_setup as j_cylinder_setup
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


@pytest.fixture(scope="module")
def kernels():
    torch.set_num_threads(1)
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
    _, t_conv, v_batch, _ = kernels
    fused = FusedConvKernel.from_arrays(
        interop.flatten_arrays(t_conv), device=CPU, dtype=torch.float64
    )
    before = conv_kernel.launches
    got = fused.conv_inner_batch(torch.as_tensor(v_batch))
    assert torch.equal(got, t_conv.conv_inner_batch(torch.as_tensor(v_batch)))
    got = fused.conv_inner(torch.as_tensor(v_batch[0]))
    assert torch.equal(got, t_conv.conv_inner(torch.as_tensor(v_batch[0])))
    assert conv_kernel.launches == before


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
    v = torch.empty((2 * t_conv.ns, 4), device="meta")
    with pytest.raises(ValueError, match="meta"):
        conv_kernel.conv_full_batch(
            v, t_conv.t0, t_conv.tri_dofs, t_conv.scatter_slots, t_conv.ns
        )
