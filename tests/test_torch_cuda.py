"""The hand-written CUDA convection kernel (csrc/conv_p2.cu) on the card.

The kernel has no CPU mode, so every test here is marked `cuda` and
skips without a card. This file imports only the port (no jax), so it
also runs on a machine without the reference installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Inputs are the cylinder wake's element tensor and maps (Re=100,
refinement 1) at the batch widths the main path uses; the kernel must
match the plain torch version to 1e-5 relative in float32.
"""
import numpy as np
import pytest
import torch

from optconpy_tpu_torch import interop
from optconpy_tpu_torch.fem.device_conv import ConvKernel, FusedConvKernel
from optconpy_tpu_torch.models.cylinder import cylinder_setup
from optconpy_tpu_torch.ops import conv_kernel

pytestmark = pytest.mark.cuda


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    dev = torch.device("cuda", 0)
    np_ops, _, cond = cylinder_setup(
        re=100.0, refinement=1, device=torch.device("cpu")
    )
    fused = FusedConvKernel.build(np_ops["full"], cond, device=dev)
    return dev, fused, np_ops["vbar_full"]


@pytest.mark.parametrize("b", [1, 3, 1024])
def test_kernel_matches_plain(card, b):
    dev, fused, vbar_full = card
    rng = np.random.default_rng(b)
    v = vbar_full[:, None] + 0.1 * rng.standard_normal((vbar_full.size, b))
    v = torch.as_tensor(v, dtype=torch.float32).to(dev)
    before = conv_kernel.launches
    got = fused.conv_full_batch(v)
    plain = conv_kernel.conv_full_batch_plain(
        v, fused.t0, fused.tri_dofs, fused.scatter_slots, fused.ns
    )
    torch.cuda.synchronize()
    assert conv_kernel.launches == before + 1
    assert got.shape == (2 * fused.ns, b)
    assert _rel(got, plain) <= 1e-5


def test_kernel_is_deterministic(card):
    dev, fused, _ = card
    v = torch.randn((2 * fused.ns, 257), device=dev,
                    generator=torch.Generator(dev).manual_seed(0))
    a = fused.conv_full_batch(v)
    b = fused.conv_full_batch(v)
    assert torch.equal(a, b)


def test_inner_batch_matches_plain_kernel(card):
    dev, fused, vbar_full = card
    plain = ConvKernel.from_arrays(
        interop.flatten_arrays(fused), device=dev, dtype=torch.float32
    )
    rng = np.random.default_rng(9)
    v = torch.as_tensor(
        rng.standard_normal((5, fused.n_free)), dtype=torch.float32
    ).to(dev)
    assert _rel(fused.conv_inner_batch(v), plain.conv_inner_batch(v)) <= 1e-5


def test_wrapper_refuses_bad_inputs(card):
    dev, fused, _ = card
    args = (fused.t0, fused.tri_dofs, fused.scatter_slots, fused.ns)
    with pytest.raises(TypeError, match="float32"):
        conv_kernel.conv_full_batch(
            torch.zeros((2 * fused.ns, 4), dtype=torch.float64, device=dev),
            *args,
        )
    with pytest.raises(ValueError, match="contiguous"):
        conv_kernel.conv_full_batch(
            torch.zeros((4, 2 * fused.ns), device=dev).T, *args
        )
    with pytest.raises(ValueError, match="shape"):
        conv_kernel.conv_full_batch(
            torch.zeros((2 * fused.ns + 1, 4), device=dev), *args
        )
    with pytest.raises(TypeError, match="float32"):
        fused.to(dtype=torch.float64)
