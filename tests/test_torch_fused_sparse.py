"""The fused step's sparse P (mpc/nse_rollout.py): build_nse_fused packs
P = M/dt + L1 for the SpMM kernel, and batched_nse_closed_loop_fused
computes x0 = inv_vv (P v - N(v)v) through it where the cache holds the
pack, and the two dense products pmat v - inv_vv N(v)v where it does
not.

On the cylinder (Re=100, refinement 1), port only: the pack holds P
(1e-12 against scipy), the sparse form equals the dense form of the same
cache in f64 (1e-12, both feedback modes, both schemes), the f32 sparse
form stays within 2e-6 of the f64 dense form over 64 steps, a cache
without the pack takes the dense form, each form bumps its counter once
a step, and to() casts the pack.
"""
import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import threadpoolctl
import torch

from optconpy_tpu_torch.fem.device_conv import FusedConvKernel
from optconpy_tpu_torch.fem.taylor_hood import convection_matrices
from optconpy_tpu_torch.models.cylinder import cylinder_setup
from optconpy_tpu_torch.mpc import batched_nse_closed_loop, build_nse_fused
from optconpy_tpu_torch.mpc import nse_rollout
from optconpy_tpu_torch.ops.spmm_kernel import spmm_plain

CPU = torch.device("cpu")
F32, F64 = torch.float32, torch.float64
DT, ALPHA = 0.005, 1e-2
S, NTS, NTS_LONG = 3, 5, 64
MODES = ["explicit", "implicit"]
SCHEMES = ["oseen", "explicit"]


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.fixture(scope="module", autouse=True)
def _one_host_thread():
    """One torch and one BLAS thread for the module (as the other port
    test modules: busy-waiting BLAS threads slow the other workers)."""
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(1):
        yield


@pytest.fixture(scope="module")
def wake():
    np_ops, sys, cond = cylinder_setup(re=100.0, refinement=1, device=CPU,
                                       dtype=F64)
    n, m = sys.b.shape
    caches = {scheme: build_nse_fused(np_ops, cond, DT, device=CPU,
                                      dtype=F64, scheme=scheme)
              for scheme in SCHEMES}
    conv = {dtype: FusedConvKernel.build(np_ops["full"], cond, device=CPU,
                                         dtype=dtype)
            for dtype in (F32, F64)}
    rng = np.random.default_rng(0)
    vbar = caches["oseen"].vbar.numpy()
    inputs = {
        "v0": torch.as_tensor(vbar[None] + 1e-3 * rng.standard_normal((S, n))),
        "ks": torch.as_tensor(1e-3 * rng.standard_normal((NTS + 1, m, n))),
        "ws": torch.as_tensor(1e-3 * rng.standard_normal((NTS + 1, n))),
    }
    return np_ops, sys, cond, caches, conv, inputs


def _dense(cache):
    return dataclasses.replace(cache, ppack=None)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_pack_holds_p(wake, scheme):
    """ppack is M/dt + L1(vbar) (M/dt for the explicit scheme), and the
    reference's pmat is inv_vv times it."""
    np_ops, _, cond, caches, _, _ = wake
    cache = caches[scheme]
    p = sp.csr_matrix(np_ops["M"]) / DT
    if scheme == "oseen":
        l1, _ = convection_matrices(np_ops["full"], np_ops["vbar_full"])
        p = p + sp.csr_matrix(cond.mat_inner(l1))
    x = np.random.default_rng(1).standard_normal((p.shape[1], 4))
    got = spmm_plain(cache.ppack, torch.as_tensor(x))
    assert cache.ppack.shape == p.shape and cache.ppack.nnz == p.nnz
    assert _rel(got, torch.as_tensor(p @ x)) <= 1e-12
    w_px = cache.inv_vv @ got
    assert _rel(w_px, cache.pmat @ torch.as_tensor(x)) <= 1e-10


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("feedback", MODES)
def test_sparse_form_equals_dense_form_f64(wake, scheme, feedback):
    _, sys, _, caches, conv, inp = wake
    cache = caches[scheme]
    args = (inp["ks"], inp["ws"], inp["v0"], ALPHA, DT)
    got = batched_nse_closed_loop(sys, conv[F64], cache, *args,
                                  feedback=feedback)
    ref = batched_nse_closed_loop(sys, conv[F64], _dense(cache), *args,
                                  feedback=feedback)
    for name, g, r in zip(("vs", "us", "ys"), got, ref):
        assert g.shape == r.shape, name
        assert _rel(g, r) <= 1e-12, (name, _rel(g, r))


@pytest.mark.parametrize("feedback", MODES)
def test_f32_sparse_form_holds_f64_dense_form(wake, feedback):
    """64 steps of the rollout cell's arithmetic (f32 sparse P) against
    the f64 dense form: the rounding stays at the dense f32 form's scale
    (the y limit of the rollout cell is 3e-5)."""
    _, sys, _, caches, conv, inp = wake
    cache = caches["oseen"]
    n, m = sys.b.shape
    k0 = inp["ks"][0]
    ks = k0.expand(NTS_LONG + 1, m, n)
    ws = torch.zeros((NTS_LONG + 1, n), dtype=F64)
    _, _, ref = batched_nse_closed_loop(sys, conv[F64], _dense(cache), ks,
                                        ws, inp["v0"], ALPHA, DT,
                                        feedback=feedback)
    c32 = cache.to(CPU, F32)
    _, _, got = batched_nse_closed_loop(
        sys.to(dtype=F32), conv[F32], c32, ks.float(), ws.float(),
        inp["v0"].float(), ALPHA, DT, feedback=feedback)
    assert got.shape == (S, NTS_LONG + 1, sys.p_out)
    assert _rel(got.double(), ref) <= 2e-6


@pytest.mark.parametrize("with_pack", [True, False])
def test_each_form_counts_its_steps(wake, with_pack):
    """A cache with the pack takes the sparse form, one without it (as
    interop and hand-built caches are) the dense form; each bumps its
    counter once a step."""
    _, sys, _, caches, conv, inp = wake
    cache = caches["oseen"] if with_pack else _dense(caches["oseen"])
    before = (nse_rollout.fused_sparse_steps, nse_rollout.fused_dense_steps)
    batched_nse_closed_loop(sys, conv[F64], cache, inp["ks"], inp["ws"],
                            inp["v0"], ALPHA, DT)
    after = (nse_rollout.fused_sparse_steps, nse_rollout.fused_dense_steps)
    want = (NTS, 0) if with_pack else (0, NTS)
    assert (after[0] - before[0], after[1] - before[1]) == want


def test_to_casts_the_pack(wake):
    _, _, _, caches, _, _ = wake
    cache = caches["oseen"]
    c32 = cache.to(CPU, F32)
    assert c32.ppack.dtype == F32 and c32.ppack.shape == cache.ppack.shape
    assert torch.equal(c32.ppack.evals, cache.ppack.evals.float())
    assert torch.equal(c32.ppack.ecol, cache.ppack.ecol)
    assert torch.equal(c32.ppack.eptr, cache.ppack.eptr)
    assert c32.ppack.smem_bytes < cache.ppack.smem_bytes  # 4-byte values
    assert _dense(cache).to(CPU, F32).ppack is None
