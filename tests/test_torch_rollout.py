"""Port fused closed loop (mpc/nse_rollout.py) and the whole slice vs
reference.

The slice end to end: each package runs its own shifts, inverse stack,
DRE sweep, fused step build and batched closed loop on the cylinder
(Re=100, refinement 1, f64), 3 scenarios x 5 steps, in both feedback
modes; gains, vs, us and ys agree to 1e-8 relative (the gains'
tolerance carries through). The rollout alone, fed identical operators
and gains through interop, agrees to 1e-10.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import threadpoolctl
import torch

from optconpy_tpu.fem.device_conv import ConvKernel as JConvKernel
from optconpy_tpu.models.cylinder import cylinder_setup as j_cylinder_setup
from optconpy_tpu.mpc.nse_rollout import batched_nse_closed_loop as j_loop
from optconpy_tpu.mpc.nse_rollout import build_nse_fused as j_build_fused
from optconpy_tpu.riccati import dre_backward_sweep as j_dre_sweep
from optconpy_tpu.riccati import dre_shift_schedule_dae as j_schedule
from optconpy_tpu.riccati import load_or_build_inverse_stack as j_stack
from optconpy_tpu.solvers.saddle import (
    SaddleShiftedInverseCache as JInverseCache,
)
from optconpy_tpu import native as j_native
from optconpy_tpu_torch import interop
from optconpy_tpu_torch.fem.device_conv import ConvKernel, FusedConvKernel
from optconpy_tpu_torch.models.cylinder import (
    cylinder_setup as t_cylinder_setup,
)
from optconpy_tpu_torch.mpc import (
    NSEFusedCache,
    batched_nse_closed_loop,
    build_nse_fused,
)
from optconpy_tpu_torch.riccati import (
    dre_backward_sweep,
    dre_shift_schedule_dae,
    load_or_build_inverse_stack,
)
from optconpy_tpu_torch.solvers.saddle import SaddleShiftedInverseCache

CPU = torch.device("cpu")
DT, ALPHA = 0.005, 1e-2
NUM_SHIFTS, N_ADI, R_MAX, NTS_GAIN = 2, 4, 8, 2
S, NTS = 3, 5
MODES = ["explicit", "implicit"]


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _at_til(ops):
    return (ops["A"].T - ops["M"] / (2.0 * DT)).tocsr()


def _reference_slice(ops, sys, cond):
    sig, sseq, iseq = j_schedule(
        ops["A"], ops["M"], ops["J"], DT, num_shifts=NUM_SHIFTS, n_adi=N_ADI
    )
    inv, _ = j_stack(_at_til(ops), ops["M"], ops["J"], sig, np.float64)
    _, ks = j_dre_sweep(
        sys, JInverseCache(jnp.asarray(inv), sys.n), ALPHA, DT, NTS_GAIN,
        jnp.asarray(sseq), jnp.asarray(iseq), n_newton=1, r_max=R_MAX,
    )
    conv = JConvKernel.build(ops["full"], cond, dtype=jnp.float64)
    return ks, conv, j_build_fused(ops, cond, DT, dtype=jnp.float64)


def _port_slice(ops, sys, cond):
    sig, sseq, iseq = dre_shift_schedule_dae(
        ops["A"], ops["M"], ops["J"], DT, num_shifts=NUM_SHIFTS, n_adi=N_ADI
    )
    inv, _ = load_or_build_inverse_stack(
        _at_til(ops), ops["M"], ops["J"], sig, np.float64
    )
    _, ks = dre_backward_sweep(
        sys, SaddleShiftedInverseCache(torch.as_tensor(inv), sys.n),
        ALPHA, DT, NTS_GAIN, sseq, iseq, n_newton=1, r_max=R_MAX,
    )
    conv = FusedConvKernel.build(ops["full"], cond, device=CPU,
                                 dtype=torch.float64)
    return ks, conv, build_nse_fused(ops, cond, DT, device=CPU,
                                     dtype=torch.float64)


@pytest.fixture(scope="module", autouse=True)
def _one_host_thread():
    """One torch and one BLAS thread for the module: host BLAS/LAPACK
    work runs many times slower when busy-waiting BLAS threads share
    the cores with other test workers."""
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(1):
        yield


@pytest.fixture(scope="module")
def slices():
    with pytest.MonkeyPatch.context() as mp:
        # the reference's numpy element path, the port's only one
        mp.setattr(j_native, "available", lambda: False)
        j_ops, j_sys, j_cond = j_cylinder_setup(re=100.0, refinement=1)
    t_ops, t_sys, t_cond = t_cylinder_setup(re=100.0, refinement=1,
                                            device=CPU)
    n, m = t_sys.b.shape
    rng = np.random.default_rng(0)
    vbar = t_cond.restrict(t_ops["vbar_full"])
    inputs = {
        "v0": vbar[None] + 1e-3 * rng.standard_normal((S, n)),
        "ws": 1e-3 * rng.standard_normal((NTS + 1, n)),
        "ks": 1e-3 * rng.standard_normal((NTS + 1, m, n)),
    }
    return (
        (j_sys, *_reference_slice(j_ops, j_sys, j_cond)),
        (t_sys, *_port_slice(t_ops, t_sys, t_cond)),
        inputs,
    )


def test_fused_cache_bitwise(slices):
    (_, _, _, j_cache), (_, _, _, t_cache), _ = slices
    assert t_cache.dt == j_cache.dt == DT
    for key in ("pmat", "inv_vv", "gmat", "c0", "vbar"):
        assert np.array_equal(
            getattr(t_cache, key).numpy(), np.asarray(getattr(j_cache, key))
        ), key


@pytest.mark.parametrize("feedback", MODES)
def test_slice_end_to_end_matches_reference(slices, feedback):
    """Shifts -> stack -> DRE -> fused build -> closed loop, each package
    on its own; k0 broadcast over the horizon as the bench runs it."""
    (j_sys, j_ks, j_conv, j_cache), (t_sys, t_ks, t_conv, t_cache), inp = (
        slices
    )
    assert _rel(t_ks, j_ks) <= 1e-8
    n, m = t_sys.b.shape
    ref = j_loop(
        j_sys, j_conv, j_cache, jnp.broadcast_to(j_ks[0], (NTS + 1, m, n)),
        jnp.asarray(inp["ws"]), jnp.asarray(inp["v0"]), ALPHA, DT,
        feedback=feedback,
    )
    got = batched_nse_closed_loop(
        t_sys, t_conv, t_cache, t_ks[0].expand(NTS + 1, m, n),
        torch.as_tensor(inp["ws"]), torch.as_tensor(inp["v0"]), ALPHA, DT,
        feedback=feedback,
    )
    shapes = [(S, NTS + 1, n), (S, NTS, m), (S, NTS + 1, 2)]
    for name, g, r, shape in zip(("vs", "us", "ys"), got, ref, shapes):
        assert tuple(g.shape) == shape, name
        assert _rel(g, r) <= 1e-8, (name, _rel(g, r))


@pytest.mark.parametrize("feedback", MODES)
def test_rollout_matches_reference_on_same_operators(slices, feedback):
    """Identical gains and fused operators, handed to the port through
    interop: only the device math differs."""
    (j_sys, _, j_conv, j_cache), _, inp = slices
    t_sys = interop.dae_from_arrays(interop.flatten_arrays(j_sys), device=CPU)
    t_conv = ConvKernel.from_arrays(interop.flatten_arrays(j_conv), device=CPU)
    t_cache = interop.nse_fused_from_arrays(
        interop.flatten_arrays(j_cache), device=CPU
    )
    ref = j_loop(
        j_sys, j_conv, j_cache, jnp.asarray(inp["ks"]),
        jnp.asarray(inp["ws"]), jnp.asarray(inp["v0"]), ALPHA, DT,
        feedback=feedback,
    )
    got = batched_nse_closed_loop(
        t_sys, t_conv, t_cache, torch.as_tensor(inp["ks"]),
        torch.as_tensor(inp["ws"]), torch.as_tensor(inp["v0"]), ALPHA, DT,
        feedback=feedback,
    )
    for name, g, r in zip(("vs", "us", "ys"), got, ref):
        assert _rel(g, r) <= 1e-10, (name, _rel(g, r))


def test_closed_loop_guards(slices):
    _, (t_sys, _, t_conv, t_cache), inp = slices
    args = (
        torch.as_tensor(inp["ks"]), torch.as_tensor(inp["ws"]),
        torch.as_tensor(inp["v0"]), ALPHA,
    )
    with pytest.raises(ValueError, match="dt"):
        batched_nse_closed_loop(t_sys, t_conv, t_cache, *args, 2 * DT)
    with pytest.raises(TypeError, match="NSEFusedCache"):
        batched_nse_closed_loop(t_sys, t_conv, object(), *args, DT)
    with pytest.raises(ValueError, match="feedback"):
        batched_nse_closed_loop(
            t_sys, t_conv, t_cache, *args, DT, feedback="lagged"
        )


def test_fused_cache_to_casts_every_array(slices):
    _, (_, _, _, t_cache), _ = slices
    c32 = t_cache.to(CPU, torch.float32)
    assert isinstance(c32, NSEFusedCache) and c32.dt == t_cache.dt
    for key in ("pmat", "inv_vv", "gmat", "c0", "vbar"):
        x32, x64 = getattr(c32, key), getattr(t_cache, key)
        assert x32.dtype == torch.float32, key
        assert torch.equal(x32, x64.float()), key
