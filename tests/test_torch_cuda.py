"""The hand-written CUDA kernels (csrc/conv_p2.cu, csrc/spmm_tile.cu) on
the card.

The kernels have no CPU mode, so every test here is marked `cuda` and
skips without a card. This file imports only the port (no jax), so it
also runs on a machine without the reference installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Inputs come from the cylinder wake (Re=100, refinement 1): the
convection kernel's element tensor and patch plan at the batch widths
of the rollout, and the NS pencil's operators (Atil^T, M, J, J^T in RCM
order) at the widths of the NS build, plus ragged edges (last column
tiles, a small operator with an empty row). Each kernel must match its plain torch
version to 1e-5 relative in float32 (and the SpMM to 1e-12 in float64).

The driver's host-LU solvers apply their factors on the card with
torch.linalg.lu_solve (1-based pivots): on the card they must match the
same factors applied on the CPU to 1e-12 in f64, and the driven-cavity
driver (tests/test_optcont_driver.py's CFG) on the card must match its
CPU run to 1e-10. Its fused f32 run launches the convection kernel once
a step; its Newton-Schulz gain tier launches the SpMM kernel.

The matrix-free tier: FGMRES and SaddleMatfreeCache (f32 and f64, the
cylinder's DRE pencil) and the reference-LU Krylov caches on the card
against the CPU, QuadConvKernel against ConvKernel's plain version, and
the cavity driver on the matfree tiers, card against CPU (1e-8).

Receding-horizon MPC: the dense re-linearization repeats bit for bit on
the card and matches the CPU (1e-12); NSShiftStack's build and refresh
on the card match the CPU (1e-10); the dense_ns macro loop on the
cavity, card against CPU (1e-8).

The parameter sweep: the cavity sweep on the 'lu' steppers, card
against CPU (1e-10); the f32 Newton-Schulz stepper chain certified on
the card; the convection kernel on the sweep's flattened state.

The sharding and the scripts: the ragged cavity sweep through a
one-rank NCCL group equals the one-process sweep bit for bit on the
card and the CPU's statistics to 1e-10; config3xl_cylinder.run at a
small shape (the cavity, f32) launches both kernels and matches its CPU
run (gains 1e-4).
"""
import dataclasses
from dataclasses import replace

import numpy as np
import pytest
import torch

from optconpy_tpu_torch import interop
from optconpy_tpu_torch.fem.device_conv import (
    ConvKernel,
    FusedConvKernel,
    QuadConvKernel,
)
from optconpy_tpu_torch.models.cylinder import cylinder_setup
from optconpy_tpu_torch.ops import conv_kernel, spmm_kernel
from optconpy_tpu_torch.fem.dae import dae_from_scipy
from optconpy_tpu_torch.models.cavity import cavity_stokes_setup
from optconpy_tpu_torch.ops.dense import LUSolver
from optconpy_tpu_torch.optcont import optcon_nse
from optconpy_tpu_torch.solvers.saddle import SaddleLU
from optconpy_tpu_torch.utils import (
    CostConfig,
    OptConConfig,
    ProblemConfig,
    SolverConfig,
    TimeConfig,
)
from optconpy_tpu_torch.riccati import (
    build_dre_cache_dae_krylov,
    build_dre_cache_dae_ns,
    dre_backward_sweep,
    dre_shift_schedule_dae,
    load_or_build_inverse_stack,
)
from optconpy_tpu_torch.solvers.krylov import ShiftedKrylovCache, fgmres
from optconpy_tpu_torch.solvers.matfree import SaddleMatfreeCache
from optconpy_tpu_torch.solvers.ns_inverse import (
    NSShiftStack,
    SaddleOpsPack,
    build_inverse_stack_ns,
)

pytestmark = pytest.mark.cuda


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


DT = 0.005
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def cylinder():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    np_ops, _, cond = cylinder_setup(re=100.0, refinement=1, device=CPU)
    return torch.device("cuda", 0), np_ops, cond


@pytest.fixture(scope="module")
def card(cylinder):
    dev, np_ops, cond = cylinder
    fused = FusedConvKernel.build(np_ops["full"], cond, device=dev)
    return dev, fused, np_ops["vbar_full"]


def _at_til(np_ops):
    return (np_ops["A"].T - np_ops["M"] / (2.0 * DT)).tocsr()


@pytest.fixture(scope="module")
def pencil(cylinder):
    """The NS pack's operators on the card, in float32 and float64."""
    dev, np_ops, _ = cylinder
    packs = {
        dtype: SaddleOpsPack.build(
            _at_til(np_ops), np_ops["M"], np_ops["J"], device=dev,
            dtype=dtype,
        )[0]
        for dtype in (torch.float32, torch.float64)
    }
    return dev, np_ops, packs


@pytest.mark.parametrize("b", [1, 3, 63, 1000, 1024])
def test_kernel_matches_plain(card, b):
    """The free-dof contract (n_free, B) -> (n_free, B) against its plain
    version, the slot sums of ConvKernel (independent of the patch
    plan); B=63 and 1000 leave a ragged last column tile."""
    dev, fused, vbar_full = card
    rng = np.random.default_rng(b)
    v = vbar_full[fused.free.cpu().numpy(), None] + 0.1 * rng.standard_normal(
        (fused.n_free, b)
    )
    v = torch.as_tensor(v, dtype=torch.float32).to(dev)
    before = conv_kernel.launches
    got = conv_kernel.conv_inner(v, fused)
    torch.cuda.synchronize()
    assert conv_kernel.launches == before + 1
    assert got.shape == (fused.n_free, b)
    plain = ConvKernel.from_arrays(
        interop.flatten_arrays(fused), device=dev, dtype=torch.float32
    )
    assert _rel(got, plain.conv_inner_batch_t(v)) <= 1e-5


@pytest.mark.parametrize("b", [3, 1024])
def test_kernel_is_deterministic(card, b):
    dev, fused, _ = card
    v = torch.randn((fused.n_free, b), device=dev,
                    generator=torch.Generator(dev).manual_seed(b))
    a = conv_kernel.conv_inner(v, fused)
    c = conv_kernel.conv_inner(v, fused)
    assert torch.equal(a, c)


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


def test_single_vector_launches_kernel(card):
    """conv_inner of one free-dof vector goes through the kernel (one
    launch); the full-dof evaluations refuse CUDA tensors."""
    dev, fused, vbar_full = card
    plain = ConvKernel.from_arrays(
        interop.flatten_arrays(fused), device=dev, dtype=torch.float32
    )
    v = torch.as_tensor(
        vbar_full[fused.free.cpu().numpy()], dtype=torch.float32
    ).to(dev)
    before = conv_kernel.launches
    got = fused.conv_inner(v)
    torch.cuda.synchronize()
    assert conv_kernel.launches == before + 1
    assert got.shape == (fused.n_free,)
    assert _rel(got, plain.conv_inner(v)) <= 1e-5
    v_full = plain.expand(v)
    with pytest.raises(ValueError, match="free dofs only"):
        fused.conv_full(v_full)
    with pytest.raises(ValueError, match="free dofs only"):
        fused.conv_full_batch(v_full[:, None])
    assert conv_kernel.launches == before + 1


def test_wrapper_refuses_bad_inputs(card):
    dev, fused, _ = card
    n = fused.n_free
    run = conv_kernel.conv_inner
    with pytest.raises(TypeError, match="float32"):
        run(torch.zeros((n, 4), dtype=torch.float64, device=dev), fused)
    with pytest.raises(ValueError, match="contiguous"):
        run(torch.zeros((4, n), device=dev).T, fused)
    with pytest.raises(ValueError, match="shape"):
        run(torch.zeros((n + 1, 4), device=dev), fused)
    with pytest.raises(ValueError, match="is on"):
        run(torch.zeros((n, 4), device=dev), replace(
            fused, plan=replace(fused.plan, pslot=fused.plan.pslot.cpu())))
    with pytest.raises(TypeError, match="int32"):
        run(torch.zeros((n, 4), device=dev), replace(
            fused, plan=replace(fused.plan, pdst=fused.plan.pdst.long())))
    with pytest.raises(TypeError, match="float32"):
        fused.to(dtype=torch.float64)


def _ragged_operator():
    """37 x 53 with a ragged last row tile, an empty row and one row
    spanning every column."""
    import scipy.sparse as sp

    rng = np.random.default_rng(3)
    a = sp.random(37, 53, density=0.15, random_state=rng, format="lil")
    a[5, :] = 0.0
    a[36, :] = rng.standard_normal(53)
    return sp.csr_matrix(a)


@pytest.mark.parametrize("dtype, tol", [
    (torch.float32, 1e-5), (torch.float64, 1e-12),
])
@pytest.mark.parametrize("b", [1, 8, 33, 5037])
@pytest.mark.parametrize("name", ["at", "m", "j", "jt", "ragged"])
def test_spmm_matches_plain(pencil, name, b, dtype, tol):
    """The NS pencil's operators (J the wide one) and a ragged operator
    with an empty row; B=33 and 5037 leave a ragged last column tile."""
    dev, _, packs = pencil
    if name == "ragged":
        a = spmm_kernel.pack_spmm(_ragged_operator(), device=dev, dtype=dtype)
    else:
        a = getattr(packs[dtype], name)
    rng = np.random.default_rng(b)
    x = torch.as_tensor(
        rng.standard_normal((a.shape[1], b)), dtype=dtype
    ).to(dev)
    before = spmm_kernel.launches
    got = spmm_kernel.spmm(a, x)
    plain = spmm_kernel.spmm_plain(a, x)
    torch.cuda.synchronize()
    assert spmm_kernel.launches == before + 1
    assert got.shape == (a.shape[0], b) and got.dtype == dtype
    assert _rel(got, plain) <= tol
    if name == "ragged":
        assert torch.all(got[5] == 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", ["at", "j"])
def test_spmm_is_deterministic(pencil, name, dtype):
    dev, _, packs = pencil
    a = getattr(packs[dtype], name)
    x = torch.randn((a.shape[1], 300), device=dev, dtype=dtype,
                    generator=torch.Generator(dev).manual_seed(1))
    before = spmm_kernel.launches
    assert torch.equal(spmm_kernel.spmm(a, x), spmm_kernel.spmm(a, x))
    assert spmm_kernel.launches == before + 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_spmm_nonfinite_x_as_plain(pencil, dtype):
    """An inf in X spreads to the rows of the groups that hold its column
    (ops/spmm_kernel.py semantics), in the kernel as in the plain version;
    every other row stays finite and matches."""
    dev, _, packs = pencil
    a = packs[dtype].at
    x = torch.randn((a.shape[1], 64), device=dev, dtype=dtype,
                    generator=torch.Generator(dev).manual_seed(2))
    x[a.ecol[a.eptr[7]].long()] = float("inf")
    got = spmm_kernel.spmm(a, x)
    plain = spmm_kernel.spmm_plain(a, x)
    ok = torch.isfinite(plain)
    assert torch.equal(torch.isfinite(got), ok) and not ok.all()
    assert torch.equal(torch.isnan(got), torch.isnan(plain))
    assert _rel(got[ok.all(dim=1)], plain[ok.all(dim=1)]) <= (
        1e-5 if dtype == torch.float32 else 1e-12
    )


def test_spmm_refuses_bad_inputs(pencil):
    dev, _, packs = pencil
    a = packs[torch.float32].m
    n = a.shape[1]
    with pytest.raises(TypeError, match="dtype"):
        spmm_kernel.spmm(a, torch.zeros((n, 4), dtype=torch.float64,
                                        device=dev))
    with pytest.raises(TypeError, match="float32 or float64"):
        spmm_kernel.spmm(replace(a, evals=a.evals.half()),
                         torch.zeros((n, 4), dtype=torch.float16, device=dev))
    with pytest.raises(ValueError, match="contiguous"):
        spmm_kernel.spmm(a, torch.zeros((4, n), device=dev).T)
    with pytest.raises(ValueError, match="shape"):
        spmm_kernel.spmm(a, torch.zeros((n + 1, 4), device=dev))
    with pytest.raises(ValueError, match="n, B"):
        spmm_kernel.spmm(a, torch.zeros((n,), device=dev))
    with pytest.raises(ValueError, match="is on"):
        spmm_kernel.spmm(replace(a, evals=a.evals.cpu()),
                         torch.zeros((n, 4), device=dev))
    with pytest.raises(TypeError, match="int32"):
        spmm_kernel.spmm(replace(a, ecol=a.ecol.long()),
                         torch.zeros((n, 4), device=dev))


def test_ns_stack_on_card_matches_host_splu(cylinder):
    """A 2-shift f64 NS stack built through the kernel on the card vs the
    host splu stack, to 1e-6 (tests/test_ns_inverse.py's bound)."""
    dev, np_ops, _ = cylinder
    sig, _, _ = dre_shift_schedule_dae(
        np_ops["A"], np_ops["M"], np_ops["J"], DT, num_shifts=2, n_adi=2
    )
    at = _at_til(np_ops)
    before = spmm_kernel.launches
    inv, info = build_inverse_stack_ns(
        at, np_ops["M"], np_ops["J"], sig, device=dev, dtype=torch.float64,
        certify_tol=1e-8,
    )
    assert spmm_kernel.launches - before >= 4 * info["ns_passes"]
    assert info["certified"] == [True, True], info["residuals"]
    ref, _ = load_or_build_inverse_stack(
        at, np_ops["M"], np_ops["J"], sig, np.float64
    )
    for i in range(2):
        assert _rel(inv[i], torch.as_tensor(ref[i]).to(dev)) <= 1e-6, i


def test_ns_stack_and_gains_repeat_bit_for_bit(cylinder):
    """Two f32 NS builds of one 2-shift stack, and the DRE gains from
    each, are equal bit for bit within one process."""
    dev, np_ops, _ = cylinder
    sig, sseq, iseq = dre_shift_schedule_dae(
        np_ops["A"], np_ops["M"], np_ops["J"], DT, num_shifts=2, n_adi=2
    )
    sys32 = dae_from_scipy(
        np_ops["M"], np_ops["A"], np_ops["J"], np_ops["B"], np_ops["C"],
        device=dev, dtype=torch.float32,
    )

    def run():
        cache, info = build_dre_cache_dae_ns(sys32, DT, sig)
        _, ks = dre_backward_sweep(sys32, cache, 1e-2, DT, 2, sseq, iseq,
                                   n_newton=1, r_max=8)
        return cache.inv, info["residuals"], ks

    inv_a, res_a, ks_a = run()
    inv_b, res_b, ks_b = run()
    assert res_a == res_b
    assert torch.equal(inv_a, inv_b)
    assert torch.equal(ks_a, ks_b)


# --- the driver's solvers and the driver on the card ------------------------

CAVITY_CFG = OptConConfig(  # tests/test_optcont_driver.py CFG
    problem=ProblemConfig(name="drivencavity", nx=6),
    time=TimeConfig(t0=0.0, t_end=0.4, nts=20),
    cost=CostConfig(alpha=1e-8, ystar="steady_offset", ystar_amp=0.01),
    solver=SolverConfig(
        num_shifts=8, n_adi=20, n_newton=2, r_max=30, dtype="float64"
    ),
)


@pytest.fixture(scope="module")
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the driver runs on the card")
    return torch.device("cuda", 0)


def _rel_np(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("which", ["LUSolver", "SaddleLU"])
def test_lu_solvers_on_card_match_cpu(gpu, which):
    """Host factors applied on the card and on the CPU: a pivot in the
    wrong convention would give wrong solves without an error."""
    rng = np.random.default_rng(5)
    if which == "LUSolver":
        a = rng.standard_normal((300, 300))
        a[[0, 9]] = a[[9, 0]] * 1e-3  # row interchanges from the start
        solvers = [LUSolver.factor(torch.as_tensor(a), device=d)
                   for d in (gpu, CPU)]
        rhs = rng.standard_normal((300, 7))
    else:
        ops, _, _ = cavity_stokes_setup(nx=6, device=CPU)
        f = torch.as_tensor(ops["M"].toarray() / 0.02 - ops["A"].toarray())
        j = torch.as_tensor(ops["J"].toarray())
        solvers = [SaddleLU.build(f.to(d), j.to(d)) for d in (gpu, CPU)]
        rhs = rng.standard_normal((f.shape[0], 7))
    card, host = solvers
    assert card.piv.is_cuda and card.piv.dtype == torch.int32
    assert torch.equal(card.piv.cpu(), host.piv)
    x = torch.as_tensor(rhs)
    got = card.apply(x.to(gpu))
    assert _rel(got.cpu(), host.apply(x)) <= 1e-12
    assert _rel(card.apply(x[:, 0].to(gpu)).cpu(), host.apply(x[:, 0])) <= 1e-12


def test_cavity_driver_on_card_matches_cpu(gpu, tmp_path):
    got = optcon_nse(CAVITY_CFG, cache_dir=str(tmp_path / "card"), device=gpu)
    ref = optcon_nse(CAVITY_CFG, cache_dir=str(tmp_path / "cpu"), device=CPU)
    assert got.gains.is_cuda
    assert _rel(got.gains.cpu(), ref.gains) <= 1e-10
    for a, b in ((got.ys, ref.ys), (got.us, ref.us)):
        assert _rel_np(a, b) <= 1e-10
    assert abs(got.cost - ref.cost) <= 1e-10 * abs(ref.cost)


@pytest.mark.parametrize("dre_solver", ["inverse", "inverse_ns"])
def test_fused_f32_driver_launches_kernels(gpu, tmp_path, dre_solver):
    cfg = dataclasses.replace(CAVITY_CFG, solver=dataclasses.replace(
        CAVITY_CFG.solver, dtype="float32", step_solver="fused",
        dre_solver=dre_solver,
    ))
    conv0, spmm0 = conv_kernel.launches, spmm_kernel.launches
    res = optcon_nse(cfg, v0_batch=None, cache_dir=str(tmp_path), device=gpu)
    assert conv_kernel.launches - conv0 == cfg.time.nts
    assert (spmm_kernel.launches - spmm0 > 0) == (dre_solver == "inverse_ns")
    assert np.isfinite(res.ys).all() and np.isfinite(res.us).all()


# --- the matrix-free tier and the quadrature convection on the card --------

def _nonsymmetric(n, seed):
    rng = np.random.default_rng(seed)
    return np.eye(n) + 0.5 * rng.standard_normal((n, n)) / np.sqrt(n), rng


@pytest.mark.parametrize("dtype, tol, dev_tol", [
    (torch.float32, 1e-5, 1e-4), (torch.float64, 1e-12, 1e-10),
])
def test_fgmres_on_card_matches_cpu(gpu, dtype, tol, dev_tol):
    a, rng = _nonsymmetric(300, 7)
    b = rng.standard_normal((300, 5))
    b[:, 3] = 0.0
    out = []
    for d in (gpu, CPU):
        at = torch.as_tensor(a, dtype=dtype, device=d)
        x, rel = fgmres(lambda v: at @ v, torch.as_tensor(b, dtype=dtype,
                                                        device=d),
                        m=10, tol=tol, max_cycles=30)
        assert rel <= tol and torch.isfinite(x).all()
        out.append(x.cpu())
    assert _rel(out[0], out[1]) <= dev_tol
    assert out[0][:, 3].abs().max() == 0
    bad = torch.as_tensor(a, dtype=dtype, device=gpu)
    bad[2, 2] = float("nan")
    with pytest.raises(RuntimeError, match="not finite"):
        fgmres(lambda v: bad @ v, torch.ones((300, 2), dtype=dtype,
                                             device=gpu), m=10, tol=tol)


@pytest.mark.parametrize("dtype, tol, dev_tol", [
    (torch.float32, 1e-5, 1e-3), (torch.float64, 1e-11, 1e-8),
])
def test_matfree_cache_on_card_matches_cpu(cylinder, dtype, tol, dev_tol):
    """SaddleMatfreeCache of the cylinder's DRE pencil on 2 shifts: each
    solve through the SpMM kernel (5 launches an Arnoldi step) reaches
    the FGMRES tolerance and agrees with the same cache on the CPU."""
    dev, np_ops, _ = cylinder
    sig, _, _ = dre_shift_schedule_dae(
        np_ops["A"], np_ops["M"], np_ops["J"], DT, num_shifts=2, n_adi=2
    )
    c = 1.0 / (2.0 * DT)
    caches = [
        SaddleMatfreeCache.build(
            _at_til(np_ops), np_ops["M"], np_ops["J"], sig, device=d,
            dtype=dtype, schur_offset=-c, max_cycles=12, tol=tol,
        )
        for d in (dev, CPU)
    ]
    rhs = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (np_ops["M"].shape[0], 4)), dtype=dtype)
    for i in range(2):
        before = spmm_kernel.launches
        x, rel = caches[0].solve_relres(i, rhs.to(dev))
        assert spmm_kernel.launches - before >= 5 * 30
        y, rel_cpu = caches[1].solve_relres(i, rhs)
        assert rel <= tol and rel_cpu <= tol
        assert _rel(x.cpu(), y) <= dev_tol, i
        jx = np_ops["J"] @ x.double().cpu().numpy()
        assert np.abs(jx).max() <= 10 * tol * x.abs().max().item()


def test_krylov_caches_on_card_match_cpu(gpu):
    """The reference-LU Krylov caches (host f64 LUs, lu_solve and GMRES on
    the card) against the same caches on the CPU, f64, cavity nx=6."""
    ops, sys_, _ = cavity_stokes_setup(nx=6, device=CPU)
    sig, _, _ = dre_shift_schedule_dae(ops["A"], ops["M"], ops["J"], 0.02,
                                       num_shifts=4, n_adi=4)
    rhs = torch.as_tensor(np.random.default_rng(4).standard_normal(
        (sys_.n, 3)))
    s_card = sys_.to(gpu)
    saddle = [build_dre_cache_dae_krylov(s, 0.02, sig) for s in (s_card, sys_)]
    plain = [ShiftedKrylovCache.build(s.stiff.todense().T, s.mass, sig)
             for s in (s_card, sys_)]
    for i in range(4):
        for card_cache, host_cache in (saddle, plain):
            got = card_cache.solve(i, rhs.to(gpu))
            assert got.is_cuda
            assert _rel(got.cpu(), host_cache.solve(i, rhs)) <= 1e-10, i


def test_quad_conv_on_card_matches_plain(cylinder, card):
    """QuadConvKernel in f32 at B=1024: four SpMM launches a call, and
    ConvKernel's plain slot sums agree to 1e-5."""
    _, np_ops, cond = cylinder
    dev, fused, vbar_full = card
    quad = QuadConvKernel.build(np_ops["full"], cond, device=dev,
                                dtype=torch.float32)
    rng = np.random.default_rng(8)
    v = torch.as_tensor(
        vbar_full[fused.free.cpu().numpy(), None]
        + 1e-3 * rng.standard_normal((fused.n_free, 1024)),
        dtype=torch.float32,
    ).to(dev)
    before = spmm_kernel.launches
    got = quad.conv_inner_batch_t(v)
    assert spmm_kernel.launches - before == 4
    plain = ConvKernel.conv_inner_batch_t(fused, v)
    assert _rel(got, plain) <= 1e-5
    assert _rel(quad.conv_inner(v[:, 0].contiguous()), plain[:, 0]) <= 1e-5


@pytest.mark.parametrize("tiers", [
    {"step_solver": "matfree"}, {"dre_solver": "matfree"},
])
def test_cavity_driver_matfree_on_card_matches_cpu(gpu, tmp_path, tiers):
    """4 of CFG's 20 steps: each matrix-free DRE step is 80 FGMRES solves
    of 30 Arnoldi steps, on the card and on the host."""
    cfg = dataclasses.replace(
        CAVITY_CFG, time=TimeConfig(t0=0.0, t_end=0.08, nts=4),
        solver=dataclasses.replace(CAVITY_CFG.solver, fgmres_tol=1e-11,
                                   fgmres_cycles=12, **tiers),
    )
    spmm0 = spmm_kernel.launches
    got = optcon_nse(cfg, cache_dir=str(tmp_path / "card"), device=gpu)
    assert spmm_kernel.launches > spmm0
    ref = optcon_nse(cfg, cache_dir=str(tmp_path / "cpu"), device=CPU)
    assert _rel(got.gains.cpu(), ref.gains) <= 1e-8
    for a, b in ((got.ys, ref.ys), (got.us, ref.us)):
        assert _rel_np(a, b) <= 1e-8


def test_matfree_f32_driver_launches_kernels(gpu, tmp_path):
    """The f32 matrix-free step tier runs the convection kernel: once per
    step and once for the CNAB2/AB2 seed of the rollout."""
    cfg = dataclasses.replace(CAVITY_CFG, solver=dataclasses.replace(
        CAVITY_CFG.solver, dtype="float32", step_solver="matfree",
        dre_solver="inverse", fgmres_tol=1e-5))
    conv0 = conv_kernel.launches
    res = optcon_nse(cfg, cache_dir=str(tmp_path), device=gpu)
    assert conv_kernel.launches - conv0 == cfg.time.nts + 1
    assert np.isfinite(res.ys).all() and np.isfinite(res.us).all()


# --- receding-horizon MPC ------------------------------------------------


def test_linearized_dense_on_card_repeats_and_matches_cpu(cylinder):
    """The (2 ns)^2 f64 re-linearization at the bench shape (0.19 GB):
    its fixed-order slot sums repeat bit for bit on the card."""
    dev, np_ops, cond = cylinder
    v = torch.as_tensor(np_ops["vbar_full"])
    got = ConvKernel.build(np_ops["full"], cond, device=dev,
                           dtype=torch.float64).linearized_dense(v.to(dev))
    conv_cpu = ConvKernel.build(np_ops["full"], cond, device=CPU,
                                dtype=torch.float64)
    again = ConvKernel.build(np_ops["full"], cond, device=dev,
                             dtype=torch.float64).linearized_dense(v.to(dev))
    assert torch.equal(got, again)
    assert _rel(got.cpu(), conv_cpu.linearized_dense(v)) <= 1e-12


def _rh_cavity():
    from optconpy_tpu_torch.solvers.steady import solve_steady_nse_host

    ops, sys, cond = cavity_stokes_setup(nx=4, device=CPU)
    ops["vbar_full"], _ = solve_steady_nse_host(ops["full"], cond)
    sched = dre_shift_schedule_dae(ops["A"], ops["M"], ops["J"], 0.02,
                                   num_shifts=3, n_adi=6)
    return ops, sys, cond, sched


def _at_about(ops, cond, v_full, dt=0.02):
    import scipy.sparse as sp

    from optconpy_tpu_torch.fem.taylor_hood import convection_matrices

    l1, l2 = convection_matrices(ops["full"], v_full)
    a = sp.csr_matrix(cond.mat_inner(ops["full"]["A"] - l1 - l2))
    return (a.T - sp.csr_matrix(ops["M"]) / (2.0 * dt)).tocsr()


def test_ns_shift_stack_on_card_matches_cpu(gpu):
    """Build about the steady flow, refresh about 1.5x it: card vs CPU in
    f64; the f32 stack on the card certifies its refresh in f64."""
    ops, _, cond, (sig, _, _) = _rh_cavity()
    at0 = _at_about(ops, cond, ops["vbar_full"])
    at1 = _at_about(ops, cond, 1.5 * ops["vbar_full"])
    stacks = {d: NSShiftStack(at0, ops["M"], ops["J"], sig, device=d,
                              dtype=torch.float64) for d in (gpu, CPU)}
    assert _rel(stacks[gpu].vv.cpu(), stacks[CPU].vv) <= 1e-10
    for st in stacks.values():
        st.refresh(at1)
        assert all(st.certified) and st.rebuilds == 0
    assert _rel(stacks[gpu].vv.cpu(), stacks[CPU].vv) <= 1e-10
    st32 = NSShiftStack(at0, ops["M"], ops["J"], sig, device=gpu,
                        dtype=torch.float32)
    st32.refresh(at1)
    assert all(st32.certified) and max(st32.residuals) <= 5e-4
    assert _rel(st32.vv.double().cpu(), stacks[CPU].vv) <= 1e-4


def test_dense_ns_receding_on_card_matches_cpu(gpu):
    """The dense_ns macro loop (tests/test_receding_mpc.py:296's setup,
    4 scenarios x 3 macros, f64) on the card against the CPU."""
    from optconpy_tpu_torch.mpc import RHConfig, receding_horizon_mpc

    ops, sys, cond, sched = _rh_cavity()
    cfg = RHConfig(horizon=3, apply=3, dt=0.02, alpha=1e-6, n_newton=1,
                   r_max=8, warm_n_adi=4, fgmres_tol=1e-10, fgmres_cycles=12,
                   solver="dense_ns")
    vbar = cond.restrict(ops["vbar_full"])
    v0 = vbar[None] + 1e-3 * np.random.default_rng(0).standard_normal(
        (4, sys.n))
    outs = {}
    for d in (gpu, CPU):
        conv = ConvKernel.build(ops["full"], cond, device=d,
                                dtype=torch.float64)
        outs[d] = receding_horizon_mpc(sys.to(d), conv, ops, cond, cfg,
                                       *sched, torch.as_tensor(v0),
                                       n_macro=3)
    for key in ("vs", "us", "ks"):
        assert _rel(outs[gpu][key].cpu(), outs[CPU][key]) <= 1e-8, key
    assert all(r["ns_refresh_rebuilds"] == 0 for r in outs[gpu]["macros"])


def _sweep_cavities(nus, device):
    """The cavity (nx=5) about its steady flow at each viscosity, on
    `device` (tests/test_param_sweep.py's sweep buckets)."""
    from optconpy_tpu_torch.solvers.steady import solve_steady_nse_host

    setups = []
    for nu in nus:
        ops, sys, cond = cavity_stokes_setup(nx=5, device=device, nu=nu)
        ops["vbar_full"], _ = solve_steady_nse_host(ops["full"], cond)
        setups.append((ops, sys, cond))
    return setups


def test_cavity_sweep_on_card_matches_cpu(gpu):
    """The reference test's cavity sweep (nu 1.0 and 0.5, 'lu' steppers,
    2 x 4 scenarios x 6 steps, f64) on the card against the CPU."""
    from optconpy_tpu_torch.parallel import (
        build_sweep_gains_and_caches,
        sweep_rollout,
    )

    outs = {}
    for d in (gpu, CPU):
        setups = _sweep_cavities([1.0, 0.5], d)
        stack, ks = build_sweep_gains_and_caches(
            setups, 0.02, 1e-8, dtype=torch.float64, num_shifts=6, n_adi=12,
            nts_gain=4, r_max=16, solver="lu")
        conv = ConvKernel.build(setups[0][0]["full"], setups[0][2], device=d,
                                dtype=torch.float64)
        vbars = stack.vbar.cpu().numpy()
        v0 = vbars[:, None] + 1e-3 * np.random.default_rng(0).standard_normal(
            (2, 4, vbars.shape[1]))
        outs[d] = (ks, sweep_rollout(setups[0][1], conv, stack, ks,
                                     torch.as_tensor(v0).to(d), 1e-8, 0.02, 6))
    assert _rel(outs[gpu][0].cpu(), outs[CPU][0]) <= 1e-10
    for a, b in zip(outs[gpu][1], outs[CPU][1]):
        assert _rel(a.cpu(), b) <= 1e-10


def test_ns_chain_certifies_on_card(gpu):
    """The f32 Newton-Schulz stepper chain on the card (nu 1.0, 0.9, 0.8):
    every bucket certified in f64 at 1e-4 with no extra pass, through the
    SpMM kernel, and within 1e-4 of the f64 chain on the CPU."""
    from optconpy_tpu_torch.mpc import build_sweep_steppers_ns_chain

    nus = [1.0, 0.9, 0.8]
    cpu_set = _sweep_cavities(nus, CPU)
    conv = ConvKernel.build(cpu_set[0][0]["full"], cpu_set[0][2], device=CPU,
                            dtype=torch.float64)
    ref, _, _ = build_sweep_steppers_ns_chain(cpu_set, 0.02, conv,
                                              dtype=torch.float64)
    card_set = _sweep_cavities(nus, gpu)
    fused = FusedConvKernel.build(card_set[0][0]["full"], card_set[0][2],
                                  device=gpu)
    spmm_kernel.launches = 0
    got, res, info = build_sweep_steppers_ns_chain(card_set, 0.02, fused)
    assert spmm_kernel.launches > 0
    assert max(res) <= 1e-4 and info["extra_passes"] == [0, 0, 0]
    for a, b in zip(got, ref):
        assert _rel(a.lu.inv.double().cpu(), b.lu.inv) <= 1e-4
        assert _rel(a.l1_imp.double().cpu(), b.l1_imp) <= 1e-5


def test_conv_kernel_at_flattened_sweep_width(card):
    """K1 on the sweep's (n, R*S) state of 3 buckets x 400 scenarios
    (each bucket's columns a block) against its plain version."""
    dev, fused, vbar_full = card
    vbar = torch.as_tensor(vbar_full, dtype=torch.float32)[fused.free.cpu()]
    v0 = vbar + 1e-3 * torch.as_tensor(
        np.random.default_rng(2).standard_normal((3, 400, vbar.shape[0])),
        dtype=torch.float32)
    v = v0.to(dev).permute(2, 0, 1).contiguous().view(vbar.shape[0], 1200)
    out = conv_kernel.conv_inner(v, fused)
    assert _rel(out, ConvKernel.conv_inner_batch_t(fused, v)) <= 1e-5
    assert torch.equal(out, conv_kernel.conv_inner(v, fused))


def test_sharded_sweep_world_one_on_card(gpu, tmp_path):
    """sharded_sweep_rollout through a one-rank NCCL group on the card,
    ragged with NaN padded rows: ys and statistics bit-equal to
    sweep_rollout and masked_sweep_stats on the card, the statistics
    within 1e-10 of the CPU's."""
    import torch.distributed as dist

    from optconpy_tpu_torch.parallel import (
        build_sweep_gains_and_caches,
        init_multihost,
        masked_sweep_stats,
        scenario_mesh,
        shard_scenarios,
        sharded_sweep_rollout,
        sweep_rollout,
    )

    stats = {}
    init_multihost(gpu, f"file://{tmp_path / 'store'}", rank=0, world_size=1)
    try:
        mesh = scenario_mesh(gpu)
        for d in (gpu, CPU):
            setups = _sweep_cavities([1.0, 0.5], d)
            stack, ks = build_sweep_gains_and_caches(
                setups, 0.02, 1e-8, dtype=torch.float64, num_shifts=6,
                n_adi=12, nts_gain=4, r_max=16, solver="lu")
            conv = ConvKernel.build(setups[0][0]["full"], setups[0][2],
                                    device=d, dtype=torch.float64)
            vbars = stack.vbar.cpu().numpy()
            v0 = vbars[:, None] + 1e-3 * np.random.default_rng(1).standard_normal(
                (2, 4, vbars.shape[1]))
            v0[0, 3:] = v0[1, 2:] = np.nan
            mask = torch.ones((2, 4), dtype=torch.float64)
            mask[0, 3:] = mask[1, 2:] = 0.0
            v0, mask = torch.as_tensor(v0).to(d), mask.to(d)
            ystar = torch.zeros((2, setups[0][1].p_out), dtype=torch.float64,
                                device=d)
            ys1, u_sq1, _ = sweep_rollout(setups[0][1], conv, stack, ks, v0,
                                          1e-8, 0.02, 6)
            stats[d] = masked_sweep_stats(ys1, u_sq1, 1e-8, 0.02, ystar, mask)
            if d == gpu:
                ys, got = sharded_sweep_rollout(
                    mesh, setups[0][1], conv, stack, ks,
                    shard_scenarios(mesh, v0, dim=1), 1e-8, 0.02, 6,
                    ystar=ystar, mask_local=mask)
                assert torch.equal(ys.nan_to_num(), ys1.nan_to_num())
                for key in got:
                    assert torch.equal(got[key], stats[d][key]), key
    finally:
        dist.destroy_process_group()
    for key, ref in stats[CPU].items():
        assert torch.isfinite(stats[gpu][key]).all()
        assert _rel(stats[gpu][key].cpu(), ref) <= 1e-10, key


def test_config3xl_run_small_on_card_matches_cpu(gpu):
    """scripts/config3xl_cylinder.run on the cavity (nx=5, f32, FGMRES
    tol 1e-6) on the card launches both kernels, passes its checks and
    gives the gains of its CPU run to 1e-4."""
    from optconpy_tpu_torch.scripts import config3xl_cylinder

    shape = dict(nts_gain=2, nts_roll=3, n_shifts=3, n_adi=6, r_max=8,
                 s_batch=2, block=64, tol=1e-6)
    out = {}
    for d in (gpu, CPU):
        arrays = {}
        conv_kernel.launches = spmm_kernel.launches = 0
        config3xl_cylinder.run(d, ops=_sweep_cavities([1.0], d)[0],
                               problem="cavity_nx5", arrays=arrays,
                               log=lambda _: None, **shape)
        out[d] = (arrays["ks"], conv_kernel.launches, spmm_kernel.launches)
    assert out[gpu][1] == shape["nts_roll"] + 1 and out[gpu][2] > 0
    assert out[CPU][1:] == (0, 0)  # the CPU takes the plain versions
    assert _rel(out[gpu][0].cpu().double(), out[CPU][0].double()) <= 1e-4
