"""The Arnoldi step's orthogonalisation (ops/arnoldi_kernel.py,
csrc/mgs_step.cu).

On the CPU: `mgs_step_plain` is, bit for bit, the loop that
solvers/krylov.py's gmres ran inline (a copy of it is kept here), with
and without a breakdown column; the kernel's argument checks refuse what
the kernel does not take; the launch counters do not move on the CPU.

On the card (marked `cuda`, skipped without one): the kernel against
`mgs_step_plain` at the gains cell's shapes (n = 17,396, q = 4 and 46,
every step of a 30-step cycle, float32), at q = 16 and q = 1,024 (the
streamed parameter set), in float64 and at the bench shape's stepper
(n = 5,037, q = 3, float64), on both sides of the plan's crossover from
one thread-block cluster to several (each owning a range of columns),
the basis it builds within twice the plain loop's loss of orthogonality
and Arnoldi residual, and two runs equal bit for bit. The kernel sums in
another order than torch (by block, then over a cluster's blocks), so it
is held to the plain version within rounding: 2e-5 relative in
float32 and 1e-12 in float64 on the H column and the new basis vector
(the inputs are well conditioned: w keeps most of its norm). This file
imports no jax:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_arnoldi_kernel.py
"""
import pytest
import torch

from optconpy_tpu_torch.ops import arnoldi_kernel as ak
from optconpy_tpu_torch.solvers import krylov

M = 30  # the Krylov dimension of the matrix-free tier (m_krylov)
N_CELL = 17_396  # the gains cell's saddle: 15,316 velocity + 2,080 pressure
N_BENCH = 5_037  # the bench shape's saddle (its matrix-free stepper, q = 3)


def _inline_loop(vs, w, h, j, safe_beta):
    """solvers/krylov.py's gmres loop body as it was before the kernel."""
    eps = torch.finfo(w.dtype).eps
    hcol = []
    for i in range(j + 1):
        hcol.append((vs[i] * w).sum(dim=0))
        w = w.addcmul(vs[i], hcol[-1], value=-1.0)
    h[: j + 1, j] = torch.stack(hcol)
    hnorm = (w * w).sum(dim=0).sqrt()
    breakdown = hnorm < 64.0 * eps * safe_beta
    h[j + 1, j] = torch.where(breakdown, 0.0, hnorm)
    vs[j + 1] = torch.where(breakdown, 0.0, w / hnorm.clamp_min(1e-30))


def _factor(dtype):
    """The breakdown factor gmres passes: 64 eps of the dtype."""
    return krylov.BREAKDOWN_EPS * torch.finfo(dtype).eps


def _inputs(n, q, j, dtype, device, seed=0, breakdown=True):
    """An orthonormal basis vs[0..j] per column, a w, H with earlier
    columns set, and safe_beta, made in float64 on `device`. With
    breakdown and q > 1, the last column's w lies in the span of its
    basis."""
    g = torch.Generator(device=device).manual_seed(seed)
    f64 = {"dtype": torch.float64, "device": device}

    def randn(*shape):
        return torch.randn(shape, generator=g, **f64)

    basis = torch.linalg.qr(randn(q, n, j + 1))[0]  # (q, n, j + 1)
    vs = torch.zeros((M + 1, n, q), **f64)
    vs[: j + 1] = basis.permute(2, 1, 0)
    w = randn(n, q) + vs[: j + 1].sum(dim=0)  # nonzero projections
    if breakdown and q > 1:
        coef = 0.1 * randn(j + 1)
        w[:, -1] = (vs[: j + 1, :, -1] * coef[:, None]).sum(dim=0)
    h = torch.zeros((M + 1, M, q), **f64)
    h[:, :j] = randn(M + 1, j, q)
    safe_beta = 0.5 + torch.rand(q, generator=g, **f64)

    def put(x):
        return x.to(dtype).contiguous()

    return put(vs), put(w), put(h), put(safe_beta)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("j", [0, 1, 29])
@pytest.mark.parametrize("q", [1, 4, 46])
def test_plain_is_the_inline_loop_bit_for_bit(q, j, dtype):
    vs, w, h, sb = _inputs(64, q, j, dtype, torch.device("cpu"))
    w_in = w.clone()
    vs_a, h_a = vs.clone(), h.clone()
    _inline_loop(vs_a, w.clone(), h_a, j, sb)
    ak.mgs_step_plain(vs, w, h, j, sb, _factor(dtype))
    assert torch.equal(vs, vs_a) and torch.equal(h, h_a)
    assert torch.equal(w, w_in)  # w is only read
    if q > 1:  # the breakdown column: a zero vector and a zero H entry
        assert float(h[j + 1, j, -1]) == 0.0
        assert not vs[j + 1, :, -1].any()
    assert float(h[j + 1, j, 0]) > 0.0
    assert torch.equal(h[j + 2:], h_a[j + 2:])


def test_gmres_calls_the_wrapper_once_a_step(monkeypatch):
    """gmres hands every Arnoldi step to mgs_step, with a contiguous w."""
    seen = []
    real = krylov.mgs_step

    def spy(vs, w, h, j, safe_beta, factor):
        seen.append((j, w.is_contiguous(), factor))
        return real(vs, w, h, j, safe_beta, factor)

    monkeypatch.setattr(krylov, "mgs_step", spy)
    a = torch.eye(24, dtype=torch.float64) + 0.05 * torch.randn(
        (24, 24), generator=torch.Generator().manual_seed(1),
        dtype=torch.float64)
    # a matvec whose result is column-major
    krylov.gmres(lambda x: (x.T @ a.T).T, torch.ones((24, 3),
                 dtype=torch.float64), n_iter=7)
    assert seen == [(j, True, _factor(torch.float64)) for j in range(7)]


def _bad_inputs():
    vs, w, h, sb = _inputs(16, 4, 2, torch.float32, torch.device("cpu"))
    return {
        "w not contiguous": (vs, w.T.contiguous().T, h, sb, 2, ValueError),
        "vs not contiguous": (vs.transpose(1, 2).contiguous().transpose(1, 2),
                              w, h, sb, 2, ValueError),
        "w of another dtype": (vs, w.double(), h, sb, 2, TypeError),
        "float16": (vs.half(), w.half(), h.half(), sb.half(), 2, TypeError),
        "h of another shape": (vs, w, h[:, :-1].contiguous(), sb, 2,
                               ValueError),
        "w of another width": (vs, w[:, :3].contiguous(), h, sb, 2,
                               ValueError),
        "safe_beta of another dtype": (vs, w, h, sb.double(), 2, TypeError),
        "safe_beta on another device": (vs, w, h, sb.to("meta"), 2,
                                        ValueError),
        "vs not 3-d": (vs[0], w, h, sb, 2, ValueError),
        "j = m": (vs, w, h, sb, M, ValueError),
        "j < 0": (vs, w, h, sb, -1, ValueError),
    }


@pytest.mark.parametrize("case", list(_bad_inputs()))
def test_kernel_arguments_refused(case):
    vs, w, h, sb, j, err = _bad_inputs()[case]
    with pytest.raises(err):
        ak.validate(vs, w, h, j, sb)


def test_kernel_arguments_accepted():
    vs, w, h, sb = _inputs(16, 4, 2, torch.float32, torch.device("cpu"))
    assert ak.validate(vs, w, h, 2, sb) == (M, 16, 4)


def test_no_kernel_for_other_devices():
    vs, w, h, sb = (x.to("meta") for x in _inputs(16, 4, 2, torch.float32,
                                                   torch.device("cpu")))
    with pytest.raises(ValueError, match="no MGS kernel"):
        ak.mgs_step(vs, w, h, 2, sb, _factor(torch.float32))


def test_counters_do_not_move_on_the_cpu():
    before = (ak.launches, ak.launches_onchip, ak.launches_one_cluster)
    vs, w, h, sb = _inputs(32, 4, 3, torch.float64, torch.device("cpu"))
    ak.mgs_step(vs, w, h, 3, sb, _factor(torch.float64))
    a = torch.eye(32, dtype=torch.float64) * 2.0
    krylov.fgmres(lambda x: a @ x, torch.ones((32, 2), dtype=torch.float64),
                  m=5)
    assert (ak.launches, ak.launches_onchip,
            ak.launches_one_cluster) == before


# --- on the card ------------------------------------------------------------

TOL = {torch.float32: 2e-5, torch.float64: 1e-12}


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


def _operator(v):
    """A nonsymmetric banded operator on (n, q) blocks: the Krylov basis
    of a convection-diffusion stencil."""
    out = 2.5 * v
    out[1:] -= v[:-1]
    out[:-1] -= 0.5 * v[1:]
    return out


def _cycle(step, n, q, dtype, dev, seed=0):
    """A 30-step Arnoldi cycle of _operator built by `step` (mgs_step or
    mgs_step_plain). Returns vs, h and the w of every step."""
    g = torch.Generator(device=dev).manual_seed(seed)
    r0 = torch.randn((n, q), generator=g, dtype=dtype, device=dev)
    beta = r0.norm(dim=0)
    sb = beta.clamp_min(1e-30)
    vs = torch.zeros((M + 1, n, q), dtype=dtype, device=dev)
    vs[0] = r0 / sb
    h = torch.zeros((M + 1, M, q), dtype=dtype, device=dev)
    ws = []
    for j in range(M):
        ws.append(_operator(vs[j]).contiguous())
        step(vs, ws[-1], h, j, sb, _factor(dtype))
    return vs, h, ws, sb


def _orthogonality(vs):
    """max over columns of |V^T V - I| (float64)."""
    v = vs.double().permute(2, 0, 1)  # (q, m + 1, n)
    gram = v @ v.transpose(1, 2)
    eye = torch.eye(vs.shape[0], dtype=torch.float64, device=vs.device)
    return float((gram - eye).abs().max())


def _arnoldi_residual(vs, h, ws):
    """max |A v_j - sum_i h_ij v_i| over steps and columns (float64): the
    relation a cycle must satisfy to rounding. Two cycles that round
    differently drift apart (the Arnoldi basis is not forward stable);
    each must still satisfy it."""
    v = vs.double()
    hd = h.double()
    return max(
        float((ws[j].double() - (hd[:, j, None, :] * v).sum(dim=0)).abs().max())
        for j in range(len(ws))
    )


def _one_cluster(dtype, n, q):
    """Whether the plan's grid is one thread-block cluster."""
    plan = ak.plan(0, dtype, n, q)
    return plan[0] == plan[4]


@pytest.mark.cuda
@pytest.mark.parametrize("n, q, dtype, onchip, one", [
    (N_CELL, 4, torch.float32, True, True),
    (N_CELL, 46, torch.float32, True, False),
    (N_CELL, 16, torch.float32, True, False),
    (N_CELL, 1024, torch.float32, False, False),
    (N_CELL, 46, torch.float64, True, False),
    (N_CELL, 4, torch.float64, True, False),
    (N_BENCH, 3, torch.float64, True, True),
])
def test_kernel_matches_plain_every_step(dev, n, q, dtype, onchip, one):
    """Every step of a 30-step cycle: the kernel from the plain loop's
    basis and w gives the plain loop's H column and v_{j+1} within
    rounding; a whole cycle built by the kernel is no less orthogonal
    than the plain loop's and satisfies the Arnoldi relation as well
    (2x: both lose orthogonality and the relation by rounding); the
    parameter set and the cluster count are the ones the shape calls
    for, on both sides of the plan's crossover to one cluster."""
    assert ak.plan(0, dtype, n, q)[2] is onchip
    assert _one_cluster(dtype, n, q) is one
    vs, h, ws, sb = _cycle(ak.mgs_step_plain, n, q, dtype, dev)
    before = (ak.launches, ak.launches_onchip, ak.launches_one_cluster)
    for j in range(M):
        vk, hk = vs.clone(), h.clone()
        vk[j + 1:] = 0.0
        hk[:, j] = 0.0
        ak.mgs_step(vk, ws[j], hk, j, sb, _factor(dtype))
        torch.cuda.synchronize()
        assert _rel(hk[:, j], h[:, j]) <= TOL[dtype], j
        assert _rel(vk[j + 1], vs[j + 1]) <= TOL[dtype], j
        assert torch.equal(vk[: j + 1], vs[: j + 1])
        assert not hk[j + 2:, j].any()
    assert (ak.launches - before[0], ak.launches_onchip - before[1],
            ak.launches_one_cluster - before[2]) == (
        M, M if onchip else 0, M if one else 0)
    vk, hk, wk, _ = _cycle(ak.mgs_step, n, q, dtype, dev)
    assert _orthogonality(vk) <= 2.0 * _orthogonality(vs)
    assert _arnoldi_residual(vk, hk, wk) <= 2.0 * _arnoldi_residual(vs, h, ws)


@pytest.mark.cuda
@pytest.mark.parametrize("n, q, dtype", [
    (N_CELL, 46, torch.float32), (N_CELL, 1024, torch.float32),
    (N_CELL, 4, torch.float64), (N_CELL, 4, torch.float32),
    (N_CELL, 16, torch.float32), (N_BENCH, 3, torch.float64),
])
def test_kernel_repeats_bit_for_bit(dev, n, q, dtype):
    """Two cycles from one start are the same bits, on one cluster and on
    several (a fixed summation order)."""
    one = _cycle(ak.mgs_step, n, q, dtype, dev, seed=3)
    two = _cycle(ak.mgs_step, n, q, dtype, dev, seed=3)
    assert torch.equal(one[0], two[0]) and torch.equal(one[1], two[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n, q, j", [(N_CELL, 46, 29), (N_CELL, 1024, 5),
                                     (37, 3, 4), (4_396, 1, 0),
                                     (N_CELL, 4, 29), (17_389, 4, 3),
                                     (17_389, 16, 11), (17_389, 46, 9),
                                     (1_001, 2, 6)])
def test_kernel_breakdown_and_ragged_shapes(dev, dtype, n, q, j):
    """A column in the span of its basis breaks down to a zero vector and
    a zero H entry as in the plain loop; small and ragged shapes (fewer
    rows than blocks, q = 1, a last block of fewer rows, on one cluster
    and on several) match it too."""
    vs, w, h, sb = _inputs(n, q, j, dtype, dev, seed=7)
    vp, hp = vs.clone(), h.clone()
    ak.mgs_step_plain(vp, w, hp, j, sb, _factor(dtype))
    ak.mgs_step(vs, w, h, j, sb, _factor(dtype))
    torch.cuda.synchronize()
    assert _rel(h, hp) <= TOL[dtype] and _rel(vs, vp) <= TOL[dtype]
    if q > 1:
        assert float(h[j + 1, j, -1]) == 0.0 and not vs[j + 1, :, -1].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_w_off_16_bytes(dev, dtype):
    """A w that starts off a 16-byte boundary (a contiguous view at an
    offset of one element) takes the kernel's single-element runs and
    gives the same result within rounding."""
    n, q, j = N_CELL, 16, 12
    vs, w, h, sb = _inputs(n, q, j, dtype, dev, seed=11)
    assert ak.plan(0, dtype, n, q)[3] > 1
    big = torch.empty(n * q + 1, dtype=dtype, device=dev)
    w_off = big[1:].view(n, q)
    w_off.copy_(w)
    assert w_off.is_contiguous() and w_off.data_ptr() % 16 != 0
    vp, hp = vs.clone(), h.clone()
    ak.mgs_step_plain(vp, w, hp, j, sb, _factor(dtype))
    ak.mgs_step(vs, w_off, h, j, sb, _factor(dtype))
    torch.cuda.synchronize()
    assert _rel(h, hp) <= TOL[dtype] and _rel(vs, vp) <= TOL[dtype]


@pytest.mark.cuda
def test_kernel_plans_of_other_shapes_in_between(dev):
    """Launches at one shape after plans and launches at others (each plan
    sets the kernels' shared-memory limit): every one as the plain loop."""
    for q in (46, 4, 1024, 46, 4):
        vs, w, h, sb = _inputs(N_CELL, q, 3, torch.float32, dev, seed=q)
        vp, hp = vs.clone(), h.clone()
        ak.mgs_step_plain(vp, w, hp, 3, sb, _factor(torch.float32))
        ak.mgs_step(vs, w, h, 3, sb, _factor(torch.float32))
        torch.cuda.synchronize()
        assert _rel(h, hp) <= TOL[torch.float32], q
        assert _rel(vs, vp) <= TOL[torch.float32], q


@pytest.mark.cuda
def test_plan_one_cluster_narrow_several_wide(dev):
    """At the gains cell's saddle the narrow solves (q = 4) take one
    cluster over every column and the wide ones (q = 46) several, each
    owning a range of columns; every plan's grid is whole clusters, at
    most one block an SM, and its clusters own every column once."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for dtype, n, q in ((torch.float32, N_CELL, 4), (torch.float32, N_CELL, 16),
                        (torch.float32, N_CELL, 46), (torch.float64, N_BENCH, 3),
                        (torch.float32, N_CELL, 1024), (torch.float64, N_CELL, 46)):
        grid, _, _, vec, cluster, threads, qc = ak.plan(0, dtype, n, q)
        assert grid % cluster == 0 and grid <= sms, (n, q)
        assert threads in (128, 256, 512, 1024), (n, q)
        clusters = grid // cluster
        assert (clusters - 1) * qc < q <= clusters * qc, (n, q)
        assert clusters == 1 or (q % vec == 0 and qc % vec == 0), (n, q)
    assert _one_cluster(torch.float32, N_CELL, 4)
    assert _one_cluster(torch.float64, N_BENCH, 3)
    assert not _one_cluster(torch.float32, N_CELL, 46)
