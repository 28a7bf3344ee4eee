"""Port the scenario sharding (parallel/mesh.py, parallel/sharded_mpc.py,
param_sweep.sharded_sweep_rollout, parallel/dryrun.py) vs the reference's
sharded functions, in f64 on the CPU.

Two gloo ranks run every case in one spawned group (a file:// store in
the test's temporary directory, one thread a rank); the reference runs
the same inputs on 2 devices of its 8-device CPU mesh:

  * sharded_closed_loop on heat1d (tests/test_parallel.py's gains);
  * sharded_nse_rollout on the matrix-free cavity nx=4
    (tests/test_matfree.py's sharded case, FGMRES tol 1e-13);
  * sharded_sweep_rollout on tests/test_param_sweep.py's cavity sweep,
    without and with a per-bucket y*, and ragged with the padded rows
    NaN for the port and finite garbage for the reference;

with the same gains fed to both: ys 1e-12 (the ranks' blocks joined),
statistics 1e-10, counts exact. The 2-rank dry run and replicate run in
the same group. At world size 1 (in process) the sharded functions
equal the one-process ones bit for bit; scenario_mesh raises without a
process group and shard_scenarios on an axis the world size does not
divide.

This module's top level imports no jax: the spawned ranks import it to
find _rank_main. The reference is imported inside the fixtures.
"""
import os
import sys
import time

import numpy as np
import pytest
import threadpoolctl
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from optconpy_tpu_torch.fem.device_conv import ConvKernel
from optconpy_tpu_torch.fem.heat1d import heat1d_operators
from optconpy_tpu_torch.models.cavity import cavity_stokes_setup
from optconpy_tpu_torch.mpc import (
    NSEStepCache,
    batched_closed_loop,
    batched_nse_closed_loop,
    build_nse_stepper,
    build_nse_stepper_matfree,
    build_step_cache,
)
from optconpy_tpu_torch.parallel import (
    ScenarioMesh,
    init_multihost,
    masked_sweep_stats,
    replicate,
    scenario_mesh,
    shard_scenarios,
    sharded_closed_loop,
    sharded_nse_rollout,
    sharded_sweep_rollout,
    sweep_rollout,
)
from optconpy_tpu_torch.solvers.steady import solve_steady_nse_host

CPU = torch.device("cpu")
F64 = torch.float64
WORLD = 2
RANKS_TIMEOUT_S = 300

# tests/test_parallel.py
H_N, H_ALPHA, H_NTS, H_DT, H_S = 32, 1e-3, 10, 0.05, 16
# tests/test_matfree.py:235 (FGMRES tol 1e-13: both packages' solves
# agree to the ys bound)
M_DT, M_ALPHA, M_NTS, M_S = 0.02, 1e-4, 4, 8
M_MF = dict(block=64, max_cycles=20, tol=1e-13)
# tests/test_param_sweep.py
NUS = [1.0, 0.5]
S_DT, S_NTS, S_ALPHA = 0.02, 6, 1e-8
S_GAINS = dict(num_shifts=6, n_adi=12, nts_gain=4, r_max=16)
S_PER, S_MAX, COUNTS = 8, 8, [6, 3]
SWEEP_CASES = ("plain", "ystar", "ragged")


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


def _t(x):
    return torch.as_tensor(np.array(x))


def _cavity(nx, nu=1.0):
    ops, sys, cond = cavity_stokes_setup(nx=nx, device=CPU, nu=nu)
    ops["vbar_full"], _ = solve_steady_nse_host(ops["full"], cond)
    return ops, sys, cond


@pytest.fixture(scope="module")
def cases():
    """The inputs of every case in both packages and the reference's
    sharded results on 2 devices of its CPU mesh: {case: (port args,
    reference (ys, stats))}."""
    import jax
    import jax.numpy as jnp

    from optconpy_tpu import native as j_native
    from optconpy_tpu.control import build_costate_cache as j_costate
    from optconpy_tpu.control import feedforward_sweep as j_ff
    from optconpy_tpu.fem import heat1d_operators as j_heat
    from optconpy_tpu.fem.device_conv import ConvKernel as JConv
    from optconpy_tpu.models.cavity import cavity_stokes_setup as j_cavity
    from optconpy_tpu.mpc import build_step_cache as j_step_cache
    from optconpy_tpu.mpc import build_nse_stepper_matfree as j_mf_stepper
    from optconpy_tpu.parallel import build_sweep_gains_and_caches as j_gains
    from optconpy_tpu.parallel import scenario_mesh as j_mesh
    from optconpy_tpu.parallel import shard_scenarios as j_shard
    from optconpy_tpu.parallel import sharded_closed_loop as j_closed
    from optconpy_tpu.parallel import sharded_nse_rollout as j_nse
    from optconpy_tpu.parallel import sharded_sweep_rollout as j_sweep
    from optconpy_tpu.riccati import build_dre_cache as j_dre_cache
    from optconpy_tpu.riccati import dre_backward_sweep as j_dre
    from optconpy_tpu.riccati import dre_shift_schedule as j_schedule
    from optconpy_tpu.solvers.steady import solve_steady_nse_host as j_steady

    mesh = j_mesh(jax.devices("cpu")[:WORLD])
    out = {}

    # heat1d: the reference's gains and feedforward drive both packages
    j_ops, j_sys = j_heat(n=H_N)
    sig, sseq, iseq = j_schedule(j_ops["A"], j_ops["M"], H_DT, num_shifts=8,
                                 n_adi=16)
    _, ks = j_dre(j_sys, j_dre_cache(j_sys, H_DT, sig), H_ALPHA, H_DT, H_NTS,
                  jnp.asarray(sseq), jnp.asarray(iseq), n_newton=2, r_max=24)
    ws = j_ff(j_sys, j_costate(j_sys, H_DT), ks,
              jnp.zeros((H_NTS + 1, j_sys.p_out)), H_DT)
    v0 = np.random.default_rng(0).standard_normal((H_S, H_N))
    ys, st = j_closed(mesh, j_sys, j_step_cache(j_sys, H_DT), ks, ws,
                      j_shard(mesh, jnp.asarray(v0)), H_ALPHA, H_DT)
    _, t_sys = heat1d_operators(n=H_N, device=CPU)
    out["closed_loop"] = (
        (t_sys, build_step_cache(t_sys, H_DT), _t(ks), _t(ws), _t(v0),
         H_ALPHA, H_DT),
        (np.asarray(ys), {k: np.asarray(v) for k, v in st.items()}),
    )

    # the matrix-free cavity nx=4
    with pytest.MonkeyPatch.context() as mpatch:
        mpatch.setattr(j_native, "available", lambda: False)
        j_ops, j_sys, j_cond = j_cavity(nx=4)
    j_ops["vbar_full"], _ = j_steady(j_ops["full"], j_cond)
    j_cache = j_mf_stepper(j_ops, j_cond, M_DT, dtype=jnp.float64,
                           kind="ell", **M_MF)
    n, m = j_sys.b.shape
    rng = np.random.default_rng(2)
    v0 = np.asarray(j_cache.vbar)[None] + 1e-3 * rng.standard_normal((M_S, n))
    ks = np.broadcast_to(1e-3 * rng.standard_normal((m, n)),
                         (M_NTS + 1, m, n)).copy()
    ws = np.zeros((M_NTS + 1, n))
    ys, st = j_nse(mesh, j_sys.astype(jnp.float64),
                   JConv.build(j_ops["full"], j_cond, dtype=jnp.float64),
                   j_cache, jnp.asarray(ks), jnp.asarray(ws), jnp.asarray(v0),
                   M_ALPHA, M_DT)
    t_ops, t_sys, t_cond = _cavity(4)
    out["nse_matfree"] = (
        (t_sys, ConvKernel.build(t_ops["full"], t_cond, device=CPU,
                                 dtype=F64),
         build_nse_stepper_matfree(t_ops, t_cond, M_DT, device=CPU,
                                   dtype=F64, **M_MF),
         _t(ks), _t(ws), _t(v0), M_ALPHA, M_DT),
        (np.asarray(ys), {k: np.asarray(v) for k, v in st.items()}),
    )

    # the cavity sweep: the reference's gains drive both packages
    j_set, t_set = [], []
    for nu in NUS:
        with pytest.MonkeyPatch.context() as mpatch:
            mpatch.setattr(j_native, "available", lambda: False)
            ops, sys, cond = j_cavity(nx=5, nu=nu)
        ops["vbar_full"], _ = j_steady(ops["full"], cond)
        j_set.append((ops, sys, cond))
        t_set.append(_cavity(5, nu))
    j_stack, j_ks = j_gains(j_set, S_DT, S_ALPHA, dtype=jnp.float64,
                            solver="lu", **S_GAINS)
    j_sys = j_set[0][1].astype(jnp.float64)
    j_conv = JConv.build(j_set[0][0]["full"], j_set[0][2], dtype=jnp.float64)
    t_stack = NSEStepCache.stack([
        build_nse_stepper(ops, cond, S_DT, device=CPU, dtype=F64)
        for ops, _, cond in t_set
    ])
    t_conv = ConvKernel.build(t_set[0][0]["full"], t_set[0][2], device=CPU,
                              dtype=F64)
    n = j_sys.n
    vbars = np.asarray(j_stack.vbar)
    rng = np.random.default_rng(1)
    for case in SWEEP_CASES:
        v0 = vbars[:, None, :] + 1e-3 * rng.standard_normal(
            (len(NUS), S_PER, n))
        ystar = (rng.standard_normal((len(NUS), j_sys.p_out))
                 if case != "plain" else np.zeros((len(NUS), j_sys.p_out)))
        mask = np.ones((len(NUS), S_PER))
        v0_port = v0.copy()
        if case == "ragged":
            for r, c in enumerate(COUNTS):
                v0[r, c:] = vbars[r] + 1e3 * rng.standard_normal((S_MAX - c, n))
                v0_port[r, c:] = np.nan
                mask[r, c:] = 0.0
        ys, st = j_sweep(mesh, j_sys, j_conv, j_stack, j_ks, jnp.asarray(v0),
                         S_ALPHA, S_DT, S_NTS, ystar=jnp.asarray(ystar),
                         mask=jnp.asarray(mask))
        out[f"sweep_{case}"] = (
            (t_set[0][1], t_conv, t_stack, _t(j_ks), _t(v0_port), S_ALPHA,
             S_DT, S_NTS, _t(ystar), _t(mask)),
            (np.asarray(ys), {k: np.asarray(v) for k, v in st.items()}),
        )
    return out


def _rank_main(rank, world, store, inputs, out_dir):
    """One rank of the spawned group: every case on this rank's block,
    the dry run and a replicate; saves {case: (ys block, stats)}."""
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    torch.set_num_threads(1)
    from optconpy_tpu_torch.parallel.dryrun import dryrun_multichip

    init_multihost(CPU, f"file://{store}", rank=rank, world_size=world)
    try:
        mesh = scenario_mesh(CPU)
        res = {}
        system, cache, ks, ws, v0, alpha, dt = inputs["closed_loop"]
        res["closed_loop"] = sharded_closed_loop(
            mesh, system, cache, ks, ws, shard_scenarios(mesh, v0), alpha, dt)
        system, conv, cache, ks, ws, v0, alpha, dt = inputs["nse_matfree"]
        res["nse_matfree"] = sharded_nse_rollout(
            mesh, system, conv, cache, ks, ws, shard_scenarios(mesh, v0), alpha,
            dt)
        for case in SWEEP_CASES:
            system, conv, stack, ks, v0, alpha, dt, nts, ystar, mask = (
                inputs[f"sweep_{case}"])
            res[f"sweep_{case}"] = sharded_sweep_rollout(
                mesh, system, conv, stack, ks, shard_scenarios(mesh, v0, dim=1),
                alpha, dt, nts, ystar=ystar,
                mask_local=shard_scenarios(mesh, mask, dim=1))
        res["dryrun"] = dryrun_multichip(mesh)
        res["replicate"] = replicate(mesh, {"x": torch.full((3,), rank + 1.0)})
        res["modules"] = sorted(k for k in sys.modules if k == "jax"
                                or k.split(".")[0] == "optconpy_tpu")
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(cases, tmp_path_factory):
    """The spawned group's results: one dict a rank."""
    tmp = tmp_path_factory.mktemp("gloo")
    inputs = {k: v[0] for k, v in cases.items()}
    ctx = mp.start_processes(_rank_main,
                             args=(WORLD, str(tmp / "store"), inputs, str(tmp)),
                             nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + RANKS_TIMEOUT_S
    while not ctx.join(timeout=1):  # raises when a rank failed
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.terminate()
            pytest.fail(f"the gloo ranks did not finish in {RANKS_TIMEOUT_S} s")
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


def _joined(ranks, case):
    dim = 1 if case.startswith("sweep") else 0
    return torch.cat([r[case][0] for r in ranks], dim=dim).numpy()


CASES = ("closed_loop", "nse_matfree") + tuple(f"sweep_{c}"
                                               for c in SWEEP_CASES)


@pytest.mark.parametrize("case", CASES)
def test_sharded_outputs_match_reference(cases, ranks, case):
    ys_ref, _ = cases[case][1]
    ys = _joined(ranks, case)
    if case == "sweep_ragged":  # the padded rows are NaN in the port
        for r, c in enumerate(COUNTS):
            assert np.isnan(ys[r, c:]).all()
            ys, ys_ref = ys.copy(), ys_ref.copy()
            ys[r, c:] = ys_ref[r, c:] = 0.0
    assert ys.shape == ys_ref.shape
    assert _rel(ys, ys_ref) <= 1e-12


@pytest.mark.parametrize("case", CASES)
def test_sharded_stats_match_reference(cases, ranks, case):
    """Every rank holds the same global statistics, within 1e-10 of the
    reference's; the counts are exact. NaN padded rows (port) and garbage
    ones (reference) leave them alike."""
    _, st_ref = cases[case][1]
    for r in ranks:
        st = r[case][1]
        for key, ref in st_ref.items():
            got = st[key].numpy()
            assert np.isfinite(got).all(), key
            assert _rel(got, ref) <= 1e-10, (key, got, ref)
        assert torch.equal(st["mean_cost"], ranks[0][case][1]["mean_cost"])
    if case.startswith("sweep"):
        counts = COUNTS if case == "sweep_ragged" else [S_PER] * len(NUS)
        assert ranks[0][case][1]["scenarios"].tolist() == counts
    else:
        n_s = H_S if case == "closed_loop" else M_S
        assert float(ranks[0][case][1]["scenarios"]) == n_s


def test_dryrun_two_ranks(ranks):
    """Both ranks pass every stage and hold the same global statistics
    of 2 x world scenarios, each over its own block of 2."""
    a, b = (r["dryrun"] for r in ranks)
    assert (a["rank"], b["rank"], a["world_size"]) == (0, 1, WORLD)
    for stage in ("closed_loop", "sweep", "matfree_rollout"):
        assert a[stage] == b[stage]
        sc = a[stage]["scenarios"]
        assert (sc[0] if isinstance(sc, list) else sc) == 2 * WORLD
    assert a["closed_loop"]["ys_shape"][0] == 2
    assert a["receding"] == b["receding"] == {"v_final_shape": [2, 50]}


def test_ranks_import_no_jax(ranks):
    """The spawned ranks ran the port and imported neither jax nor the
    reference."""
    assert [r["modules"] for r in ranks] == [[]] * WORLD


def test_replicate_broadcasts_rank_zero(ranks):
    for r in ranks:
        assert torch.equal(r["replicate"]["x"], torch.full((3,), 1.0))


@pytest.fixture
def world_one(tmp_path):
    """A gloo group of one rank in this process, destroyed afterwards."""
    init_multihost(CPU, f"file://{tmp_path / 'store'}", rank=0, world_size=1)
    try:
        yield scenario_mesh(CPU)
    finally:
        dist.destroy_process_group()


def test_world_size_one_sweep_is_bit_equal(cases, world_one):
    sys, conv, stack, ks, v0, alpha, dt, nts, ystar, mask = (
        cases["sweep_ragged"][0])
    ys, stats = sharded_sweep_rollout(
        world_one, sys, conv, stack, ks, shard_scenarios(world_one, v0, dim=1),
        alpha, dt, nts, ystar=ystar, mask_local=mask)
    ys1, u_sq1, _ = sweep_rollout(sys, conv, stack, ks, v0, alpha, dt, nts)
    assert torch.equal(ys.nan_to_num(), ys1.nan_to_num())
    stats1 = masked_sweep_stats(ys1, u_sq1, alpha, dt, ystar, mask)
    for key in stats1:
        assert torch.equal(stats[key], stats1[key]), key


def test_world_size_one_rollouts_are_bit_equal(cases, world_one):
    sys, cache, ks, ws, v0, alpha, dt = cases["closed_loop"][0]
    ys, stats = sharded_closed_loop(world_one, sys, cache, ks, ws, v0, alpha,
                                    dt)
    _, us1, ys1 = batched_closed_loop(sys, cache, ks, ws, v0, alpha, dt)
    assert torch.equal(ys, ys1)
    cost = (ys1**2).sum() * dt + alpha * (us1**2).sum() * dt
    assert torch.equal(stats["mean_cost"], cost / len(v0))
    assert torch.equal(stats["max_abs_y"], ys1.abs().amax())
    sys, conv, cache, ks, ws, v0, alpha, dt = cases["nse_matfree"][0]
    ys, _ = sharded_nse_rollout(world_one, sys, conv, cache, ks, ws, v0,
                                alpha, dt)
    assert torch.equal(ys, batched_nse_closed_loop(sys, conv, cache, ks, ws,
                                                   v0, alpha, dt)[2])


def test_scenario_mesh_raises_without_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no torch.distributed"):
        scenario_mesh(CPU)


def test_shard_scenarios_raises_when_the_world_does_not_divide():
    mesh = ScenarioMesh(rank=1, world_size=2, group=None, device=CPU)
    x = torch.arange(12.0).reshape(2, 6)
    assert torch.equal(shard_scenarios(mesh, x, dim=1), x[:, 3:])
    with pytest.raises(ValueError, match="do not divide"):
        shard_scenarios(mesh, torch.zeros(5, 3))
