"""The multi-rank dry run: every sharded path at toy size.

Counterpart of __graft_entry__.py dryrun_multichip: the rank-local body
of the same four stages, run by each rank of an initialised process
group (parallel/mesh.py). Every check raises.

  1. heat1d (n=16, f32): DRE gains and the feedforward on rank 0,
     replicated, then sharded_closed_loop over 2 x world scenarios;
  2. the cavity (nx=3) through sharded_sweep_rollout (one bucket, the
     host-LU stepper; the convection kernel on a CUDA device);
  3. matrix-free gains and sharded_nse_rollout on the matrix-free
     stepper;
  4. one receding-horizon macro step on the matrix-free tier (each rank
     on its own 2 scenarios, as the reference's dry run does).

Run it on several ranks with a launcher, e.g. two ranks sharing one
card through gloo:

    torchrun --standalone --nproc-per-node 2 \\
        -m optconpy_tpu_torch.parallel.dryrun --device cuda:0 --backend gloo

Each rank prints one JSON line with its stage results.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

N, NTS, DT, ALPHA = 16, 3, 0.05, 1e-3


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"dryrun check failed: {msg}")


def dryrun_multichip(mesh) -> dict:
    """The four stages on this rank of `mesh` (f32 on mesh.device).
    Returns per stage this rank's ys block shape and the global
    statistics, as floats."""
    from ..control import build_costate_cache, feedforward_sweep
    from ..fem.device_conv import FusedConvKernel
    from ..fem.heat1d import heat1d_operators
    from ..models.cavity import cavity_stokes_setup
    from ..mpc import (
        NSEStepCache,
        RHConfig,
        build_nse_stepper,
        build_nse_stepper_matfree,
        build_step_cache,
        receding_horizon_mpc,
    )
    from ..riccati import (
        build_dre_cache,
        build_dre_cache_dae,
        build_dre_cache_dae_matfree,
        dre_backward_sweep,
        dre_shift_schedule,
        dre_shift_schedule_dae,
    )
    from ..solvers.steady import solve_steady_nse_host
    from .mesh import replicate, shard_scenarios
    from .param_sweep import sharded_sweep_rollout
    from .sharded_mpc import sharded_closed_loop, sharded_nse_rollout

    dev, f32 = mesh.device, torch.float32
    s_batch = 2 * mesh.world_size
    s_local = s_batch // mesh.world_size
    out = {"rank": mesh.rank, "world_size": mesh.world_size}

    def summary(ys, stats):
        return {"ys_shape": list(ys.shape),
                **{k: v.tolist() for k, v in stats.items()}}

    # 1. heat1d: gains and feedforward replicated from rank 0
    np_ops, sys64 = heat1d_operators(n=N, device=dev)
    sys = sys64.to(dtype=f32)
    sig, sseq, iseq = dre_shift_schedule(np_ops["A"], np_ops["M"], DT,
                                         num_shifts=4, n_adi=6)
    _, ks = dre_backward_sweep(sys, build_dre_cache(sys, DT, sig), ALPHA, DT,
                               NTS, sseq, iseq, n_newton=1, r_max=8)
    ws = feedforward_sweep(sys, build_costate_cache(sys, DT), ks,
                           torch.zeros((NTS + 1, sys.p_out), dtype=f32,
                                       device=dev), DT)
    ks, ws = replicate(mesh, (ks, ws))
    v0 = torch.as_tensor(np.random.default_rng(0).standard_normal((s_batch, N)),
                         dtype=f32)
    ys, stats = sharded_closed_loop(mesh, sys, build_step_cache(sys, DT), ks,
                                    ws, shard_scenarios(mesh, v0), ALPHA, DT)
    _check(bool(torch.isfinite(stats["mean_cost"])), "heat1d mean cost finite")
    _check(tuple(ys.shape) == (s_local, NTS + 1, sys.p_out),
           f"heat1d ys block shape {tuple(ys.shape)}")
    _check(int(stats["scenarios"]) == s_batch,
           f"heat1d scenarios {float(stats['scenarios'])}")
    out["closed_loop"] = summary(ys, stats)

    # 2. the cavity through the sharded sweep (one bucket)
    np_ops2, dsys64, cond = cavity_stokes_setup(nx=3, device=dev)
    np_ops2["vbar_full"], _ = solve_steady_nse_host(np_ops2["full"], cond)
    dsys = dsys64.to(dtype=f32)
    sig2, sseq2, iseq2 = dre_shift_schedule_dae(
        np_ops2["A"], np_ops2["M"], np_ops2["J"], DT, num_shifts=3, n_adi=4)
    _, ks2 = dre_backward_sweep(dsys, build_dre_cache_dae(dsys, DT, sig2),
                                ALPHA, DT, 2, sseq2, iseq2, n_newton=1,
                                r_max=6)
    conv = FusedConvKernel.build(np_ops2["full"], cond, device=dev)
    stepper = build_nse_stepper(np_ops2, cond, DT, device=dev, dtype=f32)
    nf = dsys.n
    v0d = stepper.vbar.expand(1, s_batch, nf)
    ys2, stats2 = sharded_sweep_rollout(
        mesh, dsys, conv, NSEStepCache.stack([stepper]), ks2[:1],
        shard_scenarios(mesh, v0d, dim=1), ALPHA, DT, NTS)
    _check(bool(torch.isfinite(ys2).all()), "sweep ys finite")
    _check(int(stats2["scenarios"][0]) == s_batch,
           f"sweep scenarios {stats2['scenarios'].tolist()}")
    out["sweep"] = summary(ys2, stats2)

    # 3. matrix-free gains and the sharded matrix-free rollout
    mf = dict(block=8, m_krylov=10, max_cycles=4, tol=1e-5)
    _, ks3 = dre_backward_sweep(
        dsys, build_dre_cache_dae_matfree(dsys, DT, sig2, **mf), ALPHA, DT,
        2, sseq2, iseq2, n_newton=1, r_max=6)
    mf_stepper = build_nse_stepper_matfree(np_ops2, cond, DT, device=dev,
                                           dtype=f32, **mf)
    ks_roll = ks3[0].expand(NTS + 1, *ks3[0].shape)
    ws3 = torch.zeros((NTS + 1, nf), dtype=f32, device=dev)
    v0m = mf_stepper.vbar.expand(s_batch, nf)
    ys3, stats3 = sharded_nse_rollout(
        mesh, dsys, conv, mf_stepper, ks_roll, ws3,
        shard_scenarios(mesh, v0m), ALPHA, DT)
    _check(bool(torch.isfinite(ys3).all()), "matfree rollout ys finite")
    _check(bool(torch.isfinite(stats3["mean_cost"])),
           "matfree rollout mean cost finite")
    out["matfree_rollout"] = summary(ys3, stats3)

    # 4. one receding macro step on the matrix-free tier
    rh = receding_horizon_mpc(
        dsys, conv, np_ops2, cond,
        RHConfig(horizon=2, apply=2, dt=DT, alpha=ALPHA, n_newton=1,
                 r_max=6, solver="matfree", warm_n_adi=2),
        sig2, sseq2, iseq2, v0m[:max(2, mesh.world_size)].contiguous(),
        n_macro=2)
    _check(bool(torch.isfinite(rh["v_final"]).all()), "receding v_final finite")
    out["receding"] = {"v_final_shape": list(rh["v_final"].shape)}
    return out


def main(argv=None) -> None:
    """Initialise the process group from the launcher's environment, run
    the dry run on this rank and print its JSON line."""
    from ..ops import conv_kernel, spmm_kernel
    from ..utils import setup
    from .mesh import init_multihost, scenario_mesh

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", required=True,
                    help="this rank's device, e.g. cuda:0 or cpu")
    ap.add_argument("--backend", default=None,
                    help="nccl or gloo (default: nccl on CUDA, gloo on CPU)")
    args = ap.parse_args(argv)
    setup()
    init_multihost(args.device, backend=args.backend)
    try:
        out = dryrun_multichip(scenario_mesh(args.device))
        out["launches"] = {"conv_p2": conv_kernel.launches,
                           "spmm_tile": spmm_kernel.launches}
        print(json.dumps(out), flush=True)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
