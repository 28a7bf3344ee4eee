"""Scenario-sharded batched MPC rollouts on torch.distributed.

Counterpart of optconpy_tpu/parallel/sharded_mpc.py (configs 4 and 5:
many scenario rollouts sharded over devices). Gains and operators are
the same on every rank (they belong to one linearization); each rank
rolls out its block of the scenario batch (mesh.shard_scenarios) with
the one-process rollout, and only the statistics cross ranks: one
all_reduce SUM of the cost and the scenario count and one all_reduce
MAX of |y|. Every rollout here solves its columns independently
(FGMRES's reductions are per column too), so no collective runs inside
a step.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..mpc import batched_closed_loop, batched_nse_closed_loop
from .mesh import ScenarioMesh


def all_reduce_stats(mesh: ScenarioMesh, sums: torch.Tensor,
                     maxima: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The global sums and maxima of this rank's partial ones: one
    all_reduce SUM and one all_reduce MAX over the mesh's group, on
    copies (the partials stay as they were)."""
    sums, maxima = sums.clone(), maxima.clone()
    dist.all_reduce(sums, op=dist.ReduceOp.SUM, group=mesh.group)
    dist.all_reduce(maxima, op=dist.ReduceOp.MAX, group=mesh.group)
    return sums, maxima


def _rollout_stats(mesh, us, ys, alpha, dt):
    cost = (ys**2).sum() * dt + alpha * (us**2).sum() * dt
    count = torch.tensor(float(ys.shape[0]), dtype=ys.dtype, device=ys.device)
    sums, max_y = all_reduce_stats(
        mesh, torch.stack([cost, count]), ys.abs().amax()
    )
    return {"mean_cost": sums[0] / sums[1], "max_abs_y": max_y,
            "scenarios": sums[1]}


def sharded_closed_loop(mesh: ScenarioMesh, sys, cache, ks, ws, v0_local,
                        alpha: float, dt: float):
    """The batched linear closed loop (mpc.batched_closed_loop) on this
    rank's block v0_local (S/world, n) of the scenario batch. Returns
    (ys (S/world, nts+1, p), this rank's block; stats, the same on every
    rank: mean_cost over all S scenarios of sum_t |y|^2 dt + alpha
    sum_t |u|^2 dt, max_abs_y, scenarios S)."""
    _, us, ys = batched_closed_loop(sys, cache, ks, ws, v0_local, alpha, dt)
    return ys, _rollout_stats(mesh, us, ys, alpha, dt)


def sharded_nse_rollout(mesh: ScenarioMesh, sys, conv, cache, ks, ws,
                        v0_local, alpha: float, dt: float,
                        feedback: str = "explicit"):
    """The nonlinear NSE closed loop (mpc.batched_nse_closed_loop, any
    stepper tier: host LU or inverse, fused, matrix-free FGMRES) on this
    rank's block v0_local of the scenario batch. Returns (ys block,
    stats) as sharded_closed_loop."""
    _, us, ys = batched_nse_closed_loop(
        sys, conv, cache, ks, ws, v0_local, alpha, dt, feedback=feedback
    )
    return ys, _rollout_stats(mesh, us, ys, alpha, dt)
