"""The scenario mesh on torch.distributed.

Counterpart of optconpy_tpu/parallel/mesh.py. The reference lays a 1-D
('scenario',) device mesh over its devices and lets shard_map place one
block of the scenario batch on each; here every rank is one process
with one device, holds its contiguous block of the scenario axis, and
the sharded rollouts (parallel/sharded_mpc.py, param_sweep.py) reduce
their statistics with torch.distributed collectives. Gains and
operators are replicated: every rank builds them, or rank 0's are
broadcast (replicate).

Ranks are started by a launcher (torchrun sets RANK, WORLD_SIZE,
MASTER_ADDR and MASTER_PORT) or by the caller, who then passes an
init_method (a file:// store needs no port), the rank and the world
size. NCCL serves CUDA devices, gloo the CPU; gloo can also reduce CUDA
tensors, for several ranks that share one card.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class ScenarioMesh:
    """This rank's place on the scenario axis: its rank and the world
    size in `group` (None: the default group), and its device."""

    rank: int
    world_size: int
    group: object
    device: torch.device


def init_multihost(device, init_method: str | None = None, *,
                   rank: int | None = None, world_size: int | None = None,
                   backend: str | None = None) -> None:
    """Initialise the default process group, once per process.

    Without init_method the launcher's environment is read ("env://").
    backend: 'nccl' for a CUDA device and 'gloo' for the CPU unless
    given ('gloo' also takes CUDA tensors, for ranks sharing a card).
    """
    if dist.is_initialized():
        return
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    kwargs = {k: v for k, v in (("rank", rank), ("world_size", world_size))
              if v is not None}  # else the launcher's RANK and WORLD_SIZE
    if backend == "nccl":
        torch.cuda.set_device(device)
        kwargs["device_id"] = device
    dist.init_process_group(backend, init_method=init_method or "env://",
                            **kwargs)


def scenario_mesh(device, group=None) -> ScenarioMesh:
    """The mesh of this rank in `group` (default: the default group).
    Raises when no process group is initialised: a sharded run never
    falls back to one rank silently."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "no torch.distributed process group is initialised; call "
            "init_multihost first (a single process runs at world size 1)"
        )
    return ScenarioMesh(
        rank=dist.get_rank(group), world_size=dist.get_world_size(group),
        group=group, device=torch.device(device),
    )


def shard_scenarios(mesh: ScenarioMesh, batch: torch.Tensor,
                    dim: int = 0) -> torch.Tensor:
    """This rank's contiguous block of the scenario axis `dim` of a
    batch that every rank holds, on the mesh's device. Raises unless the
    axis divides by the world size, as the reference's sharding does."""
    s = batch.shape[dim]
    if s % mesh.world_size:
        raise ValueError(
            f"{s} scenarios do not divide over {mesh.world_size} ranks"
        )
    block = s // mesh.world_size
    return batch.narrow(dim, mesh.rank * block, block).to(
        mesh.device).contiguous()


def replicate(mesh: ScenarioMesh, tree):
    """Rank 0's tensors on every rank: each tensor of a tensor, list,
    tuple or dict is moved to the mesh's device and broadcast from rank
    0 of the mesh's group. Returns the same structure."""
    if isinstance(tree, dict):
        return {k: replicate(mesh, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(replicate(mesh, v) for v in tree)
    if not isinstance(tree, torch.Tensor):
        raise TypeError(f"replicate takes tensors, got {type(tree).__name__}")
    out = tree.to(mesh.device, copy=True).contiguous()
    src = 0 if mesh.group is None else dist.get_global_rank(mesh.group, 0)
    dist.broadcast(out, src=src, group=mesh.group)
    return out
