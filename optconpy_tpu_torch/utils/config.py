"""Frozen config tree: one JSON-serializable description per run.

Counterpart of optconpy_tpu/utils/config.py with the same dataclasses,
field names and defaults, so a config built in either package has the
same JSON and the same `hash()`. The hash keys the checkpoint cache
(utils/cache.py), whose filenames also carry this package's own salt.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from dataclasses import dataclass, field


@dataclass(frozen=True)
class ProblemConfig:
    """Which flow problem, at which discretization."""

    name: str = "cylinderwake"  # 'cylinderwake' | 'drivencavity' | 'heat1d'
    re: float = 60.0  # Reynolds number (ignored for heat1d)
    refinement: int = 1  # mesh refinement level / 1d grid exponent
    nx: int = 8  # cavity grid resolution
    n_dof: int = 64  # heat1d dof count


@dataclass(frozen=True)
class TimeConfig:
    t0: float = 0.0
    t_end: float = 1.0
    nts: int = 100

    @property
    def dt(self) -> float:
        return (self.t_end - self.t0) / self.nts


@dataclass(frozen=True)
class CostConfig:
    alpha: float = 1e-2  # control penalty  int ||y-y*||^2 + alpha ||u||^2
    ystar: str = "zero"  # 'zero' | 'const' | 'steady_offset' | 'sin'
    ystar_amp: float = 0.0
    ystar_freq: float = 1.0


@dataclass(frozen=True)
class SolverConfig:
    num_shifts: int = 12
    n_adi: int = 24
    n_newton: int = 2
    r_max: int = 40
    dtype: str = "float32"
    imex_scheme: str = "oseen"  # 'oseen' | 'explicit' | 'oseen-cn'
    # Forward-step solver tier:
    #   'lu'      triangular solves on one dense saddle factor;
    #   'inverse' host-built explicit inverse, one GEMM per solve;
    #   'fused'   linear step pre-contracted into one GEMM and one SpMM;
    #   'matfree' not in this package yet (optcont.py raises).
    step_solver: str = "lu"
    # Riccati (DRE) cache tier: 'auto' follows step_solver ('matfree'
    # step -> matfree DRE, else the dense 'inverse' cache); or pin one
    # of 'lu' | 'inverse' | 'inverse_ns' | 'matfree'.
    dre_solver: str = "auto"
    # matfree knobs (both tiers): FGMRES tolerance / restart cycles.
    fgmres_tol: float = 1e-6
    fgmres_cycles: int = 8
    feedback: str = "implicit"  # 'implicit' (SMW) | 'explicit'
    # Matmul precision of the run and a rollout-only override (None =
    # follow matmul_precision). This package accepts 'highest' only
    # (utils/runtime.py); the fields exist so configs hash the same in
    # both packages.
    matmul_precision: str = "highest"
    rollout_matmul_precision: str | None = None


@dataclass(frozen=True)
class ShardingConfig:
    scenario_batch: int = 1
    mesh_axes: tuple = ("scenario",)


@dataclass(frozen=True)
class OptConConfig:
    """Full run description = problem + horizon + cost + solver + mesh."""

    problem: ProblemConfig = field(default_factory=ProblemConfig)
    time: TimeConfig = field(default_factory=TimeConfig)
    cost: CostConfig = field(default_factory=CostConfig)
    solver: SolverConfig = field(default_factory=SolverConfig)
    sharding: ShardingConfig = field(default_factory=ShardingConfig)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    def hash(self) -> str:
        """Stable 12-hex digest keying cached artifacts for this config."""
        return hashlib.sha256(self.to_json().encode()).hexdigest()[:12]


def config_from_json(text: str) -> OptConConfig:
    d = json.loads(text)
    return OptConConfig(
        problem=ProblemConfig(**d["problem"]),
        time=TimeConfig(**d["time"]),
        cost=CostConfig(**d["cost"]),
        solver=SolverConfig(**d["solver"]),
        sharding=ShardingConfig(
            scenario_batch=d["sharding"]["scenario_batch"],
            mesh_axes=tuple(d["sharding"]["mesh_axes"]),
        ),
    )
