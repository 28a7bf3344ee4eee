"""What the script modules share: logging, synchronized clocks, the
command line, and the projected residual checks of a DRE sweep."""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def clock(device):
    """A stamp function: perf_counter after synchronizing `device` (the
    host's clock for the CPU)."""
    device = torch.device(device)

    def stamp() -> float:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()

    return stamp


def stats_since(stats, start: int) -> dict:
    """The FGMRES record (solvers/matfree.py FgmresStats) of the solves
    after the first `start` ones, as a dict."""
    from ..solvers.matfree import FgmresStats

    return FgmresStats(stats.tol, stats.relres[start:]).as_dict()


def projected_residuals(np_ops, zs, ks, steps, alpha: float, dt: float,
                        log=log, pit=None) -> dict:
    """The projected DRE residual (riccati/validate.py, host f64) of the
    factors of each step in `steps`, with one Leray projector for all of
    them (np_ops' leray_projector, built here unless given). Returns
    {"residuals": [...], "projector_s": the projector's build (0 when
    given), "residual_s": the residuals' seconds after it, "saved_s":
    the projector seconds a rebuild per step would add}."""
    from ..riccati.validate import dre_step_residual, leray_projector

    t0 = time.perf_counter()
    if pit is None:
        pit = leray_projector(np_ops)
    t1 = time.perf_counter()
    residuals = []
    for k in steps:
        r = dre_step_residual(
            np_ops, zs[k].cpu().numpy(), ks[k].cpu().numpy(),
            zs[k + 1].cpu().numpy(), alpha, dt, pit=pit,
        )
        residuals.append(float(r))
        log(f"projected DRE residual @ step {k}: {r:.3e}")
    t2 = time.perf_counter()
    return {"residuals": residuals, "projector_s": t1 - t0,
            "residual_s": t2 - t1,
            "saved_s": (t1 - t0) * (len(residuals) - 1)}


def cli_main(run, description: str, argv=None) -> dict:
    """`python -m ...`: run(device) and print its dict as JSON; --out
    also writes it to a file."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "versions of the kernels)")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the "
                         "host")
    from ..utils import setup

    setup()
    out = run(device)
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
    return out
