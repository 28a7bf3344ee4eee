"""What the benchmark loads: a whole tiny run of run.py's path loads no
module whose top-level name is jax's, its kin's or the JAX package's,
and the reference loads nothing of the program either. Top-level names
are compared whole (the part before the first dot): the port's name
begins with the JAX package's."""
from __future__ import annotations

import json
import subprocess
import sys

import harness

RUN = """
import json, sys
sys.path[:0] = {paths!r}
import torch
torch.set_num_threads(2)
import harness, run
from conftest import tiny_cell
cell = tiny_cell("cyl-re100-ref1.realtime-b1")
out, checks = run.run(cell, 2**31 + 77, 0.1, False, torch.device("cpu"))
print(json.dumps({{"forbidden": harness.forbidden_modules(),
                  "tops": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""

REFERENCE = """
import json, sys
sys.path[:0] = {paths!r}
import torch
from reference import plain
prob = plain.Problem(100.0, 1, torch.device("cpu"))
v = prob.vbar[:, None].repeat(1, 2)
assert bool(torch.isfinite(prob.convection(v)).all())
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _run(code: str):
    paths = [str(harness.HERE), str(harness.HERE / "drivers"),
             str(harness.HERE / "tests")]
    proc = subprocess.run([sys.executable, "-c", code.format(paths=paths)],
                          capture_output=True, text=True, timeout=600,
                          cwd=harness.ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax_module():
    out = _run(RUN)
    assert out["forbidden"] == []
    assert "optconpy_tpu_torch" in out["tops"]  # the program did run
    assert not {"jax", "jaxlib", "flax", "optconpy_tpu"} & set(out["tops"])


def test_the_reference_loads_nothing_of_the_program():
    tops = set(_run(REFERENCE))
    assert "reference" in tops
    assert not {"optconpy_tpu_torch", "optconpy_tpu", "jax", "jaxlib",
                "flax"} & tops
