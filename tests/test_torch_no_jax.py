"""The port runs without JAX: a fresh interpreter imports every module of
somar_tpu_torch, builds and steps a level on the CPU with the spectral and
with the multigrid pressure solver, and has imported neither jax nor the
JAX package."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib, pkgutil, sys
import torch
torch.set_num_threads(1)
import somar_tpu_torch
for mod in pkgutil.walk_packages(somar_tpu_torch.__path__,
                                 "somar_tpu_torch."):
    importlib.import_module(mod.name)
from somar_tpu_torch import entry
from somar_tpu_torch.solvers.multigrid import MGParams
level, _ = entry.build_level(nx=16, nz=8, ny=8, device="cpu")
state = entry.run(level, level.initial_state(), 2)
assert bool(torch.isfinite(state.vel).all())
level2, _ = entry.build_level(nx=16, nz=8, device="cpu")
state2 = entry.run(level2, level2.initial_state(), 2)
assert bool(torch.isfinite(state2.scalars).all())
level3, _ = entry.build_level(nx=16, nz=8, ny=8, device="cpu",
                              pressure_solver="mg",
                              mg=MGParams(eps=1e-5, imax=12))
assert level3.projector.method == "mg"
state3 = level3.post_initialize(level3.initial_state())
state3 = level3.advance(state3, 0.02)
assert bool(torch.isfinite(state3.vel).all())
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "somar_tpu" or m.startswith("somar_tpu."))
assert not bad, bad
print("ok")
"""


def test_port_imports_no_jax():
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
