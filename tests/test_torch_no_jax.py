"""The port runs without JAX: a fresh interpreter imports every module of
somar_tpu_torch (the mapped geometry, the probed-stencil kernels K7-K8, the
altered metric and the stratification utilities among them), builds and
steps a level on the CPU with the spectral and with the multigrid pressure
solver, steps the mapped implicit-gravity BeamGeneration level, runs a
tiny input deck through RunDriver and through the command line's main
function (with an RK3 step), and has imported neither jax nor the JAX
package."""

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
level4, _ = entry.build_beam_level(40, 32, device="cpu")
assert level4._altered_metric is not None
assert level4.projector.mg.ops[0]._stencil_plan is not None
state4 = level4.post_initialize(level4.initial_state())
state4 = level4.advance(state4, level4.compute_dt(state4))
assert bool(torch.isfinite(state4.vel).all())
assert bool(torch.isfinite(state4.scalars).all())
import os, tempfile
from somar_tpu_torch.__main__ import main
from somar_tpu_torch.config.context import ProblemContext
from somar_tpu_torch.config.parmparse import ParmParse
from somar_tpu_torch.driver import RunDriver
deck = ("amr.nx = 16 8\namr.length = 15 2\namr.nx_offset = -8 0\n"
        "ibc.problem = 1\namr.viscosity = 1e-4\namr.max_dt = 0.05\n"
        "plot.plot_interval = 1\nplot.checkpoint_interval = 1\n"
        "amr.verbosity = 0\n")
with tempfile.TemporaryDirectory() as tmp:
    ctx = ProblemContext.from_parmparse(ParmParse.from_string(deck))
    state5, steps = RunDriver(ctx, out_dir=tmp, device="cpu").run(
        max_steps=2, verbose=False)
    assert steps == 2 and bool(torch.isfinite(state5.vel).all())
    path = os.path.join(tmp, "deck")
    with open(path, "w") as f:
        f.write(deck)
    os.chdir(tmp)
    assert main(["somar_tpu_torch", "--device", "cpu", path,
                 "amr.maxsteps=1", "amr.updateScheme=2"]) == 0
    assert os.path.exists(os.path.join(tmp, "chkpt_final.hdf5"))
    os.chdir("/")
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
