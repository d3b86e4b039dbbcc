"""The port runs without JAX: a fresh interpreter imports every module of
somar_tpu_torch (the mapped geometry, the probed-stencil kernels K7-K8, the
altered metric and the stratification utilities among them), builds and
steps a level on the CPU with the spectral and with the multigrid pressure
solver, steps the mapped implicit-gravity BeamGeneration level, runs a
tiny input deck through RunDriver and through the command line's main
function (with an RK3 step), builds every ibc.problem from a deck and
steps VortexStreet with a ramped inflow, HorizConv, PLM advection with
central fluxes and the leptic pressure solver, traces a batch, filters a
field, imports the AMR modules and the clustering library, places and
steps a two-level hierarchy, runs an AMR deck (amr.maxlevel = 1, a
regrid) through RunDriver and the command line, and has imported neither
jax nor the JAX package.  The script blocks both imports: any attempt
fails it."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib, importlib.abc, pkgutil, sys


class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "somar_tpu"):
            raise ImportError(f"{name} is blocked")
        return None


sys.meta_path.insert(0, _Block())
import numpy as np
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
from somar_tpu_torch.core.grid import Grid
from somar_tpu_torch.geometry.geo_source import CartesianMap
from somar_tpu_torch.geometry.level_geometry import build_level_geometry
from somar_tpu_torch.physics import godunov
from somar_tpu_torch.physics.navier_stokes import NSLevel, NSParams
from somar_tpu_torch.problems import VortexStreet
from somar_tpu_torch.utils.filters import shapiro_filter
small = ("amr.nx = 16 8\namr.length = 4 1\namr.nx_offset = 0 -8\n"
         "ibc.useBackgroundScalar = 1\namr.viscosity = 1e-3\n"
         "amr.scal_diffusion_coeffs = 1e-3\namr.fixed_dt = 0.01\n")
for t in range(9):
    ctx = ProblemContext.from_parmparse(ParmParse.from_string(
        small + f"ibc.problem = {t}\n"
        + ("projection.solver = 2\n" if t == 1 else "")
        + ("advection.normalPredOrderScal = 1\nadvection.useUpwindingScal"
           " = 0\n" if t == 3 else "")))
    lev = NSLevel(build_level_geometry(ctx.base_grid(),
                                       ctx.new_geo_source(), device="cpu",
                                       dtype=ctx.ns.dtype),
                  ctx.new_problem(), ctx.ns)
    st = lev.advance(lev.post_initialize(lev.initial_state()), 0.01)
    assert bool(torch.isfinite(st.vel).all()), t
g = Grid(nx=(16, 8), dx=(0.25, 0.125), periodic=(False, True))
geo = build_level_geometry(g, CartesianMap(), device="cpu")
lev = NSLevel(geo, VortexStreet(inflow_vel=(1.0, 0.0), ramp_time=0.1),
              NSParams(nu=1e-3, gravity_method=0))
st = lev.advance(lev.post_initialize(lev.initial_state()), 0.01)
assert lev._time_bcs and bool(torch.isfinite(st.vel).all())
u_pad = [godunov.fill_ghosts_cc(st.vel[d], g, lev.vel_bcs_trace[d].at_time(
    0.0), 4) for d in range(2)]
adv = tuple(godunov.pad_valid_faces(torch.zeros(g.fc_shape(d)), g, d)
            for d in range(2))
faces = godunov.trace_face_states_batched(
    [st.scalars[0], st.lam], None, [lev.scal_bcs, lev.lam_bcs], adv, 0.01,
    geo, godunov.AdvectionParams(normal_pred_order=0), u_pad)
assert faces[0].shape[0] == 2
assert bool(torch.isfinite(shapiro_filter(st.vel[0], g,
                                          lev.lam_bcs)).all())
import somar_tpu_torch.amr.composite, somar_tpu_torch.amr.flux_register
import somar_tpu_torch.amr.hierarchy, somar_tpu_torch.amr.tagging
import somar_tpu_torch.amr.transfer, somar_tpu_torch.native
from somar_tpu_torch.ops.norms import composite_mapped_sum
h = entry.build_amr_hierarchy(32, None, 8, (4, 1), device="cpu")
s0, fine, origin = entry.place_amr(h)
s0, fine = entry.run_amr(h, s0, fine, origin, 0.02, 1)
assert bool(torch.isfinite(fine.vel).all()) and h.last_sync_info[0] == 2
assert bool(torch.isfinite(composite_mapped_sum(
    h, [s0.scalars[0], fine.scalars[0]], [origin])))
amr_deck = ("amr.nx = 32 8\namr.length = 15 2\namr.nx_offset = -16 0\n"
            "ibc.problem = 1\namr.viscosity = 1e-4\n"
            "amr.scal_diffusion_coeffs = 1e-4\namr.maxlevel = 1\n"
            "amr.refratio_lev0 = 4 1\namr.regrid_intervals = 2\n"
            "amr.buoyancy_tag_tol = 0.2\namr.tags_grow = 1\n"
            "amr.max_dt = 0.05\nplot.plot_interval = 2\n"
            "plot.checkpoint_interval = 2\namr.verbosity = 0\n")
with tempfile.TemporaryDirectory() as tmp:
    ctx = ProblemContext.from_parmparse(ParmParse.from_string(amr_deck))
    drv = RunDriver(ctx, out_dir=tmp, device="cpu")
    s6, steps = drv.run(max_steps=2, verbose=False)
    assert steps == 2 and drv.hierarchy is not None and len(drv.regrids) == 1
    assert bool(torch.isfinite(drv.fine_state[0].vel).all())
    path = os.path.join(tmp, "amr_deck")
    with open(path, "w") as f:
        f.write(amr_deck)
    os.chdir(tmp)
    assert main(["somar_tpu_torch", "--device", "cpu", path,
                 "amr.maxsteps=2"]) == 0
    for name in ("plot_000002.2d.hdf5", "chkpt_000002.hdf5"):
        assert os.path.exists(os.path.join(tmp, name)), name
    os.chdir("/")
assert somar_tpu_torch.native.tag_bounding_box(
    np.ones((2, 3), bool)) is not None
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
