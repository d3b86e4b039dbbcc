"""The slice as a whole: steps of the new problems and options in the
port against the JAX package's step from the same state, in float64
(jax_enable_x64, strongly typed dt, the smoothing multigrid bottom):

  * VortexStreet (2D 32x16, periodic in y) with a ramped inflow
    (ramp_time > 0: a callable BC bound at each step's midpoint time),
    sponges, nu = 1e-3, on a gently stretched x map: every solve takes
    multigrid, the viscous ones with the bound inflow value; 3 steps
    against the jitted JAX step, within 1e-8 of max|field|.  (On a
    uniform map the JAX package cannot build this level: its
    FFTPoissonSolver.supports calls float() on the callable.)  The port's
    host reads a step equal the same run's with ramp_time = 0 when every
    solve takes a fixed number of V-cycles (binding reads nothing; with a
    tolerance the two flows' solves may take different counts);
  * HorizConv (2D 32x16) with nu = kappa = 1e-3: its top buoyancy profile
    enters the diffusive solve, which takes multigrid
    (FFTPoissonSolver.supports refuses an array value; the viscous and
    pressure solves stay spectral), 3 steps against the jitted JAX step,
    1e-8;
  * a flat lock exchange with `projection.solver = 2` (the leptic
    pressure solver with its multigrid finisher) from an inline deck
    through both ProblemContexts, 3 steps against the jitted JAX step,
    1e-8;
  * AdvectionTest with PLM, `projection.isIncompressible = 0` and
    amr.precision = 64 as a deck through ProblemContext and
    RunDriver(device="cpu"), 4 steps at the deck's fixed dt, against the
    JAX step applied eagerly as many times, within 1e-10.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from somar_tpu.config.context import ProblemContext as JContext
from somar_tpu.config.parmparse import ParmParse as JPP
from somar_tpu.core.grid import Grid as JGrid
from somar_tpu.geometry.geo_source import CartesianMap as JCartesian
from somar_tpu.geometry.geo_source import StretchedCartesianMap as JStretch
from somar_tpu.geometry.level_geometry import build_level_geometry as jgeo
from somar_tpu.physics.navier_stokes import NSLevel as JLevel
from somar_tpu.physics.navier_stokes import NSParams as JParams
from somar_tpu.problems.base import SpongeSpec as JSponge
from somar_tpu.problems.library import HorizConv as JHC
from somar_tpu.problems.library import VortexStreet as JVS
from somar_tpu.solvers.leptic import LepticParams as JLP
from somar_tpu.solvers.leptic import LevelLepticSolver as JLeptic
from somar_tpu.solvers.multigrid import MGParams as JMG

from somar_tpu_torch import entry
from somar_tpu_torch.config.context import ProblemContext as TContext
from somar_tpu_torch.config.parmparse import ParmParse as TPP
from somar_tpu_torch.core.grid import Grid as TGrid
from somar_tpu_torch.driver import RunDriver
from somar_tpu_torch.geometry.geo_source import CartesianMap as TCartesian
from somar_tpu_torch.geometry.geo_source import (
    StretchedCartesianMap as TStretch)
from somar_tpu_torch.geometry.level_geometry import build_level_geometry
from somar_tpu_torch.ops import ctu_kernels
from somar_tpu_torch.physics.navier_stokes import NSLevel as TLevel
from somar_tpu_torch.physics.navier_stokes import NSParams as TParams
from somar_tpu_torch.problems.base import SpongeSpec as TSponge
from somar_tpu_torch.problems.library import HorizConv as THC
from somar_tpu_torch.problems.library import VortexStreet as TVS
from somar_tpu_torch.solvers.host_reads import read_scalars
from somar_tpu_torch.solvers.leptic import LepticParams as TLP
from somar_tpu_torch.solvers.leptic import LevelLepticSolver as TLeptic
from somar_tpu_torch.solvers.multigrid import MGParams as TMG
from tests.torch_jax_reference import jax_unoptimized  # noqa: F401 (autouse)

torch.set_num_threads(1)

FIELDS = ("vel", "scalars", "lam", "pressure")
NSTEPS = 3
SOLVER_RTOL = 1e-8      # multigrid or leptic stops at a tolerance
EXACT_RTOL = 1e-10
SMOOTH = dict(bottom_solver="smooth")
HORIZ = dict(eps=1e-2, imin=1, imax=4, num_smooth_down=2, num_smooth_up=2,
             bottom_solver="smooth")


@pytest.fixture(autouse=True)
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _np_state(state):
    return {f: np.asarray(getattr(state, f)) for f in entry.STATE_FIELDS}


def _assert_close(got, want, rtol, fields=FIELDS):
    for f in fields:
        scale = max(float(np.abs(want[f]).max()), 1e-30)
        err = float(np.abs(got[f] - want[f]).max())
        assert err <= rtol * scale, (f, err, scale)
    np.testing.assert_allclose(got["time"], want["time"], rtol=1e-12)


def _run_both(jl, tl, dt, nsteps=NSTEPS):
    """nsteps of the jitted JAX step and of the port from the JAX
    package's post-initialized state; the states after the last step."""
    js = jl.post_initialize(jl.initial_state())
    ts = entry.ns_state_from_numpy(_np_state(js), device="cpu",
                                   dtype=torch.float64)
    step = jax.jit(jl.advance)
    for _ in range(nsteps):
        js = step(js, jnp.asarray(dt, jnp.float64))
        ts = tl.advance(ts, dt)
    return _np_state(js), entry.ns_state_to_numpy(ts)


def _pair(kw, jprob, tprob, jparams, tparams, maps=None):
    jmap, tmap = maps or (JCartesian(), TCartesian())
    jl = JLevel(jgeo(JGrid(**kw), jmap, jnp.float64), jprob, jparams)
    tl = TLevel(build_level_geometry(TGrid(**kw), tmap, device="cpu",
                                     dtype=torch.float64),
                tprob, tparams)
    return jl, tl


VORTEX = dict(nx=(32, 16), dx=(4.0 / 32, 2.0 / 16), x0=(0.0, -1.0),
              periodic=(False, True))


def _stretch_x(xi):
    return xi + 0.05 * np.sin(0.5 * np.pi * xi)


def _identity(xi):
    return xi


def _vortex(ramp_time, mg=SMOOTH):
    sponge = dict(width_lo=(0.1, 0.0), width_hi=(0.1, 0.0))
    common = dict(nu=1e-3, kappa=(1e-3,), gravity_method=0)
    jp = JParams(**common, dtype=jnp.float64, mg=JMG(**mg))
    tp = TParams(**common, dtype=torch.float64, mg=TMG(**mg))
    return _pair(VORTEX,
                 JVS(inflow_vel=(1.0, 0.0), ramp_time=ramp_time,
                     sponge=JSponge(**sponge)),
                 TVS(inflow_vel=(1.0, 0.0), ramp_time=ramp_time,
                     sponge=TSponge(**sponge)), jp, tp,
                 maps=(JStretch((_stretch_x, _identity)),
                       TStretch((_stretch_x, _identity))))


def test_vortex_street_ramped_inflow_steps_match_jax():
    jl, tl = _vortex(ramp_time=0.5)
    assert tl._time_bcs and jl._time_bcs
    assert tl.projector.method == "mg"
    assert all(hs._fft is None and hs._mg is not None
               for hs in tl.visc_solvers)
    want, got = _run_both(jl, tl, 0.02)
    _assert_close(got, want, SOLVER_RTOL)


def test_vortex_street_binding_adds_no_host_read():
    """Host reads a step with the ramped inflow equal those with a
    constant one (the binding's time is a 0-d tensor on the device)."""
    reads = {}
    fixed = dict(SMOOTH, eps=1e-30, imin=3, imax=3)
    for ramp in (0.5, 0.0):
        _, tl = _vortex(ramp, fixed)
        state = tl.post_initialize(tl.initial_state())
        state = tl.advance(state, 0.02)
        r0 = read_scalars.count
        for _ in range(2):
            state = tl.advance(state, 0.02)
        reads[ramp] = read_scalars.count - r0
        assert torch.isfinite(state.vel).all()
    assert reads[0.5] == reads[0.0] > 0


def test_horiz_conv_steps_match_jax():
    kw = dict(nx=(32, 16), dx=(15.0 / 32, 2.0 / 16))
    common = dict(nu=1e-3, kappa=(1e-3,), gravity_method=1)
    jl, tl = _pair(kw, JHC(), THC(),
                   JParams(**common, mg=JMG(**SMOOTH), dtype=jnp.float64),
                   TParams(**common, mg=TMG(**SMOOTH), dtype=torch.float64))
    hs = tl.diff_solvers[0]
    assert hs._fft is None and tl.projector.method == "fft"
    assert tl._visc_batched is not None
    want, got = _run_both(jl, tl, 0.05)
    _assert_close(got, want, SOLVER_RTOL)


LEPTIC_DECK = """
amr.nx = 32 8
amr.nx_offset = -16 0
amr.length = 15.0 0.5
amr.isPeriodic = 0 0
ibc.problem = 1
amr.gravityMethod = 1
amr.viscosity = 1e-4
amr.scal_diffusion_coeffs = 1e-4
projection.solver = 2
AMRMG.bottom_solver = smooth
amr.verbosity = 0
"""


def test_leptic_lock_exchange_steps_match_jax():
    jctx = JContext.from_parmparse(JPP.from_string(LEPTIC_DECK))
    tctx = TContext.from_parmparse(TPP.from_string(LEPTIC_DECK))
    assert jctx.ns.pressure_solver == tctx.ns.pressure_solver == "leptic"
    jl = JLevel(jgeo(jctx.base_grid(), jctx.new_geo_source(), jnp.float64),
                jctx.new_problem(),
                dataclasses.replace(jctx.ns, dtype=jnp.float64,
                                    mg=JMG(**SMOOTH)))
    tl = TLevel(build_level_geometry(tctx.base_grid(), tctx.new_geo_source(),
                                     device="cpu", dtype=torch.float64),
                tctx.new_problem(),
                dataclasses.replace(tctx.ns, dtype=torch.float64,
                                    mg=TMG(**SMOOTH)))
    # the projectors' leptic solvers with the smoothing bottom (f64)
    jl.projector.leptic = JLeptic(jl.geo, jl.projector.phi_bcs,
                                  JLP(horiz_mg=JMG(**HORIZ)), jnp.float64)
    tl.projector.leptic = TLeptic(tl.geo, tl.projector.phi_bcs,
                                  TLP(horiz_mg=TMG(**HORIZ)), torch.float64)
    want, got = _run_both(jl, tl, 0.02)
    _assert_close(got, want, SOLVER_RTOL)
    info = tl.projector.last_info
    assert info["mac"][1] < 1e-5 and info["cc"][1] < 1e-5


ADVECTION_DECK = """
amr.nx = 32 32
amr.length = 1 1
amr.isPeriodic = 1 1
ibc.problem = 0
projection.isIncompressible = 0
amr.gravityMethod = 0
advection.normalPredOrderScal = 1
advection.normalPredOrderVel = 1
amr.precision = 64
amr.fixed_dt = 0.01
amr.maxsteps = 4
amr.final = 100
plot.plot_interval = -1
plot.checkpoint_interval = -1
amr.verbosity = 0
"""


def test_advection_test_plm_deck_through_the_driver(tmp_path):
    tctx = TContext.from_parmparse(TPP.from_string(ADVECTION_DECK))
    assert tctx.ns.advection_scal.normal_pred_order == 1
    assert not tctx.ns.is_incompressible
    ctu_kernels.reset_launch_counts()
    drv = RunDriver(tctx, out_dir=str(tmp_path), device="cpu")
    state, steps = drv.run(verbose=False)
    assert steps == 4
    # CPU tensors run the kernels' twins: no launch is counted
    assert all(n == 0 for n in ctu_kernels.launch_counts().values())
    # the JAX step from the same deck (the JAX context without the
    # precision key, which would switch x64 on process-wide)
    jctx = JContext.from_parmparse(JPP.from_string(
        ADVECTION_DECK.replace("amr.precision = 64", "")))
    jl = JLevel(jgeo(jctx.base_grid(), jctx.new_geo_source(), jnp.float64),
                jctx.new_problem(),
                dataclasses.replace(jctx.ns, dtype=jnp.float64))
    js = jl.initial_state()
    for _ in range(steps):
        js = jl.advance(js, jnp.asarray(0.01, jnp.float64))
    _assert_close(entry.ns_state_to_numpy(state), _np_state(js), EXACT_RTOL,
                  fields=("vel", "scalars", "lam"))
    s = state.scalars[0]
    assert -0.15 < float(s.min()) and float(s.max()) < 1.15
