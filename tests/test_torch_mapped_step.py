"""The mapped, implicit-gravity step as a whole: the port's NSLevel.advance
on a small BeamGeneration level against the JAX package's from the same
state, in f32 (tests/test_torch_mapped_step_f64.py: the same in f64).

  * The 40x32 BeamGeneration level of entry.build_beam_level (dx/dz =
    10.24, as at 640x512; 7 MG levels, stencil plans on the 4 finest):
    implicit gravity with the altered-metric CC projection, tide, sponges,
    Crank-Nicolson viscosity and diffusion on multigrid, the internal-wave
    dt limit.  Five steps at the JAX package's compute_dt: vel, scalars,
    pressure within 1e-3 of max|field| in f32 after 3 and 5 steps (the
    solves stop at eps = 1e-6 of ||rhs||, and in f32 several stall at a
    roundoff floor of a few 1e-6), within 1e-8 in f64 with the smoothing
    bottom solver (the JAX BiCGStab cannot run under jax_enable_x64);
    compute_dt equal to 1e-6 relative before every step.
  * A step on the CPU launches no kernel and reports both solves.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from somar_tpu.core.grid import Grid as JGrid
from somar_tpu.geometry.bathymetric import BeamGeneratorMap as JBeamMap
from somar_tpu.geometry.level_geometry import build_level_geometry as jgeo
from somar_tpu.physics.navier_stokes import NSLevel as JLevel
from somar_tpu.physics.navier_stokes import NSParams as JParams
from somar_tpu.problems.base import LinearProfile as JLinear
from somar_tpu.problems.library import BeamGeneration as JBeam
from somar_tpu.solvers.multigrid import MGParams as JMG

from somar_tpu_torch import entry
from somar_tpu_torch.ops import stencil_gsrb_kernels as sgk
from somar_tpu_torch.solvers.multigrid import MGParams as TMG
from tests.torch_jax_reference import jax_unoptimized  # noqa: F401 (autouse)

torch.set_num_threads(1)

NX, NZ = 40, 32
NSTEPS = 5
FIELDS = ("vel", "scalars", "pressure")
TOL = {"f32": 1e-3, "f64": 1e-8}
MG = {"f32": dict(eps=1e-6, imax=20, relax_mode="gsrb"),
      "f64": dict(eps=1e-6, imax=20, relax_mode="gsrb",
                  bottom_solver="smooth")}


def _np_state(state):
    return {f: np.asarray(getattr(state, f)) for f in entry.STATE_FIELDS}


def _jax_level(prec):
    jd = jnp.float64 if prec == "f64" else jnp.float32
    Lx, H = entry.BEAM_LENGTH, entry.BEAM_DEPTH
    grid = JGrid(nx=(NX, NZ), dx=(Lx / NX, H / NZ), x0=(-Lx / 2, 0.0))
    src = JBeamMap((0.0, H), full_depth=H,
                   angle=float(np.deg2rad(entry.BEAM_ALPHA_DEG)), lx=Lx)
    prob = JBeam(background=JLinear(0.0, -entry.BEAM_NSQ),
                 tidal_u0=entry.BEAM_TIDAL_U0, tidal_omega=entry.BEAM_OMEGA,
                 ndim=2)
    params = JParams(nu=entry.BEAM_NU, kappa=(entry.BEAM_NU,),
                     gravity_method=2, gravity_theta=0.6,
                     limit_dt_via_internal_wave_speed=True,
                     mg=JMG(**MG[prec]), dtype=jd)
    return JLevel(jgeo(grid, src, dtype=jd), prob, params)


def trajectories(prec):
    """(dt, port dt, JAX state, port state) after each of NSTEPS steps from
    the initial state (the IC velocity is zero, so the initial projections
    leave it as it is), and the diagnostics of both packages on the last
    JAX state."""
    jd = jnp.float64 if prec == "f64" else jnp.float32
    td = torch.float64 if prec == "f64" else torch.float32
    jax.config.update("jax_enable_x64", prec == "f64")
    try:
        jl = _jax_level(prec)
        js = jl.initial_state()
        tl, _ = entry.build_beam_level(NX, NZ, device="cpu", dtype=td,
                                       mg=TMG(**MG[prec]))
        assert tl.projector.method == "mg"
        assert tl._altered_metric is not None
        ts = entry.ns_state_from_numpy(_np_state(js), device="cpu",
                                       dtype=td)
        step = jax.jit(lambda s, d: jl.advance(s, d))
        out = []
        for _ in range(NSTEPS):
            dt = float(jl.compute_dt(js))
            dt_port = tl.compute_dt(ts)
            js = step(js, jnp.asarray(dt, jd))
            ts = tl.advance(ts, dt)
            out.append((dt, dt_port, _np_state(js),
                        entry.ns_state_to_numpy(ts)))
        same = entry.ns_state_from_numpy(_np_state(js), device="cpu",
                                         dtype=td)
        # sum of |energy density| J dV: the energy's terms cancel (b' z
        # takes both signs), so its roundoff scales with this, not with it
        dens = 0.5 * (same.vel ** 2).sum(0) + same.scalars[0] * tl._z_cc
        scale = float((dens * tl.geo.J).abs().sum()) * float(
            np.prod(tl.grid.dx))
        diags = {"energy": (float(jl.total_energy(js)),
                            float(tl.total_energy(same)), scale),
                 "max_div": (float(jl.max_divergence(js)),
                             float(tl.max_divergence(same)),
                             float(jl.max_divergence(js)))}
        return out, diags
    finally:
        jax.config.update("jax_enable_x64", False)


def check_step(trajectory, prec, after):
    _, _, want, got = trajectory[0][after - 1]
    assert got["vel"].dtype == (np.float64 if prec == "f64" else np.float32)
    for f in FIELDS:
        scale = np.abs(want[f]).max()
        err = np.abs(got[f] - want[f]).max()
        assert err <= TOL[prec] * scale, (prec, after, f, err, scale)
    np.testing.assert_allclose(got["time"], want["time"], rtol=1e-6)


def check_dt(trajectory):
    """The internal-wave limit sets dt here (c0 ~ 3.7 m/s against a tide of
    1e-2): the vertical eigenproblem and the projected phase speeds agree."""
    for dt, dt_port, _, _ in trajectory[0]:
        assert abs(dt_port - dt) <= 1e-6 * dt, (dt, dt_port)


def check_diagnostics(trajectory, rtol):
    """total_energy (J-weighted, physical z) and max_divergence (mapped
    divergence of the face-averaged velocity) on the same state, each
    within rtol of its scale."""
    for name, (want, got, scale) in trajectory[1].items():
        assert abs(got - want) <= rtol * abs(scale), (name, want, got, scale)


@pytest.fixture(scope="module")
def trajectory():
    return trajectories("f32")


@pytest.mark.parametrize("after", [3, NSTEPS])
def test_beam_step_matches_jax(trajectory, after):
    check_step(trajectory, "f32", after)


def test_beam_compute_dt_matches_jax(trajectory):
    check_dt(trajectory)


def test_beam_diagnostics_match_jax(trajectory):
    # f32 sums of 1280 cells in another order
    check_diagnostics(trajectory, 1e-6)


def test_beam_step_on_cpu_counts_no_launches():
    level, grid = entry.build_beam_level(NX, NZ, device="cpu")
    assert grid.shape == (NZ, NX)
    mg = level.projector.mg
    assert [op._stencil_plan is not None for op in mg.ops] == \
        [True] * 4 + [False] * 3
    sgk.reset_launch_counts()
    state = level.post_initialize(level.initial_state())
    state = level.advance(state, level.compute_dt(state))
    assert sgk.launch_counts() == {"stencil_gsrb_sweeps": 0,
                                   "stencil_helm_residual": 0}
    assert set(level.projector.last_info) == {"mac", "cc"}
    for f in FIELDS:
        assert torch.isfinite(getattr(state, f)).all(), f
