"""The RK3 scheme and the derived fields of the port against the JAX
package's, eagerly (no JAX compile), on levels that both packages build
from the same inline deck through their ProblemContexts:

  * vorticity (2D Cartesian, 2D terrain-following, 3D), the CC
    divergence, the 2D stream function, the vector Laplacian, the gradient
    Richardson number (with and without a background stratification) and
    the kinetic energy, on one state made from a numpy seed: f32 within
    1e-5 of max|field|;
  * one SSP-RK3 step (`advance_rk3`, amr.updateScheme = 2) of the viscous
    lock exchange from the same post-initialized, perturbed state, 2D
    16x8 and 3D 16x8x8: within 1e-4 of max|field| in f32 and 1e-10 in f64
    (the JAX step with jax_enable_x64 and a strongly typed dt);
  * the RK3 step on the CPU launches no kernel and raises for the AMR
    arguments.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from somar_tpu.config.context import ProblemContext as JContext
from somar_tpu.config.parmparse import ParmParse as JPP
from somar_tpu.geometry.level_geometry import build_level_geometry as jgeo
from somar_tpu.ops.stencil import cc_divergence as j_cc_div
from somar_tpu.physics import derived as jder
from somar_tpu.physics.navier_stokes import NSLevel as JLevel
from somar_tpu.physics.navier_stokes import NSState as JState
from somar_tpu.physics.rk3 import advance_rk3 as j_rk3

from somar_tpu_torch import entry
from somar_tpu_torch.config.context import ProblemContext as TContext
from somar_tpu_torch.config.parmparse import ParmParse as TPP
from somar_tpu_torch.geometry.level_geometry import build_level_geometry
from somar_tpu_torch.ops import ctu_kernels
from somar_tpu_torch.ops.stencil import cc_divergence as t_cc_div
from somar_tpu_torch.physics import derived as tder
from somar_tpu_torch.physics.navier_stokes import NSLevel as TLevel
from somar_tpu_torch.physics.rk3 import advance_rk3 as t_rk3
from tests.torch_jax_reference import jax_unoptimized  # noqa: F401 (autouse)

torch.set_num_threads(1)

LOCK = """
amr.nx = {nx}
amr.length = {length}
amr.nx_offset = {offset}
amr.isPeriodic = {periodic}
ibc.problem = 1
amr.gravityMethod = 1
amr.viscosity = 1e-3
amr.scal_diffusion_coeffs = 1e-3
amr.cfl = 0.9
amr.updateScheme = 2
"""
DECKS = {
    "2d": LOCK.format(nx="16 8", length="15 2", offset="-8 0",
                      periodic="0 0"),
    "3d": LOCK.format(nx="16 8 8", length="15 2 2", offset="-8 0 0",
                      periodic="0 1 0"),
    "beam": """
amr.nx = 16 16
amr.length = 38400 3000
amr.nx_offset = -8 0
geometry.coordMap = 2
geometry.beamGenMapAlpha = 15
ibc.problem = 2
ibc.useBackgroundScalar = 1
ibc.bgScalarProfile = 1
ibc.tidalU0 = 0.01
ibc.tidalOmega = 1e-3
amr.gravityMethod = 1
amr.viscosity = 1e-4
amr.scal_diffusion_coeffs = 1e-4
""",
}
DT = 0.02
TOL = {"f32": 1e-4, "f64": 1e-10}
DERIVED_TOL = 1e-5


def _levels(name, prec="f32"):
    """(JAX level, port level) of a deck at a precision."""
    jd = jnp.float64 if prec == "f64" else jnp.float32
    td = torch.float64 if prec == "f64" else torch.float32
    jctx = JContext.from_parmparse(JPP.from_string(DECKS[name]))
    tctx = TContext.from_parmparse(TPP.from_string(DECKS[name]))
    jns = dataclasses.replace(jctx.ns, dtype=jd)
    tns = dataclasses.replace(tctx.ns, dtype=td)
    jl = JLevel(jgeo(jctx.base_grid(), jctx.new_geo_source(), dtype=jd),
                jctx.new_problem(), jns)
    tl = TLevel(build_level_geometry(tctx.base_grid(),
                                     tctx.new_geo_source(), device="cpu",
                                     dtype=td),
                tctx.new_problem(), tns)
    return jl, tl


def _states(jl, tl, seed, project=True):
    """The same state in both packages: the JAX initial state (projected
    by JAX when `project`) plus a velocity perturbation from a numpy
    seed."""
    js = jl.initial_state()
    if project:
        js = jl.post_initialize(js)
    fields = {f: np.asarray(getattr(js, f)) for f in entry.STATE_FIELDS}
    rng = np.random.default_rng(seed)
    vel = fields["vel"]
    fields["vel"] = (vel + 0.05 * rng.standard_normal(vel.shape)).astype(
        vel.dtype)
    js = JState(**{k: jnp.asarray(v) for k, v in fields.items()})
    ts = entry.ns_state_from_numpy(fields, device="cpu",
                                   dtype=tl.params.dtype)
    return js, ts


def _close(got, want, rtol, what):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= rtol * scale, (what, err, scale)


@pytest.mark.parametrize("name", ["2d", "3d", "beam"])
def test_derived_fields_match_jax(name):
    jl, tl = _levels(name)
    js, ts = _states(jl, tl, seed=3, project=False)
    bcs = [tl.vel_bcs_trace[m] for m in range(tl.grid.ndim)]
    _close(tder.compute_vorticity(tl, ts), jder.compute_vorticity(jl, js),
           DERIVED_TOL, "vorticity")
    _close(t_cc_div(ts.vel, tl.geo, bcs),
           j_cc_div(js.vel, jl.geo,
                    [jl.vel_bcs_trace[m] for m in range(jl.grid.ndim)]),
           DERIVED_TOL, "cc_divergence")
    _close(tder.compute_lap_vel(tl, ts), jder.compute_lap_vel(jl, js),
           DERIVED_TOL, "lap_vel")
    _close(tder.compute_ri_number(tl, ts), jder.compute_ri_number(jl, js),
           DERIVED_TOL, "Ri")
    _close(tder.kinetic_energy(tl, ts), jder.kinetic_energy(jl, js),
           DERIVED_TOL, "kinetic energy")
    if name == "2d":
        _close(tder.compute_stream_function(tl, ts),
               jder.compute_stream_function(jl, js), DERIVED_TOL,
               "stream function")


def _rk3_step(name, prec):
    jd = jnp.float64 if prec == "f64" else jnp.float32
    jax.config.update("jax_enable_x64", prec == "f64")
    try:
        jl, tl = _levels(name, prec)
        js, ts = _states(jl, tl, seed=5)
        want = j_rk3(jl, js, jnp.asarray(DT, jd))
        return ({f: np.asarray(getattr(want, f))
                 for f in entry.STATE_FIELDS},
                entry.ns_state_to_numpy(tl.advance(ts, DT)))
    finally:
        jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("prec", ["f32", "f64"])
@pytest.mark.parametrize("name", ["2d", "3d"])
def test_rk3_step_matches_jax(name, prec):
    want, got = _rk3_step(name, prec)
    assert got["vel"].dtype == (np.float64 if prec == "f64" else np.float32)
    for f in ("vel", "scalars", "lam", "cc_phi", "pressure"):
        scale = np.abs(want[f]).max()
        err = np.abs(got[f] - want[f]).max()
        assert err <= TOL[prec] * scale, (name, prec, f, err, scale)
    np.testing.assert_allclose(got["time"], want["time"], rtol=1e-12)


def test_rk3_on_cpu_launches_no_kernel_and_rejects_amr():
    _, tl = _levels("2d")
    state = tl.post_initialize(tl.initial_state())
    ctu_kernels.reset_launch_counts()
    diag = {}
    out = tl.advance(state, DT, diag=diag)
    assert all(n == 0 for n in ctu_kernels.launch_counts().values())
    assert bool(torch.isfinite(out.vel).all())
    # the last stage's MAC projection is exact (spectral): its divergence
    # is roundoff against the velocity's gradient scale
    scale = max(float(out.vel[d].abs().max()) / tl.grid.dx[d]
                for d in range(tl.grid.ndim))
    assert float(diag["max_mac_div"]) <= 1e-5 * scale, (diag, scale)
    # the AMR arguments: no ring leaves the step as it is, and the flux
    # collection returns the stages' weighted fluxes beside it
    ringless = t_rk3(tl, state, DT, rings={"mac": None})
    collect = {}
    collected = t_rk3(tl, state, DT, collect=collect)
    for f in entry.STATE_FIELDS:
        assert torch.equal(getattr(ringless, f), getattr(out, f)), f
        assert torch.equal(getattr(collected, f), getattr(out, f)), f
    assert sorted(collect) == ["lam", "scalars", "vel"]
    assert len(collect["vel"]) == len(collect["lam"]) == tl.grid.ndim
    assert all(bool(torch.isfinite(f).all()) for f in collect["lam"])
