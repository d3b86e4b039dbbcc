"""Entry points of the port: the 3D lock-exchange level of the JAX
package's `__graft_entry__`, the BeamGeneration level of its mapped bench
path, the single-level time loop of its `RunDriver` (somar_tpu/driver.py),
and the carriers of states, probed stencils and raw (array-defined)
geometries between the two packages.

    level, grid = build_level(nx=64, nz=32, ny=16, device="cuda")
    state = run(level, level.initial_state(), nsteps=10)
    level, grid = build_beam_level(640, 512, device="cuda")
    level, grid = build_vortex_level(1024, 512, ramp_time=1.0, device="cuda")
    h = build_amr_hierarchy(64, 96, 64, ratio=(4, 1, 1), device="cuda")
    s0, fine, origin = place_amr(h)        # (.., weights) when K > 1
    s0, fine = run_amr(h, s0, fine, origin, dt=0.01, nsteps=10)
    h = build_amr_hierarchy(64, None, 16, ratios=[(4, 1), (4, 2)])
    s0, fines, origins = place_amr(h)      # per refined level
    s0, fines = run_amr(h, s0, fines, origins, 0.01, 10,
                        parent_sels=h.parent_sels)
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from somar_tpu_torch.amr.hierarchy import AMRHierarchy
from somar_tpu_torch.amr.tagging import TagParams
from somar_tpu_torch.core.grid import Grid
from somar_tpu_torch.geometry.bathymetric import BeamGeneratorMap
from somar_tpu_torch.geometry.geo_source import CartesianMap
from somar_tpu_torch.geometry.level_geometry import (
    LevelGeometry, build_level_geometry, require_device)
from somar_tpu_torch.geometry.raw_geometry import raw_level_geometry
from somar_tpu_torch.ops.stencil_gsrb_kernels import StencilPlan
from somar_tpu_torch.physics.navier_stokes import NSLevel, NSParams, NSState
from somar_tpu_torch.problems.base import LinearProfile, SpongeSpec
from somar_tpu_torch.problems.library import BeamGeneration, VortexStreet
from somar_tpu_torch.problems.lock_exchange import LockExchange
from somar_tpu_torch.solvers.multigrid import MGParams

STATE_FIELDS = tuple(f.name for f in dataclasses.fields(NSState))


def build_level(nx: int, nz: int, ny: int | None = None, *, device="cuda",
                dtype=torch.float32, pressure_solver: str = "auto",
                mg: MGParams = MGParams()):
    """The lock exchange on a 15 x [2 x] 2 box: 2D (x, z) without ny, 3D
    periodic in y with it.  Explicit gravity, Crank-Nicolson viscosity and
    diffusion (nu = kappa = 1e-4), CFL 0.9.  pressure_solver "auto" takes
    the spectral pressure solves; "mg" with mg=MGParams(eps=1e-5, imax=12)
    is the multigrid-forced level of the JAX package's bench.  Runs on the
    GPU unless `device` says otherwise, and raises without one.
    Returns (level, grid)."""
    Lx, Lz = 15.0, 2.0
    if ny is None:
        grid = Grid(nx=(nx, nz), dx=(Lx / nx, Lz / nz), x0=(-Lx / 2, 0.0))
        prob = LockExchange(pert_amp=0.0)
    else:
        Ly = 2.0
        grid = Grid(nx=(nx, ny, nz), dx=(Lx / nx, Ly / ny, Lz / nz),
                    x0=(-Lx / 2, 0.0, 0.0), periodic=(False, True, False))
        prob = LockExchange()
    geo = build_level_geometry(grid, CartesianMap(), device=device,
                               dtype=dtype)
    params = NSParams(nu=1e-4, kappa=(1e-4,), gravity_method=1, cfl=0.9,
                      pressure_solver=pressure_solver, mg=mg, dtype=dtype)
    return NSLevel(geo, prob, params), grid


#: BeamGeneration stand-ins: the shipped input file that fixes the domain,
#: the tidal amplitude and the viscosity is not in the repository, so these
#: values stand in for it (README, "The BeamGeneration level")
BEAM_LENGTH = 38400.0       # Lx (m)
BEAM_DEPTH = 3000.0         # H (m)
BEAM_TIDAL_U0 = 0.01        # m/s, the problem class's default
BEAM_NU = 1e-4              # nu = kappa (m^2/s)
#: recorded by the JAX package's mapped bench configuration
BEAM_ALPHA_DEG = 15.0       # ridge slope
BEAM_OMEGA = 1e-3           # tidal frequency (1/s)
BEAM_NSQ = 1.493e-5         # N^2 of the linear stratification (1/s^2)
BEAM_MG = MGParams(eps=1e-6, imax=20, relax_mode="gsrb")


def build_beam_level(nx: int = 640, nz: int = 512, *, device="cuda",
                     dtype=torch.float32, mg: MGParams = BEAM_MG):
    """Internal-tide beam generation over a 15-degree ridge on a
    terrain-following (BeamGeneratorMap) grid, 2D (x, z), Lx x H =
    38400 x 3000 with x0 = (-Lx/2, 0): linear stratification
    N^2 = 1.493e-5, tide U0 = 0.01 at omega = 1e-3, the problem's sponges,
    implicit gravity (theta 0.6), Crank-Nicolson viscosity and diffusion
    (nu = kappa = 1e-4), the internal-wave dt limit, and multigrid
    pressure solves (point GSRB, eps 1e-6, imax 20, BiCGStab bottom).
    Lx, H, U0 and nu are stand-ins (BEAM_* above).  Runs on the GPU unless
    `device` says otherwise, and raises without one.  Returns (level,
    grid)."""
    Lx, H = BEAM_LENGTH, BEAM_DEPTH
    grid = Grid(nx=(nx, nz), dx=(Lx / nx, H / nz), x0=(-Lx / 2, 0.0))
    geo_src = BeamGeneratorMap((0.0, H), full_depth=H,
                               angle=float(np.deg2rad(BEAM_ALPHA_DEG)),
                               lx=Lx)
    geo = build_level_geometry(grid, geo_src, device=device, dtype=dtype)
    prob = BeamGeneration(background=LinearProfile(b0=0.0, slope=-BEAM_NSQ),
                          tidal_u0=BEAM_TIDAL_U0, tidal_omega=BEAM_OMEGA,
                          ndim=2)
    params = NSParams(nu=BEAM_NU, kappa=(BEAM_NU,), gravity_method=2,
                      gravity_theta=0.6,
                      limit_dt_via_internal_wave_speed=True, mg=mg,
                      dtype=dtype)
    return NSLevel(geo, prob, params), grid


def build_vortex_level(nx: int = 1024, ny: int = 512, *,
                       ramp_time: float = 1.0, device="cuda",
                       dtype=torch.float32, mg: MGParams = MGParams(
                           eps=1e-5, imax=12)):
    """VortexStreet on an 8 x 4 box, 2D (x, y) periodic in y: inflow (1, 0)
    at x = 0 ramped over `ramp_time` (a time-dependent Dirichlet value,
    bound at each step's midpoint time; ramp_time = 0 holds it at 1), an
    extrapolated outflow, sponges over 0.1 of x at each end relaxing to
    the inflow, the default 1e-2 random perturbation (seed 0), nu = 1e-3,
    no gravity, Crank-Nicolson viscosity, and multigrid pressure and
    viscous solves.  A deck cannot set ramp_time.  Runs on the GPU unless
    `device` says otherwise, and raises without one.  Returns (level,
    grid)."""
    Lx, Ly = 8.0, 4.0
    grid = Grid(nx=(nx, ny), dx=(Lx / nx, Ly / ny), x0=(0.0, -Ly / 2),
                periodic=(False, True))
    geo = build_level_geometry(grid, CartesianMap(), device=device,
                               dtype=dtype)
    prob = VortexStreet(inflow_vel=(1.0, 0.0), ramp_time=ramp_time,
                        sponge=SpongeSpec(width_lo=(0.1, 0.0),
                                          width_hi=(0.1, 0.0)))
    params = NSParams(nu=1e-3, kappa=(1e-3,), gravity_method=0,
                      pressure_solver="mg", mg=mg, dtype=dtype)
    return NSLevel(geo, prob, params), grid


#: the tag parameters of the AMR lock exchange: stand-ins (the JAX
#: package's AMR tests use them, tests/test_amr.py:84-98) until the shipped
#: deck inputs.LockExchange_Cartesian3D.machine is in the repository
AMR_TAG_PARAMS = TagParams(buoyancy_tag_tol=0.2, tags_grow=1)


def build_amr_hierarchy(nx: int, ny: int | None, nz: int,
                        ratio=(4, 1, 1), *, ratios=None, device="cuda",
                        dtype=torch.float32, pressure_solver: str = "auto",
                        mg: MGParams = MGParams(),
                        tag_params: TagParams = AMR_TAG_PARAMS,
                        **hierarchy_kw) -> AMRHierarchy:
    """The lock exchange of `build_level` (15 x [2 x] 2, nu = kappa = 1e-4,
    explicit gravity, CN, CFL 0.9; 2D (x, z) with ny = None) as the base of
    a hierarchy with one refined level at `ratio` (per logical
    direction), or one per entry of `ratios` (nested levels), tagged by
    `tag_params` (buoyancy_tag_tol 0.2, tags_grow 1).  hierarchy_kw go to
    AMRHierarchy (e.g. num_patches, grid_buffer_size, do_sync_projection,
    sync_composite_iters).  Runs on the GPU unless `device` says
    otherwise, and raises without one."""
    level, grid = build_level(nx, nz, ny, device=device, dtype=dtype,
                              pressure_solver=pressure_solver, mg=mg)
    ratios = [tuple(ratio)] if ratios is None else [tuple(r) for r in ratios]
    for r in ratios:
        if len(r) != grid.ndim:
            raise ValueError(f"ratio {r} for a {grid.ndim}D base level")
    return AMRHierarchy(level.geo, level.problem, level.params,
                        ratios=ratios, tag_params=tag_params,
                        **hierarchy_kw)


def amr_hierarchy_from_context(ctx, device="cuda") -> AMRHierarchy:
    """The hierarchy of a deck at amr.maxlevel >= 1: the amr.* keys that
    the JAX driver reads (somar_tpu/driver.py:40-85), the per-level
    ratios amr.refratio_lev<l>, amr.max_patches (an int is the finest
    level's K: 1, the default, lets right-sizing double it, any other
    value pins it; a per-level list pins each level it names) and
    amr.grid_buffer_size (the nest buffer, default 1) included.  The
    regrid cadence amr.regrid_intervals (default 10) is set on the
    hierarchy as `regrid_intervals`, one per refined level.  As in the
    JAX driver, amr.advective_{momentum,scalar,lambda}_reflux select the
    refluxed fields ("vel", "scalars", "lam"), either of
    amr.implicit_{scalar,momentum}_reflux turns implicit refluxing on,
    amr.postRegrid_smoothing_coeff (with amr.smooth_after_regrid) is the
    smoothing coefficient, and projection.etaLambda is eta_lambda where
    projection.applyVDCorrection is on."""
    a = ctx.amr
    if a.max_level < 1:
        raise ValueError("amr.maxlevel = 0 has no refined level: use "
                         "RunDriver")
    grid = ctx.base_grid()
    geo = build_level_geometry(grid, ctx.new_geo_source(), device=device,
                               dtype=ctx.ns.dtype)
    tags = TagParams(
        buoyancy_tag_tol=a.buoyancy_tag_tol, vel_tag_tol=a.vel_tag_tol,
        magvort_tag_quota=a.magvort_tag_quota,
        pressure_tag_tol=a.pressure_tag_tol, vort_tag_tol=a.vort_tag_tol,
        do_ri_tagging=a.do_ri_tagging, ri_tag_tol=a.ri_tag_tol,
        tags_grow=a.tags_grow, fill_ratio=a.fill_ratio,
        block_factor=a.block_factor, vert_extrude=a.vert_extrude_tags)
    h = AMRHierarchy(
        geo, ctx.new_problem(), ctx.ns,
        ratios=list(a.ref_ratios[:a.max_level]), tag_params=tags,
        reflux=tuple(name for flag, name in (
            (a.advective_momentum_reflux, "vel"),
            (a.advective_scalar_reflux, "scalars"),
            (a.advective_lambda_reflux, "lam")) if flag),
        implicit_reflux=(a.implicit_scalar_reflux
                         or a.implicit_momentum_reflux),
        regrid_smoothing_coeff=a.regrid_smoothing_coeff,
        eta_lambda=a.eta_lambda if a.apply_vd_correction else 0.0,
        num_patches=a.max_patches, use_subcycling=a.use_subcycling,
        max_grid_size=a.max_grid_size,
        grid_buffer_size=a.grid_buffer_size,
        do_sync_projection=(a.do_sync_projection
                            and a.apply_sync_correction),
        sync_projection_iters=a.sync_projection_iters,
        sync_composite_iters=a.sync_composite_iters)
    ivs = list(a.regrid_intervals) or [10]
    h.regrid_intervals = [int(ivs[min(lev, len(ivs) - 1)])
                          for lev in range(len(h.couplings))]
    return h


def place_amr(h: AMRHierarchy, s0: Optional[NSState] = None,
              init_projection: bool = True):
    """The bench's set-up of a hierarchy: the base level's initial state
    post-initialized (unless s0 is given), the patches placed once from
    its tags and filled, then one composite initial projection.  Returns
    (s0, refined level's state, origins), and the weights as a fourth
    item when the level has K > 1 patches; with nested levels the
    per-level tuples (states, origins[, weights]) in their place, and the
    parent selections in `h.parent_sels`."""
    if s0 is None:
        s0 = h.level0.post_initialize(h.level0.initial_state())
    got = h.initial_patch_states(s0)
    fine, origin = got[:2]
    weights = got[2] if len(got) > 2 else None
    if init_projection:
        s0, fine = h.init_project(s0, fine, origin, weights=weights,
                                  parent_sels=h.parent_sels)
    if len(h.couplings) == 1:
        fine, origin = fine[0], origin[0]
        weights = None if weights is None else weights[0]
    return (s0, fine, origin) if weights is None else \
        (s0, fine, origin, weights)


def run_amr(h: AMRHierarchy, s0: NSState, fine: NSState, origin, dt: float,
            nsteps: int,
            on_step: Optional[Callable[[int, NSState, NSState], None]] = None,
            weights=None, parent_sels=None):
    """`nsteps` coarse steps of length dt at fixed patch origins (the JAX
    package's AMR bench path); fine, origin and weights in either form of
    `AMRHierarchy.advance`, parent_sels per refined level (nested levels
    under parents of K > 1 patches).  on_step(i, s0, fine) is called after
    step i.  Returns (s0, fine)."""
    for i in range(nsteps):
        s0, fine = h.advance(s0, fine, origin, dt, weights=weights,
                             parent_sels=parent_sels)
        if on_step is not None:
            on_step(i, s0, fine)
    return s0, fine


def run(level: NSLevel, state: NSState, nsteps: int,
        on_step: Optional[Callable[[int, NSState, float], None]] = None
        ) -> NSState:
    """RunDriver's single-level loop: initial projections, a first dt of
    init_dt_multiplier times the CFL dt, lagged-pressure initialization,
    then `nsteps` steps with dt = min(compute_dt, max_dt_grow * dt,
    max_dt).  compute_dt is one host read per step (the iterative pressure
    solvers add theirs).  on_step(i, state, dt) is called after step i (and
    with i = -1 on the initialized state)."""
    p = level.params
    state = level.post_initialize(state)
    dt = min(level.compute_dt(state) * p.init_dt_multiplier, p.max_dt)
    if p.fixed_dt > 0.0:
        dt = p.fixed_dt
    state = level.initialize_pressure(state, dt)
    if on_step is not None:
        on_step(-1, state, dt)
    for i in range(nsteps):
        if i > 0:
            dt = min(level.compute_dt(state), p.max_dt_grow * dt, p.max_dt)
            if p.fixed_dt > 0.0:
                dt = p.fixed_dt
        state = level.advance(state, dt)
        if on_step is not None:
            on_step(i, state, dt)
    return state


def ns_state_from_numpy(fields: Dict[str, np.ndarray], device="cuda",
                        dtype=torch.float32) -> NSState:
    """An NSState on `device` (the GPU unless told otherwise) from host
    arrays keyed by field name (e.g. a JAX NSState read out with
    np.asarray per field)."""
    device = require_device(device)
    return NSState(**{
        name: torch.tensor(np.array(fields[name]), dtype=dtype,
                           device=device)
        for name in STATE_FIELDS})


def amr_states_from_numpy(base: Dict[str, np.ndarray],
                          fine: Dict[str, np.ndarray], origin,
                          device="cuda", dtype=torch.float32, weights=None):
    """(base state, refined level's state, origins) of a two-level
    hierarchy on `device` from host arrays (e.g. a JAX hierarchy's states
    read out with np.asarray per field, and its patch origins): the fine
    fields carry a leading K axis when the level has K > 1 patches, and
    the origins become host int64 arrays per array axis ((K, ndim) at
    K > 1).  With weights given, they follow as a fourth item, a host
    float32 (K,) array."""
    out = (ns_state_from_numpy(base, device=device, dtype=dtype),
           ns_state_from_numpy(fine, device=device, dtype=dtype),
           np.asarray(origin, dtype=np.int64).copy())
    if weights is None:
        return out
    return out + (np.asarray(weights, dtype=np.float32).copy(),)


def ns_state_to_numpy(state: NSState) -> Dict[str, np.ndarray]:
    """Host copies of every NSState field, keyed by field name."""
    return {name: getattr(state, name).detach().cpu().numpy()
            for name in STATE_FIELDS}


def stencil_plan_from_numpy(offsets, Wn, R, D, shape, periodic,
                            device="cuda") -> StencilPlan:
    """A StencilPlan of the port from a probed plan's host arrays (e.g. a
    JAX StencilPlan read out with np.asarray), so that kernel tests feed
    both packages the same weights.  dtype follows Wn."""
    device = require_device(device)
    Wn = np.asarray(Wn)
    dtype = torch.float64 if Wn.dtype == np.float64 else torch.float32

    def t(a):
        return torch.as_tensor(np.array(a), dtype=dtype,
                               device=device)

    return StencilPlan(offsets, t(Wn), t(R), t(np.broadcast_to(D, shape)),
                       shape, periodic)


def raw_geometry_from_numpy(grid: Grid, J, Jgup_diag, device="cuda",
                            dtype=torch.float32) -> LevelGeometry:
    """A raw (array-defined) LevelGeometry of the port from host arrays:
    J at cell centres and J g^dd on the faces of each direction (e.g. a
    JAX raw geometry's arrays read out with np.asarray), so that tests
    feed one metric, such as a leptic solver's flattened level, to both
    packages."""
    device = require_device(device)
    return raw_level_geometry(grid, np.asarray(J),
                              [np.asarray(g) for g in Jgup_diag],
                              device=device, dtype=dtype)
