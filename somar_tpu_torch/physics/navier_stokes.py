"""Single-level incompressible Boussinesq Navier-Stokes: the PPM step
(PyTorch port of `somar_tpu.physics.navier_stokes`).

One step (`NSLevel.advance`):
  advecting velocities: trace each velocity component to faces (CTU
    kernels K1-K3), MAC-project the normal fluxes;
  scalars and the freestream tracer lambda: trace + fused flux difference
    (K1-K3) + implicit diffusion;
  velocity: re-upwind the stashed velocity traces against the projected
    advecting velocity (K4), add gravity / lagged pressure gradient /
    sponge / tidal forcing, implicit viscous update;
  CC projection.

Velocity is stored in the Cartesian basis at cell centers.  The step takes
dt as a Python float, so no kernel argument forces a device sync;
`compute_dt` is one host read per step; the iterative solvers add one per
V-cycle and one per BiCGStab iteration (solvers/host_reads.py).

Uniform Cartesian levels run with spectral, multigrid or BiCGStab
pressure solves and spectral or multigrid heat solves.  Implicit gravity
(gravity_method=2), the RK3 scheme, mapped metrics, time-dependent BCs and
the internal-wave dt limit raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from somar_tpu_torch.core.bc import BC, FieldBCs, apply_fc_bc, fill_ghosts_cc
from somar_tpu_torch.geometry.level_geometry import LevelGeometry
from somar_tpu_torch.ops.stencil import cc_to_fc, face_avg, mac_divergence
from somar_tpu_torch.physics.godunov import (
    ADVECT_GROW, AdvectionParams, _crop_faces, divergence_from_partials,
    flux_divergence, momentum_flux_divergence, pad_valid_faces,
    riemann_from_states, trace_face_states)
from somar_tpu_torch.problems.base import Problem, sponge_ramp, tidal_source
from somar_tpu_torch.projection.projector import LevelProjector
from somar_tpu_torch.solvers.host_reads import read_scalars
from somar_tpu_torch.solvers.multigrid import MGParams
from somar_tpu_torch.solvers.parabolic import (
    BatchedSpectralHeat, make_heat_solver)
from somar_tpu_torch.solvers.poisson_op import PoissonOp


# --------------------------------------------------------------------------
# parameters (the amr.* / advection.* namespaces)
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class NSParams:
    nu: float = 0.0                       # amr.viscosity
    kappa: Tuple[float, ...] = (0.0,)     # amr.scal_diffusion_coeffs
    viscous_solver_type: int = 1          # 0=BE 1=CN 2=TGA
    diffusive_solver_type: int = 1
    gravity_method: int = 1               # 0=none 1=explicit 2=implicit (IG)
    gravity_theta: float = 0.6
    cfl: float = 0.8
    max_dt: float = 1.0e8
    max_dt_grow: float = 1.5
    init_dt_multiplier: float = 0.1
    fixed_dt: float = -1.0
    limit_dt_via_viscosity: bool = True
    limit_dt_via_diffusion: bool = True
    limit_dt_via_pressure_gradient: bool = False
    limit_dt_via_internal_wave_speed: bool = False
    nonlinear_differencing_form: int = 0  # -1 none, 0 conservative, 1 advective
    update_scheme: str = "ppm"            # "ppm" | "rk3"
    advection_vel: AdvectionParams = AdvectionParams(use_limiting=False)
    advection_scal: AdvectionParams = AdvectionParams(use_limiting=True)
    mg: MGParams = MGParams()
    #: per-solver MG/bottom overrides; None falls back to `mg`
    mg_mac: Optional[MGParams] = None
    mg_cc: Optional[MGParams] = None
    mg_viscous: Optional[MGParams] = None
    mg_diffusive: Optional[MGParams] = None
    is_incompressible: bool = True
    #: "auto" (spectral where it applies, else MG) | "fft" | "mg" | "bicgstab"
    pressure_solver: str = "auto"
    level_projection_iters: int = 1
    dtype: torch.dtype = torch.float32


# --------------------------------------------------------------------------
# state
# --------------------------------------------------------------------------
@dataclasses.dataclass
class NSState:
    vel: torch.Tensor                # (ndim,)+shape, Cartesian CC
    scalars: torch.Tensor            # (nscal,)+shape (comp 0 = buoyancy dev)
    lam: torch.Tensor                # freestream tracer
    mac_phi: torch.Tensor            # last MAC projection potential
    cc_phi: torch.Tensor             # last CC projection increment potential
    pressure: torch.Tensor           # lagged CC pressure p (incremental form)
    e_lambda: torch.Tensor           # VD/freestream potential (AMR sync)
    time: torch.Tensor               # 0-d


@dataclasses.dataclass
class _StepTemps:
    """Per-step temporaries shared by the traces of one `advance`."""
    u_pad: list                      # ADVECT_GROW-padded tracing velocities
    adv_valid: tuple = None          # projected advecting fluxes (valid faces)
    adv_pad: tuple = None            # the same, padded face-indexed
    vel_pre: list = None             # per component, per dir (lo_f, hi_f)


class NSLevel:
    """One level's Navier-Stokes integrator."""

    def __init__(self, geo: LevelGeometry, problem: Problem,
                 params: NSParams = NSParams()):
        if params.update_scheme != "ppm":
            raise NotImplementedError(
                f"update_scheme={params.update_scheme!r} is ported in "
                "slice 5, see ROADMAP")
        if params.gravity_method == 2:
            raise NotImplementedError(
                "implicit gravity (gravity_method=2) is ported in slice 3, "
                "see ROADMAP")
        if params.limit_dt_via_internal_wave_speed and \
                problem.use_background_scalar:
            raise NotImplementedError(
                "the internal-wave dt limit is ported in slice 3")
        self.geo = geo
        self.grid = geo.grid
        self.problem = problem
        self.params = params
        self.device = geo.device
        grid = self.grid
        ndim = grid.ndim
        dtype = params.dtype
        kw = dict(dtype=dtype, device=self.device)

        self.is_viscous = params.nu > 0.0
        self.vel_bcs_trace = problem.vel_bcs(grid, viscous=False)
        self.vel_bcs_visc = problem.vel_bcs(grid, viscous=self.is_viscous)
        self.scal_bcs = problem.scalar_bcs(grid)
        self.lam_bcs = FieldBCs.from_periodic(grid, BC.extrap(1))
        if (any(b.time_dependent for b in self.vel_bcs_trace)
                or any(b.time_dependent for b in self.vel_bcs_visc)
                or self.scal_bcs.time_dependent):
            raise NotImplementedError(
                "time-dependent BC values are not ported yet, see ROADMAP")

        mg_purposes = {k: v for k, v in (("mac", params.mg_mac),
                                         ("cc", params.mg_cc))
                       if v is not None}
        self.projector = LevelProjector(geo, mg_params=params.mg,
                                        mg_params_by_purpose=mg_purposes,
                                        method=params.pressure_solver,
                                        dtype=dtype)

        if self.is_viscous:
            self.visc_solvers = [
                make_heat_solver(params.viscous_solver_type, geo,
                                 self.vel_bcs_visc[m], params.nu,
                                 params.mg_viscous or params.mg, dtype)
                for m in range(ndim)]
            # one batched spectral solve for all velocity components (same
            # scheme and nu, per-component BCs) where every component has a
            # spectral path; else the per-component solvers
            self._visc_batched = (
                BatchedSpectralHeat(self.visc_solvers)
                if BatchedSpectralHeat.supports(self.visc_solvers) else None)
        diff_bcs = getattr(problem, "diffusive_solve_bcs", None)
        diff_bcs = diff_bcs(grid) if callable(diff_bcs) else \
            FieldBCs.from_periodic(grid, BC.neumann(0.0))
        self.diff_solvers = []
        for comp in range(problem.num_scalars):
            kap = params.kappa[comp] if comp < len(params.kappa) else 0.0
            self.diff_solvers.append(
                make_heat_solver(params.diffusive_solver_type, geo, diff_bcs,
                                 kap, params.mg_diffusive or params.mg,
                                 dtype)
                if kap > 0.0 else None)

        # Laplacian op for the explicit viscous source
        self._visc_ops = [PoissonOp(geo, self.vel_bcs_visc[m])
                          for m in range(ndim)]

        self._sponge_ramp = None
        if problem.sponge is not None:
            self._sponge_ramp = torch.as_tensor(
                sponge_ramp(grid, problem.sponge), **kw)
            vt, st = problem.sponge_targets(geo)
            self._sponge_targets = (torch.as_tensor(vt, **kw),
                                    torch.as_tensor(st, **kw))
        self._nsq_cc = (torch.as_tensor(problem.nsq_cc(geo), **kw)
                        if problem.use_background_scalar else None)
        # physical z at cell centers, for the energy diagnostic
        self._z_cc = torch.as_tensor(np.ascontiguousarray(np.broadcast_to(
            geo.phys_coords_cc()[ndim - 1], grid.shape)), **kw)

    # ------------------------------------------------------------- set-up
    def _tensor(self, arr):
        return torch.as_tensor(np.asarray(arr), dtype=self.params.dtype,
                               device=self.device)

    def initial_state(self) -> NSState:
        shape = self.grid.shape
        kw = dict(dtype=self.params.dtype, device=self.device)
        return NSState(
            vel=self._tensor(self.problem.vel_ic(self.geo)),
            scalars=self._tensor(np.stack([
                self.problem.scalar_ic(self.geo, c)
                for c in range(self.problem.num_scalars)])),
            lam=torch.ones(shape, **kw),
            mac_phi=torch.zeros(shape, **kw),
            cc_phi=torch.zeros(shape, **kw),
            pressure=torch.zeros(shape, **kw),
            e_lambda=torch.zeros(shape, **kw),
            time=torch.zeros((), **kw))

    def post_initialize(self, state: NSState, num_proj: int = 2) -> NSState:
        """Initial projection iterations: project the IC velocity so the
        first step starts divergence-free."""
        if not self.params.is_incompressible:
            return state
        vel = state.vel
        for _ in range(num_proj):
            vel, _, _ = self.projector.project_cc(vel, self.vel_bcs_trace)
        return dataclasses.replace(state, vel=vel)

    def initialize_pressure(self, state: NSState, dt: float,
                            iters: int = 2) -> NSState:
        """Converge the lagged pressure with dummy advances that keep only
        the pressure."""
        if not self.params.is_incompressible:
            return state
        for _ in range(iters):
            trial = self.advance(state, dt)
            state = dataclasses.replace(state, pressure=trial.pressure,
                                        mac_phi=trial.mac_phi,
                                        cc_phi=trial.cc_phi)
        return state

    # ----------------------------------------------------------- forcing
    def _gravity_source(self, scalars):
        """-b' zhat for explicit gravity; Python 0.0 for the components it
        leaves unforced."""
        ndim = self.grid.ndim
        src = [0.0] * ndim
        if self.params.gravity_method == 1:
            src[ndim - 1] = -scalars[0]
        return src

    def _sponge_source(self, vel, scalars, dt):
        """Rayleigh damping toward targets."""
        if self._sponge_ramp is None:
            return None, None
        coeff = self._sponge_ramp / (self.problem.sponge.time_coeff * dt)
        vtgt, stgt = self._sponge_targets
        return coeff * (vtgt - vel), coeff * (stgt - scalars[0])

    def _viscous_source(self, vel):
        """Explicit nu*L(u) estimate for the predictor."""
        if not self.is_viscous:
            return None
        return torch.stack([
            self.params.nu * self._visc_ops[m].apply(
                vel[m], 0.0, 1.0, homogeneous=False)
            for m in range(self.grid.ndim)])

    # ----------------------------------------------- advecting velocities
    def compute_advecting_velocities(self, state: NSState, src_vel, dt,
                                     tmp: _StepTemps):
        """Predict face-centered J u^d at t+dt/2 and MAC-project.  The
        velocity traces' pre-Riemann states are stashed in tmp.vel_pre for
        the momentum update."""
        grid, geo = self.grid, self.geo
        ndim = grid.ndim
        vel = state.vel
        # provisional advecting velocity for upwinding: face-averaged
        # J u^d (J = 1), padded face-indexed from the shared pads
        prov_pad = tuple(face_avg(tmp.u_pad[d], grid.axis(d))
                         for d in range(ndim))
        predicted = []
        tmp.vel_pre = []
        for m in range(ndim):
            # the advecting flux on d-faces reads only component m=d's
            # Riemann output: the other directions emit pre-states only
            faces, pre = trace_face_states(
                vel[m], vel, prov_pad, src_vel[m], dt, geo,
                self.vel_bcs_trace[m], self.params.advection_vel,
                vel_bcs=self.vel_bcs_trace, u_pad=tmp.u_pad,
                return_pre_riemann=True, padded=True, rie_dirs=[m])
            predicted.append(faces)
            tmp.vel_pre.append(pre)

        G = ADVECT_GROW
        adv = tuple(
            apply_fc_bc(_crop_faces(predicted[d][d], grid, d, G), d, grid,
                        self.vel_bcs_trace[d])
            for d in range(ndim))
        if self.params.is_incompressible:
            adv, mac_phi, _ = self.projector.project_mac(
                adv, phi0=state.mac_phi)
            adv = tuple(apply_fc_bc(adv[d], d, grid, self.vel_bcs_trace[d])
                        for d in range(ndim))
        else:
            mac_phi = state.mac_phi
        return adv, mac_phi

    # ------------------------------------------------------------ scalars
    def _advect_update(self, s, src, dt, bcs, params, tmp: _StepTemps,
                       pre_states=None):
        """One field's advection term on the padded path against the
        projected advecting velocities, cropped once."""
        form = self.params.nonlinear_differencing_form
        if pre_states is None and form == 0:
            # fused path: K3 emits the undivided flux differences directly
            partials = trace_face_states(
                s, None, tmp.adv_pad, src, dt, self.geo, bcs, params,
                vel_bcs=self.vel_bcs_trace, u_pad=tmp.u_pad, padded=True,
                want_div=True)
            return divergence_from_partials(partials, self.geo)
        if pre_states is not None:
            faces = riemann_from_states(pre_states, tmp.adv_pad,
                                        upwind=params.use_upwinding)
        else:
            faces = trace_face_states(
                s, None, tmp.adv_pad, src, dt, self.geo, bcs, params,
                vel_bcs=self.vel_bcs_trace, u_pad=tmp.u_pad, padded=True)
        out = flux_divergence(faces, tmp.adv_pad, self.geo, padded=True)
        if form == 1:
            # advective form: div(u s) - s div(u)
            out = out - s * mac_divergence(tmp.adv_valid, self.geo)
        return out

    def _scalar_sources(self, state: NSState, dt):
        """Per-component CC source terms for the scalar traces (background
        advection w N^2 + sponge damping)."""
        _, sponge_s = self._sponge_source(state.vel, state.scalars, dt)
        srcs = []
        for c in range(self.problem.num_scalars):
            src = None
            if c == 0:
                parts = []
                if self._nsq_cc is not None:
                    parts.append(state.vel[self.grid.ndim - 1] * self._nsq_cc)
                if sponge_s is not None:
                    parts.append(sponge_s)
                if parts:
                    src = sum(parts)
            srcs.append(src)
        return srcs

    def get_new_scalars_and_lambda(self, state: NSState, dt,
                                   tmp: _StepTemps):
        """Advect + diffuse the scalars and the freestream tracer lambda."""
        srcs = self._scalar_sources(state, dt)
        out = []
        for c in range(self.problem.num_scalars):
            s = state.scalars[c]
            adv = self._advect_update(s, srcs[c], dt, self.scal_bcs,
                                      self.params.advection_scal, tmp)
            total_src = -adv + (srcs[c] if srcs[c] is not None else 0.0)
            if self.diff_solvers[c] is not None:
                s_new, _ = self.diff_solvers[c].update(s, total_src, dt)
            else:
                s_new = s + dt * total_src
            out.append(s_new)
        adv = self._advect_update(state.lam, None, dt, self.lam_bcs,
                                  self.params.advection_scal, tmp)
        return torch.stack(out), state.lam - dt * adv

    # ----------------------------------------------------------- velocity
    def get_new_velocity(self, state: NSState, src_vel, grav, tidal,
                         sponge_v, grad_p, dt, tmp: _StepTemps):
        """Conservative momentum advection + forcing + implicit viscosity.
        The momentum fluxes re-upwind the advecting-velocity prediction's
        pre-Riemann states against the projected velocity."""
        ndim = self.grid.ndim
        if self.params.nonlinear_differencing_form == 0:
            advs = momentum_flux_divergence(
                tmp.vel_pre, tmp.adv_pad, self.geo,
                upwind=self.params.advection_vel.use_upwinding)
        else:
            advs = [self._advect_update(state.vel[m], src_vel[m], dt,
                                        self.vel_bcs_trace[m],
                                        self.params.advection_vel, tmp,
                                        pre_states=tmp.vel_pre[m])
                    for m in range(ndim)]
        new_vel = []
        for m in range(ndim):
            force = grav[m]
            if grad_p is not None:
                force = force - grad_p[m]
            if tidal is not None:
                force = force + tidal[m]
            if sponge_v is not None:
                force = force + sponge_v[m]
            total_src = -advs[m] + force
            if self.is_viscous and self._visc_batched is not None:
                new_vel.append(total_src)   # stacked + solved below
            elif self.is_viscous:
                u_new, _ = self.visc_solvers[m].update(state.vel[m],
                                                       total_src, dt)
                new_vel.append(u_new)
            else:
                new_vel.append(state.vel[m] + dt * total_src)
        if self.is_viscous and self._visc_batched is not None:
            return self._visc_batched.update(state.vel, torch.stack(new_vel),
                                             dt)
        return torch.stack(new_vel)

    # ------------------------------------------------------------ advance
    def advance(self, state: NSState, dt: float,
                diag: Optional[dict] = None) -> NSState:
        """One PPM predictor-corrector time step of length dt (a Python
        float).  A dict passed as `diag` receives "max_mac_div", the max
        |divergence| of the projected advecting velocity (a 0-d tensor)."""
        p = self.params
        grid = self.grid
        ndim = grid.ndim
        dt = float(dt)

        grav = self._gravity_source(state.scalars)
        tidal = None
        if self.problem.tidal is not None:
            tidal = tidal_source(self.problem.tidal, ndim,
                                 float(state.time), dt)
        sponge_v, _ = self._sponge_source(state.vel, state.scalars, dt)
        visc_src = self._viscous_source(state.vel)
        # lagged pressure gradient (incremental pressure correction)
        grad_p = (self.projector.cc_grad_cart(state.pressure)
                  if p.is_incompressible else None)
        src_vel = tuple(
            (visc_src[m] if visc_src is not None else 0.0)
            + grav[m]
            - (grad_p[m] if grad_p is not None else 0.0)
            + (tidal[m] if tidal is not None else 0.0)
            + (sponge_v[m] if sponge_v is not None else 0.0)
            for m in range(ndim))
        # every component is a tensor: explicit gravity alone can leave a
        # component that is the Python float 0.0
        src_vel = tuple(s if isinstance(s, torch.Tensor)
                        else torch.full(grid.shape, s, dtype=p.dtype,
                                        device=self.device)
                        for s in src_vel)

        # one shared ghost fill of the tracing velocities for all traces
        tmp = _StepTemps(u_pad=[
            fill_ghosts_cc(state.vel[d], grid, self.vel_bcs_trace[d],
                           ADVECT_GROW) for d in range(ndim)])
        adv_vel, mac_phi = self.compute_advecting_velocities(
            state, src_vel, dt, tmp)
        tmp.adv_valid = adv_vel
        if diag is not None:
            diag["max_mac_div"] = mac_divergence(adv_vel, self.geo).abs().max()
        tmp.adv_pad = tuple(pad_valid_faces(adv_vel[d], grid, d)
                            for d in range(ndim))

        scalars, lam = self.get_new_scalars_and_lambda(state, dt, tmp)
        vel = self.get_new_velocity(state, src_vel, grav, tidal, sponge_v,
                                    grad_p, dt, tmp)
        del tmp

        cc_phi = state.cc_phi
        pressure = state.pressure
        if p.is_incompressible:
            for _ in range(max(1, p.level_projection_iters)):
                vel, cc_phi, _ = self.projector.project_cc(
                    vel, self.vel_bcs_trace, phi0=state.cc_phi)
            pressure = state.pressure + cc_phi / dt
        return NSState(vel=vel, scalars=scalars, lam=lam, mac_phi=mac_phi,
                       cc_phi=cc_phi, pressure=pressure,
                       e_lambda=state.e_lambda, time=state.time + dt)

    # ---------------------------------------------------------------- dt
    def compute_dt(self, state: NSState) -> float:
        """CFL + viscous + diffusive + pressure-gradient dt limits, as a
        Python float (one device-to-host read)."""
        p = self.params
        grid = self.grid
        if p.fixed_dt > 0.0:
            return float(torch.tensor(p.fixed_dt, dtype=p.dtype))
        # per-direction max|u_d|/dx_d, reduced on the device in dtype
        rates = torch.stack([state.vel[d].abs().max() / grid.dx[d]
                             for d in range(grid.ndim)])
        inv_dt = torch.clamp_min(rates.max(), 1e-12)
        dt = p.cfl / inv_dt
        min_dx2 = min(dx * dx for dx in grid.dx)
        if p.limit_dt_via_viscosity and p.nu > 0.0:
            dt = torch.clamp_max(dt, p.cfl * min_dx2 / (2 * grid.ndim * p.nu))
        if p.limit_dt_via_diffusion:
            for kap in p.kappa:
                if kap > 0.0:
                    dt = torch.clamp_max(
                        dt, p.cfl * min_dx2 / (2 * grid.ndim * kap))
        if p.limit_dt_via_pressure_gradient:
            for d in range(grid.ndim):
                dphi = torch.diff(state.cc_phi, dim=grid.axis(d)).abs().max()
                dt = torch.minimum(
                    dt, grid.dx[d] / torch.sqrt(torch.clamp_min(dphi, 1e-30)))
        return read_scalars(torch.clamp_max(dt, p.max_dt).to(p.dtype))[0]

    # --------------------------------------------------------- diagnostics
    def total_energy(self, state: NSState):
        """Volume integral of 0.5|u|^2 + b z (a 0-d tensor)."""
        ke = 0.5 * torch.sum(state.vel * state.vel, dim=0)
        pe = state.scalars[0] * self._z_cc
        dv = float(np.prod(self.grid.dx))
        return torch.sum((ke + pe) * self.geo.J) * dv

    def cell_divergence(self, state: NSState):
        """Per-cell divergence of the face-averaged CC velocity."""
        fluxes = tuple(
            cc_to_fc(self.geo.mult_by_J(state.vel[d]), d, self.grid,
                     self.vel_bcs_trace[d])
            for d in range(self.grid.ndim))
        return mac_divergence(fluxes, self.geo)

    def max_divergence(self, state: NSState):
        return torch.max(torch.abs(self.cell_divergence(state)))
