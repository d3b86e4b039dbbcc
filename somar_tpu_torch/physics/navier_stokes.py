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
  CC projection, or with implicit gravity (gravity_method=2) the
    semi-implicit buoyancy update around a CC projection with the altered
    metric (projection/altered_metric.py).

Velocity is stored in the Cartesian basis at cell centers; on a mapped
metric the traces and the advecting fluxes use its contravariant
(mapped-basis) components.  The step takes
dt as a Python float, so no kernel argument forces a device sync;
`compute_dt` is one host read per step; the iterative solvers add one per
V-cycle and one per BiCGStab iteration (solvers/host_reads.py).

With update_scheme = "rk3" the step is the SSP-RK3 method of lines of
physics/rk3.py instead.

AMR patch levels (amr/hierarchy.py) pass `rings` to `advance`: the CF
ghost potentials of the MAC and the CC projection.  `collect_fluxes`
returns the advective interface fluxes a flux register accumulates.  With
`use_vd_correction` (AMR with eta_lambda > 0) the advecting velocity
gains grad e_lambda after its MAC projection.

Uniform Cartesian levels run with spectral, multigrid, BiCGStab or
leptic pressure solves and spectral or multigrid heat solves; mapped
levels with multigrid.  Time-dependent (callable) BC values are bound at
the step's midpoint time, a 0-d device tensor, for the whole step
(`_bound_time_bcs`), so they add no host read; array-valued BC profiles
are moved to the level's device once, at construction.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from somar_tpu_torch.core.bc import (
    BC, BCType, FieldBCs, apply_fc_bc, bind_bcs_time, fill_ghosts_cc)
from somar_tpu_torch.geometry.level_geometry import LevelGeometry
from somar_tpu_torch.ops.stencil import (
    avg_along, cc_to_fc, face_avg, mac_divergence, mac_gradient, slc)
from somar_tpu_torch.physics.godunov import (
    ADVECT_GROW, AdvectionParams, _crop_faces, divergence_from_partials,
    flux_divergence, momentum_flux_divergence, pad_valid_faces,
    riemann_from_states, trace_face_states)
from somar_tpu_torch.physics.rk3 import advance_rk3
from somar_tpu_torch.problems.base import Problem, sponge_ramp, tidal_source
from somar_tpu_torch.projection.altered_metric import AlteredMetric
from somar_tpu_torch.projection.projector import LevelProjector
from somar_tpu_torch.solvers.host_reads import read_scalars
from somar_tpu_torch.solvers.multigrid import MGParams
from somar_tpu_torch.solvers.parabolic import (
    BatchedSpectralHeat, make_heat_solver)
from somar_tpu_torch.solvers.poisson_op import PoissonOp
from somar_tpu_torch.utils.strat import solve_vert_eigen_problem


def _edge_face_avg(t, ax: int):
    """2-point average onto every face of axis ax, each boundary face
    taking its edge cell's value."""
    n = t.shape[ax]
    return avg_along(torch.cat([slc(t, ax, 0, 1), t, slc(t, ax, n - 1, n)],
                               dim=ax), ax)


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
    mg_sync: Optional[MGParams] = None    # AMR sync projection
    mg_vd: Optional[MGParams] = None      # AMR volume-discrepancy solve
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
    u_pad: list                      # ADVECT_GROW-padded mapped velocities
    adv_valid: tuple = None          # projected advecting fluxes (valid faces)
    adv_pad: tuple = None            # the same, padded face-indexed
    vel_pre: list = None             # per component, per dir (lo_f, hi_f)


class NSLevel:
    """One level's Navier-Stokes integrator."""

    def __init__(self, geo: LevelGeometry, problem: Problem,
                 params: NSParams = NSParams(),
                 aux_fields: Optional[dict] = None):
        """aux_fields optionally gives the problem fields derived from the
        geometry ("nsq_cc", "sponge_ramp", "sponge_targets") as tensors, in
        place of deriving them from `geo`."""
        aux = aux_fields or {}
        if params.update_scheme not in ("ppm", "rk3"):
            raise ValueError(f"update_scheme={params.update_scheme!r}: "
                             "use 'ppm' or 'rk3'")
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
        #: add grad e_lambda (the AMR VD correction's potential) to the
        #: advecting velocity; set by AMRHierarchy when eta_lambda > 0
        self.use_vd_correction = False
        # BC sets, their array profiles moved to the device once
        self.vel_bcs_trace = tuple(
            b.on_device(self.device, dtype)
            for b in problem.vel_bcs(grid, viscous=False))
        self.vel_bcs_visc = tuple(
            b.on_device(self.device, dtype)
            for b in problem.vel_bcs(grid, viscous=self.is_viscous))
        self.scal_bcs = problem.scalar_bcs(grid).on_device(self.device,
                                                           dtype)
        self.lam_bcs = FieldBCs.from_periodic(grid, BC.extrap(1))
        #: any callable (time-dependent) BC values?  Then `advance` binds
        #: every BC value at the step's midpoint time (_bound_time_bcs)
        self._time_bcs = (any(b.time_dependent for b in self.vel_bcs_trace)
                          or any(b.time_dependent
                                 for b in self.vel_bcs_visc)
                          or self.scal_bcs.time_dependent)

        mg_purposes = {k: v for k, v in (("mac", params.mg_mac),
                                         ("cc", params.mg_cc),
                                         ("sync", params.mg_sync),
                                         ("vd", params.mg_vd))
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
        diff_bcs = (diff_bcs(grid) if callable(diff_bcs) else
                    FieldBCs.from_periodic(grid, BC.neumann(0.0))
                    ).on_device(self.device, dtype)
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
        # time-dependent BC values with implicit solves: build the lazy MG
        # hierarchies now, outside any bound scope, so that no bound value
        # is captured by an operator the scope does not swap back
        if self._time_bcs:
            for hs in self._heat_solvers():
                if hs.bcs.time_dependent and hs._fft is None:
                    hs.mg  # noqa: B018 (built for its side effect)

        self._sponge_ramp = None
        if problem.sponge is not None:
            if "sponge_ramp" in aux:
                self._sponge_ramp = aux["sponge_ramp"]
                self._sponge_targets = aux["sponge_targets"]
            else:
                self._sponge_ramp = torch.as_tensor(
                    sponge_ramp(grid, problem.sponge), **kw)
                vt, st = problem.sponge_targets(geo)
                self._sponge_targets = (torch.as_tensor(vt, **kw),
                                        torch.as_tensor(st, **kw))
        if "nsq_cc" in aux:
            self._nsq_cc = aux["nsq_cc"]
        else:
            self._nsq_cc = (torch.as_tensor(problem.nsq_cc(geo), **kw)
                            if problem.use_background_scalar else None)
        # first-mode internal-wave phase speed per direction, for the dt
        # limit
        self._c0i = None
        if (params.limit_dt_via_internal_wave_speed
                and self._nsq_cc is not None):
            self._c0i = self._internal_wave_speed()
        # implicit gravity: altered-metric fields per MG level
        self._altered_metric = None
        if params.gravity_method == 2 and problem.use_background_scalar:
            self._altered_metric = AlteredMetric(
                self.projector.mg, problem.background, dtype)
        # physical z at cell centers, for the energy diagnostic
        self._z_cc = torch.as_tensor(np.array(np.broadcast_to(
            geo.phys_coords_cc()[ndim - 1], grid.shape)), **kw)

    def _heat_solvers(self):
        return ((self.visc_solvers if self.is_viscous else [])
                + [h for h in self.diff_solvers if h is not None])

    @contextlib.contextmanager
    def _bound_time_bcs(self, t):
        """Scope in which every callable BC value is bound at time t (a
        0-d tensor on the level's device, or a float): the level's BC
        sets, the heat solvers, their operators and their multigrid
        level-0 operators get the bound BCs, restored on exit.  The
        operators' structural data (diagonals, face factors, kernel plans)
        depends only on the BC types, so swapping values is safe."""
        saved = []

        def swap(obj, name, val):
            saved.append((obj, name, getattr(obj, name)))
            setattr(obj, name, val)

        vt = bind_bcs_time(self.vel_bcs_trace, t)
        vv = bind_bcs_time(self.vel_bcs_visc, t)
        swap(self, "vel_bcs_trace", vt)
        swap(self, "vel_bcs_visc", vv)
        swap(self, "scal_bcs", self.scal_bcs.at_time(t))
        if self.is_viscous:
            for m, op in enumerate(self._visc_ops):
                if op.bcs.time_dependent:
                    swap(op, "bcs", vv[m])
        for hs in self._heat_solvers():
            if hs.bcs.time_dependent:
                b = hs.bcs.at_time(t)
                swap(hs, "bcs", b)
                swap(hs._op, "bcs", b)
                if hs._mg is not None:
                    swap(hs._mg.ops[0], "bcs", b)
        try:
            yield
        finally:
            for obj, name, val in reversed(saved):
                setattr(obj, name, val)

    def _internal_wave_speed(self):
        """Per-direction first-mode phase speed c0^d = c0 * max over
        horizontal j of |dxi^d/dx^j|, from the vertical eigenproblem of the
        horizontally averaged N^2 profile: Python floats on uniform maps,
        CC tensors on mapped ones."""
        grid = self.grid
        vd = grid.vertical_dir
        vax = grid.axis(vd)
        nsq = self._nsq_cc.cpu().numpy()
        horiz_axes = tuple(a for a in range(nsq.ndim) if a != vax)
        prof = nsq.mean(axis=horiz_axes) if horiz_axes else nsq
        c, _ = solve_vert_eigen_problem(np.maximum(prof, 0.0),
                                        grid.dx[vd], 1)
        c0 = float(np.asarray(c).ravel()[0])
        if self.geo.einv_cc is None:
            return tuple(0.0 if d == vd else c0 for d in range(grid.ndim))
        einv = self.geo.einv_cc.cpu().numpy()
        hdirs = [n for n in range(grid.ndim) if n != vd]
        return tuple(
            self._tensor(c0 * np.max([np.abs(einv[d, n]) for n in hdirs],
                                     axis=0))
            for d in range(grid.ndim))

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
        with self._bound_time_bcs(state.time):
            for _ in range(num_proj):
                vel, _, _ = self.projector.project_cc(vel,
                                                      self.vel_bcs_trace)
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
    def _einv_fc(self, d):
        """dxi/dx averaged to d-faces (None on uniform maps)."""
        e = self.geo.einv_cc
        if e is None:
            return None
        return _edge_face_avg(e, 2 + self.grid.axis(d))

    def _J_fc(self, d):
        """J averaged to d-faces."""
        J = self.geo.J * torch.ones(self.grid.shape, dtype=self.params.dtype,
                                    device=self.device)
        return _edge_face_avg(J, self.grid.axis(d))

    def compute_advecting_velocities(self, state: NSState, src_vel, dt,
                                     tmp: _StepTemps, u_mapped,
                                     ring_mac=None):
        """Predict face-centered J u^d at t+dt/2 and MAC-project (with the
        CF ghost ring `ring_mac` on a patch level).  The velocity traces'
        pre-Riemann states are stashed in tmp.vel_pre for the momentum
        update."""
        grid, geo = self.grid, self.geo
        ndim = grid.ndim
        vel = state.vel
        # provisional advecting velocity for upwinding: face-averaged
        # J u^d, padded face-indexed (J = 1 and the shared pads on uniform
        # maps)
        if geo.is_uniform:
            prov_pad = tuple(face_avg(tmp.u_pad[d], grid.axis(d))
                             for d in range(ndim))
        else:
            prov_pad = tuple(
                face_avg(fill_ghosts_cc(geo.mult_by_J(u_mapped[d]), grid,
                                        self.vel_bcs_trace[d], ADVECT_GROW),
                         grid.axis(d))
                for d in range(ndim))
        predicted = []
        tmp.vel_pre = []
        for m in range(ndim):
            # identity einv (uniform maps): the advecting flux on d-faces
            # reads only component m=d's Riemann output, so the other
            # directions emit pre-states only
            faces, pre = trace_face_states(
                vel[m], u_mapped, prov_pad, src_vel[m], dt, geo,
                self.vel_bcs_trace[m], self.params.advection_vel,
                vel_bcs=self.vel_bcs_trace, u_pad=tmp.u_pad,
                return_pre_riemann=True, padded=True,
                rie_dirs=[m] if geo.einv_cc is None else None)
            predicted.append(faces)
            tmp.vel_pre.append(pre)

        # normal contravariant flux on d-faces: J * einv[d, m] * u_m,
        # cropped to valid faces
        G = ADVECT_GROW
        adv = []
        for d in range(ndim):
            einv = self._einv_fc(d)
            if einv is None:
                flux = _crop_faces(predicted[d][d], grid, d, G)
            else:
                flux = einv[d, 0] * _crop_faces(predicted[0][d], grid, d, G)
                for m in range(1, ndim):
                    flux = flux + einv[d, m] * _crop_faces(
                        predicted[m][d], grid, d, G)
            if not geo.is_uniform:
                flux = self._J_fc(d) * flux
            adv.append(apply_fc_bc(flux, d, grid, self.vel_bcs_trace[d]))
        adv = tuple(adv)
        if self.params.is_incompressible:
            adv, mac_phi, _ = self.projector.project_mac(
                adv, phi0=state.mac_phi, ring=ring_mac)
            adv = tuple(apply_fc_bc(adv[d], d, grid, self.vel_bcs_trace[d])
                        for d in range(ndim))
        else:
            mac_phi = state.mac_phi
        if self.use_vd_correction:
            # the volume-discrepancy (freestream) correction: grad e_lambda
            # added to the advecting velocity.  A patch level's CF sides
            # take a linear extrapolation: the halo holds donor-filled
            # e_lambda, and a CF ghost without ring data would read 0
            fix = lambda b: BC.extrap(1) if b.type == BCType.CF else b
            pb = self.projector.phi_bcs
            grad_e = mac_gradient(state.e_lambda, geo, FieldBCs(
                lo=tuple(fix(b) for b in pb.lo),
                hi=tuple(fix(b) for b in pb.hi)))
            adv = tuple(adv[d] + grad_e[d] for d in range(ndim))
        return adv, mac_phi

    # ------------------------------------------------------------ scalars
    def _advect_update(self, s, src, dt, bcs, params, tmp: _StepTemps,
                       pre_states=None, return_fluxes: bool = False):
        """One field's advection term on the padded path against the
        projected advecting velocities, cropped once.  return_fluxes: also
        the interface fluxes J u^d s on the valid faces, as a tuple over
        directions."""
        form = self.params.nonlinear_differencing_form
        if pre_states is None and form == 0 and not return_fluxes:
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
        if return_fluxes:
            return out, tuple(
                _crop_faces(faces[d], self.grid, d, ADVECT_GROW)
                * tmp.adv_valid[d] for d in range(self.grid.ndim))
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
                if self._nsq_cc is not None and self._altered_metric is None:
                    # background advection w N^2 (explicit gravity; implicit
                    # gravity applies it semi-implicitly)
                    parts.append(state.vel[self.grid.ndim - 1] * self._nsq_cc)
                if sponge_s is not None:
                    parts.append(sponge_s)
                if parts:
                    src = sum(parts)
            srcs.append(src)
        return srcs

    def get_new_scalars_and_lambda(self, state: NSState, dt,
                                   tmp: _StepTemps,
                                   collect: Optional[dict] = None):
        """Advect + diffuse the scalars and the freestream tracer lambda.
        With `collect` (a dict), the interface fluxes go to
        collect["scalars"] (a tuple per component) and collect["lam"]."""
        srcs = self._scalar_sources(state, dt)
        out = []
        fluxes = []
        for c in range(self.problem.num_scalars):
            s = state.scalars[c]
            adv = self._advect_update(s, srcs[c], dt, self.scal_bcs,
                                      self.params.advection_scal, tmp,
                                      return_fluxes=collect is not None)
            if collect is not None:
                adv, fl = adv
                fluxes.append(fl)
            total_src = -adv + (srcs[c] if srcs[c] is not None else 0.0)
            if self.diff_solvers[c] is not None:
                s_new, _ = self.diff_solvers[c].update(s, total_src, dt)
            else:
                s_new = s + dt * total_src
            out.append(s_new)
        adv = self._advect_update(state.lam, None, dt, self.lam_bcs,
                                  self.params.advection_scal, tmp,
                                  return_fluxes=collect is not None)
        if collect is not None:
            adv, collect["lam"] = adv
            collect["scalars"] = tuple(fluxes)
        return torch.stack(out), state.lam - dt * adv

    # ----------------------------------------------------------- velocity
    def get_new_velocity(self, state: NSState, src_vel, grav, tidal,
                         sponge_v, grad_p, dt, tmp: _StepTemps,
                         collect: Optional[dict] = None):
        """Conservative momentum advection + forcing + implicit viscosity.
        The momentum fluxes re-upwind the advecting-velocity prediction's
        pre-Riemann states against the projected velocity.  With
        `collect`, per component and its interface fluxes go to
        collect["vel"]."""
        ndim = self.grid.ndim
        if self.params.nonlinear_differencing_form == 0 and collect is None:
            advs = momentum_flux_divergence(
                tmp.vel_pre, tmp.adv_pad, self.geo,
                upwind=self.params.advection_vel.use_upwinding)
        else:
            advs = [self._advect_update(state.vel[m], src_vel[m], dt,
                                        self.vel_bcs_trace[m],
                                        self.params.advection_vel, tmp,
                                        pre_states=tmp.vel_pre[m],
                                        return_fluxes=collect is not None)
                    for m in range(ndim)]
            if collect is not None:
                collect["vel"] = tuple(a[1] for a in advs)
                advs = [a[0] for a in advs]
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
                diag: Optional[dict] = None, rings: Optional[dict] = None,
                collect_fluxes: bool = False):
        """One time step of length dt (a Python float): the PPM
        predictor-corrector, or the RK3 scheme when update_scheme = "rk3".
        A dict passed as `diag` receives "max_mac_div", the max
        |divergence| of the projected advecting velocity (a 0-d tensor; of
        the last stage's under RK3).  rings: {"mac": ..., "cc": ...}, the
        padded-shape CF ghost potentials of a patch level's projections.
        collect_fluxes: return (state, {"vel", "scalars", "lam": the
        advective interface fluxes}) for AMR flux registers."""
        dt = float(dt)
        if not self._time_bcs:
            return self._advance_inner(state, dt, diag, rings,
                                       collect_fluxes)
        with self._bound_time_bcs(state.time + 0.5 * dt):
            return self._advance_inner(state, dt, diag, rings,
                                       collect_fluxes)

    def _advance_inner(self, state: NSState, dt: float,
                       diag: Optional[dict], rings: Optional[dict] = None,
                       collect_fluxes: bool = False):
        p = self.params
        if p.update_scheme == "rk3":
            collect = {} if collect_fluxes else None
            out = advance_rk3(self, state, dt, collect=collect, rings=rings,
                              diag=diag)
            return (out, collect) if collect_fluxes else out
        ring_mac = rings.get("mac") if rings else None
        ring_cc = rings.get("cc") if rings else None
        grid = self.grid
        ndim = grid.ndim

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
        u_mapped = self.geo.to_mapped(state.vel)
        tmp = _StepTemps(u_pad=[
            fill_ghosts_cc(u_mapped[d], grid, self.vel_bcs_trace[d],
                           ADVECT_GROW) for d in range(ndim)])
        adv_vel, mac_phi = self.compute_advecting_velocities(
            state, src_vel, dt, tmp, u_mapped, ring_mac=ring_mac)
        tmp.adv_valid = adv_vel
        if diag is not None:
            diag["max_mac_div"] = mac_divergence(adv_vel, self.geo).abs().max()
        tmp.adv_pad = tuple(pad_valid_faces(adv_vel[d], grid, d)
                            for d in range(ndim))

        collect = {} if collect_fluxes else None
        scalars, lam = self.get_new_scalars_and_lambda(state, dt, tmp,
                                                       collect)
        vel = self.get_new_velocity(state, src_vel, grav, tidal, sponge_v,
                                    grad_p, dt, tmp, collect)
        del tmp

        cc_phi = state.cc_phi
        pressure = state.pressure
        if self._altered_metric is not None:
            vel, scalars, cc_phi = self._do_ig_projection(
                state, vel, scalars, dt)
            pressure = state.pressure + cc_phi / dt
        elif p.is_incompressible:
            for _ in range(max(1, p.level_projection_iters)):
                vel, cc_phi, _ = self.projector.project_cc(
                    vel, self.vel_bcs_trace, phi0=state.cc_phi,
                    ring=ring_cc)
            pressure = state.pressure + cc_phi / dt
        out = NSState(vel=vel, scalars=scalars, lam=lam, mac_phi=mac_phi,
                      cc_phi=cc_phi, pressure=pressure,
                      e_lambda=state.e_lambda, time=state.time + dt)
        return (out, collect) if collect_fluxes else out

    # ------------------------------------------------- implicit gravity
    def _do_ig_projection(self, state: NSState, vel_star, scalars_star, dt):
        """Semi-implicit buoyancy + altered-metric projection.  In the
        Cartesian velocity basis the contravariant update
        u^i -= dt*Dinv*(dxi^i/dz)*btilde collapses to a purely vertical
        kick u_z -= dt*Dinv*btilde."""
        p = self.params
        theta = p.gravity_theta
        vert = self.grid.ndim - 1
        nsq = self._altered_metric.nsq_cc()
        dt_theta = dt * theta
        dinv = 1.0 / (1.0 + dt_theta * dt_theta * nsq)

        b_old = state.scalars[0]
        b_new = scalars_star[0]
        w_theta = theta * vel_star[vert] + (1.0 - theta) * state.vel[vert]
        b_theta = theta * b_new + (1.0 - theta) * b_old
        btilde = b_theta + dt_theta * nsq * w_theta
        vel_star = vel_star.clone()
        vel_star[vert] = vel_star[vert] + (-dt * dinv * btilde)

        cc_phi = state.cc_phi
        if p.is_incompressible:
            deltas = self._altered_metric.jgup_delta_list(dt_theta)
            vel_star, cc_phi, _ = self.projector.project_cc(
                vel_star, self.vel_bcs_trace, phi0=state.cc_phi,
                jgup_deltas=deltas)

        # semi-implicit buoyancy update with the projected velocity
        w_theta_new = (theta * vel_star[vert]
                       + (1.0 - theta) * state.vel[vert])
        scalars_star = scalars_star.clone()
        scalars_star[0] = b_new + dt * nsq * w_theta_new
        return vel_star, scalars_star, cc_phi

    # ---------------------------------------------------------------- dt
    def compute_dt(self, state: NSState) -> float:
        """CFL + viscous + diffusive + pressure-gradient + internal-wave dt
        limits, as a Python float (one device-to-host read)."""
        if self.params.fixed_dt > 0.0:
            return float(torch.tensor(self.params.fixed_dt,
                                      dtype=self.params.dtype))
        return read_scalars(self.compute_dt_tensor(state))[0]

    def compute_dt_tensor(self, state: NSState):
        """compute_dt as a 0-d tensor on the level's device, unread."""
        p = self.params
        grid = self.grid
        if p.fixed_dt > 0.0:
            return torch.tensor(p.fixed_dt, dtype=p.dtype,
                                device=state.vel.device)
        u_mapped = self.geo.to_mapped(state.vel)
        # per-direction max|u^d|/dx_d, reduced on the device in dtype
        rates = torch.stack([u_mapped[d].abs().max() / grid.dx[d]
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
        if p.limit_dt_via_internal_wave_speed and self._c0i is not None:
            # dt <= cfl * min_cells,d dx_d / (|u^d| + c0^d)
            bv = torch.stack([(u_mapped[d].abs() + self._c0i[d]).max()
                              / grid.dx[d] for d in range(grid.ndim)])
            dt = torch.minimum(dt, p.cfl / torch.clamp_min(bv.max(), 1e-12))
        return torch.clamp_max(dt, p.max_dt).to(p.dtype)

    # --------------------------------------------------------- diagnostics
    def total_energy(self, state: NSState):
        """Volume integral of 0.5|u|^2 + b z (a 0-d tensor)."""
        ke = 0.5 * torch.sum(state.vel * state.vel, dim=0)
        pe = state.scalars[0] * self._z_cc
        dv = float(np.prod(self.grid.dx))
        return torch.sum((ke + pe) * self.geo.J) * dv

    def cell_divergence(self, state: NSState):
        """Per-cell mapped divergence of the face-averaged CC velocity."""
        u_mapped = self.geo.to_mapped(state.vel)
        bcs = bind_bcs_time(self.vel_bcs_trace, state.time)
        fluxes = tuple(
            cc_to_fc(self.geo.mult_by_J(u_mapped[d]), d, self.grid, bcs[d])
            for d in range(self.grid.ndim))
        return mac_divergence(fluxes, self.geo)

    def max_divergence(self, state: NSState):
        return torch.max(torch.abs(self.cell_divergence(state)))
