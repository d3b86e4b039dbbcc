"""RK3 method-of-lines time integrator, the alternative to the PPM step
(PyTorch port of `somar_tpu.physics.rk3`).

A 3-stage SSP Runge-Kutta (Shu-Osher form) over the MOL right-hand side

  R(u) = -div(u (x) u_adv) + grav + sponge [+ nu L u],
  R(b) = -div(b u_adv) + background advection + sponge,

with a MAC projection of the advecting velocity and a CC projection of the
velocity each stage, and each stage's implicit viscous / diffusive solve
over its effective dt.  The spatial fluxes are the Godunov face states
traced at dt = 0 (upwind PPM faces, no time-centering: the stages supply
the time accuracy), so in 3D every stage launches K1, K2 and K3 for each
traced field (3 velocity components, the scalars, lambda) along each axis,
and no K4: the fluxes go through `flux_divergence`.

Selected by NSParams.update_scheme = "rk3" (input amr.updateScheme = 2).
On AMR patch levels `rings` carries the CF ghost potentials of every
stage's MAC and CC projection, and `collect` receives the step's advective
interface fluxes for the flux registers: each stage's, combined with the
Shu-Osher weights (1/6, 1/6, 2/3).
"""

from __future__ import annotations

import dataclasses

import torch

from somar_tpu_torch.core.bc import apply_fc_bc
from somar_tpu_torch.ops.stencil import cc_to_fc, mac_divergence
from somar_tpu_torch.physics.godunov import flux_divergence, trace_face_states


def _mol_rhs(level, state, grad_p, dt_for_sponge, diag=None, collect=None,
             ring_mac=None):
    """The MOL right-hand sides (dvel, dscalars, dlam) of a state; a dict
    passed as `diag` receives "max_mac_div", the max |divergence| of the
    projected advecting velocity (a 0-d tensor).  With `collect` (a dict)
    the stage's advective interface fluxes J u^d s go to collect["vel"],
    ["scalars"] (tuples per component of tuples per direction) and
    ["lam"]; `ring_mac` is the MAC projection's CF ghost ring."""
    p = level.params
    grid = level.grid
    geo = level.geo
    ndim = grid.ndim

    u_mapped = geo.to_mapped(state.vel)
    # advecting velocity: face-averaged J u^d, MAC projected
    adv = tuple(
        apply_fc_bc(cc_to_fc(geo.mult_by_J(u_mapped[d]), d, grid,
                             level.vel_bcs_trace[d]),
                    d, grid, level.vel_bcs_trace[d])
        for d in range(ndim))
    if p.is_incompressible:
        adv, _, _ = level.projector.project_mac(adv, phi0=state.mac_phi,
                                                ring=ring_mac)
        adv = tuple(apply_fc_bc(adv[d], d, grid, level.vel_bcs_trace[d])
                    for d in range(ndim))
    if diag is not None:
        diag["max_mac_div"] = mac_divergence(adv, geo).abs().max()

    def upwind_div(s, bcs, params):
        faces = trace_face_states(s, u_mapped, adv, None, 0.0, geo, bcs,
                                  params, vel_bcs=level.vel_bcs_trace)
        div = flux_divergence(faces, adv, geo)
        if collect is None:
            return div, None
        return div, tuple(faces[d] * adv[d] for d in range(ndim))

    grav = level._gravity_source(state.scalars)
    sponge_v, sponge_s = level._sponge_source(state.vel, state.scalars,
                                              dt_for_sponge)
    # viscosity and diffusion are not part of the explicit RHS when the
    # level owns implicit heat solvers: each stage runs its own solve
    visc = None if level.is_viscous else level._viscous_source(state.vel)

    dvel, vel_fluxes = [], []
    for m in range(ndim):
        r, fl = upwind_div(state.vel[m], level.vel_bcs_trace[m],
                           p.advection_vel)
        vel_fluxes.append(fl)
        r = -r + grav[m]
        if grad_p is not None:
            r = r - grad_p[m]
        if visc is not None:
            r = r + visc[m]
        if sponge_v is not None:
            r = r + sponge_v[m]
        dvel.append(r)

    dscal, scal_fluxes = [], []
    for c in range(level.problem.num_scalars):
        r, fl = upwind_div(state.scalars[c], level.scal_bcs,
                           p.advection_scal)
        scal_fluxes.append(fl)
        r = -r
        if c == 0 and level._nsq_cc is not None:
            r = r + state.vel[ndim - 1] * level._nsq_cc
        if c == 0 and sponge_s is not None:
            r = r + sponge_s
        dscal.append(r)

    dlam, lam_flux = upwind_div(state.lam, level.lam_bcs, p.advection_scal)
    if collect is not None:
        collect["vel"] = tuple(vel_fluxes)
        collect["scalars"] = tuple(scal_fluxes)
        collect["lam"] = lam_flux
    return torch.stack(dvel), torch.stack(dscal), -dlam


#: the Shu-Osher stage weights of the step's effective flux
STAGE_FLUX_WEIGHTS = (1.0 / 6.0, 1.0 / 6.0, 2.0 / 3.0)


def _combine(collects):
    """The stage collects' fluxes weighted by STAGE_FLUX_WEIGHTS, leaf by
    leaf (the same nesting as each collect)."""
    def comb(leaves):
        if isinstance(leaves[0], (tuple, list)):
            return tuple(comb(ls) for ls in zip(*leaves))
        w = STAGE_FLUX_WEIGHTS
        return w[0] * leaves[0] + w[1] * leaves[1] + w[2] * leaves[2]
    return {key: comb([c[key] for c in collects]) for key in collects[0]}


def advance_rk3(level, state, dt: float, collect=None, rings=None,
                diag=None):
    """One SSP-RK3 step of length dt (a Python float) with a projection
    and implicit viscous / diffusive solves in every stage.  A dict passed
    as `diag` receives the last stage's "max_mac_div".  rings: {"mac":
    ..., "cc": ...}, the CF ghost rings of a patch level, applied to every
    stage's projections; collect: a dict filled with the step's effective
    advective interface fluxes (the stages' weighted 1/6, 1/6, 2/3)."""
    p = level.params
    ring_mac = rings.get("mac") if rings else None
    ring_cc = rings.get("cc") if rings else None
    stage_collects = []
    dt = float(dt)
    grad_p = (level.projector.cc_grad_cart(state.pressure)
              if p.is_incompressible else None)

    def stage(s, w_old: float, w_new: float):
        sc = {} if collect is not None else None
        dv, ds, dl = _mol_rhs(level, s, grad_p, dt, diag, collect=sc,
                              ring_mac=ring_mac)
        if sc is not None:
            stage_collects.append(sc)
        vel = w_old * state.vel + w_new * (s.vel + dt * dv)
        scal = w_old * state.scalars + w_new * (s.scalars + dt * ds)
        lam = w_old * state.lam + w_new * (s.lam + dt * dl)
        # implicit stage solves over the stage's effective dt = w_new*dt
        # (the Shu-Osher convex combination scales the stage increment)
        dt_eff = w_new * dt
        if level.is_viscous:
            vel = torch.stack([
                level.visc_solvers[m].update(vel[m], None, dt_eff)[0]
                for m in range(level.grid.ndim)])
        scal = torch.stack([
            hs.update(scal[c], None, dt_eff)[0] if hs is not None
            else scal[c]
            for c, hs in enumerate(level.diff_solvers)])
        cc_phi = s.cc_phi
        if p.is_incompressible:
            vel, cc_phi, _ = level.projector.project_cc(
                vel, level.vel_bcs_trace, phi0=s.cc_phi, ring=ring_cc)
        return dataclasses.replace(s, vel=vel, scalars=scal, lam=lam,
                                   cc_phi=cc_phi)

    s1 = stage(state, 0.0, 1.0)
    s2 = stage(s1, 0.75, 0.25)
    s3 = stage(s2, 1.0 / 3.0, 2.0 / 3.0)
    if collect is not None:
        # u^{n+1} = u^n + dt (R0/6 + R1/6 + 2 R2/3): the effective flux
        # through each interface is the same combination
        collect.update(_combine(stage_collects))

    pressure = state.pressure
    if p.is_incompressible:
        pressure = state.pressure + s3.cc_phi / dt
    return dataclasses.replace(s3, pressure=pressure, time=state.time + dt)
