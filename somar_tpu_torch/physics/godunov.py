"""Unsplit Godunov (CTU) advection: PLM/PPM tracing, limiters and
upwinding (PyTorch port of `somar_tpu.physics.godunov`).

Scheme (Colella's unsplit corner-transport-upwind):
  1. normal predictor per direction: CTU(0) / PLM(1) / PPM(2) half-step
     traced left/right face states, with van Leer or 4th-order limited
     slopes (PLM), CW84 parabola limiting (PPM), or the
     extremum-preserving limiter of either (use_high_order_limiter);
  2. transverse corrections: 1D Riemann states of the other directions
     feed an advective-form quasilinear correction (full 3-stage CTU in
     3D with the dt/3 intermediate states);
  3. Riemann upwinding by the face advecting velocity, or the face
     average (central fluxes, use_upwinding=False);
  4. conservative flux divergence (1/J) d_d (J u^d s).

Every intermediate keeps the full padded cell shape ("face-indexed": entry
f is the face between cells f and f+1, the last entry is junk); junk
entries live in ghost space and are cropped once at the end.  Ghost
requirement: ADVECT_GROW = 4 layers.

Which stages take the CTU kernels (the JAX package's gate for its Pallas
kernels, extended to every stage that computes the same function):
  * K1 (PPM predictor + stage-1 Riemann + corr2) for PPM with upwinding
    and without the high-order limiter; every other predictor is plain
    torch (`_normal_predict_fullpad`), as in JAX;
  * K2 (3D cross terms) and K3 (final states, Riemann, flux difference)
    on the traced states of every predictor when upwinding: their math
    does not depend on how stage 1 traced;
  * K4 (momentum re-upwinding) when upwinding.
Central fluxes are plain torch at every stage, as in JAX.
The batched tracer (`trace_face_states_batched`) traces each field of
the batch in turn through the same kernels.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from somar_tpu_torch.core.bc import FieldBCs, fill_ghosts_cc
from somar_tpu_torch.core.grid import Grid
from somar_tpu_torch.geometry.level_geometry import LevelGeometry
from somar_tpu_torch.ops.ctu_kernels import (
    ctu_corr3, ctu_final, ppm_face_states, ppm_predict, riemann,
    riemann_fluxdiv)
from somar_tpu_torch.ops.stencil import diff_along, shift_m, shift_p, slc

ADVECT_GROW = 4


@dataclasses.dataclass(frozen=True)
class AdvectionParams:
    """The `advection.*` input namespace."""

    normal_pred_order: int = 2        # 0=CTU, 1=PLM, 2=PPM
    use_fourth_order_slopes: bool = True
    use_limiting: bool = True
    use_high_order_limiter: bool = False  # extremum-preserving variant
    #: False replaces the Riemann upwind selection with the face average
    use_upwinding: bool = True


def _uses_k1(params: AdvectionParams) -> bool:
    """K1 computes the PPM predictor with upwinding and CW84 limiting (or
    none); the other predictors and central fluxes are plain torch."""
    return (params.normal_pred_order == 2 and params.use_upwinding
            and not params.use_high_order_limiter)


#: passive-advection Riemann: upwind by the face velocity
_riemann = riemann


def _riemann_avg(lo, hi, vface):
    """Central face states (advection.useUpwinding* = 0)."""
    return 0.5 * (lo + hi)


def _cc_deriv(face_arr, ax: int, dx: float):
    """Cell-centred derivative of a face-indexed array: the difference
    across cell c is face[c] - face[c-1] (junk at c = 0)."""
    return (face_arr - shift_m(face_arr, ax)) / dx


def _face_avg(u, ax: int):
    return 0.5 * (u + shift_p(u, ax))


# --------------------------------------------------------------------------
# slopes
# --------------------------------------------------------------------------
def _vanleer_slope(sm, s0, sp, limit: bool):
    dc = 0.5 * (sp - sm)
    if not limit:
        return dc
    dl = s0 - sm
    dr = sp - s0
    lim = 2.0 * torch.minimum(dl.abs(), dr.abs())
    mono = (dl * dr) > 0.0
    return torch.where(mono, torch.sign(dc) * torch.minimum(dc.abs(), lim),
                       0.0)


def _fourth_order_slope(smm, sm, s0, sp, spp, limit: bool):
    """delta4 = (2/3)[(s_{+1} - s_{-1}) - (dvL_{+1} + dvL_{-1})/4]."""
    dvl_m = _vanleer_slope(smm, sm, s0, limit)
    dvl_p = _vanleer_slope(s0, sp, spp, limit)
    d4 = (2.0 / 3.0) * ((sp - sm) - 0.25 * (dvl_p + dvl_m))
    if not limit:
        return d4
    dl = s0 - sm
    dr = sp - s0
    lim = 2.0 * torch.minimum(dl.abs(), dr.abs())
    mono = (dl * dr) > 0.0
    return torch.where(mono, torch.sign(d4) * torch.minimum(d4.abs(), lim),
                       0.0)


def _ext_preserving_slope(dwc, smm, sm, s0, sp, spp):
    """Extremum-preserving van Leer limiting of a centred (or 4th-order)
    slope dwc (Colella & Sekora 2008): at a resolved extremum (adjacent
    one-sided differences change sign) the slope is limited by second
    differences instead of being zeroed."""
    dwl = s0 - sm
    dwll = sm - smm
    dwr = sp - s0
    dwrr = spp - sp
    dpmin = torch.minimum(dwl * dwr, dwll * dwrr)
    dw2l = dwl - dwll
    dw2c = 0.5 * (dwr - dwl)
    dw2r = dwrr - dwr
    s2 = torch.sign(dw2c)
    dw2lim = torch.minimum(dw2c.abs(),
                           torch.minimum(torch.clamp_min(s2 * dw2l, 0.0),
                                         torch.clamp_min(s2 * dw2r, 0.0)))
    dwvl = 1.25 * 1.5 * dw2lim
    dwlim_ext = torch.where(s2 * dwc < 0.0,
                            torch.minimum(dwvl, 2.0 * dwl.abs()),
                            torch.minimum(dwvl, 2.0 * dwr.abs()))
    dwlim_mono = 2.0 * torch.minimum(dwl.abs(), dwr.abs())
    dwlim = torch.where(dpmin < 0.0, dwlim_ext, dwlim_mono)
    return torch.sign(dwc) * torch.minimum(dwc.abs(), dwlim)


# --------------------------------------------------------------------------
# the full CTU predictor
# --------------------------------------------------------------------------
def _final_plain(lo1, hi1, adv, c3_list, src, half_dt, ax, want_pre,
                 want_rie, want_div, riem):
    """Stage 3 in plain torch with the Riemann state `riem` (K3's twin for
    any Riemann rule)."""
    csum = c3_list[0]
    for c in c3_list[1:]:
        csum = csum + c
    if src is not None:
        csum = csum + half_dt * src
    lo_f = lo1 + csum
    hi_f = hi1 + shift_p(csum, ax)
    out = []
    if want_div:
        F = riem(lo_f, hi_f, adv) * adv
        out.append(F - shift_m(F, ax))
    elif want_rie:
        out.append(riem(lo_f, hi_f, adv))
    if want_pre:
        out += [lo_f, hi_f]
    return tuple(out)


def trace_face_states(
    s,                      # CC scalar to advect
    vel_mapped_cc,          # (ndim,)+shape contravariant CC velocity (tracing)
    adv_vel,                # tuple of FC J u^d advecting velocities
    src,                    # CC source term (or None): added as dt/2 * src
    dt: float,
    geo: LevelGeometry,
    bcs: FieldBCs,
    params: AdvectionParams,
    vel_bcs: Optional[Sequence[FieldBCs]] = None,
    u_pad: Optional[Sequence] = None,
    return_pre_riemann: bool = False,
    padded: bool = False,
    rie_dirs: Optional[Sequence[int]] = None,
    want_div: bool = False,
):
    """Predict time-centered upwind face states of `s` in every direction.

    u_pad: optional precomputed ADVECT_GROW-padded tracing velocities (one
    per direction), shared across the fields a step traces.
    Returns a tuple of face-state tensors per logical dir d: fc_shape(d)
    (valid faces) by default, or full padded face-indexed tensors with
    `padded=True`, in which case `adv_vel` must be padded face-indexed too
    (see pad_valid_faces).

    return_pre_riemann: also return the (lo, hi) face-state pairs per
    direction before the final Riemann upwinding; they depend only on
    (s, u_pad, src, dt), so a caller that upwinds the same field against a
    second advecting velocity reuses them (riemann_from_states).

    rie_dirs: restrict which directions' final Riemann outputs are wanted;
    excluded entries of the returned tuple are None.

    want_div (padded only): each returned entry is the cell-indexed
    undivided flux difference (rie*adv)[c] - (rie*adv)[c-1] instead of
    the Riemann face state (see divergence_from_partials).
    """
    if want_div and not padded:
        raise ValueError("want_div needs padded=True")
    grid = geo.grid
    ndim = grid.ndim
    G = ADVECT_GROW
    upwind = params.use_upwinding
    riem = _riemann if upwind else _riemann_avg

    sp = fill_ghosts_cc(s, grid, bcs, G)
    if u_pad is None:
        if vel_bcs is None:
            vel_bcs = [bcs] * ndim
        u_pad = [fill_ghosts_cc(vel_mapped_cc[d], grid, vel_bcs[d], G)
                 for d in range(ndim)]

    # ------------------------------------------- stage 1: 1D states (K1)
    # corr2 = -coef u d(rie)/dxi with coef = dt/3 for the 3D CTU stage 2,
    # dt/2 in 2D where it IS the stage-3 correction
    coef = dt / 3.0 if ndim == 3 else dt / 2.0
    k1 = _uses_k1(params)
    lo1, hi1, corr2 = [], [], []
    for d in range(ndim):
        ax = grid.axis(d)
        if k1:
            lo_d, hi_d, c2_d = ppm_predict(
                sp, u_pad[d], dt / grid.dx[d], ax, params.use_limiting,
                corr_coef_over_dx=coef / grid.dx[d])
        else:
            lo_d, hi_d = _normal_predict_fullpad(sp, u_pad[d], ax, G,
                                                 grid.dx[d], dt, params)
            rie_d = riem(lo_d, hi_d, _face_avg(u_pad[d], ax))
            c2_d = -coef * u_pad[d] * _cc_deriv(rie_d, ax, grid.dx[d])
        lo1.append(lo_d)
        hi1.append(hi_d)
        corr2.append(c2_d)

    # ----------------------------- stage 2+3 cross terms (3D only; K2)
    # corr3[(j, k)] = -(dt/2) u_j d/dxi_j [Riemann(lo1_j + corr2_k, ...)]:
    # the final stage-3 correction along j for output direction 3-j-k
    corr3 = {}
    if ndim == 3:
        for j in range(ndim):
            ks = [k for k in range(ndim) if k != j]
            axj = grid.axis(j)
            if upwind:
                got = ctu_corr3(lo1[j], hi1[j], u_pad[j],
                                [corr2[k] for k in ks],
                                (dt / 2.0) / grid.dx[j], axj)
            else:
                vf = _face_avg(u_pad[j], axj)
                got = [-(dt / 2.0) * u_pad[j] * _cc_deriv(
                    riem(lo1[j] + corr2[k], hi1[j] + shift_p(corr2[k], axj),
                         vf), axj, grid.dx[j]) for k in ks]
            for k, c3 in zip(ks, got):
                corr3[(j, k)] = c3

    # --------------------------------------- stage 3: final face states (K3)
    src_pad = (fill_ghosts_cc(src, grid, bcs, G) if src is not None
               else None)

    def final(d, adv, want_pre, want_rie, want_div):
        c3_list = ([corr3[(j, 3 - d - j)] for j in range(ndim) if j != d]
                   if ndim == 3 else [corr2[1 - d]])
        if upwind:
            return ctu_final(lo1[d], hi1[d], adv, c3_list, src_pad,
                             0.5 * dt, grid.axis(d), want_pre=want_pre,
                             want_rie=want_rie, want_div=want_div)
        return _final_plain(lo1[d], hi1[d], adv, c3_list, src_pad, 0.5 * dt,
                            grid.axis(d), want_pre, want_rie, want_div, riem)

    out = {}
    pre = {}
    for d in range(ndim):
        want_rie_d = rie_dirs is None or d in rie_dirs
        if padded:
            if not (want_rie_d or return_pre_riemann or want_div):
                continue
            got = final(d, adv_vel[d], return_pre_riemann, want_rie_d,
                        want_div)
            i = 0
            if want_rie_d or want_div:
                out[d] = got[0]
                i = 1
            if return_pre_riemann:
                pre[d] = (got[i], got[i + 1])
            continue
        # crop to valid faces/cells and final Riemann with the advecting vel
        lo_f, hi_f = final(d, None, True, False, False)
        lo_v = _crop_faces(lo_f, grid, d, G)
        hi_v = _crop_faces(hi_f, grid, d, G)
        pre[d] = (lo_v, hi_v)
        out[d] = riem(lo_v, hi_v, adv_vel[d])
    faces = tuple(out.get(d) for d in range(ndim))
    if return_pre_riemann:
        return faces, tuple(pre.get(d) for d in range(ndim))
    return faces


def riemann_from_states(pre_states, adv_vel, upwind: bool = True):
    """Final Riemann upwinding of precomputed (lo, hi) face states against
    a (new) advecting velocity."""
    riem = _riemann if upwind else _riemann_avg
    return tuple(riem(lo, hi, adv_vel[d])
                 for d, (lo, hi) in enumerate(pre_states))


def _normal_predict_fullpad(sp, u_pad, ax: int, G: int, dx: float, dt: float,
                            params: AdvectionParams):
    """Normal predictor on the full padded array: face-indexed (lo, hi) of
    sp's shape for every order and limiter (the PPM predictor without the
    high-order limiter is the first half of kernel K1's math)."""
    hol = params.use_high_order_limiter and params.use_limiting
    if params.normal_pred_order == 2 and not hol:
        return ppm_face_states(sp, u_pad, dt / dx, ax, params.use_limiting)
    if params.normal_pred_order == 2:
        need = 3
    else:
        need = 2 if (params.use_fourth_order_slopes or hol) else 1
    ncell = sp.shape[ax] - 2 * need

    def cell(k):
        return sp.narrow(ax, need + k, ncell)

    u = u_pad.narrow(ax, need, ncell)
    s0 = cell(0)
    nu = u * dt / dx

    if params.normal_pred_order == 0:
        splus = s0
        sminus = s0
    elif params.normal_pred_order == 1:
        if hol:
            # extremum-preserving limit of the raw (unlimited) slope
            if params.use_fourth_order_slopes:
                raw = _fourth_order_slope(cell(-2), cell(-1), s0, cell(1),
                                          cell(2), False)
            else:
                raw = 0.5 * (cell(1) - cell(-1))
            slope = _ext_preserving_slope(raw, cell(-2), cell(-1), s0,
                                          cell(1), cell(2))
        elif params.use_fourth_order_slopes:
            slope = _fourth_order_slope(cell(-2), cell(-1), s0, cell(1),
                                        cell(2), params.use_limiting)
        else:
            slope = _vanleer_slope(cell(-1), s0, cell(1),
                                   params.use_limiting)
        splus = s0 + 0.5 * (1.0 - torch.clamp_min(nu, 0.0)) * slope
        sminus = s0 - 0.5 * (1.0 + torch.clamp_max(nu, 0.0)) * slope
    else:
        sL, sR = _ppm_high_order_limited(cell, s0)
        dsum = sR - sL
        s6 = 6.0 * (s0 - 0.5 * (sL + sR))
        sig_p = torch.clamp_min(nu, 0.0)
        sig_m = torch.clamp_min(-nu, 0.0)
        splus = sR - 0.5 * sig_p * (dsum - (1.0 - (2.0 / 3.0) * sig_p) * s6)
        sminus = sL + 0.5 * sig_m * (dsum + (1.0 - (2.0 / 3.0) * sig_m) * s6)

    # back to the padded length along ax with edge values (ghost space,
    # cropped before use); face-indexed: lo from the left cell f, hi from
    # the right cell f+1
    def edge_pad(arr):
        first = arr.narrow(ax, 0, 1)
        last = arr.narrow(ax, ncell - 1, 1)
        return torch.cat([first] * need + [arr] + [last] * need, dim=ax)

    return edge_pad(splus), shift_p(edge_pad(sminus), ax)


def _ppm_high_order_limited(cell, s0):
    """PPM face values (sL, sR) of each cell with the Colella-Sekora
    (2008) extremum-preserving limiter (limitC = 1.25, c3 = 0.1,
    eps = 1e-12): smooth extrema are rescaled by rho = D2lim / D2fcf
    instead of flattened; discontinuities clip to the parabola bounds."""
    def face(k):
        return (7.0 / 12.0) * (cell(k) + cell(k + 1)) \
            - (1.0 / 12.0) * (cell(k - 1) + cell(k + 2))

    sR = face(0)
    sL = face(-1)
    limitC, c3, eps = 1.25, 0.1, 1e-12
    dWM = sL - s0
    dWP = sR - s0

    def d2(k):
        return cell(k - 1) - 2.0 * cell(k) + cell(k + 1)

    d2WLL, d2WL, d2WC = d2(-2), d2(-1), d2(0)
    d2WR, d2WRR = d2(1), d2(2)
    fcf = 6.0 * (dWM + dWP)     # D2 of the face-cell-face parabola
    bigM = dWM.abs() > 2.0 * dWP.abs()
    bigP = dWP.abs() > 2.0 * dWM.abs()
    prodE1 = dWM * dWP
    prodE2 = (s0 - cell(-2)) * (cell(2) - s0)
    extremum = (prodE1 >= 0.0) | (prodE2 <= 0.0)
    sC = torch.sign(d2WC)
    same = ((torch.sign(d2WL) == sC) & (torch.sign(d2WR) == sC)
            & (torch.sign(fcf) == sC))
    d2Wlim = sC * torch.minimum(
        fcf.abs(),
        limitC * torch.minimum(d2WC.abs(),
                               torch.minimum(d2WL.abs(), d2WR.abs())))
    nonzero = fcf.abs() >= eps
    rho = torch.where(same & nonzero,
                      d2Wlim / torch.where(nonzero, fcf, 1.0), 0.0)
    # third-derivative check: near a cubic profile, leave alone
    d3WLL = d2WL - d2WLL
    d3WL = d2WC - d2WL
    d3WR = d2WR - d2WC
    d3WRR = d2WRR - d2WR
    d3min = torch.minimum(torch.minimum(d3WLL, d3WL),
                          torch.minimum(d3WR, d3WRR))
    d3max = torch.maximum(torch.maximum(d3WLL, d3WL),
                          torch.maximum(d3WR, d3WRR))
    prodD3 = (c3 * torch.maximum(d3max.abs(), d3min.abs())
              - (d3max - d3min).abs())
    mod = extremum & (rho < 1.0 - eps) & (prodD3 <= 0.0)
    shrink = prodE1 > 0.0
    dWMn = torch.where(
        mod,
        torch.where(shrink, dWM * rho,
                    torch.where(bigM, dWM * rho - 2.0 * dWP * (1.0 - rho),
                                dWM)),
        torch.where(~extremum & bigM, -2.0 * dWP, dWM))
    dWPn = torch.where(
        mod,
        torch.where(shrink, dWP * rho,
                    torch.where(bigP, dWP * rho - 2.0 * dWM * (1.0 - rho),
                                dWP)),
        torch.where(~extremum & bigP, -2.0 * dWM, dWP))
    return s0 + dWMn, s0 + dWPn


def _crop_faces(face_pad, grid: Grid, d: int, G: int, lead: int = 0):
    """Crop a face-indexed padded array to the valid faces of dir d
    (n+1 of them: entries G-1 .. G+n) and valid cells of the other axes."""
    out = face_pad
    for j in range(grid.ndim):
        ax = grid.axis(j) + lead
        if j == d:
            out = slc(out, ax, G - 1, G + grid.nx[d])
        else:
            out = slc(out, ax, G, -G)
    return out


def _crop_cells(cc_pad, grid: Grid, G: int, lead: int = 0):
    """Crop a padded cell array to the valid region."""
    out = cc_pad
    for j in range(grid.ndim):
        out = slc(out, grid.axis(j) + lead, G, G + grid.nx[j])
    return out


def pad_valid_faces(valid, grid: Grid, d: int, G: int = ADVECT_GROW):
    """Embed a valid (n+1)-face array of dir d into the padded face-indexed
    shape (zeros at ghost entries): valid face i lands at padded index
    G-1+i."""
    shape = list(valid.shape)
    index = [slice(None)] * valid.ndim
    for j in range(grid.ndim):
        ax = grid.axis(j)
        lo, hi = (G - 1, G) if j == d else (G, G)
        index[ax] = slice(lo, lo + shape[ax])
        shape[ax] += lo + hi
    out = valid.new_zeros(shape)
    out[tuple(index)] = valid
    return out


# --------------------------------------------------------------------------
# flux divergence updates
# --------------------------------------------------------------------------
def flux_divergence(face_states: Sequence, adv_vel: Sequence,
                    geo: LevelGeometry, padded: bool = False):
    """Conservative update term (1/J) d_d (J u^d s).  padded=True: the
    inputs are padded face-indexed and the result is cropped once."""
    grid = geo.grid
    out = None
    for d in range(grid.ndim):
        ax = grid.axis(d)
        F = face_states[d] * adv_vel[d]
        if padded:
            term = (F - shift_m(F, ax)) / grid.dx[d]
        else:
            term = diff_along(F, ax) / grid.dx[d]
        out = term if out is None else out + term
    if padded:
        out = _crop_cells(out, grid, ADVECT_GROW)
    return out * geo.Jinv


def divergence_from_partials(partials: Sequence, geo: LevelGeometry):
    """Conservative update term from per-direction undivided flux
    differences: out = (1/J) sum_d dF_d / dx_d, cropped once."""
    grid = geo.grid
    out = None
    for d in range(grid.ndim):
        term = partials[d] / grid.dx[d]
        out = term if out is None else out + term
    return _crop_cells(out, grid, ADVECT_GROW) * geo.Jinv


def momentum_flux_divergence(pre_list: Sequence, adv_pad: Sequence,
                             geo: LevelGeometry, upwind: bool = True):
    """Deferred momentum update: re-upwind each field's stashed (lo_f,
    hi_f) pairs against the projected advecting velocity and form the
    conservative flux divergence, one K4 launch per direction for all
    fields.  pre_list: per field, per dir (lo, hi) padded pairs."""
    grid = geo.grid
    nf = len(pre_list)
    partials = [[None] * grid.ndim for _ in range(nf)]
    for d in range(grid.ndim):
        ax = grid.axis(d)
        pairs = [pre_list[f][d] for f in range(nf)]
        if upwind:
            got = riemann_fluxdiv(pairs, adv_pad[d], ax)
        else:
            got = []
            for lo, hi in pairs:
                F = _riemann_avg(lo, hi, adv_pad[d]) * adv_pad[d]
                got.append(F - shift_m(F, ax))
        for f in range(nf):
            partials[f][d] = got[f]
    return [divergence_from_partials(p, geo) for p in partials]


# --------------------------------------------------------------------------
# batched padded-path tracer: B fields against shared velocities
# --------------------------------------------------------------------------
def trace_face_states_batched(
    fields: Sequence,          # B cell-centered fields
    srcs,                      # per-field CC source or None (or None)
    bcs_list: Sequence[FieldBCs],
    adv_vel: Sequence,         # per-dir PADDED face-indexed advecting vel
    dt: float,
    geo: LevelGeometry,
    params: AdvectionParams,
    u_pad: Sequence,           # per-dir padded tracing velocity (shared)
    return_pre_riemann: bool = False,
):
    """`trace_face_states(padded=True)` of B fields against the same
    tracing and advecting velocities.  Each field is traced in turn
    through the same kernels (one K1-K3 set of launches per field).
    Returns a tuple over d of (B,)+padded face arrays (and the stacked
    (lo, hi) pre-Riemann pairs)."""
    ndim = geo.grid.ndim
    faces, pres = [], []
    for b, (f, bcs) in enumerate(zip(fields, bcs_list)):
        src = srcs[b] if srcs is not None else None
        got = trace_face_states(f, None, adv_vel, src, dt, geo, bcs, params,
                                u_pad=u_pad, padded=True,
                                return_pre_riemann=return_pre_riemann)
        if return_pre_riemann:
            got, pre = got
            pres.append(pre)
        faces.append(got)
    out = tuple(torch.stack([fc[d] for fc in faces]) for d in range(ndim))
    if return_pre_riemann:
        return out, tuple(
            (torch.stack([p[d][0] for p in pres]),
             torch.stack([p[d][1] for p in pres])) for d in range(ndim))
    return out


def flux_divergence_batched(face_states: Sequence, adv_vel: Sequence,
                            geo: LevelGeometry):
    """Conservative update for a batch: face_states[d] is (B,)+padded
    face-indexed, adv_vel[d] the unbatched padded advecting velocity.
    Returns (B,)+valid cells."""
    grid = geo.grid
    out = None
    for d in range(grid.ndim):
        ax = grid.axis(d) + 1
        F = face_states[d] * adv_vel[d][None]
        term = (F - shift_m(F, ax)) / grid.dx[d]
        out = term if out is None else out + term
    return _crop_cells(out, grid, ADVECT_GROW, lead=1) * geo.Jinv


def riemann_batched(pre_states, adv_vel, upwind: bool = True):
    """Final Riemann upwinding of batched padded (lo, hi) pre-states
    against the (unbatched padded) advecting velocity."""
    riem = _riemann if upwind else _riemann_avg
    return tuple(riem(lo, hi, adv_vel[d][None])
                 for d, (lo, hi) in enumerate(pre_states))
