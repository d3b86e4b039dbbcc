"""Unsplit Godunov (CTU) advection: PPM tracing + limiting + upwinding
(PyTorch port of the padded path of `somar_tpu.physics.godunov`).

Scheme (Colella's unsplit corner-transport-upwind):
  1. normal predictor per direction: PPM half-step traced left/right face
     states with optional CW84 parabola limiting (kernel K1, which also
     emits the shared transverse correction corr2);
  2. transverse corrections: 1D Riemann states of the other directions
     feed an advective-form quasilinear correction (full 3-stage CTU in
     3D with the dt/3 intermediate states; kernel K2);
  3. Riemann upwinding by the face advecting velocity (kernel K3);
  4. conservative flux divergence (1/J) d_d (J u^d s) (K3's fused flux
     difference, or K4 for the momentum update).

Every intermediate keeps the full padded cell shape ("face-indexed": entry
f is the face between cells f and f+1, the last entry is junk); junk
entries live in ghost space and are cropped once at the end.  Ghost
requirement: ADVECT_GROW = 4 layers.

This slice ports the PPM predictor with Riemann upwinding.  The PLM/CTU(0)
predictors, the extremum-preserving limiter and central (non-upwinded)
fluxes raise NotImplementedError, as does the batched multi-field tracer
of the JAX package (nothing on the main path calls it).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from somar_tpu_torch.core.bc import FieldBCs, fill_ghosts_cc
from somar_tpu_torch.core.grid import Grid
from somar_tpu_torch.geometry.level_geometry import LevelGeometry
from somar_tpu_torch.ops.ctu_kernels import (
    ctu_corr3, ctu_final, ppm_face_states, ppm_predict, riemann,
    riemann_fluxdiv)
from somar_tpu_torch.ops.stencil import diff_along, shift_m, slc

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


def _check_supported(params: AdvectionParams):
    if params.normal_pred_order != 2:
        raise NotImplementedError(
            "only the PPM predictor (normal_pred_order=2) is ported")
    if params.use_high_order_limiter and params.use_limiting:
        raise NotImplementedError(
            "the extremum-preserving PPM limiter is not ported")
    if not params.use_upwinding:
        raise NotImplementedError("central (non-upwinded) fluxes are not ported")


#: passive-advection Riemann: upwind by the face velocity
_riemann = riemann


def _riemann_avg(lo, hi, vface):
    """Central face states (advection.useUpwinding* = 0)."""
    return 0.5 * (lo + hi)


# --------------------------------------------------------------------------
# the full CTU predictor
# --------------------------------------------------------------------------
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
    _check_supported(params)
    if want_div and not padded:
        raise ValueError("want_div needs padded=True")
    grid = geo.grid
    ndim = grid.ndim
    G = ADVECT_GROW

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
    lo1, hi1, corr2 = [], [], []
    for d in range(ndim):
        lo_d, hi_d, c2_d = ppm_predict(
            sp, u_pad[d], dt / grid.dx[d], grid.axis(d), params.use_limiting,
            corr_coef_over_dx=coef / grid.dx[d])
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
            got = ctu_corr3(lo1[j], hi1[j], u_pad[j], [corr2[k] for k in ks],
                            (dt / 2.0) / grid.dx[j], grid.axis(j))
            for k, c3 in zip(ks, got):
                corr3[(j, k)] = c3

    # --------------------------------------- stage 3: final face states (K3)
    src_pad = (fill_ghosts_cc(src, grid, bcs, G) if src is not None
               else None)
    out = {}
    pre = {}
    for d in range(ndim):
        ax = grid.axis(d)
        want_rie_d = rie_dirs is None or d in rie_dirs
        c3_list = ([corr3[(j, 3 - d - j)] for j in range(ndim) if j != d]
                   if ndim == 3 else [corr2[1 - d]])
        if padded:
            if not (want_rie_d or return_pre_riemann or want_div):
                continue
            got = ctu_final(lo1[d], hi1[d], adv_vel[d], c3_list, src_pad,
                            0.5 * dt, ax, want_pre=return_pre_riemann,
                            want_rie=want_rie_d, want_div=want_div)
            i = 0
            if want_rie_d or want_div:
                out[d] = got[0]
                i = 1
            if return_pre_riemann:
                pre[d] = (got[i], got[i + 1])
            continue
        # crop to valid faces/cells and final Riemann with the advecting vel
        lo_f, hi_f = ctu_final(lo1[d], hi1[d], None, c3_list, src_pad,
                               0.5 * dt, ax, want_pre=True, want_rie=False)
        lo_v = _crop_faces(lo_f, grid, d, G)
        hi_v = _crop_faces(hi_f, grid, d, G)
        pre[d] = (lo_v, hi_v)
        out[d] = _riemann(lo_v, hi_v, adv_vel[d])
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
    """PPM normal predictor on the full padded array: face-indexed (lo, hi)
    of sp's shape (the first half of kernel K1's math)."""
    _check_supported(params)
    return ppm_face_states(sp, u_pad, dt / dx, ax, params.use_limiting)


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
    if not upwind:
        raise NotImplementedError("central (non-upwinded) fluxes are not ported")
    grid = geo.grid
    nf = len(pre_list)
    partials = [[None] * grid.ndim for _ in range(nf)]
    for d in range(grid.ndim):
        got = riemann_fluxdiv([pre_list[f][d] for f in range(nf)],
                              adv_pad[d], grid.axis(d))
        for f in range(nf):
            partials[f][d] = got[f]
    return [divergence_from_partials(p, geo) for p in partials]
