"""Mapped-grid finite-volume stencil operators (PyTorch port of
`somar_tpu.ops.stencil`).

Conventions:
  * CC scalar fields: shape grid.shape (vertical-major).
  * MAC flux fields: tuple over logical dir d of tensors on fc_shape(d); a
    "flux" is the J-scaled contravariant component J u^d.
  * Operators take unpadded interior fields plus the FieldBCs needed to
    manufacture ghosts.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from somar_tpu_torch.core.bc import BCType, FieldBCs, fill_ghosts_cc
from somar_tpu_torch.core.grid import Grid
from somar_tpu_torch.geometry.level_geometry import LevelGeometry


# --------------------------------------------------------------------------
# slicing helpers
# --------------------------------------------------------------------------
def slc(arr, ax: int, lo: int, hi: int | None):
    s = [slice(None)] * arr.ndim
    s[ax] = slice(lo, hi)
    return arr[tuple(s)]


def diff_along(arr, ax: int):
    """arr[i+1] - arr[i] along axis ax (length shrinks by 1)."""
    return slc(arr, ax, 1, None) - slc(arr, ax, 0, -1)


def avg_along(arr, ax: int):
    """0.5*(arr[i+1] + arr[i]) along axis ax (length shrinks by 1)."""
    return 0.5 * (slc(arr, ax, 1, None) + slc(arr, ax, 0, -1))


# --------------------------------------------------------------------------
# same-shape shifted copies with junk edge entries (the face-indexed
# convention of physics/godunov.py)
# --------------------------------------------------------------------------
def shift_p(a, ax: int):
    """out[i] = a[i+1]; edge junk at the last entry."""
    return torch.cat([slc(a, ax, 1, None), slc(a, ax, -1, None)], dim=ax)


def shift_m(a, ax: int):
    """out[i] = a[i-1]; edge junk at the first entry."""
    return torch.cat([slc(a, ax, 0, 1), slc(a, ax, 0, -1)], dim=ax)


def face_avg(u, ax: int):
    """Face value at f = 0.5 (u[f] + u[f+1]), same shape as u."""
    return 0.5 * (u + shift_p(u, ax))


# --------------------------------------------------------------------------
# cell <-> face interpolation
# --------------------------------------------------------------------------
def cc_to_fc(field, d: int, grid: Grid, bcs: FieldBCs):
    """2-point average of a CC field onto faces normal to logical dir d,
    including the domain-boundary faces (1 ghost layer from BCs)."""
    ng = [0] * grid.ndim
    ng[d] = 1
    return avg_along(fill_ghosts_cc(field, grid, bcs, ng), grid.axis(d))


def fc_to_cc(flux, d: int, grid: Grid):
    """2-point average of a FC field back to cell centers."""
    return avg_along(flux, grid.axis(d))


# --------------------------------------------------------------------------
# MAC gradient: F_d = sum_j J g^{dj} d_j(phi) at faces normal to d
# --------------------------------------------------------------------------
def mac_gradient(phi, geo: LevelGeometry, bcs: FieldBCs,
                 jgup_delta=None) -> Tuple:
    """jgup_delta: optional per-direction additive modification of the
    face metric, ((diag_d,)*ndim, (full_d,)*ndim | None): the altered
    metric of implicit gravity (projection/altered_metric.py)."""
    # one ghost everywhere covers both normal and tangential derivatives
    p = fill_ghosts_cc(phi, geo.grid, bcs, 1)
    return mac_gradient_prepadded(p, geo, jgup_delta, bcs=bcs)


def mac_gradient_prepadded(p, geo: LevelGeometry, jgup_delta=None,
                           bcs: Optional[FieldBCs] = None) -> Tuple:
    """mac_gradient on a tensor already padded with ONE ghost layer on
    every side.

    bcs (when known): Neumann sides constrain the TOTAL co-normal flux
    J g^{dj} d_j phi, so the cross-metric term is zeroed at those boundary
    faces.  Without this the cross term leaks flux through solid walls:
    the pure-Neumann solvability condition breaks and the projected
    velocity's wall-normal flux is not conserved."""
    grid = geo.grid
    ndim = grid.ndim
    dx = grid.dx
    d_diag = jgup_delta[0] if jgup_delta is not None else None
    d_full = jgup_delta[1] if jgup_delta is not None else None
    fluxes = []
    for d in range(ndim):
        ax = grid.axis(d)
        # normal derivative at faces of d: strip tangential ghosts
        pn = p
        for j in range(ndim):
            if j != d:
                pn = slc(pn, grid.axis(j), 1, -1)
        Jg_d = geo.Jgup_diag[d]
        if d_diag is not None and d_diag[d] is not None:
            Jg_d = Jg_d + d_diag[d]
        flux = Jg_d * (diff_along(pn, ax) / dx[d])

        if d_full is not None or (not geo.is_diagonal
                                  and geo.Jgup_full is not None):
            # tangential derivatives averaged to the d-faces: CC central
            # derivative in j, then 2-point average along d
            for j in range(ndim):
                if j == d:
                    continue
                coef = (geo.Jgup_full[d][j] if geo.Jgup_full is not None
                        else 0.0)
                if d_full is not None and d_full[d] is not None:
                    coef = coef + d_full[d][j]
                if isinstance(coef, float) and coef == 0.0:
                    continue
                axj = grid.axis(j)
                pj = p
                for k in range(ndim):
                    if k != d and k != j:
                        pj = slc(pj, grid.axis(k), 1, -1)
                dphi_j = (slc(pj, axj, 2, None)
                          - slc(pj, axj, 0, -2)) / (2.0 * dx[j])
                cross = coef * avg_along(dphi_j, ax)   # a fresh tensor
                if bcs is not None:
                    n = cross.shape[ax]
                    for bc, idx in ((bcs.lo[d], 0), (bcs.hi[d], n - 1)):
                        if bc.type == BCType.NEUMANN:
                            cross.select(ax, idx).zero_()
                flux = flux + cross
        fluxes.append(flux)
    return tuple(fluxes)


# --------------------------------------------------------------------------
# MAC divergence: (1/J) sum_d (F_d[hi] - F_d[lo]) / dx_d
# --------------------------------------------------------------------------
def mac_divergence(fluxes: Sequence, geo: LevelGeometry,
                   scale_by_Jinv: bool = True):
    grid = geo.grid
    out = None
    for d in range(grid.ndim):
        term = diff_along(fluxes[d], grid.axis(d)) / grid.dx[d]
        out = term if out is None else out + term
    if scale_by_Jinv:
        out = out * geo.Jinv
    return out


# --------------------------------------------------------------------------
# CC gradient of a CC field via face-average of the MAC gradient
# --------------------------------------------------------------------------
def cc_gradient(phi, geo: LevelGeometry, bcs: FieldBCs):
    """(ndim,)+shape tensor: (J g^{dj} d_j phi)/J averaged to CC, i.e. the
    contravariant gradient g^{dj} d_j phi at cell centers."""
    grid = geo.grid
    fluxes = mac_gradient(phi, geo, bcs)
    return torch.stack([fc_to_cc(fluxes[d], d, grid) * geo.Jinv
                        for d in range(grid.ndim)])


# --------------------------------------------------------------------------
# CC divergence of a CC (Cartesian-basis) velocity: diagnostics
# --------------------------------------------------------------------------
def cc_divergence(vel_cart, geo: LevelGeometry,
                  bcs_per_comp: Sequence[FieldBCs]):
    """div u = (1/J) d_d (J u^d) with u^d = einv . u_cart, by CC central
    differences (diagnostic quality; the solvers use mac_divergence)."""
    grid = geo.grid
    u_mapped = geo.to_mapped(vel_cart)
    out = None
    for d in range(grid.ndim):
        ax = grid.axis(d)
        ng = [0] * grid.ndim
        ng[d] = 1
        f = fill_ghosts_cc(geo.mult_by_J(u_mapped[d]), grid, bcs_per_comp[d],
                           ng)
        term = (slc(f, ax, 2, None) - slc(f, ax, 0, -2)) / (2.0 * grid.dx[d])
        out = term if out is None else out + term
    return out * geo.Jinv


# --------------------------------------------------------------------------
# vorticity
# --------------------------------------------------------------------------
def _cc_phys_derivs(f, geo: LevelGeometry, bcs: FieldBCs):
    """Physical-space gradient d f / d x_k at CC via the chain rule."""
    grid = geo.grid
    p = fill_ghosts_cc(f, grid, bcs, 1)
    dxi = []
    for j in range(grid.ndim):
        pj = p
        for k in range(grid.ndim):
            if k != j:
                pj = slc(pj, grid.axis(k), 1, -1)
        axj = grid.axis(j)
        dxi.append((slc(pj, axj, 2, None) - slc(pj, axj, 0, -2))
                   / (2.0 * grid.dx[j]))
    if geo.einv_cc is None:
        return torch.stack(dxi)  # d f / d xi_j
    # d f / d x_k = sum_j (d f / d xi_j) (d xi_j / d x_k), summed in j
    # order as an elementwise sum (no matrix product, so no TF32)
    e = geo.einv_cc
    out = []
    for k in range(grid.ndim):
        acc = e[0, k] * dxi[0]
        for j in range(1, grid.ndim):
            acc = acc + e[j, k] * dxi[j]
        out.append(acc)
    return torch.stack(out)


def vorticity(vel_cart, geo: LevelGeometry,
              bcs_per_comp: Sequence[FieldBCs]):
    """2D: scalar omega = dv/dx - du/dz (the two in-plane dirs);
    3D: 3-component curl of the Cartesian velocity."""
    ndim = geo.grid.ndim
    # grads[m][k] = d u_m / d x_k
    grads = [_cc_phys_derivs(vel_cart[m], geo, bcs_per_comp[m])
             for m in range(ndim)]
    if ndim == 2:
        return grads[1][0] - grads[0][1]
    wx = grads[2][1] - grads[1][2]
    wy = grads[0][2] - grads[2][0]
    wz = grads[1][0] - grads[0][1]
    return torch.stack([wx, wy, wz])
