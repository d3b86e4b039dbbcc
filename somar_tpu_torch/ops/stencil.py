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

from typing import Sequence, Tuple

import torch

from somar_tpu_torch.core.bc import FieldBCs, fill_ghosts_cc
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
# MAC gradient: F_d = J g^{dd} d_d(phi) at faces normal to d (the diagonal
# metric of the uniform maps this slice runs; mapped metrics add the
# cross terms in slice 3)
# --------------------------------------------------------------------------
def mac_gradient(phi, geo: LevelGeometry, bcs: FieldBCs) -> Tuple:
    # one ghost everywhere covers the normal derivatives
    return mac_gradient_prepadded(fill_ghosts_cc(phi, geo.grid, bcs, 1), geo)


def mac_gradient_prepadded(p, geo: LevelGeometry) -> Tuple:
    """mac_gradient on a tensor already padded with ONE ghost layer on
    every side."""
    grid = geo.grid
    fluxes = []
    for d in range(grid.ndim):
        # normal derivative at faces of d: strip tangential ghosts
        pn = p
        for j in range(grid.ndim):
            if j != d:
                pn = slc(pn, grid.axis(j), 1, -1)
        fluxes.append(geo.Jgup_diag[d]
                      * (diff_along(pn, grid.axis(d)) / grid.dx[d]))
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
