"""Raw-coefficient geometries: a LevelGeometry built from explicit arrays
(PyTorch port of `somar_tpu.geometry.raw_geometry`).

Used where an operator's coefficients do not come from a coordinate map:
the leptic solver's flattened horizontal operator (vertically integrated
J g^ij) and any variable-coefficient elliptic solve.  Coarse multigrid
levels coarsen the arrays directly (face coefficients: subsample along
the normal, block-average tangentially; cell-centred fields: block
average), the coefficient coarsening of operator-driven multigrid.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from somar_tpu_torch.core.grid import Grid
from somar_tpu_torch.geometry.geo_source import GeoSource
from somar_tpu_torch.geometry.level_geometry import LevelGeometry


class RawGeoSource(GeoSource):
    """Marker geo-source of array-defined geometries (no coordinate map):
    never uniform, so operators on it take the probed-stencil plans;
    equal to another by its flag alone."""

    is_uniform = False
    name = "Raw"

    def __init__(self, is_diagonal: bool = True):
        self.is_diagonal = is_diagonal

    def __eq__(self, other):
        return (type(other) is RawGeoSource
                and other.is_diagonal == self.is_diagonal)

    def __hash__(self):
        return hash(("RawGeoSource", self.is_diagonal))

    def phys_coor(self, mu, xi):
        return xi[mu]   # identity placeholder; the metric is the arrays


def _full(a, shape, device, dtype):
    """a (scalar, numpy array or tensor) broadcast to a tensor of shape."""
    t = torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor)
                        else a, dtype=dtype, device=device)
    return t * torch.ones(shape, dtype=dtype, device=device)


def raw_level_geometry(grid: Grid, J, Jgup_diag: Sequence, *, device,
                       dtype=torch.float32) -> LevelGeometry:
    """A diagonal raw geometry on `device`: J at cell centres and J g^dd
    on the faces of each direction d (scalars, numpy arrays or tensors,
    broadcast to grid.shape and grid.fc_shape(d))."""
    device = torch.device(device)
    J = _full(J, grid.shape, device, dtype)
    return LevelGeometry(
        grid, RawGeoSource(), device=device, dtype=dtype,
        J=J, Jinv=1.0 / J,
        Jgup_diag=tuple(_full(g, grid.fc_shape(d), device, dtype)
                        for d, g in enumerate(Jgup_diag)))


def raw_from_level_geometry(lg: LevelGeometry,
                            grid: Grid = None) -> LevelGeometry:
    """A map-derived LevelGeometry re-wrapped as a raw one, so that
    multigrid coarsens its metric as data instead of re-evaluating the
    map.  Keeps the full metric (Jgup_full, e, einv, gdn) where present.
    `grid` optionally rebases it onto a grid with the same nx and dx."""
    if grid is None:
        grid = lg.grid
    if grid.nx != lg.grid.nx or grid.dx != lg.grid.dx:
        raise ValueError("raw_from_level_geometry: the grids differ in nx "
                         "or dx")
    kw = dict(dtype=lg.dtype, device=lg.device)
    J = lg.J * torch.ones(grid.shape, **kw)
    return LevelGeometry(
        grid, RawGeoSource(is_diagonal=lg.is_diagonal),
        device=lg.device, dtype=lg.dtype,
        J=J, Jinv=1.0 / J,
        Jgup_diag=tuple(lg.Jgup_diag[d] * torch.ones(grid.fc_shape(d), **kw)
                        for d in range(grid.ndim)),
        Jgup_full=lg.Jgup_full, e_cc=lg.e_cc, einv_cc=lg.einv_cc,
        gdn_cc=lg.gdn_cc)


def _block_mean_cc(arr, grid: Grid, ratio):
    """Block average of a cell-centred array by the per-direction ratio."""
    shape = arr.shape
    new_shape = []
    for ax in range(len(shape)):
        r = ratio[grid.dir_of_axis(ax)]
        new_shape.extend([shape[ax] // r, r])
    return arr.reshape(new_shape).mean(
        dim=tuple(range(1, 2 * len(shape), 2)))


def _coarsen_fc(arr, grid: Grid, d: int, ratio):
    """Coarsen a face-centred coefficient of direction d: subsample the
    faces that coincide with coarse faces along the normal, block-average
    tangentially."""
    ax_n = grid.axis(d)
    sl = [slice(None)] * arr.ndim
    sl[ax_n] = slice(None, None, ratio[d])
    out = arr[tuple(sl)]
    new_shape = []
    mean_axes = []
    pos = 0
    for ax, n in enumerate(out.shape):
        if ax == ax_n:
            new_shape.append(n)
            pos += 1
        else:
            r = ratio[grid.dir_of_axis(ax)]
            new_shape.extend([n // r, r])
            mean_axes.append(pos + 1)
            pos += 2
    return out.reshape(new_shape).mean(dim=tuple(mean_axes))


def coarsen_raw_geometry(geo: LevelGeometry, ratio) -> LevelGeometry:
    """The raw geometry of the grid coarsened by `ratio`, its arrays
    coarsened directly."""
    grid = geo.grid
    grid_c = grid.coarsen(ratio)
    ndim = grid.ndim
    kw = dict(dtype=geo.dtype, device=geo.device)
    J_c = _block_mean_cc(geo.J * torch.ones(grid.shape, **kw), grid, ratio)
    Jg_c = tuple(
        _coarsen_fc(geo.Jgup_diag[d] * torch.ones(grid.fc_shape(d), **kw),
                    grid, d, ratio)
        for d in range(ndim))
    Jg_full_c = None
    if geo.Jgup_full is not None:
        Jg_full_c = tuple(
            torch.stack([_coarsen_fc(geo.Jgup_full[d][j], grid, d, ratio)
                         for j in range(ndim)])
            for d in range(ndim))

    def cc_tensor(t):
        if t is None:
            return None
        return torch.stack([
            torch.stack([_block_mean_cc(t[i, j], grid, ratio)
                         for j in range(ndim)])
            for i in range(ndim)])

    return LevelGeometry(
        grid_c, geo.geo, device=geo.device, dtype=geo.dtype,
        J=J_c, Jinv=1.0 / J_c, Jgup_diag=Jg_c, Jgup_full=Jg_full_c,
        e_cc=cc_tensor(geo.e_cc), einv_cc=cc_tensor(geo.einv_cc),
        gdn_cc=cc_tensor(geo.gdn_cc))
