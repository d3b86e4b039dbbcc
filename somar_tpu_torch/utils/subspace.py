"""Subspace utilities (PyTorch port of `somar_tpu.utils.subspace`):
flattening the vertical away, vertical integrals and means, and
extrusion back up the water column, the substrate of the leptic solver's
vertical/horizontal split.  The vertical is array axis 0, so each is a
reduction or a broadcast along axis 0.
"""

from __future__ import annotations

import torch

from somar_tpu_torch.core.grid import Grid


def flatten_grid(grid: Grid) -> Grid:
    """The horizontal grid: the vertical direction removed."""
    v = grid.vertical_dir
    keep = [d for d in range(grid.ndim) if d != v]
    return Grid(
        nx=tuple(grid.nx[d] for d in keep),
        dx=tuple(grid.dx[d] for d in keep),
        x0=tuple(grid.x0[d] for d in keep),
        periodic=tuple(grid.periodic[d] for d in keep),
    )


def vertical_integral(field, grid: Grid, weight=None):
    """Sum over the vertical axis times dz, optionally weighted; returns
    the flattened-grid array."""
    if weight is not None:
        field = field * weight
    return torch.sum(field, dim=0) * grid.dx[grid.vertical_dir]


def vertical_mean(field, grid: Grid, weight=None):
    """Weighted vertical average per column."""
    if weight is None:
        return torch.mean(field, dim=0)
    return torch.sum(field * weight, dim=0) / torch.sum(
        weight * torch.ones_like(field), dim=0)


def extrude(flat_field, nz: int):
    """Broadcast a flattened-grid field back up the water column (a view
    of nz copies)."""
    return flat_field.unsqueeze(0).expand((nz,) + tuple(flat_field.shape))
