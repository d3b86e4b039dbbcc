"""LevelGeometry: the metric fields of one level (PyTorch port of
`somar_tpu.geometry.level_geometry`).

This slice ports the uniform scalar-metric fast path: on a uniform
(Cartesian) map every metric field is the Python float 1.0, so `J * x`
and the basis transforms cost nothing.  Mapped metrics (array-valued J,
J g^ij and basis transforms) come with ROADMAP slice 3;
`build_level_geometry` raises NotImplementedError for them.

Fields (logical direction d; array axis = grid.axis(d)):
  J, Jinv        CC volume element and its inverse
  Jgup_diag[d]   J g^{dd} at faces normal to d
  Jgup_full, e_cc, einv_cc, gdn_cc   None (mapped metrics only)
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from somar_tpu_torch.core.grid import Grid
from somar_tpu_torch.geometry.geo_source import GeoSource


class LevelGeometry:
    def __init__(self, grid: Grid, geo: GeoSource, *, device, dtype):
        self.grid = grid
        self.geo = geo
        self.J = 1.0
        self.Jinv = 1.0
        self.Jgup_diag = (1.0,) * grid.ndim
        self.Jgup_full = None
        self.e_cc = None
        self.einv_cc = None
        self.gdn_cc = None
        self.device = torch.device(device)
        self.dtype = dtype

    @property
    def is_uniform(self) -> bool:
        return self.geo.is_uniform

    @property
    def is_diagonal(self) -> bool:
        return self.geo.is_diagonal

    @property
    def ndim(self) -> int:
        return self.grid.ndim

    @property
    def dx(self):
        return self.grid.dx

    # ----------------------------------------------------- basis transforms
    def to_cartesian(self, vel_mapped):
        """Contravariant (mapped-basis) -> Cartesian components at CC (the
        identity on a uniform map)."""
        return vel_mapped

    def to_mapped(self, vel_cart):
        """Cartesian -> contravariant (mapped-basis) components at CC (the
        identity on a uniform map)."""
        return vel_cart

    def mult_by_J(self, field):
        return field * self.J

    def div_by_J(self, field):
        return field * self.Jinv

    # -------------------------------------------------------------- coords
    def phys_coords_cc(self) -> Tuple[np.ndarray, ...]:
        """Physical cell-center coordinates (host numpy, broadcastable)."""
        xi = self.grid.coords()
        return tuple(
            np.asarray(self.geo.phys_coor(mu, xi)) for mu in range(self.ndim))

    def phys_coords_fc(self, d: int) -> Tuple[np.ndarray, ...]:
        cent = [0] * self.ndim
        cent[d] = 1
        xi = self.grid.coords(cent)
        return tuple(
            np.asarray(self.geo.phys_coor(mu, xi)) for mu in range(self.ndim))


def require_device(device) -> torch.device:
    """`device` as a torch.device; a CUDA device that is not there raises
    (nothing carries on on the CPU by itself)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} asked for, but no CUDA device is "
            "available; pass device=\"cpu\" to run on the CPU")
    return device


def build_level_geometry(grid: Grid, geo: GeoSource, *, device="cuda",
                         dtype=torch.float32) -> LevelGeometry:
    """The level's metric on `device` (the GPU unless told otherwise),
    stored as `dtype`."""
    device = require_device(device)
    if not geo.is_uniform:
        raise NotImplementedError(
            "mapped metrics are ported in slice 3, see ROADMAP")
    return LevelGeometry(grid, geo, device=device, dtype=dtype)
