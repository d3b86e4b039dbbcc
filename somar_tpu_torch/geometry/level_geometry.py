"""LevelGeometry: the metric fields of one level (PyTorch port of
`somar_tpu.geometry.level_geometry`).

Every field is computed once per level on the host in float64 numpy and
then stored as tensors of the level's dtype on its device.  On a uniform
(Cartesian) map every metric field is the Python float 1.0, so `J * x` and
the basis transforms cost nothing.

Fields (logical direction d; array axis = grid.axis(d)):
  J, Jinv        CC volume element and its inverse (grid.shape tensors on
                 mapped levels)
  Jgup_diag[d]   J g^{dd} at faces normal to d, fc_shape(d)
  Jgup_full[d]   J g^{d,:} full row, (ndim,)+fc_shape(d); None when the
                 metric is diagonal
  e_cc           dx_mu/dxi_nu at CC, (ndim, ndim)+shape; None when uniform
  einv_cc        dxi_mu/dx_nu at CC; None when uniform
  gdn_cc         covariant metric at CC; None when uniform

Velocity tensors have shape (ndim,)+shape with component index = logical
Cartesian direction.  The basis transforms are written as explicit
elementwise sums, never as a matrix product, so no TF32 product can enter
them on the card.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from somar_tpu_torch.core.grid import Grid
from somar_tpu_torch.geometry.geo_source import GeoSource


def _contract(m, v):
    """out[mu] = sum_nu m[mu, nu] * v[nu], summed in nu order."""
    nd = v.shape[0]
    rows = []
    for mu in range(nd):
        acc = m[mu, 0] * v[0]
        for nu in range(1, nd):
            acc = acc + m[mu, nu] * v[nu]
        rows.append(acc)
    return torch.stack(rows)


class LevelGeometry:
    def __init__(self, grid: Grid, geo: GeoSource, *, device, dtype,
                 J=1.0, Jinv=1.0, Jgup_diag=None, Jgup_full=None, e_cc=None,
                 einv_cc=None, gdn_cc=None):
        self.grid = grid
        self.geo = geo
        self.J = J
        self.Jinv = Jinv
        self.Jgup_diag = (Jgup_diag if Jgup_diag is not None
                          else (1.0,) * grid.ndim)
        self.Jgup_full = Jgup_full
        self.e_cc = e_cc
        self.einv_cc = einv_cc
        self.gdn_cc = gdn_cc
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
        """Contravariant (mapped-basis) -> Cartesian components at CC."""
        if self.e_cc is None:
            return vel_mapped
        return _contract(self.e_cc, vel_mapped)

    def to_mapped(self, vel_cart):
        """Cartesian -> contravariant (mapped-basis) components at CC."""
        if self.einv_cc is None:
            return vel_cart
        return _contract(self.einv_cc, vel_cart)

    def mult_by_J(self, field):
        return field * self.J

    def div_by_J(self, field):
        return field * self.Jinv

    def contract_vectors(self, a, b):
        """g_ij a^i b^j for mapped-basis vectors (a . b on uniform maps)."""
        nd = a.shape[0]
        acc = None
        for i in range(nd):
            for j in range(nd):
                if self.gdn_cc is None:
                    if i != j:
                        continue
                    term = a[i] * b[j]
                else:
                    term = self.gdn_cc[i, j] * a[i] * b[j]
                acc = term if acc is None else acc + term
        return acc

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

    def displacement_cc(self) -> np.ndarray:
        """x(xi) - xi at CC, (ndim,)+shape host numpy (for plot files)."""
        xi = self.grid.coords()
        return np.stack([
            np.broadcast_to(np.asarray(self.geo.phys_coor(mu, xi)) - xi[mu],
                            self.grid.shape)
            for mu in range(self.ndim)])


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
    computed in float64 on the host and stored as `dtype`."""
    device = require_device(device)
    if geo.is_uniform:
        return LevelGeometry(grid, geo, device=device, dtype=dtype)
    ndim = grid.ndim

    def tensor(a, shape):
        return torch.as_tensor(np.array(np.broadcast_to(a, shape)),
                               dtype=dtype, device=device)

    # --- CC metrics
    J_cc, _, gdn_cc, e_cc, einv_cc = geo.metrics(grid.coords())
    shape = grid.shape
    J_cc = np.broadcast_to(J_cc, shape)

    # --- FC metrics: J g^{d, :} on faces normal to each logical dir d
    Jgup_diag = []
    Jgup_full = [] if not geo.is_diagonal else None
    for d in range(ndim):
        cent = [0] * ndim
        cent[d] = 1
        J_fc, gup_fc, _, _, _ = geo.metrics(grid.coords(cent))
        fshape = grid.fc_shape(d)
        Jgup_diag.append(tensor(J_fc * gup_fc[d, d], fshape))
        if Jgup_full is not None:
            row = np.stack([np.broadcast_to(J_fc * gup_fc[d, j], fshape)
                            for j in range(ndim)])
            Jgup_full.append(tensor(row, row.shape))

    full = (ndim, ndim) + shape
    return LevelGeometry(
        grid, geo, device=device, dtype=dtype,
        J=tensor(J_cc, shape), Jinv=tensor(1.0 / J_cc, shape),
        Jgup_diag=tuple(Jgup_diag),
        Jgup_full=tuple(Jgup_full) if Jgup_full is not None else None,
        e_cc=tensor(e_cc, full), einv_cc=tensor(einv_cc, full),
        gdn_cc=tensor(gdn_cc, full))
