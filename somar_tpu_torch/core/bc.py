"""Boundary conditions as functional ghost fills (PyTorch port of
`somar_tpu.core.bc`).

A `BC` is a (type, value, order) triple per (direction, side);
`fill_ghosts_cc` pads a cell-centered tensor with `ngrow` ghost layers
computed from the BC formulas.

Ghost formulas for CC data (boundary face lies between ghost and interior):
  PERIODIC   wrap.
  DIRICHLET  value v held at the face: odd reflection g_k = 2 v - c_{k-1}.
  NEUMANN    coordinate derivative dphi/dxi = g at the face: even
             reflection plus linear ramp g_k = c_{k-1} -/+ (2k-1) h g.
  EXTRAP     polynomial extrapolation of order 0/1/2 from interior cells.
  CF         externally supplied ghost data: a uniform value (zeros when
             homogeneous).

BC values are scalars in this slice.  Array-valued profiles and
time-dependent (callable) values are not ported yet: `fill_ghosts_cc`
raises NotImplementedError on a callable one.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Sequence, Tuple

import torch

from somar_tpu_torch.core.grid import Grid


class BCType(enum.IntEnum):
    PERIODIC = 0
    DIRICHLET = 1
    NEUMANN = 2
    EXTRAP = 3
    CF = 4


@dataclasses.dataclass(frozen=True)
class BC:
    """value: Dirichlet face value or Neumann coordinate derivative, a
    scalar (profiles and time-dependent values are not ported yet)."""
    type: BCType
    value: object = 0.0
    order: int = 1      # extrapolation order (0, 1 or 2) for EXTRAP

    @property
    def time_dependent(self) -> bool:
        return callable(self.value)

    @staticmethod
    def periodic() -> "BC":
        return BC(BCType.PERIODIC)

    @staticmethod
    def dirichlet(value: float = 0.0) -> "BC":
        return BC(BCType.DIRICHLET, value=value)

    @staticmethod
    def neumann(value: float = 0.0) -> "BC":
        return BC(BCType.NEUMANN, value=value)

    @staticmethod
    def extrap(order: int = 1) -> "BC":
        return BC(BCType.EXTRAP, order=order)

    @staticmethod
    def cf(value: float = 0.0) -> "BC":
        """Coarse-fine ghost data, a uniform value (zeros when
        homogeneous)."""
        return BC(BCType.CF, value=value)


@dataclasses.dataclass(frozen=True)
class FieldBCs:
    """Per-direction, per-side BCs for one field: lo[d] / hi[d] are the BCs
    on the low / high side of logical dir d."""

    lo: Tuple[BC, ...]
    hi: Tuple[BC, ...]

    def __post_init__(self):
        if len(self.lo) != len(self.hi):
            raise ValueError("lo and hi BC tuples differ in length")

    @property
    def ndim(self) -> int:
        return len(self.lo)

    @staticmethod
    def from_periodic(grid: Grid, interior: BC) -> "FieldBCs":
        """Periodic where the grid is periodic, `interior` elsewhere."""
        lo = tuple(BC.periodic() if p else interior for p in grid.periodic)
        return FieldBCs(lo=lo, hi=lo)

    def homogeneous(self) -> "FieldBCs":
        """Same types with zero values (for residual / correction solves)."""
        z = lambda b: dataclasses.replace(b, value=0.0)
        return FieldBCs(lo=tuple(z(b) for b in self.lo),
                        hi=tuple(z(b) for b in self.hi))

    @property
    def time_dependent(self) -> bool:
        return any(b.time_dependent for b in self.lo + self.hi)


def _take(arr, ax: int, lo: int, hi: int):
    return arr.narrow(ax, lo, hi - lo)


def _ghost_block(arr, ax: int, bc: BC, ngrow: int, side: int, h: float):
    """The ngrow-layer ghost block along axis ax on one side (side = -1
    low, +1 high), ordered for direct concatenation."""
    n = arr.shape[ax]
    if n < ngrow:
        raise ValueError(f"need >= {ngrow} interior cells along axis {ax}")
    if callable(bc.value):
        raise NotImplementedError(
            "time-dependent BC values are not ported yet, see ROADMAP")
    val = float(bc.value)

    def interior(k):
        # k-th interior cell counted from the boundary (k = 1..ngrow)
        if side < 0:
            return _take(arr, ax, k - 1, k)
        return _take(arr, ax, n - k, n - k + 1)

    layers = []  # innermost ghost (k=1) first
    if bc.type == BCType.DIRICHLET:
        for k in range(1, ngrow + 1):
            layers.append(2.0 * val - interior(k))
    elif bc.type == BCType.NEUMANN:
        s = -1.0 if side < 0 else 1.0
        for k in range(1, ngrow + 1):
            layers.append(interior(k) + s * (2 * k - 1) * h * val)
    elif bc.type == BCType.EXTRAP:
        if bc.order == 0:
            for k in range(1, ngrow + 1):
                layers.append(interior(1))
        elif bc.order == 1:
            c0, c1 = interior(1), interior(2)
            for k in range(1, ngrow + 1):
                layers.append((k + 1.0) * c0 - k * c1)
        elif bc.order == 2:
            c0, c1, c2 = interior(1), interior(2), interior(3)
            for k in range(1, ngrow + 1):
                # quadratic through the 3 edge cells, evaluated k cells out
                a = (k + 1.0) * (k + 2.0) / 2.0
                b = -k * (k + 2.0)
                c = k * (k + 1.0) / 2.0
                layers.append(a * c0 + b * c1 + c * c2)
        else:
            raise ValueError(f"unsupported extrap order {bc.order}")
    elif bc.type == BCType.CF:
        # externally supplied ghost data: a uniform value (0 homogeneous)
        block_shape = list(arr.shape)
        block_shape[ax] = ngrow
        return torch.full(block_shape, val, dtype=arr.dtype,
                          device=arr.device)
    else:
        raise ValueError(f"unsupported BC type {bc.type}")

    if side < 0:
        layers = layers[::-1]  # outermost first
    return torch.cat(layers, dim=ax)


def fill_ghosts_cc(field, grid: Grid, bcs: FieldBCs,
                   ngrow: int | Sequence[int] = 1):
    """Pad a CC field with ghost layers per the BCs.

    Axes are filled in logical-direction order x, y, z so that corner ghosts
    are consistent (each later axis's ghost formulas see the earlier axes'
    ghosts).  ngrow may be a scalar or a per-logical-direction sequence; 0
    skips a direction.
    """
    ndim = grid.ndim
    if isinstance(ngrow, int):
        ngrow = (ngrow,) * ndim
    out = field
    for d in range(ndim):
        ng = ngrow[d]
        if ng == 0:
            continue
        ax = grid.axis(d)
        if bcs.lo[d].type == BCType.PERIODIC:
            if bcs.hi[d].type != BCType.PERIODIC:
                raise ValueError("periodic BC on one side only")
            n = out.shape[ax]
            out = torch.cat([_take(out, ax, n - ng, n), out,
                             _take(out, ax, 0, ng)], dim=ax)
        else:
            lo = _ghost_block(out, ax, bcs.lo[d], ng, -1, grid.dx[d])
            hi = _ghost_block(out, ax, bcs.hi[d], ng, +1, grid.dx[d])
            out = torch.cat([lo, out, hi], dim=ax)
    return out


def apply_fc_bc(flux, d: int, grid: Grid, bcs: FieldBCs):
    """Overwrite the boundary faces of a FC (normal-component) field.

    Only DIRICHLET BCs pin the boundary face value (e.g. zero normal flow
    through solid walls); other types leave the face untouched.  Returns a
    new tensor; the input is not modified.
    """
    ax = grid.axis(d)
    n = flux.shape[ax]
    out = flux
    for bc, idx in ((bcs.lo[d], 0), (bcs.hi[d], n - 1)):
        if bc.type == BCType.DIRICHLET:
            if out is flux:
                out = flux.clone()
            out.select(ax, idx).fill_(float(bc.value))
    return out
