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
             homogeneous) or a block shaped like the ghost region.

A BC value is a scalar, a 0-d tensor (e.g. a value bound at a step's time
on the device), an array profile (e.g. the HorizConv top buoyancy, varying
along x) or a callable `t -> value` of time.  Callables must be bound with
`BC.bind_time` / `FieldBCs.at_time` before a ghost fill; bound at a 0-d
device tensor t they stay on the device, so binding adds no host read.
`FieldBCs.on_device` turns array profiles into tensors on the field's
device once; a fill given a numpy profile copies it on every call.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Sequence, Tuple

import numpy as np
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
    """value: Dirichlet face value or Neumann coordinate derivative: a
    scalar, a 0-d tensor, an array profile, or a callable `t -> scalar /
    array` for time-dependent boundary data, bound with `bind_time`
    before a ghost fill."""
    type: BCType
    value: object = 0.0
    order: int = 1      # extrapolation order (0, 1 or 2) for EXTRAP

    @property
    def time_dependent(self) -> bool:
        return callable(self.value)

    def bind_time(self, t) -> "BC":
        """Evaluate a callable value at time t (a Python float or a 0-d
        tensor); other values are returned as they are."""
        if not callable(self.value):
            return self
        return dataclasses.replace(self, value=self.value(t))

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
    def cf(value=0.0) -> "BC":
        """Coarse-fine ghost cells: a uniform value (zeros when
        homogeneous) or a block shaped like the ghost region."""
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

    def at_time(self, t) -> "FieldBCs":
        """Bind every callable value at time t; the same object when
        nothing is time-dependent."""
        if not self.time_dependent:
            return self
        return FieldBCs(lo=tuple(b.bind_time(t) for b in self.lo),
                        hi=tuple(b.bind_time(t) for b in self.hi))

    def on_device(self, device, dtype) -> "FieldBCs":
        """The same BCs with every array profile a tensor of `dtype` on
        `device` (scalars and callables unchanged): a level converts its
        profiles once instead of on every fill."""
        def conv(b):
            v = b.value
            if callable(v) or np.ndim(v) == 0:
                return b
            return dataclasses.replace(b, value=torch.as_tensor(
                np.asarray(v) if not isinstance(v, torch.Tensor) else v,
                dtype=dtype, device=device))
        return FieldBCs(lo=tuple(conv(b) for b in self.lo),
                        hi=tuple(conv(b) for b in self.hi))


def bind_bcs_time(bcs, t):
    """at_time over a FieldBCs or a (nested) tuple of them."""
    if isinstance(bcs, FieldBCs):
        return bcs.at_time(t)
    return tuple(bind_bcs_time(b, t) for b in bcs)


def _value_like(v, like):
    """A BC value ready for arithmetic with `like`: a Python float, or a
    tensor of like's dtype on its device (no copy where it already is)."""
    if isinstance(v, torch.Tensor):
        if v.device == like.device and v.dtype == like.dtype:
            return v
        return v.to(device=like.device, dtype=like.dtype)
    if np.ndim(v) == 0:
        return float(v)
    return torch.as_tensor(np.asarray(v), dtype=like.dtype,
                           device=like.device)


def _edge_pad(v, pads):
    """Pad v by (lo, hi) per axis, repeating its edge entries."""
    for a, (lo, hi) in enumerate(pads):
        if lo == 0 and hi == 0:
            continue
        n = v.shape[a]
        idx = torch.arange(-lo, n + hi, device=v.device).clamp_(0, n - 1)
        v = v.index_select(a, idx)
    return v


def _take(arr, ax: int, lo: int, hi: int):
    return arr.narrow(ax, lo, hi - lo)


def _ghost_block(arr, ax: int, bc: BC, ngrow: int, side: int, h: float):
    """The ngrow-layer ghost block along axis ax on one side (side = -1
    low, +1 high), ordered for direct concatenation."""
    n = arr.shape[ax]
    if n < ngrow:
        raise ValueError(f"need >= {ngrow} interior cells along axis {ax}")
    if callable(bc.value):
        raise ValueError("time-dependent BC value not bound: call "
                         "FieldBCs.at_time(t) first")

    def interior(k):
        # k-th interior cell counted from the boundary (k = 1..ngrow)
        if side < 0:
            return _take(arr, ax, k - 1, k)
        return _take(arr, ax, n - k, n - k + 1)

    def fit_value(v):
        """An array profile is built on the interior shape; ghost fills
        along earlier directions have already widened the tangential
        axes, so edge-pad it symmetrically to match."""
        v = _value_like(v, arr)
        if not isinstance(v, torch.Tensor) or v.ndim == 0:
            return v
        ref = interior(1)
        pads = []
        for a in range(ref.ndim):
            if a == ax or v.shape[a] in (1, ref.shape[a]):
                pads.append((0, 0))
            else:
                extra = ref.shape[a] - v.shape[a]
                pads.append((extra // 2, extra - extra // 2))
        return _edge_pad(v, pads)

    layers = []  # innermost ghost (k=1) first
    if bc.type == BCType.DIRICHLET:
        val = fit_value(bc.value)
        for k in range(1, ngrow + 1):
            layers.append(2.0 * val - interior(k))
    elif bc.type == BCType.NEUMANN:
        s = -1.0 if side < 0 else 1.0
        val = fit_value(bc.value)
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
        # externally supplied ghost data (zeros when homogeneous): a
        # scalar broadcasts, an array must already be the ngrow-deep ghost
        # block in the right orientation
        block_shape = list(arr.shape)
        block_shape[ax] = ngrow
        val = _value_like(bc.value, arr)
        if isinstance(val, torch.Tensor):
            return val.expand(block_shape)
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
    through solid walls, or an inflow); other types leave the face
    untouched.  Returns a new tensor; the input is not modified.
    """
    ax = grid.axis(d)
    n = flux.shape[ax]
    out = flux
    for bc, idx in ((bcs.lo[d], 0), (bcs.hi[d], n - 1)):
        if bc.type == BCType.DIRICHLET:
            if out is flux:
                out = flux.clone()
            _set_slice(out, ax, idx, bc.value)
    return out


def _set_slice(arr, ax: int, idx: int, value):
    """arr[..., idx, ...] = value along axis ax, in place: a scalar, a 0-d
    tensor (copied on the device, no host read) or a profile shaped like
    arr with extent 1 along ax."""
    dst = arr.select(ax, idx)
    v = _value_like(value, arr)
    if not isinstance(v, torch.Tensor):
        dst.fill_(v)
    else:
        dst.copy_(v.squeeze(ax) if v.ndim == arr.ndim else v)
