"""Inter-level transfer operators: prolongation, restriction, patch moves
(PyTorch port of `somar_tpu.amr.transfer`).

Anisotropic per-direction ratios throughout (ratio is per logical
direction; arrays are vertical-major).  Prolongation is slope-based
(limited central differences, one-sided at the edges, or the unlimited
parabola for elliptic ghost data) evaluated at the fine-cell offsets inside
each coarse cell; restriction is block averaging.  Patch origins are host
ints: extract_patch / insert_patch are plain indexing, with the start
clamped so that the patch fits, as `lax.dynamic_slice` clamps it.
"""

from __future__ import annotations

from typing import Sequence

import torch

from somar_tpu_torch.core.grid import Grid
from somar_tpu_torch.ops.stencil import slc
from somar_tpu_torch.solvers.multigrid import restrict_fullweight


def _slopes(arr, ax: int):
    """Van-Leer-limited central slopes per cell, one-sided at the edges."""
    n = arr.shape[ax]
    dl = slc(arr, ax, 1, n - 1) - slc(arr, ax, 0, n - 2)
    dr = slc(arr, ax, 2, n) - slc(arr, ax, 1, n - 1)
    dc = 0.5 * (dl + dr)
    lim = 2.0 * torch.minimum(dl.abs(), dr.abs())
    interior = torch.where((dl * dr) > 0.0,
                           torch.sign(dc) * torch.minimum(dc.abs(), lim),
                           torch.zeros((), dtype=arr.dtype,
                                       device=arr.device))
    lo = slc(arr, ax, 1, 2) - slc(arr, ax, 0, 1)
    hi = slc(arr, ax, n - 1, n) - slc(arr, ax, n - 2, n - 1)
    return torch.cat([lo, interior, hi], dim=ax)


def _offsets(r: int, out, ax: int):
    """Fine sub-cell offsets ((k + 0.5)/r - 0.5) shaped to broadcast along
    the inserted axis ax + 1."""
    off = (torch.arange(r, dtype=out.dtype, device=out.device) + 0.5) / r \
        - 0.5
    shape = [1] * (out.ndim + 1)
    shape[ax + 1] = r
    return off.reshape(shape)


def _merge(vals, out, ax: int, r: int):
    merged = list(out.shape)
    merged[ax] = merged[ax] * r
    return vals.reshape(merged)


def prolong_linear(coarse, grid_c: Grid, ratio: Sequence[int]):
    """Piecewise-multilinear interpolation with limited slopes onto the
    refined grid."""
    out = coarse
    for ax in range(coarse.ndim):
        r = ratio[grid_c.dir_of_axis(ax)]
        if r == 1:
            continue
        s = _slopes(out, ax)
        vals = out.unsqueeze(ax + 1) + _offsets(r, out, ax) * s.unsqueeze(
            ax + 1)
        out = _merge(vals, out, ax, r)
    return out


def prolong_quadratic(coarse, grid_c: Grid, ratio: Sequence[int]):
    """Piecewise-parabolic (unlimited) interpolation onto the refined grid:
    per axis the parabola through three coarse cells, f(off) = f0 + off*s1
    + off^2/2 * s2, one-sided at the edges (the elliptic CF ghost data)."""
    out = coarse
    for ax in range(coarse.ndim):
        r = ratio[grid_c.dir_of_axis(ax)]
        if r == 1:
            continue
        n = out.shape[ax]
        if n >= 3:
            dl = slc(out, ax, 1, n - 1) - slc(out, ax, 0, n - 2)
            dr = slc(out, ax, 2, n) - slc(out, ax, 1, n - 1)
            s1_int = 0.5 * (dl + dr)
            s2_int = dr - dl
            s1_lo = slc(s1_int, ax, 0, 1) - slc(s2_int, ax, 0, 1)
            s1_hi = slc(s1_int, ax, n - 3, n - 2) + slc(s2_int, ax, n - 3,
                                                         n - 2)
            s1 = torch.cat([s1_lo, s1_int, s1_hi], dim=ax)
            s2 = torch.cat([slc(s2_int, ax, 0, 1), s2_int,
                            slc(s2_int, ax, n - 3, n - 2)], dim=ax)
        elif n == 2:
            s1 = slc(out, ax, 1, 2) - slc(out, ax, 0, 1)
            s1 = torch.cat([s1, s1], dim=ax)
            s2 = torch.zeros_like(out)
        else:
            s1 = torch.zeros_like(out)
            s2 = torch.zeros_like(out)
        off = _offsets(r, out, ax)
        vals = (out.unsqueeze(ax + 1) + off * s1.unsqueeze(ax + 1)
                + 0.5 * off * off * s2.unsqueeze(ax + 1))
        out = _merge(vals, out, ax, r)
    return out


def restrict_average(fine, grid_f: Grid, ratio: Sequence[int]):
    """Fine -> coarse block average."""
    return restrict_fullweight(fine, grid_f, ratio)


def restrict_average_fc(fine_fc, d: int, grid_f: Grid, ratio: Sequence[int],
                        harmonic: bool = False):
    """Fine -> coarse averaging of a face-centered (d-normal) field: every
    ratio[d]-th fine face plane, block-averaged tangentially (arithmetic or
    harmonic)."""
    ax_n = grid_f.axis(d)
    s = [slice(None)] * fine_fc.ndim
    s[ax_n] = slice(0, None, ratio[d])
    out = fine_fc[tuple(s)]
    if harmonic:
        out = 1.0 / out
    resh = []
    mean_axes = []
    for ax in range(fine_fc.ndim):
        if ax == ax_n:
            resh.append(out.shape[ax])
        else:
            r = ratio[grid_f.dir_of_axis(ax)]
            resh.extend([out.shape[ax] // r, r])
            mean_axes.append(len(resh) - 1)
    out = out.reshape(resh).mean(dim=tuple(mean_axes))
    if harmonic:
        out = 1.0 / out
    return out


def prolong_linear_fc(coarse_fc, d: int, grid_c: Grid,
                      ratio: Sequence[int]):
    """Coarse -> fine interpolation of a face-centered (d-normal) field:
    linear along the normal between coincident coarse faces, limited-linear
    in the tangential directions."""
    ax_n = grid_c.axis(d)
    r_n = ratio[d]
    out = coarse_fc
    if r_n > 1:
        n = out.shape[ax_n]
        f = torch.arange(r_n, dtype=out.dtype, device=out.device) / r_n
        shape = [1] * (out.ndim + 1)
        shape[ax_n + 1] = r_n
        f = f.reshape(shape)
        vals = (slc(out, ax_n, 0, n - 1).unsqueeze(ax_n + 1) * (1.0 - f)
                + slc(out, ax_n, 1, n).unsqueeze(ax_n + 1) * f)
        merged = list(out.shape)
        merged[ax_n] = (n - 1) * r_n
        out = torch.cat([vals.reshape(merged), slc(out, ax_n, n - 1, n)],
                        dim=ax_n)
    for ax in range(coarse_fc.ndim):
        if ax == ax_n:
            continue
        r = ratio[grid_c.dir_of_axis(ax)]
        if r == 1:
            continue
        s = _slopes(out, ax)
        vals = out.unsqueeze(ax + 1) + _offsets(r, out, ax) * s.unsqueeze(
            ax + 1)
        out = _merge(vals, out, ax, r)
    return out


def _clamped(field_shape, origin_axes, shape_axes):
    """Per-axis slices of a patch, the start clamped into the array."""
    out = []
    for n, o, s in zip(field_shape, origin_axes, shape_axes):
        o = min(max(int(o), 0), n - int(s))
        out.append(slice(o, o + int(s)))
    return tuple(out)


def extract_patch(field, origin_axes, shape_axes):
    """The rectangular patch of `shape_axes` at `origin_axes` (host ints per
    array axis; trailing axes of field)."""
    lead = field.ndim - len(origin_axes)
    return field[(slice(None),) * lead
                 + _clamped(field.shape[lead:], origin_axes, shape_axes)]


def insert_patch(field, patch, origin_axes):
    """A copy of field with `patch` written at `origin_axes`."""
    out = field.clone()
    lead = field.ndim - len(origin_axes)
    out[(slice(None),) * lead + _clamped(field.shape[lead:], origin_axes,
                                         patch.shape[lead:])] = \
        patch.to(field.dtype)
    return out


def time_interp(old, new, frac):
    """Linear time interpolation between two states (every field,
    `time` included)."""
    import dataclasses
    return type(old)(**{
        f.name: (1.0 - frac) * getattr(old, f.name)
        + frac * getattr(new, f.name) for f in dataclasses.fields(old)})
