"""Volume-weighted sums and norms on mapped grids, by level and over an
AMR hierarchy (PyTorch port of the parts of `somar_tpu.ops.norms` that
the AMR path uses).

The physical-volume integral of a CC field is sum_c f_c J_c dV_xi; a
hierarchy sum takes each level's cells that no finer patch covers (a level
of K > 1 patches each active patch's, times its weight; a patch's cells
are masked by the child patches nested in it, its own children).  Sums
accumulate in float32, or in float64 for float64 fields (the JAX package
under x64).  As there, the field is rounded to float32, and |f|^p taken
in float32, before it is weighted.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def _dv(geo) -> float:
    return float(np.prod(geo.grid.dx))


def _weight(field, geo):
    """J on every cell, in the accumulation dtype."""
    acc = torch.float64 if field.dtype == torch.float64 else torch.float32
    return geo.J * torch.ones(geo.grid.shape, dtype=acc, device=field.device)


def mapped_sum(field, geo, mask=None):
    """Integral of a CC field over physical volume, sum f J dV (a 0-d
    tensor); `mask` keeps the cells where it is True."""
    w = _weight(field, geo)
    f = field.to(torch.float32).to(w.dtype) * w
    if mask is not None:
        f = torch.where(mask, f, torch.zeros((), dtype=f.dtype,
                                             device=f.device))
    return torch.sum(f) * _dv(geo)


def mapped_norm(field, geo, p: int = 2, mask=None):
    """Volume-weighted p-norm (sum |f|^p J dV)^(1/p); p = 0 is the max
    norm."""
    zero = torch.zeros((), dtype=field.dtype, device=field.device)
    if p == 0:
        f = field.abs()
        if mask is not None:
            f = torch.where(mask, f, zero)
        return f.max()
    w = _weight(field, geo)
    f = (field.to(torch.float32).abs() ** p).to(w.dtype) * w
    if mask is not None:
        f = torch.where(mask, f, zero.to(f.dtype))
    return torch.sum(f * _dv(geo)) ** (1.0 / p)


def _uncovered_mask(grid, origin_axes, shape_axes, device):
    """False inside the rectangle a finer patch covers."""
    mask = torch.ones(grid.shape, dtype=torch.bool, device=device)
    mask[tuple(slice(max(0, int(o)), max(0, int(o) + int(s)))
               for o, s in zip(origin_axes, shape_axes))] = False
    return mask


def _halo_free_mask(c, grid, device):
    """False in a patch's own CF halo (interpolated, not valid data)."""
    mask = torch.ones(grid.shape, dtype=torch.bool, device=device)
    for ax in range(grid.ndim):
        if grid.dir_of_axis(ax) in c.cf_dirs:
            sl = [slice(None)] * grid.ndim
            sl[ax] = slice(0, c.halo)
            mask[tuple(sl)] = False
            sl[ax] = slice(grid.shape[ax] - c.halo, None)
            mask[tuple(sl)] = False
    return mask


def composite_mapped_sum(hierarchy, fields: Sequence, origins):
    """Hierarchy integral: each level contributes its uncovered cells (a
    0-d tensor).  fields: one CC tensor per level, coarse to fine;
    origins: one per coupling."""
    return _composite(hierarchy, fields, origins, kind="sum")


def composite_mapped_norm(hierarchy, fields: Sequence, origins,
                          p: int = 2):
    """Hierarchy p-norm with covered-region masking."""
    return _composite(hierarchy, fields, origins, kind="norm", p=p)


def _composite(h, fields, origins, kind: str, p: int = 2):
    total = mx = None
    for lev in range(1 + len(h.couplings)):
        if lev == 0:
            parts = [(fields[0], None, h.level0.geo)]
        else:
            # a level of K > 1 patches passes its (K,)+shape stack; a
            # weight-0 slot contributes nothing, the others times weight;
            # each patch's volumes are its own metric's (a mapped slot's
            # J at its position)
            c = h.couplings[lev - 1]
            geos = [lv.geo for lv in c.levels]
            parts = ([(fields[lev][k], w, geos[k]) for k, w in
                      enumerate(c.patch_weights(c.weights))]
                     if c.K > 1 else [(fields[lev], None, geos[0])])
        for k, (field, w, geo) in enumerate(parts):
            if w == 0.0:
                continue
            grid = geo.grid
            device = field.device
            mask = (_halo_free_mask(h.couplings[lev - 1], grid, device)
                    if lev > 0 else torch.ones(grid.shape, dtype=torch.bool,
                                               device=device))
            if lev < len(h.couplings):
                cf = h.couplings[lev]
                for o, q in zip(cf.patch_origins(origins[lev]),
                                h._own_psel(cf)):
                    if q == k:
                        mask = mask & _uncovered_mask(
                            grid, cf.covered_origin_c(o),
                            cf.covered_shape_c, device)
            if kind == "sum":
                v = mapped_sum(field, geo, mask=mask)
            elif p == 0:
                v = mapped_norm(field, geo, 0, mask=mask)
                mx = v if mx is None else torch.maximum(mx, v)
                continue
            else:
                v = mapped_norm(field, geo, p, mask=mask) ** p
            if w is not None:
                v = w * v
            total = v if total is None else total + v
    if kind == "sum":
        return total
    if p == 0:
        return mx
    return total ** (1.0 / p)
