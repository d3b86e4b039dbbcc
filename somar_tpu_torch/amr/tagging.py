"""Refinement tagging: where to refine (PyTorch port of
`somar_tpu.amr.tagging`, single-patch placement).

Undivided-difference tags on buoyancy, velocity and pressure, |vorticity|
quota and absolute thresholds, gradient-Richardson-number tags, tag growing
and vertical extrusion.  Tagging is host work at placement: the fields it
needs are read to the host once per call (`solvers/host_reads.read_arrays`)
and the tags are a numpy boolean array, as in the JAX package.  The
multi-patch `patch_origins_from_tags` waits for slice 10 (ROADMAP A.5).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from somar_tpu_torch.core.grid import Grid
from somar_tpu_torch.solvers.host_reads import read_arrays


@dataclasses.dataclass(frozen=True)
class TagParams:
    buoyancy_tag_tol: float = 0.0
    vel_tag_tol: float = 0.0
    magvort_tag_quota: float = 0.0
    pressure_tag_tol: float = 0.0
    #: tag cells with gradient Richardson number <= ri_tag_tol
    do_ri_tagging: bool = False
    ri_tag_tol: float = 0.25
    #: per-component absolute |vorticity| thresholds (2D: component z)
    vort_tag_tol: tuple = (0.0, 0.0, 0.0)
    tags_grow: int = 0
    vert_extrude: bool = True
    #: Berger-Rigoutsos knobs (amr.fill_ratio / amr.block_factor)
    fill_ratio: float = 0.8
    block_factor: int = 8


def _undivided_diff_mag(f: np.ndarray) -> np.ndarray:
    """Max undivided one-sided difference magnitude over all axes."""
    out = np.zeros_like(f)
    for ax in range(f.ndim):
        d = np.abs(np.diff(f, axis=ax))
        lo = [slice(None)] * f.ndim
        hi = [slice(None)] * f.ndim
        lo[ax] = slice(0, -1)
        hi[ax] = slice(1, None)
        np.maximum(out[tuple(lo)], d, out=out[tuple(lo)])
        np.maximum(out[tuple(hi)], d, out=out[tuple(hi)])
    return out


def compute_tags(state, level, params: TagParams) -> np.ndarray:
    """Boolean tag field on the level's grid (host numpy)."""
    grid: Grid = level.grid
    ndim = grid.ndim
    use_vort_tol = any(t > 0.0 for t in params.vort_tag_tol)
    # every device field the tests below read, in one host read
    names, tensors = [], []
    if params.buoyancy_tag_tol > 0.0:
        names.append("b")
        tensors.append(state.scalars[0])
    if params.vel_tag_tol > 0.0:
        names.append("vel")
        tensors.append(state.vel)
    if params.pressure_tag_tol > 0.0:
        names.append("p")
        tensors.append(state.pressure)
    if params.do_ri_tagging:
        from somar_tpu_torch.physics.derived import compute_ri_number
        names.append("ri")
        tensors.append(compute_ri_number(level, state))
    if params.magvort_tag_quota > 0.0 or use_vort_tol:
        from somar_tpu_torch.ops.stencil import vorticity
        names.append("w")
        tensors.append(vorticity(state.vel, level.geo,
                                 [level.vel_bcs_trace[m]
                                  for m in range(ndim)]))
    host = dict(zip(names, read_arrays(*tensors))) if tensors else {}

    tags = np.zeros(grid.shape, dtype=bool)
    if "b" in host:
        tags |= _undivided_diff_mag(host["b"]) > params.buoyancy_tag_tol
    if "vel" in host:
        for m in range(ndim):
            tags |= _undivided_diff_mag(host["vel"][m]) > params.vel_tag_tol
    if "p" in host:
        tags |= _undivided_diff_mag(host["p"]) > params.pressure_tag_tol
    if "ri" in host:
        tags |= host["ri"] <= params.ri_tag_tol
    if "w" in host:
        w = host["w"]
        mag = np.abs(w) if ndim == 2 else np.sqrt((w ** 2).sum(axis=0))
        if params.magvort_tag_quota > 0.0:
            mmax = mag.max()
            if mmax > 0:
                tags |= mag > params.magvort_tag_quota * mmax
        if use_vort_tol:
            tol = params.vort_tag_tol
            if ndim == 2:
                if tol[2] > 0.0:
                    tags |= np.abs(w) >= tol[2]
            else:
                for c in range(3):
                    if tol[c] > 0.0:
                        tags |= np.abs(w[c]) >= tol[c]

    if params.tags_grow > 0 and tags.any():
        g = params.tags_grow
        grown = tags.copy()
        for ax in range(tags.ndim):
            for shift in range(1, g + 1):
                grown |= np.roll(tags, shift, axis=ax)
                grown |= np.roll(tags, -shift, axis=ax)
        tags = grown

    if params.vert_extrude and tags.any():
        # a tagged column is tagged over the whole vertical (array axis 0)
        tags = np.broadcast_to(tags.any(axis=0, keepdims=True),
                               tags.shape).copy()
    return tags


def tag_coverage(tags: np.ndarray, origins, weights, grid: Grid, ratio,
                 interior_shape_f, halo_axes):
    """(n_dropped, n_tagged): tagged parent cells not covered by any active
    patch interior."""
    origins = np.atleast_2d(np.asarray(origins, dtype=np.int64))
    covered = np.zeros_like(tags)
    for k in range(origins.shape[0]):
        if weights is not None and float(np.asarray(weights)[k]) == 0.0:
            continue
        sl = []
        for ax in range(tags.ndim):
            r = ratio[grid.dir_of_axis(ax)]
            start_c = (int(origins[k, ax]) + halo_axes[ax]) // r
            size_c = max(1, interior_shape_f[ax] // r)
            sl.append(slice(max(0, start_c),
                            min(tags.shape[ax], start_c + size_c)))
        covered[tuple(sl)] = True
    return int((tags & ~covered).sum()), int(tags.sum())


def patch_origin_from_tags(tags: np.ndarray, grid: Grid, ratio,
                           interior_shape_f, halo_axes,
                           lo_pad_f=None) -> Optional[np.ndarray]:
    """The per-array-axis origin (fine cells) of the EXTENDED patch
    centred on the tags' bounding box, snapped to coarse cells and clamped
    so that the patch, its halo and one coarse cell of donor margin stay
    in the domain (`lo_pad_f`: an extra no-go margin at both ends); None
    when nothing is tagged."""
    from somar_tpu_torch.native import tag_bounding_box

    bbox = tag_bounding_box(tags)
    if bbox is None:
        return None
    if lo_pad_f is None:
        lo_pad_f = (0,) * grid.ndim
    lo, hi = bbox[0], bbox[1]
    origin = np.zeros(grid.ndim, dtype=np.int64)
    for ax in range(grid.ndim):
        r = ratio[grid.dir_of_axis(ax)]
        n_f = grid.nx[grid.dir_of_axis(ax)] * r
        interior_f = interior_shape_f[ax]
        h = halo_axes[ax]
        center_c = 0.5 * (lo[ax] + hi[ax] + 1)
        start_f = int(round(center_c * r - interior_f / 2))
        start_f = (start_f // r) * r
        margin = h + r + lo_pad_f[ax] if h > 0 else 0
        start_f = max(margin, min(start_f, n_f - interior_f - margin))
        origin[ax] = start_f - h
    return origin
