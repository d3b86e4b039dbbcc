"""Refinement tagging: where to refine (PyTorch port of
`somar_tpu.amr.tagging`).

Undivided-difference tags on buoyancy, velocity and pressure, |vorticity|
quota and absolute thresholds, gradient-Richardson-number tags, tag growing
and vertical extrusion.  Tagging is host work at placement: the fields it
needs are read to the host once per call (`solvers/host_reads.read_arrays`)
and the tags are a numpy boolean array, as in the JAX package.  The
origins of one patch (`patch_origin_from_tags`) or of K same-shape patches
(`patch_origins_from_tags`, Berger-Rigoutsos clusters merged until they
fit K separated patches) are host integers.
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


def _extended_origin(lo, hi, grid: Grid, ratio, interior_shape_f,
                     halo_axes, lo_pad_f) -> np.ndarray:
    """The per-array-axis origin (fine cells) of the EXTENDED patch
    centred on the box [lo, hi] (parent cells, hi inclusive), snapped to
    coarse cells and clamped so that the patch, its halo and one coarse
    cell of donor margin stay in the domain (`lo_pad_f`: an extra no-go
    margin at both ends)."""
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


def patch_origins_from_tags(tags: np.ndarray, grid: Grid, ratio,
                            interior_shape_f, halo_axes, num_patches: int,
                            lo_pad_f=None, fill_ratio: float = 0.8,
                            block_factor: int = 8):
    """Up to `num_patches` separated patch origins covering the tag
    clusters: (origins (K, ndim) int64, weights (K,) float32), weight 0
    marking an inactive slot that duplicates slot 0; None when nothing is
    tagged.  Berger-Rigoutsos boxes are merged, largest first, until at
    most K remain and their extended patches (plus one parent cell of
    donor margin) are disjoint along a CF axis, so that every patch's CF
    halo sees only parent data."""
    from somar_tpu_torch.native import berger_rigoutsos

    if not tags.any():
        return None
    if lo_pad_f is None:
        lo_pad_f = (0,) * grid.ndim
    K = int(num_patches)
    boxes = np.asarray(berger_rigoutsos(
        tags, fill_ratio=fill_ratio,
        min_side=max(1, int(block_factor) // 2)))   # (n, 2, ndim), hi incl.
    if boxes.ndim != 3 or len(boxes) == 0:
        boxes = np.stack([np.stack([np.zeros(grid.ndim, np.int64),
                                    np.asarray(tags.shape) - 1])])
    cf_axes = [ax for ax in range(grid.ndim) if halo_axes[ax] > 0]
    groups = [b.astype(np.int64) for b in boxes]

    def origin_of(bbox):
        return _extended_origin(bbox[0], bbox[1], grid, ratio,
                                interior_shape_f, halo_axes, lo_pad_f)

    def merged(a, b):
        return np.stack([np.minimum(a[0], b[0]), np.maximum(a[1], b[1])])

    def patches_overlap(oa, ob):
        for ax in cf_axes:
            r = ratio[grid.dir_of_axis(ax)]
            ext_f = interior_shape_f[ax] + 2 * halo_axes[ax]
            if oa[ax] + ext_f + r <= ob[ax] - r \
                    or ob[ax] + ext_f + r <= oa[ax] - r:
                return False
        return len(cf_axes) > 0

    while True:
        groups.sort(key=lambda b: -int(np.prod(b[1] - b[0] + 1)))
        while len(groups) > K:
            # merge the pair with the smallest gap along the CF axes
            best = (None, np.inf)
            for i in range(len(groups)):
                for j in range(i + 1, len(groups)):
                    gap = 0
                    for ax in cf_axes:
                        gap += max(0, max(groups[i][0][ax]
                                          - groups[j][1][ax] - 1,
                                          groups[j][0][ax]
                                          - groups[i][1][ax] - 1))
                    if gap < best[1]:
                        best = ((i, j), gap)
            (i, j), _ = best
            groups[i] = merged(groups[i], groups[j])
            del groups[j]
        origins = [origin_of(b) for b in groups]
        collided = False
        for i in range(len(origins)):
            for j in range(i + 1, len(origins)):
                if patches_overlap(origins[i], origins[j]):
                    groups[i] = merged(groups[i], groups[j])
                    del groups[j]
                    collided = True
                    break
            if collided:
                break
        if not collided:
            break

    n = len(origins)
    out = np.zeros((K, grid.ndim), dtype=np.int64)
    w = np.zeros(K, dtype=np.float32)
    for k in range(K):
        out[k] = origins[k if k < n else 0]
        w[k] = 1.0 if k < n else 0.0
    return out, w


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
    return _extended_origin(bbox[0], bbox[1], grid, ratio, interior_shape_f,
                            halo_axes, lo_pad_f)
