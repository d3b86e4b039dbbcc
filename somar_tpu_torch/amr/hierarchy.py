"""The two-level AMR hierarchy: a base level and one refined level of K
same-shape patches, subcycled (PyTorch port of the one-refined-level part
of `somar_tpu.amr.hierarchy`).

  * A patch is a dense rectangular block of static shape that spans the
    vertical and every periodic direction; its other horizontal sides are
    coarse-fine (CF) interfaces.  It carries an ADVECT_GROW halo on its CF
    sides, refreshed from space-time interpolated base data before every
    substep; its projections take the CF ghost-potential rings
    (quadratically interpolated base potentials folded into the rhs).
  * Origins are host ints (per array axis, in fine cells, of the extended
    patch), so every transfer is plain indexing.  A level of K > 1
    patches keeps the JAX layout: its state has a leading K axis, its
    origins are (K, ndim) and its weights (K,); a weight-0 slot
    duplicates slot 0, advances as it does, and adds nothing to the base.
  * Placement and regrid are host work: the base state is tagged
    (amr/tagging.py), clustered (native/, Berger-Rigoutsos) and the
    patches centred on the clusters.  Right-sizing doubles K (1 -> 2 ->
    4 ..., up to max_auto_patches, unless num_patches pins it) and then
    widens the footprint until no tagged cell is dropped; a regrid fills
    the new patches from the base and copies the old patches' data where
    they overlap in global fine index space.
  * One coarse step (`advance`): the base advance, nt = max(ratio) (times
    the dynamic-subcycling factor nt_mults) subcycled advances of every
    patch between the old and new base states, average-down, and the
    composite sync projection (amr/composite.py) with the elliptic reflux
    of each CF interface.

What the JAX package has beyond this (nested levels and parent selection,
mapped patches, refluxing, the VD correction, post-regrid smoothing,
sharded steps) raises NotImplementedError naming slice 11 of the port.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from somar_tpu_torch.amr.tagging import (
    TagParams, compute_tags, patch_origin_from_tags, patch_origins_from_tags,
    tag_coverage)
from somar_tpu_torch.amr.transfer import (
    extract_patch, insert_patch, prolong_linear, prolong_quadratic,
    restrict_average, time_interp)
from somar_tpu_torch.core.bc import BC, FieldBCs
from somar_tpu_torch.core.grid import Grid
from somar_tpu_torch.geometry.level_geometry import build_level_geometry
from somar_tpu_torch.ops.stencil import mac_divergence, slc
from somar_tpu_torch.physics.godunov import ADVECT_GROW
from somar_tpu_torch.physics.navier_stokes import NSLevel, NSParams, NSState
from somar_tpu_torch.problems.base import Problem
from somar_tpu_torch.projection.projector import LevelProjector, pressure_bcs
from somar_tpu_torch.solvers.host_reads import read_scalars
from somar_tpu_torch.solvers.parabolic import make_heat_solver
from somar_tpu_torch.solvers.poisson_op import PoissonOp

#: what a feature outside the port's AMR so far says when it raises
SLICE11 = "slice 11 of the port's AMR (ROADMAP A.5)"


def _slice11(what: str):
    return NotImplementedError(f"{what} is {SLICE11}")


def tree_index(s: NSState, k: int) -> NSState:
    """Patch k of a K-stacked state (every field, time included)."""
    return NSState(**{f.name: getattr(s, f.name)[k]
                      for f in dataclasses.fields(s)})


def tree_stack(states) -> NSState:
    """States stacked along a new leading patch axis."""
    return NSState(**{f.name: torch.stack([getattr(s, f.name)
                                           for s in states])
                      for f in dataclasses.fields(states[0])})


def host_weights(w):
    """Patch weights as a host float64 array (tensors read once)."""
    if isinstance(w, torch.Tensor):
        w = w.detach().cpu().numpy()
    return np.asarray(w, dtype=np.float64)


def _replace_cf_sides(bcs: FieldBCs, cf_dirs, new_bc: BC) -> FieldBCs:
    lo, hi = list(bcs.lo), list(bcs.hi)
    for d in cf_dirs:
        lo[d] = new_bc
        hi[d] = new_bc
    return FieldBCs(lo=tuple(lo), hi=tuple(hi))


def _edge_pad(t, ax: int, n: int):
    """t with n copies of its edge slices added at both ends of axis ax."""
    m = t.shape[ax]
    lo = slc(t, ax, 0, 1).expand(*[n if a == ax else s
                                   for a, s in enumerate(t.shape)])
    hi = slc(t, ax, m - 1, m).expand(*[n if a == ax else s
                                       for a, s in enumerate(t.shape)])
    return torch.cat([lo, t, hi], dim=ax)


def patch_footprint(parent_nx: Sequence[int], periodic: Sequence[bool],
                    ratio: Sequence[int], patch_frac: float = 0.5,
                    max_grid_size: int = 0, halo: int = ADVECT_GROW):
    """The static patch shape over a base level of `parent_nx` cells per
    logical direction: (interior_nx, ext_nx) in fine cells.

    The patch spans the vertical (the last direction) and every periodic
    direction; on the others (CF directions) the interior is patch_frac of
    the refined extent, capped by max_grid_size, rounded down to a
    multiple of 2r, at least 4 halo and at most the refined extent less
    max(halo r, halo + r) at each end.  Along x (direction 0) an extended
    extent (interior + 2 halo) above 128 snaps to the next multiple of 128
    that a 2r-aligned interior reaches (else the largest below): the JAX
    package's lane-padding rule, kept so that footprints match it."""
    ndim = len(parent_nx)
    H = halo
    interior = []
    cf = []
    for d in range(ndim):
        r = ratio[d]
        if d == ndim - 1 or periodic[d]:
            interior.append(parent_nx[d] * r)
            continue
        cf.append(d)
        n_f = parent_nx[d] * r
        want = int(round(patch_frac * n_f))
        if max_grid_size > 0:
            want = min(want, max_grid_size)
        want = max(4 * H, (want // (2 * r)) * (2 * r))
        cap = n_f - 2 * max(H * r, H + r)
        want = min(want, cap)
        if d == 0 and want + 2 * H > 128:
            cands = [m * 128 - 2 * H
                     for m in range(1, (cap + 2 * H) // 128 + 1)
                     if (m * 128 - 2 * H) % (2 * r) == 0
                     and 4 * H <= m * 128 - 2 * H <= cap]
            if cands:
                up = [c for c in cands if c >= want]
                want = min(up) if up else max(cands)
        interior.append(want)
    ext = tuple(interior[d] + (2 * H if d in cf else 0) for d in range(ndim))
    return tuple(interior), ext


class PatchNSLevel(NSLevel):
    """NSLevel on the extended patch grid with CF sides: EXTRAP(1) tracing
    fills (the halo data is authoritative) and CF(0) ghosts in the
    projections and the heat solves, whose solvers are rebuilt.

    As in the JAX package, the batched spectral viscous solver of the
    parent constructor (built with the problem's wall BCs on every side)
    is kept: where it exists, the patch's viscous update uses it rather
    than the rebuilt per-component solvers."""

    def __init__(self, geo, problem: Problem, params: NSParams,
                 cf_dirs: Tuple[int, ...]):
        super().__init__(geo, problem, params)
        grid = self.grid
        self.vel_bcs_trace = tuple(
            _replace_cf_sides(b, cf_dirs, BC.extrap(1))
            for b in self.vel_bcs_trace)
        self.vel_bcs_visc = tuple(
            _replace_cf_sides(b, cf_dirs, BC.cf(0.0))
            for b in self.vel_bcs_visc)
        self.scal_bcs = _replace_cf_sides(self.scal_bcs, cf_dirs,
                                          BC.extrap(1))
        self.lam_bcs = _replace_cf_sides(self.lam_bcs, cf_dirs, BC.extrap(1))
        phi_bcs = _replace_cf_sides(pressure_bcs(grid), cf_dirs, BC.cf(0.0))
        self.projector = LevelProjector(geo, mg_params=params.mg,
                                        phi_bcs=phi_bcs, dtype=params.dtype)
        if self.is_viscous:
            self.visc_solvers = [
                make_heat_solver(params.viscous_solver_type, geo,
                                 self.vel_bcs_visc[m], params.nu,
                                 params.mg_viscous or params.mg,
                                 params.dtype)
                for m in range(grid.ndim)]
        diff_bcs = _replace_cf_sides(self.scal_bcs, cf_dirs, BC.cf(0.0))
        self.diff_solvers = []
        for comp in range(problem.num_scalars):
            kap = params.kappa[comp] if comp < len(params.kappa) else 0.0
            self.diff_solvers.append(
                make_heat_solver(params.diffusive_solver_type, geo,
                                 diff_bcs, kap,
                                 params.mg_diffusive or params.mg,
                                 params.dtype)
                if kap > 0.0 else None)
        self._visc_ops = [PoissonOp(geo, self.vel_bcs_visc[m])
                          for m in range(grid.ndim)]


class PatchCoupling:
    """The refined level (K same-shape patches) and its coupling to the
    base level.

    Origins are per ARRAY axis, in fine cells, of the EXTENDED patch
    relative to the base array's corner (host ints): an (ndim,) array at
    K = 1, a (K, ndim) array with (K,) weights at K > 1, where a weight-0
    slot duplicates slot 0 and adds nothing to the base level."""

    def __init__(self, parent_geo, problem: Problem, params: NSParams,
                 ratio: Tuple[int, ...], use_subcycling: bool = True,
                 max_grid_size: int = 0, patch_frac: float = 0.5,
                 num_patches: int = 1):
        parent_grid: Grid = parent_geo.grid
        if not parent_geo.is_uniform:
            raise _slice11("a mapped base level (patches with their own "
                           "metric)")
        ndim = parent_grid.ndim
        self.parent_grid = parent_grid
        self.problem = problem
        self.params = params
        self.device = parent_geo.device
        self.geo_source = parent_geo.geo
        self.ratio = tuple(int(r) for r in ratio)
        self.nt = max(self.ratio) if use_subcycling else 1
        self.K = int(num_patches)
        self.span_dirs = tuple(
            d for d in range(ndim)
            if d == parent_grid.vertical_dir or parent_grid.periodic[d])
        self.cf_dirs = tuple(d for d in range(ndim)
                             if d not in self.span_dirs)
        H = ADVECT_GROW
        self.halo = H
        self.interior_nx, self.ext_nx = patch_footprint(
            parent_grid.nx, parent_grid.periodic, self.ratio, patch_frac,
            max_grid_size, H)
        dx_f = tuple(parent_grid.dx[d] / self.ratio[d] for d in range(ndim))
        # x0 is a placeholder: the patch's fields come from its parent
        self.ext_grid = Grid(
            nx=self.ext_nx, dx=dx_f, x0=tuple(parent_grid.x0),
            periodic=tuple(parent_grid.periodic[d] and d in self.span_dirs
                           for d in range(ndim)))
        geo = build_level_geometry(self.ext_grid, self.geo_source,
                                   device=self.device, dtype=params.dtype)
        self.level = PatchNSLevel(geo, problem, params, self.cf_dirs)

        mask = torch.zeros(self.ext_grid.shape, dtype=torch.bool,
                           device=self.device)
        for d in self.cf_dirs:
            ax = self.ext_grid.axis(d)
            sl = [slice(None)] * ndim
            sl[ax] = slice(0, H)
            mask[tuple(sl)] = True
            sl[ax] = slice(self.ext_grid.shape[ax] - H, None)
            mask[tuple(sl)] = True
        self._halo_mask = mask

        # donor slab (parent cells per array axis): one parent cell of
        # margin each side on CF axes, the full extent on spanned ones
        self.donor_shape_c = tuple(
            self.ext_nx[d] // self.ratio[d] + 2 if d in self.cf_dirs
            else parent_grid.nx[d]
            for d in (parent_grid.dir_of_axis(ax) for ax in range(ndim)))
        # the patch interior (array axes) and the parent cells it covers
        self.int_start = tuple(
            H if parent_grid.dir_of_axis(ax) in self.cf_dirs else 0
            for ax in range(ndim))
        self.int_shape = tuple(self.interior_nx[parent_grid.dir_of_axis(ax)]
                               for ax in range(ndim))
        self.covered_shape_c = tuple(
            s // self._axis_ratio(ax) for ax, s in enumerate(self.int_shape))
        self.origin_f: Optional[np.ndarray] = None
        self.weights: Optional[np.ndarray] = None
        #: the parent patch of each slot: zeros at K > 1 (one base level),
        #: kept for the checkpoint layout
        self.parent_sel: Optional[np.ndarray] = None
        #: (dropped, tagged) parent cells of the last origin choice
        self.tag_coverage = (0, 0)
        #: consecutive origin choices that dropped tagged cells
        self._drop_streak = 0

    # ---------------------------------------------------------------- util
    def _axis_ratio(self, ax: int) -> int:
        return self.ratio[self.parent_grid.dir_of_axis(ax)]

    def covered_origin_c(self, origin_f):
        """Parent-cell origin of the covered region (the patch interior)."""
        return tuple((int(origin_f[ax]) + self.int_start[ax])
                     // self._axis_ratio(ax)
                     for ax in range(self.parent_grid.ndim))

    def patch_origins(self, origin_f):
        """The per-patch origins of an origin array of this level."""
        o = np.asarray(origin_f, dtype=np.int64)
        return [o[k] for k in range(self.K)] if self.K > 1 else [o]

    def patch_weights(self, weights):
        """Per-patch Python-float weights (all 1.0 where none are given)
        at K > 1; [None] at K = 1, where average-down and the composite
        solve take no blend."""
        if self.K == 1:
            return [None]
        if weights is None:
            return [1.0] * self.K
        return [float(x) for x in host_weights(weights)]

    def unstack(self, s: NSState):
        """The per-patch states of this level's (K-stacked) state."""
        return [tree_index(s, k) for k in range(self.K)] if self.K > 1 \
            else [s]

    def stack(self, patches) -> NSState:
        return tree_stack(patches) if self.K > 1 else patches[0]

    def _donor_origin_c(self, origin_f):
        """Parent-cell origin of the donor slab: one parent cell outward on
        CF axes, 0 on spanned axes."""
        return tuple(
            int(origin_f[ax]) // self._axis_ratio(ax) - 1
            if self.parent_grid.dir_of_axis(ax) in self.cf_dirs else 0
            for ax in range(self.parent_grid.ndim))

    def _interp_ext(self, coarse_field, origin_f, extra: int = 0,
                    quadratic: bool = False):
        """A parent field interpolated onto the extended patch region
        (+`extra` fine cells each side: CF axes from the donor margin,
        spanned axes edge-extended); quadratic=True takes the unlimited
        parabola (elliptic ghost data), else limited-linear."""
        pgrid = self.parent_grid
        donor = extract_patch(coarse_field, self._donor_origin_c(origin_f),
                              self.donor_shape_c)
        fine = (prolong_quadratic if quadratic else prolong_linear)(
            donor, pgrid, self.ratio)
        start, shape = [], []
        for ax in range(pgrid.ndim):
            d = pgrid.dir_of_axis(ax)
            if d in self.cf_dirs:
                start.append(self.ratio[d] - extra)
            else:
                start.append(0)
                if extra > 0:
                    fine = _edge_pad(fine, ax, extra)
            shape.append(self.ext_grid.shape[ax] + 2 * extra)
        return extract_patch(fine, start, shape)

    def _interp_state_ext(self, s0: NSState, origin_f,
                          nt: Optional[int] = None) -> NSState:
        nt = self.nt if nt is None else nt
        f = lambda arr: self._interp_ext(arr, origin_f)
        return NSState(
            vel=torch.stack([f(v) for v in s0.vel]),
            scalars=torch.stack([f(c) for c in s0.scalars]),
            lam=f(s0.lam), mac_phi=f(s0.mac_phi),
            cc_phi=f(s0.cc_phi) / nt,   # the increment scales with dt
            pressure=f(s0.pressure), e_lambda=f(s0.e_lambda),
            time=s0.time)

    def _overwrite_halo(self, s1: NSState, donor: NSState) -> NSState:
        m = self._halo_mask

        def mix(fine, c):
            return torch.where(m, c.to(fine.dtype), fine)

        return NSState(
            vel=mix(s1.vel, donor.vel), scalars=mix(s1.scalars,
                                                    donor.scalars),
            lam=mix(s1.lam, donor.lam), mac_phi=mix(s1.mac_phi,
                                                    donor.mac_phi),
            cc_phi=mix(s1.cc_phi, donor.cc_phi),
            pressure=mix(s1.pressure, donor.pressure),
            e_lambda=mix(s1.e_lambda, donor.e_lambda), time=s1.time)

    def _ring(self, coarse_phi, origin_f, scale=1.0):
        """Padded-shape (ext + 2) ghost-potential ring: quadratically
        interpolated parent values on the outermost layer of the CF
        sides, zero elsewhere."""
        ext1 = self._interp_ext(coarse_phi, origin_f, extra=1,
                                quadratic=True) * scale
        ring = torch.zeros_like(ext1)
        for d in self.cf_dirs:
            ax = self.ext_grid.axis(d)
            for i in (0, ext1.shape[ax] - 1):
                sl = [slice(None)] * ext1.ndim
                sl[ax] = i
                ring[tuple(sl)] = ext1[tuple(sl)]
        return ring

    def average_down(self, s_par: NSState, s_fine: NSState,
                     origin_f, weight=None) -> NSState:
        """The patch interior's block average written over the parent
        cells it covers (velocity, scalars, lambda).  A weight (a Python
        float) blends the average with the parent data: weight 0 leaves
        the parent as it is (an inactive slot)."""
        origin_c = self.covered_origin_c(origin_f)

        def down(coarse, fine):
            avg = restrict_average(extract_patch(fine, self.int_start,
                                                 self.int_shape),
                                   self.ext_grid, self.ratio)
            if weight is not None:
                cur = extract_patch(coarse, origin_c, avg.shape)
                avg = cur + weight * (avg.to(coarse.dtype) - cur)
            return insert_patch(coarse, avg, origin_c)

        return dataclasses.replace(
            s_par,
            vel=torch.stack([down(c, f) for c, f in zip(s_par.vel,
                                                        s_fine.vel)]),
            scalars=torch.stack([down(c, f) for c, f in
                                 zip(s_par.scalars, s_fine.scalars)]),
            lam=down(s_par.lam, s_fine.lam))

    # -------------------------------------------------------------- origin
    def _centered_origin(self) -> np.ndarray:
        pgrid = self.parent_grid
        origin = np.zeros(pgrid.ndim, dtype=np.int64)
        for ax in range(pgrid.ndim):
            d = pgrid.dir_of_axis(ax)
            r = self._axis_ratio(ax)
            if d in self.cf_dirs:
                start = (pgrid.nx[d] * r - self.ext_nx[d]) // 2
                origin[ax] = (start // r) * r
        return origin

    def _halo_axes(self):
        return tuple(self.halo if self.parent_grid.dir_of_axis(ax)
                     in self.cf_dirs else 0
                     for ax in range(self.parent_grid.ndim))

    def _record_coverage(self, tags, origins, weights, halo_axes,
                         interior_axes):
        """Store the tag coverage of the chosen patches and the streak of
        choices that dropped tagged cells; warn when they did."""
        dropped, total = tag_coverage(tags, origins, weights,
                                      self.parent_grid, self.ratio,
                                      interior_axes, halo_axes)
        self.tag_coverage = (dropped, total)
        self._drop_streak = self._drop_streak + 1 if dropped > 0 else 0
        if dropped > 0:
            warnings.warn(
                f"AMR regrid dropped {dropped}/{total} tagged cells: the "
                f"tagged region outgrew the static patch footprint "
                f"(interior {self.interior_nx} fine cells x {self.K} "
                f"patches). Raise amr.max_patches / patch_frac / "
                f"amr.max_grid_size to cover it.", RuntimeWarning,
                stacklevel=3)

    def _masked_tags(self, s_par: NSState, tag_params: TagParams):
        """Tags of the parent state (the base level has no CF halo of its
        own to mask)."""
        return compute_tags(s_par, self._parent_level, tag_params)

    def choose_origin(self, s_par: NSState, tag_params: TagParams
                      ) -> np.ndarray:
        """Tag the parent state and choose the patch origin (K = 1, host
        work); centred when nothing is tagged."""
        tags = self._masked_tags(s_par, tag_params)
        halo_axes = self._halo_axes()
        origin = patch_origin_from_tags(tags, self.parent_grid, self.ratio,
                                        self.int_shape, halo_axes,
                                        lo_pad_f=(0,) * len(halo_axes))
        if origin is None:
            self.tag_coverage = (0, 0)
            origin = self._centered_origin()
        else:
            self._record_coverage(tags, origin[None, :], None, halo_axes,
                                  self.int_shape)
        return np.asarray(origin, dtype=np.int64)

    def choose_origins(self, s_par: NSState, tag_params: TagParams):
        """Tag the parent state and choose K patch origins and weights
        (host work); inactive slots duplicate slot 0 at weight 0, and
        with nothing tagged slot 0 is centred."""
        tags = self._masked_tags(s_par, tag_params)
        halo_axes = self._halo_axes()
        got = patch_origins_from_tags(tags, self.parent_grid, self.ratio,
                                      self.int_shape, halo_axes, self.K,
                                      lo_pad_f=(0,) * len(halo_axes),
                                      fill_ratio=tag_params.fill_ratio,
                                      block_factor=tag_params.block_factor)
        if got is None:
            origins = np.tile(self._centered_origin(), (self.K, 1))
            weights = np.zeros(self.K, np.float32)
            weights[0] = 1.0
            self.tag_coverage = (0, 0)
            self._drop_streak = 0
            return origins, weights
        self._record_coverage(tags, got[0], got[1], halo_axes,
                              self.int_shape)
        return got


class AMRHierarchy:
    """Base level + one subcycled refined level of K patches.

    The arguments are the JAX package's; those that select a feature
    outside the port so far (more than one ratio, reflux, implicit
    reflux, eta_lambda > 0, post-regrid smoothing) raise
    NotImplementedError.  num_patches other than 1 pins K; the default
    K = 1 doubles (1 -> 2 -> 4 ..., up to max_auto_patches) wherever a
    placement or a regrid would drop tagged cells, and the footprint
    widens once K is at its cap.  The sync projection's composite solve
    always takes FAS tau and the elliptic reflux (the JAX defaults
    sync_use_tau = sync_use_reflux = True), and the right-sizing is
    always on (auto_escalate_patches = True); the JAX package's
    grid_buffer_size (the nesting buffer) has nothing to act on with one
    refined level and is not an argument."""

    def __init__(self, geo0, problem: Problem, params: NSParams,
                 ratio=None, tag_params: TagParams = TagParams(),
                 patch_frac: float = 0.5, eta_lambda: float = 0.0,
                 ratios: Optional[Sequence[Tuple[int, ...]]] = None,
                 reflux: Sequence[str] = (),
                 implicit_reflux: bool = False,
                 regrid_smoothing_coeff: float = 0.0,
                 num_patches=1, use_subcycling: bool = True,
                 max_grid_size: int = 0,
                 do_sync_projection: bool = True,
                 sync_projection_iters: int = 1,
                 sync_composite_iters: int = 2,
                 max_auto_patches: int = 8):
        if ratios is None:
            if ratio is None:
                raise ValueError("give ratio or ratios")
            ratios = [ratio]
        if len(ratios) != 1:
            raise _slice11(f"{len(ratios)} refinement ratios (nested "
                           "levels)")
        if reflux:
            raise _slice11(f"advective refluxing {tuple(reflux)}")
        if implicit_reflux:
            raise _slice11("implicit refluxing")
        if eta_lambda > 0.0:
            raise _slice11("the VD correction (eta_lambda > 0)")
        if regrid_smoothing_coeff > 0.0:
            raise _slice11("post-regrid smoothing")
        # an int K other than 1, or an explicit per-level list, pins K:
        # right-sizing may then widen the footprint but never change K
        if isinstance(num_patches, (list, tuple)):
            K, pinned = int(num_patches[0]), True
        else:
            K, pinned = int(num_patches), int(num_patches) != 1
        self.ratios = [tuple(int(r) for r in ratios[0])]
        self.level0 = NSLevel(geo0, problem, params)
        self.grid0: Grid = geo0.grid
        self.problem = problem
        self.params = params
        self.tag_params = tag_params
        self.do_sync_projection = bool(do_sync_projection)
        self.sync_projection_iters = max(1, int(sync_projection_iters))
        self.sync_composite_iters = max(1, int(sync_composite_iters))
        self.max_auto_patches = max(1, int(max_auto_patches))
        #: (passes, final relative composite residual: a 0-d tensor) of
        #: the last sync or initial projection's composite solve
        self.last_sync_info = None
        self._geo0 = geo0
        self._pinned_K = pinned
        self._K = K
        #: patch_frac, grown by right-sizing
        self._frac = float(patch_frac)
        self._use_subcycling = bool(use_subcycling)
        self._max_grid_size = int(max_grid_size)
        self._build_coupling()

    def _build_coupling(self):
        c = PatchCoupling(self._geo0, self.problem, self.params,
                          self.ratios[0], use_subcycling=self._use_subcycling,
                          max_grid_size=self._max_grid_size,
                          patch_frac=self._frac, num_patches=self._K)
        c._parent_level = self.level0
        self.couplings = [c]
        self.ext_nx = c.ext_nx
        self.halo = c.halo

    def _widen(self) -> bool:
        """Widen the footprint (patch_frac x 1.5, to 0.95) and rebuild the
        coupling; False when it is at its widest already."""
        if self._frac >= 0.95:
            return False
        self._frac = min(0.95, 1.5 * self._frac)
        self._build_coupling()
        return True

    def _can_double_K(self) -> bool:
        return not self._pinned_K and self._K < self.max_auto_patches

    @property
    def multi_patch(self) -> bool:
        return any(c.K > 1 for c in self.couplings)

    def attach_mesh(self, mesh):
        raise _slice11("attach_mesh (sharded hierarchy steps)")

    # ------------------------------------------------------------- advance
    def _check_extras(self, geos=None, parent_sels=None):
        for name, v in (("geos", geos), ("parent_sels", parent_sels)):
            if v is not None and any(x is not None for x in (
                    v if isinstance(v, (list, tuple)) else [v])):
                raise _slice11(f"{name} (mapped or nested levels)")

    @staticmethod
    def _forms(fine_states, origins, weights=None):
        """(patch state, origins, weights, single) of either call form: a
        bare state, or one-element sequences (nested levels raise)."""
        w = weights[0] if isinstance(weights, (list, tuple)) else weights
        if isinstance(fine_states, (list, tuple)):
            if len(fine_states) != 1:
                raise _slice11(f"{len(fine_states)} refined levels")
            return fine_states[0], origins[0], w, False
        return fine_states, origins, w, True

    def _advance_patches(self, s_old: NSState, s_new: NSState,
                         s_stack: NSState, org, dt: float, weights=None,
                         mult: int = 1):
        """The refined level's nt = c.nt * mult subcycles between the
        base states at t (s_old) and t + dt (s_new): before each, every
        patch's CF halo refreshed from the time-interpolated base state
        and its projections' CF rings from the base potentials at the
        substep's midpoint.  Returns (the averaged-down base state, the
        level's state)."""
        c = self.couplings[0]
        nt = c.nt * int(mult)
        dt_f = dt / nt
        patches = c.unstack(s_stack)
        origs = c.patch_origins(org)
        ws = c.patch_weights(weights)
        for i in range(nt):
            donor0 = time_interp(s_old, s_new, i / nt)
            mid = (i + 0.5) / nt
            mac_mid = (1.0 - mid) * s_old.mac_phi + mid * s_new.mac_phi
            cc_mid = (1.0 - mid) * s_old.cc_phi + mid * s_new.cc_phi
            for k, o in enumerate(origs):
                s_f = c._overwrite_halo(
                    patches[k], c._interp_state_ext(donor0, o, nt=nt))
                rings = {"mac": c._ring(mac_mid, o),
                         "cc": c._ring(cc_mid, o, 1.0 / nt)}
                patches[k] = c.level.advance(s_f, dt_f, rings=rings)
        s_par = s_new
        for k, o in enumerate(origs):
            s_par = c.average_down(s_par, patches[k], o, weight=ws[k])
        return s_par, c.stack(patches)

    def advance(self, s0: NSState, fine_states, origins, dt, geos=None,
                weights=None, nt_mults=None, parent_sels=None):
        """One coarse step of length dt (a Python float): the base
        advance, the subcycled patch advances (nt_mults: the dynamic
        subcycling factor of the refined level), average-down and the
        composite sync projection.  fine_states / origins / weights: the
        refined level's state (K-stacked at K > 1), origins and weights,
        bare or as one-element sequences (the return takes the same
        form).  Returns (s0_new, fine_states_new)."""
        self._check_extras(geos, parent_sels)
        s_f, origin, w, single = self._forms(fine_states, origins, weights)
        dt = float(dt)
        mult = 1 if nt_mults is None else int(nt_mults[0])
        s0_new = self.level0.advance(s0, dt)
        s0_new, s_f = self._advance_patches(s0, s0_new, s_f, origin, dt,
                                            w, mult)
        if self.params.is_incompressible and self.do_sync_projection:
            for _ in range(self.sync_projection_iters):
                s0_new, s_f = self._sync_project(s0_new, s_f, origin, w)
        return (s0_new, s_f) if single else (s0_new, (s_f,))

    def init_project(self, s0: NSState, fine_states, origins, geos=None,
                     weights=None, parent_sels=None, iters: int = 1):
        """Composite initial projection(s) over the freshly placed
        hierarchy.  Returns (s0, (refined level's state,))."""
        self._check_extras(geos, parent_sels)
        s_f, origin, w, _ = self._forms(fine_states, origins, weights)
        for _ in range(max(1, int(iters))):
            s0, s_f = self._sync_project(s0, s_f, origin, w)
        return s0, (s_f,)

    def initialize_pressure(self, s0: NSState, fine_states, origins, dt,
                            geos=None, weights=None, parent_sels=None,
                            iters: int = 1):
        """Converge the lagged pressures of both levels with dummy coarse
        steps that keep only the pressure fields."""
        self._check_extras(geos, parent_sels)
        s_f, origin, w, single = self._forms(fine_states, origins, weights)
        keep = lambda dst, src: dataclasses.replace(
            dst, pressure=src.pressure, mac_phi=src.mac_phi,
            cc_phi=src.cc_phi)
        for _ in range(max(1, int(iters))):
            t0, tf = self.advance(s0, s_f, origin, dt, weights=w)
            s0, s_f = keep(s0, t0), keep(s_f, tf)
        return (s0, s_f) if single else (s0, (s_f,))

    def _sync_project(self, s0: NSState, s_f: NSState, origin,
                      weights=None):
        """One composite sync projection: ONE composite potential solve of
        L[phi] = div(u) over both levels (the base rhs built from the
        composite divergence: the base flux on each patch's CF interface
        faces replaced by the averaged patch flux), each level's velocity
        corrected by its own gradient of the composite potential (each
        patch with the base potential's CF ring), and the corrected
        patches averaged down.  Returns (s0, s_f)."""
        from somar_tpu_torch.amr.composite import (AMRCompositeSolver,
                                                   CompositeParams)
        from somar_tpu_torch.amr.flux_register import PatchFluxRegister
        c = self.couplings[0]
        level0, lvl = self.level0, c.level
        patches = c.unstack(s_f)
        origs = c.patch_origins(origin)
        ws = c.patch_weights(weights)
        f0 = level0.projector.cc_fluxes(s0.vel, level0.vel_bcs_trace)
        rhs0 = mac_divergence(f0, level0.geo)
        fluxes = [lvl.projector.cc_fluxes(p.vel, lvl.vel_bcs_trace)
                  for p in patches]
        rhs1 = [mac_divergence(f, lvl.geo) for f in fluxes]
        fr = PatchFluxRegister(c)
        for k, o in enumerate(origs):
            reg = fr.increment_fine(fr.zeros(), fluxes[k], 1.0)
            reg = fr.increment_coarse(reg, f0, o)
            rhs0 = fr.reflux(rhs0, reg, o, -(1.0 if ws[k] is None
                                             else ws[k]), level0.geo)
        solver = AMRCompositeSolver(
            self, CompositeParams(iters=self.sync_composite_iters,
                                  purpose="sync"))
        (phi0, phi1), self.last_sync_info = solver.solve_patches(
            [rhs0, rhs1], origs, ws)
        s0 = dataclasses.replace(
            s0, vel=s0.vel - level0.projector.cc_correction(phi0))
        for k, o in enumerate(origs):
            patches[k] = dataclasses.replace(
                patches[k], vel=patches[k].vel - lvl.projector.cc_correction(
                    phi1[k], c._ring(phi0, o)))
        for k, o in enumerate(origs):
            s0 = c.average_down(s0, patches[k], o, weight=ws[k])
        return s0, c.stack(patches)

    def average_down(self, s0: NSState, s1: NSState, origin_f) -> NSState:
        return self.couplings[0].average_down(s0, s1, origin_f)

    # ----------------------------------------------------------- placement
    def _global_origin(self, upto: int = 0, last_origin=None,
                       patch: int = 0) -> np.ndarray:
        """A patch's origin in its level's global fine index space (with
        one refined level: its own origin row)."""
        if upto != 0:
            raise _slice11("nested levels")
        c = self.couplings[0]
        if last_origin is not None:
            return np.asarray(last_origin, dtype=np.int64)
        if c.K > 1:
            return np.asarray(c.origin_f[patch], dtype=np.int64)
        return np.asarray(c.origin_f, dtype=np.int64)

    def _choose(self, c, s_par):
        """(origins, weights) of a fresh origin choice on coupling c
        (weights None at K = 1)."""
        if c.K > 1:
            return c.choose_origins(s_par, self.tag_params)
        return c.choose_origin(s_par, self.tag_params), None

    def _right_sized_choice(self, s_par, grow):
        """Probe an origin choice, grow the level (`grow()` True: it was
        rebuilt or re-stacked) and re-probe until nothing is dropped or
        nothing can grow; the warnings of the final probe are replayed.
        Returns (coupling, origins, weights)."""
        c = self.couplings[0]
        for _attempt in range(8):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                org, w = self._choose(c, s_par)
            if not grow():
                for m in caught:
                    warnings.warn_explicit(m.message, m.category,
                                           m.filename, m.lineno)
                break
            c = self.couplings[0]
        return c, org, w

    def _result(self, s_f, org, w):
        """((state,), (origins,)) and, at K > 1, (weights,)."""
        if self.multi_patch:
            return (s_f,), (org.copy(),), (w.copy(),)
        return (s_f,), (org.copy(),)

    def _set_patches(self, org, w):
        c = self.couplings[0]
        c.origin_f, c.weights = org, w
        c.parent_sel = np.zeros(c.K, np.int64) if c.K > 1 else None

    def initial_patch_states(self, s0: NSState):
        """Tag the base state, choose the patch origins (growing K, then
        the footprint, until no tagged cell is dropped) and fill the
        patches from the base (host work).  Returns ((state,), (origins,))
        and, when the level has K > 1 patches, (weights,) as well; the
        origins are host int arrays per array axis."""
        c, _, _ = self._right_sized_choice(s0, self._grow_for_init_coverage)
        org, w = self._choose(c, s0)
        self._set_patches(org, w)
        s_f = c.stack([c._interp_state_ext(s0, o)
                       for o in c.patch_origins(org)])
        return self._result(s_f, org, w)

    def _grow_for_init_coverage(self) -> bool:
        """Placement right-sizing: when the probe dropped tagged cells,
        double the patch budget K (unless pinned, up to
        max_auto_patches), else widen the footprint (patch_frac x 1.5, to
        0.95); True when the level was rebuilt (the caller re-probes)."""
        if self.couplings[0].tag_coverage[0] <= 0:
            return False
        if self._can_double_K():
            self._K = min(2 * self._K, self.max_auto_patches)
            self._build_coupling()
            return True
        return self._widen()

    # -------------------------------------------------------------- regrid
    def _escalate_K(self, fine_states: list):
        """Double the refined level's patch budget K in place, padding the
        state stack, origins, weights and parent selections with weight-0
        duplicates of slot 0.  Returns (old_k, new_k)."""
        c = self.couplings[0]
        old_k = c.K
        new_k = min(2 * old_k, self.max_auto_patches)
        pad = new_k - old_k
        parts = c.unstack(fine_states[0])
        fine_states[0] = tree_stack(parts + [parts[0]] * pad)
        if c.origin_f is not None:
            origs = c.patch_origins(c.origin_f)
            c.origin_f = np.stack(origs + [origs[0]] * pad)
        w = np.zeros(new_k, np.float32)
        w[:old_k] = 1.0 if c.weights is None else np.asarray(c.weights)
        c.weights = w
        c.parent_sel = np.zeros(new_k, np.int64)
        c.K = self._K = new_k
        c._drop_streak = 0
        return old_k, new_k

    def _maybe_escalate_patches(self, fine_states: list, from_level: int):
        """Double K before this regrid re-chooses origins when the level's
        regrids dropped tagged cells twice in a row."""
        c = self.couplings[0]
        if from_level > 0 or c._drop_streak < 2 or not self._can_double_K():
            return
        old_k, new_k = self._escalate_K(fine_states)
        warnings.warn(
            f"AMR level 1 dropped tagged cells on consecutive regrids; "
            f"patch budget escalated {old_k} -> {new_k} (cap "
            f"max_auto_patches={self.max_auto_patches}).", RuntimeWarning,
            stacklevel=3)

    def _grow_for_regrid_coverage(self, fine_states: list) -> bool:
        """Runtime right-sizing: when the probe dropped tagged cells,
        double K (unless pinned; the live state stack is padded with
        weight-0 slots), else widen the footprint (a rebuilt coupling;
        the overlap copy bridges the shapes).  True when the level
        changed (the caller re-probes)."""
        if self.couplings[0].tag_coverage[0] <= 0:
            return False
        if self._can_double_K():
            self._escalate_K(fine_states)
            return True
        return self._widen()

    def _overlap_copy(self, s_new: NSState, old: NSState, new_g, old_g,
                      new_shape, old_shape) -> NSState:
        """s_new overwritten with `old` wherever the two patches overlap
        in global fine index space (the shapes may differ: right-sizing
        can widen the footprint between regrids)."""
        lo = np.maximum(old_g, new_g)
        hi = np.minimum(old_g + np.asarray(old_shape),
                        new_g + np.asarray(new_shape))
        if not np.all(hi > lo):
            return s_new
        src = tuple(slice(int(a), int(b)) for a, b in zip(lo - old_g,
                                                          hi - old_g))
        dst = tuple(slice(int(a), int(b)) for a, b in zip(lo - new_g,
                                                          hi - new_g))
        ndim = self.grid0.ndim

        def cp(new, o):
            if new.ndim < ndim:
                return new
            pre = (slice(None),) * (new.ndim - ndim)
            out = new.clone()
            out[pre + dst] = o[pre + src].to(out.dtype)
            return out

        return NSState(**{f.name: cp(getattr(s_new, f.name),
                                     getattr(old, f.name))
                          for f in dataclasses.fields(s_new)})

    def regrid(self, s0: NSState, fine_states, dt=None, from_level: int = 0):
        """Re-tag the base state and move the patches (host work): new
        origins with runtime right-sizing (K doubled, then the footprint
        widened, until no tagged cell is dropped), each new patch filled
        from the base and overwritten by the old patches' data where they
        overlap in global fine index space (weight-0 old slots skipped).
        from_level > 0 keeps the refined level as it is.  dt is the JAX
        signature's (it feeds post-regrid smoothing, which raises).
        Returns (fine_states, origins) in the form given, plus (weights,)
        when the level has K > 1 patches."""
        single = not isinstance(fine_states, (list, tuple))
        fine_states = [fine_states] if single else list(fine_states)
        if len(fine_states) != 1:
            raise _slice11(f"{len(fine_states)} refined levels")
        self._maybe_escalate_patches(fine_states, from_level)
        c = self.couplings[0]
        if from_level > 0:
            s_new, org, w = fine_states[0], np.asarray(c.origin_f), c.weights
        else:
            # the old active patches: (state, global origin), in slot order
            old_shape = c.ext_grid.shape
            old = [] if c.origin_f is None else [
                (p, self._global_origin(0, last_origin=o))
                for p, o, wk in zip(c.unstack(fine_states[0]),
                                    c.patch_origins(c.origin_f),
                                    c.patch_weights(c.weights))
                if wk is None or wk != 0.0]
            c, org, w = self._right_sized_choice(
                s0, lambda: self._grow_for_regrid_coverage(fine_states))
            self._set_patches(org, w)
            patches = []
            for o in c.patch_origins(org):
                s_k = c._interp_state_ext(s0, o)
                new_g = self._global_origin(0, last_origin=o)
                for p, old_g in old:
                    s_k = self._overlap_copy(s_k, p, new_g, old_g,
                                             c.ext_grid.shape, old_shape)
                patches.append(s_k)
            s_new = c.stack(patches)
        if single:
            return s_new, org.copy()
        return self._result(s_new, org, w)

    def restore(self, fine_states, origins, weights=None):
        """Set the refined level to a checkpoint's patches: K from the
        origins' shape, the footprint grown (as right-sizing grows it)
        until its extended shape is the patches', then the origins and
        weights.  Returns (fine_states, origins, weights) as tuples,
        weights (None,) at K = 1."""
        s_f, org, w, _ = self._forms(fine_states, origins, weights)
        org = np.asarray(org, dtype=np.int64)
        self._K = org.shape[0] if org.ndim == 2 else 1
        shape = tuple(s_f.lam.shape[-self.grid0.ndim:])
        self._build_coupling()
        while tuple(self.couplings[0].ext_grid.shape) != shape:
            if not self._widen():
                raise ValueError(f"no footprint of this hierarchy has the "
                                 f"checkpoint's patch shape {shape}")
        c = self.couplings[0]
        if c.K > 1:
            w = (np.ones(c.K, np.float32) if w is None
                 else np.asarray(host_weights(w), np.float32))
        else:
            w = None
        self._set_patches(org.copy(), w)
        return (s_f,), (org.copy(),), (None if w is None else w.copy(),)

    # ------------------------------------------------------------------ dt
    def _patch_dts(self, fine_states):
        """One unread dt tensor per patch of the refined level."""
        s_f, _, _, _ = self._forms(fine_states, [None])
        c = self.couplings[0]
        return [c.level.compute_dt_tensor(p) for p in c.unstack(s_f)]

    def compute_dt(self, s0: NSState, fine_states, geos=None) -> float:
        """Coarse dt limited so that the subcycled patches stay in their
        CFL (a Python float; one host read)."""
        self._check_extras(geos)
        base, patch = self.level_dts(s0, fine_states)
        return min(base, self.couplings[0].nt * patch)

    def level_dts(self, s0: NSState, fine_states, geos=None):
        """Per-level CFL-limited dts (base first), not scaled by the
        subcycle count: the refined level's is the least over its
        patches.  Python floats, in one host read."""
        self._check_extras(geos)
        vals = read_scalars(self.level0.compute_dt_tensor(s0),
                            *self._patch_dts(fine_states))
        return (vals[0], min(vals[1:]))

    def subcycle_multipliers(self, dt: float, level_dts,
                             tolerance_factor: float = 1.1):
        """Dynamic subcycling: per coupling, double the substep count
        until the level's dt is within tolerance_factor of its
        CFL-limited dt (at most 16x).  Returns a tuple of multipliers."""
        mults = []
        dt_run = float(dt)
        for lev, c in enumerate(self.couplings):
            dt_run /= c.nt
            m = 1
            dt_new = float(level_dts[lev + 1])
            while dt_new > 0.0 and dt_run > tolerance_factor * dt_new \
                    and m < 16:
                m *= 2
                dt_run /= 2.0
            mults.append(m)
        return tuple(mults)
