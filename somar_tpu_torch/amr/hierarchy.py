"""The AMR hierarchy: a base level and nested refined levels of K
same-shape patches each, subcycled (PyTorch port of
`somar_tpu.amr.hierarchy`).

  * A patch is a dense rectangular block of static shape that spans the
    vertical and every periodic direction; its other horizontal sides are
    coarse-fine (CF) interfaces.  It carries an ADVECT_GROW halo on its CF
    sides, refreshed from space-time interpolated parent data before every
    substep; its projections take the CF ghost-potential rings
    (quadratically interpolated parent potentials folded into the rhs).
  * Levels nest: level l+1's patches live inside level l's patches, each
    in the parent patch its `parent_sel` names, with their donor slabs
    kept `grid_buffer_size` parent cells inside the parent's own CF halo
    (the nest buffer).  Ratios are per level and may be anisotropic
    (amr.refratio_lev0 = 4 1, amr.refratio_lev1 = 4 2, ...).
  * Origins are host ints (per array axis, in fine cells, of the extended
    patch, relative to the parent array's corner), so every transfer is
    plain indexing.  A level of K > 1 patches keeps the JAX layout: its
    state has a leading K axis, its origins are (K, ndim) and its weights
    (K,); a weight-0 slot duplicates slot 0, advances as it does, and adds
    nothing to its parent.
  * Placement and regrid are host work, coarse to fine: each parent patch
    is tagged (amr/tagging.py), clustered (native/, Berger-Rigoutsos) and
    the patches centred on the clusters.  Right-sizing doubles K (1 -> 2
    -> 4 ..., up to max_auto_patches, unless num_patches pins it), then
    widens the footprint, and at placement widens the parent when proper
    nesting keeps a level from its tags; a regrid fills the new patches
    from their parents and copies the old patches' data where they overlap
    in the level's global fine index space.  regrid(from_level) keeps the
    levels above from_level + 1 as they are.
  * One coarse step (`advance`): the base advance, then recursively for
    each refined level nt = max(ratio) (times the dynamic-subcycling
    factor nt_mults) substeps between its parent's states, the next level
    subcycling inside every substep, average-down into each patch's
    parent, and the composite sync projection over all levels
    (amr/composite.py) with the elliptic reflux of each CF interface.

  * On a mapped (terrain-following) base every patch slot carries its own
    metric: the coordinate map evaluated at the patch's physical position,
    kept as a raw geometry (multigrid coarsens its arrays, as the JAX
    package's patch bundles do), with the geometry-derived problem fields
    (N^2, the sponge) and its own PatchNSLevel.  The slots are rebuilt at
    every placement, regrid and restore (`_refresh`); a slot whose global
    origin did not move keeps its level.  The patches advance and project
    on their own levels, average down weighted by their own J, and the
    composite solve applies every patch's own operator.

  * Refluxing (`reflux`): every level collects the advective interface
    fluxes of its step; each patch accumulates its own on every substep
    in a flux register (amr/flux_register.py), closes it with its parent
    patch's after the average-down and corrects the parent cells next to
    its interface (explicitly, or with implicit_reflux through the parent
    level's heat solver).  The VD correction (eta_lambda > 0): after the
    sync, one composite solve (purpose "vd") of
    L e = eta_lambda (lambda - 1) / dt sets every level's e_lambda, whose
    gradient the next step adds to the advecting velocities.  Post-regrid
    smoothing (regrid_smoothing_coeff > 0) applies (I - mu L) before the
    data moves and solves it after; as in the JAX package it is off on a
    mapped base and when nu and every kappa are 0.  RK3 patch levels take
    the CF rings in every stage.

Sharded hierarchy steps (`attach_mesh`) come with ROADMAP A.7.
"""

from __future__ import annotations

import copy
import dataclasses
import time
import warnings
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from somar_tpu_torch.amr.composite import AMRCompositeSolver, CompositeParams
from somar_tpu_torch.amr.flux_register import PatchFluxRegister
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
from somar_tpu_torch.geometry.raw_geometry import raw_from_level_geometry
from somar_tpu_torch.problems.base import Problem, sponge_ramp
from somar_tpu_torch.projection.projector import LevelProjector, pressure_bcs
from somar_tpu_torch.solvers.host_reads import read_scalars
from somar_tpu_torch.solvers.parabolic import make_heat_solver
from somar_tpu_torch.solvers.poisson_op import PoissonOp

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
                    max_grid_size: int = 0, halo: int = ADVECT_GROW,
                    parent_halo: Optional[Sequence[int]] = None):
    """The static patch shape over a parent array of `parent_nx` cells per
    logical direction: (interior_nx, ext_nx) in fine cells.

    The patch spans the vertical (the last direction) and every periodic
    direction; on the others (CF directions) the interior is patch_frac of
    the refined extent of the parent's valid cells (those inside its own
    CF halo, `parent_halo` per logical direction: none for the base),
    capped by max_grid_size, rounded down to a multiple of 2r, at least 4
    halo and at most that extent less max(halo r, halo + r) at each end.
    Along x (direction 0) an extended extent (interior + 2 halo) above 128
    snaps to the next multiple of 128 that a 2r-aligned interior reaches
    (else the largest below): the JAX package's lane-padding rule, kept so
    that footprints match it."""
    ndim = len(parent_nx)
    H = halo
    ph = (0,) * ndim if parent_halo is None else tuple(parent_halo)
    interior = []
    cf = []
    for d in range(ndim):
        r = ratio[d]
        if d == ndim - 1 or periodic[d]:
            interior.append(parent_nx[d] * r)
            continue
        cf.append(d)
        n_f = (parent_nx[d] - 2 * ph[d]) * r
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
                 cf_dirs: Tuple[int, ...], aux_fields=None):
        super().__init__(geo, problem, params, aux_fields=aux_fields)
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
    """One refined level (K same-shape patches) and its coupling to its
    parent level: the base level, or the patches of the level above.

    `parent_grid` is the whole parent array's grid (the base domain, or
    the parent's extended patch grid); `geo_source` is the domain's
    coordinate map; `parent_halo_axes` is the parent's own CF halo per
    array axis (0 for the base), which the donor slabs avoid,
    `nest_buffer` parent cells more.  Origins are per ARRAY axis, in fine
    cells, of the EXTENDED patch relative to the parent array's corner
    (host ints): an (ndim,) array at K = 1, a (K, ndim) array with (K,)
    weights at K > 1, where a weight-0 slot duplicates slot 0 and adds
    nothing to its parent.  Under a parent of several patches,
    parent_sel[k] is the parent patch that slot k nests in.

    `levels` holds one PatchNSLevel per slot: on a Cartesian map the one
    level K times; on a mapped one each slot's own, set by the
    hierarchy's refresh at every placement, regrid and restore (none
    before the first)."""

    def __init__(self, parent_grid: Grid, problem: Problem,
                 params: NSParams, ratio: Tuple[int, ...], *, device,
                 geo_source, use_subcycling: bool = True,
                 max_grid_size: int = 0, patch_frac: float = 0.5,
                 num_patches: int = 1,
                 parent_halo_axes: Optional[Tuple[int, ...]] = None,
                 nest_buffer: int = 0, use_vd_correction: bool = False):
        ndim = parent_grid.ndim
        #: every slot level adds grad e_lambda to its advecting velocity
        #: (the hierarchy's VD correction), rebuilt slots included
        self.use_vd_correction = bool(use_vd_correction)
        #: the register of the refluxed fields (set by the hierarchy)
        self.flux_register = None
        self.parent_grid = parent_grid
        self.parent_halo_axes = ((0,) * ndim if parent_halo_axes is None
                                 else tuple(int(h)
                                            for h in parent_halo_axes))
        #: the proper-nesting buffer in parent cells (amr.grid_buffer_size)
        #: between the donor slabs and a patch parent's CF halo
        self.nest_buffer = int(nest_buffer)
        self.problem = problem
        self.params = params
        self.device = torch.device(device)
        self.geo_source = geo_source
        self.is_mapped = not geo_source.is_uniform
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
        ph_dir = tuple(self.parent_halo_axes[parent_grid.axis(d)]
                       for d in range(ndim))
        self.parent_valid_nx = tuple(parent_grid.nx[d] - 2 * ph_dir[d]
                                     for d in range(ndim))
        self.interior_nx, self.ext_nx = patch_footprint(
            parent_grid.nx, parent_grid.periodic, self.ratio, patch_frac,
            max_grid_size, H, parent_halo=ph_dir)
        dx_f = tuple(parent_grid.dx[d] / self.ratio[d] for d in range(ndim))
        # x0 is a placeholder: the patch's fields come from its parent, and
        # a mapped slot's metric is evaluated at its own position
        self.ext_grid = Grid(
            nx=self.ext_nx, dx=dx_f, x0=tuple(parent_grid.x0),
            periodic=tuple(parent_grid.periodic[d] and d in self.span_dirs
                           for d in range(ndim)))
        #: per slot (mapped): {"geo": raw geometry, "aux": problem fields},
        #: the concrete map metric and the global origin it was built at
        self.bundles = self.slot_geos = self.slot_origins = None
        self._slot_levels = None
        self._level = None
        if not self.is_mapped:
            geo = build_level_geometry(self.ext_grid, geo_source,
                                       device=self.device,
                                       dtype=params.dtype)
            self._level = self.make_level(geo)

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
        #: the parent patch of each slot ((K,) ints, or (1,) for one patch
        #: under a parent of several); zeros under a one-patch parent at
        #: K > 1, None at K = 1 there
        self.parent_sel: Optional[np.ndarray] = None
        #: (dropped, tagged) parent cells of the last origin choice
        self.tag_coverage = (0, 0)
        #: candidate boxes the last origin choice had no slot for
        self._slot_overflow = 0
        #: consecutive origin choices that dropped tagged cells
        self._drop_streak = 0
        #: the parent coupling (None: the base level, `_base_level`)
        self._parent = None
        self._base_level = None

    # --------------------------------------------------------------- slots
    def make_level(self, geo, aux=None) -> PatchNSLevel:
        """The patch level on geometry `geo` with the problem fields `aux`
        ({"nsq_cc", "sponge_ramp", "sponge_targets"}; None: derived from
        geo)."""
        lvl = PatchNSLevel(geo, self.problem, self.params, self.cf_dirs,
                           aux_fields=aux)
        lvl.use_vd_correction = self.use_vd_correction
        return lvl

    def build_patch_bundle(self, global_origin_f, domain_grid: Grid):
        """The map's metric at a patch's physical position (its global
        fine origin over the domain's corner) and the problem fields
        derived from it: ({"geo": the metric as a raw geometry on the
        extended grid, "aux": nsq_cc / sponge_ramp / sponge_targets as the
        problem has them}, the concrete LevelGeometry at the position)."""
        ndim = domain_grid.ndim
        dx_f = self.ext_grid.dx
        x0 = tuple(domain_grid.x0[d]
                   + float(global_origin_f[domain_grid.axis(d)]) * dx_f[d]
                   for d in range(ndim))
        grid_at = Grid(nx=self.ext_nx, dx=dx_f, x0=x0,
                       periodic=self.ext_grid.periodic)
        lg = build_level_geometry(grid_at, self.geo_source,
                                  device=self.device,
                                  dtype=self.params.dtype)
        kw = dict(dtype=self.params.dtype, device=self.device)
        aux = {}
        if self.problem.use_background_scalar:
            aux["nsq_cc"] = torch.as_tensor(
                np.asarray(self.problem.nsq_cc(lg)), **kw)
        if self.problem.sponge is not None:
            aux["sponge_ramp"] = torch.as_tensor(
                sponge_ramp(grid_at, self.problem.sponge), **kw)
            vt, st = self.problem.sponge_targets(lg)
            aux["sponge_targets"] = (torch.as_tensor(vt, **kw),
                                     torch.as_tensor(st, **kw))
        return {"geo": raw_from_level_geometry(lg, self.ext_grid),
                "aux": aux}, lg

    @property
    def levels(self):
        """One level per slot (a list of K)."""
        if not self.is_mapped:
            return [self._level] * self.K
        if self._slot_levels is None:
            raise RuntimeError("a mapped patch has no metric before it is "
                               "placed")
        return list(self._slot_levels)

    @property
    def level(self):
        """Slot 0's level."""
        return self.levels[0]

    def map_level(self, k: int = 0):
        """Slot k's level seen through its concrete map metric (the
        LevelGeometry at the patch's position, physical coordinates
        included) rather than its raw one: what plot files read."""
        lvl = self.levels[k]
        if not self.is_mapped:
            return lvl
        view = copy.copy(lvl)
        view.geo = self.slot_geos[k]
        return view

    def _pad_slots(self, pad: int):
        """Append `pad` copies of slot 0 (weight-0 duplicates)."""
        if self._slot_levels is None:
            return
        for name in ("bundles", "slot_geos", "slot_origins",
                     "_slot_levels"):
            v = getattr(self, name)
            setattr(self, name, list(v) + [v[0]] * pad)

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
                     origin_f, weight=None, J_f=None) -> NSState:
        """The patch interior's block average written over the parent
        cells it covers (velocity, scalars, lambda); with the patch's J
        (a mapped slot) the average is volume-weighted, <b J> / <J>.  A
        weight (a Python float) blends the average with the parent data:
        weight 0 leaves the parent as it is (an inactive slot)."""
        origin_c = self.covered_origin_c(origin_f)
        J_blk = J_avg = None
        if J_f is not None:
            J_blk = extract_patch(J_f.expand(self.ext_grid.shape),
                                  self.int_start, self.int_shape)
            J_avg = restrict_average(J_blk, self.ext_grid, self.ratio)

        def down(coarse, fine):
            blk = extract_patch(fine, self.int_start, self.int_shape)
            if J_blk is None:
                avg = restrict_average(blk, self.ext_grid, self.ratio)
            else:
                avg = restrict_average(blk * J_blk, self.ext_grid,
                                       self.ratio) / J_avg
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

    def slot_J(self, k: int):
        """Slot k's J for the volume-weighted average-down (None on a
        Cartesian map)."""
        return self.levels[k].geo.J if self.is_mapped else None

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

    def _parent_halo_f(self):
        """The no-go margin (fine cells per array axis) at both ends of a
        patch parent: its CF halo plus the nest buffer; zero under the
        base level."""
        return tuple(
            (self.parent_halo_axes[ax]
             + (self.nest_buffer if self.parent_halo_axes[ax] > 0 else 0))
            * self._axis_ratio(ax) for ax in range(self.parent_grid.ndim))

    def _record_coverage(self, tags, origins, weights, halo_axes,
                         interior_axes):
        """Store the tag coverage of the chosen patches and the streak of
        choices that dropped tagged cells; warn when they did."""
        dropped, total = tag_coverage(tags, origins, weights,
                                      self.parent_grid, self.ratio,
                                      interior_axes, halo_axes)
        self.tag_coverage = (dropped, total)
        self._slot_overflow = 0
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
        """Tags of a parent state with the parent's own CF halo cleared
        (interpolated data, and no place for a donor slab)."""
        # every parent patch is tagged on slot 0's map view: the JAX
        # package's template level carries patch 0's metric (ROADMAP C.26)
        parent_level = (self._base_level if self._parent is None
                        else self._parent.map_level(0))
        tags = compute_tags(s_par, parent_level, tag_params)
        for ax, ph in enumerate(self.parent_halo_axes):
            if ph > 0:
                sl = [slice(None)] * tags.ndim
                sl[ax] = slice(0, ph)
                tags[tuple(sl)] = False
                sl[ax] = slice(tags.shape[ax] - ph, None)
                tags[tuple(sl)] = False
        return tags

    def choose_origin(self, s_par: NSState, tag_params: TagParams
                      ) -> np.ndarray:
        """Tag the parent state and choose the patch origin (K = 1, host
        work); centred when nothing is tagged."""
        tags = self._masked_tags(s_par, tag_params)
        halo_axes = self._halo_axes()
        origin = patch_origin_from_tags(tags, self.parent_grid, self.ratio,
                                        self.int_shape, halo_axes,
                                        lo_pad_f=self._parent_halo_f())
        if origin is None:
            self.tag_coverage = (0, 0)
            origin = self._centered_origin()
        else:
            self._record_coverage(tags, origin[None, :], None, halo_axes,
                                  self.int_shape)
        return np.asarray(origin, dtype=np.int64)

    def _unplaced(self):
        """(origins, weights) with nothing tagged: slot 0 centred, the
        others its weight-0 duplicates."""
        origins = np.tile(self._centered_origin(), (self.K, 1))
        weights = np.zeros(self.K, np.float32)
        weights[0] = 1.0
        return origins, weights

    def choose_origins(self, s_par: NSState, tag_params: TagParams):
        """Tag the parent state and choose K patch origins and weights
        (host work); inactive slots duplicate slot 0 at weight 0, and
        with nothing tagged slot 0 is centred."""
        tags = self._masked_tags(s_par, tag_params)
        halo_axes = self._halo_axes()
        got = patch_origins_from_tags(tags, self.parent_grid, self.ratio,
                                      self.int_shape, halo_axes, self.K,
                                      lo_pad_f=self._parent_halo_f(),
                                      fill_ratio=tag_params.fill_ratio,
                                      block_factor=tag_params.block_factor)
        if got is None:
            self.tag_coverage = (0, 0)
            self._drop_streak = 0
            return self._unplaced()
        self._record_coverage(tags, got[0], got[1], halo_axes,
                              self.int_shape)
        return got

    def choose_origins_multi(self, parent_patches, parent_weights,
                             tag_params: TagParams):
        """Under a parent of several patches: tag every active parent
        patch, cluster within each, and fill the K slots round-robin
        across the parents, most tagged first, so that every tagged parent
        gets a patch before any gets a second; warn when tagged cells are
        dropped or boxes find no slot.  Returns (origins (K, ndim),
        weights (K,), parent_sel (K,))."""
        halo_axes = self._halo_axes()
        per_parent = []     # (tag count, parent index, [origins])
        dropped_tot = total_tot = 0
        for p, s_pp in enumerate(parent_patches):
            if parent_weights is not None \
                    and float(parent_weights[p]) == 0.0:
                continue
            tags = self._masked_tags(s_pp, tag_params)
            ntags = int(tags.sum())
            total_tot += ntags
            if ntags == 0:
                continue
            got = patch_origins_from_tags(
                tags, self.parent_grid, self.ratio, self.int_shape,
                halo_axes, self.K, lo_pad_f=self._parent_halo_f(),
                fill_ratio=tag_params.fill_ratio,
                block_factor=tag_params.block_factor)
            if got is None:
                continue
            org_p, w_p = got
            dropped, _ = tag_coverage(tags, org_p, w_p, self.parent_grid,
                                      self.ratio, self.int_shape,
                                      halo_axes)
            dropped_tot += dropped
            boxes = [np.asarray(org_p[k]) for k in range(self.K)
                     if w_p[k] > 0.0]
            if boxes:
                per_parent.append((ntags, p, boxes))
        per_parent.sort(key=lambda t: -t[0])
        cands = []
        rank = 0
        while any(rank < len(b) for _, _, b in per_parent):
            for _, p, boxes in per_parent:
                if rank < len(boxes):
                    cands.append((p, boxes[rank]))
            rank += 1
        self.tag_coverage = (dropped_tot, total_tot)
        self._slot_overflow = max(0, len(cands) - self.K)
        self._drop_streak = self._drop_streak + 1 if dropped_tot > 0 else 0
        if dropped_tot > 0:
            warnings.warn(
                f"AMR regrid dropped {dropped_tot}/{total_tot} tagged "
                f"cells across parent patches; raise amr.max_patches / "
                f"amr.max_grid_size.", RuntimeWarning, stacklevel=2)
        if not cands:
            origins, weights = self._unplaced()
            return origins, weights, np.zeros(self.K, np.int64)
        if len(cands) > self.K:
            warnings.warn(
                f"AMR regrid found {len(cands)} boxes across parent "
                f"patches but only {self.K} child slots; dropping "
                f"{len(cands) - self.K} (raise amr.max_patches).",
                RuntimeWarning, stacklevel=2)
            cands = cands[:self.K]
        origins = np.zeros((self.K, self.parent_grid.ndim), np.int64)
        weights = np.zeros(self.K, np.float32)
        psel = np.zeros(self.K, np.int64)
        for k, (p, o) in enumerate(cands):
            origins[k], weights[k], psel[k] = o, 1.0, p
        for k in range(len(cands), self.K):     # inactive: slot 0's copy
            origins[k], psel[k] = origins[0], psel[0]
        return origins, weights, psel


class _RestartPlacement(Exception):
    """Raised by placement right-sizing when a coarser level's footprint
    grew so that a finer level's tags could nest in it: the placement
    starts again from the base."""


def _host_ints(v) -> np.ndarray:
    """Host int64 array of an index array (tensors read once)."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v, dtype=np.int64)


class AMRHierarchy:
    """Base level + nested subcycled refined levels of K patches each.

    The arguments are the JAX package's: `ratios` has one (maybe
    anisotropic) ratio per refined level (`ratio` alone builds one
    refined level).  reflux: the advective fluxes refluxed at every CF
    interface, any of "vel", "scalars", "lam" (True: all three);
    implicit_reflux: a viscous / diffusive field's correction solves
    (I - dt kappa L) corr = its reflux on the parent level; eta_lambda >
    0: the VD correction; regrid_smoothing_coeff > 0: post-regrid
    smoothing (off, as in the JAX package, on a mapped base and when nu
    and every kappa are 0).  num_patches: an int K is the finest level's
    budget (1, the default, lets right-sizing double it; any other value
    pins it), a per-level sequence pins every level it names.
    Right-sizing doubles an unpinned K (1 -> 2 -> 4 ..., up to
    max_auto_patches) wherever a placement or a regrid would drop tagged
    cells, then widens the footprint, and at placement widens the parent
    level.  grid_buffer_size is the nest buffer in parent cells.  The sync
    projection's composite solve always takes FAS tau and the elliptic
    reflux (the JAX defaults sync_use_tau = sync_use_reflux = True), and
    the right-sizing is always on (auto_escalate_patches = True).

    The per-level arguments of advance, init_project and the rest keep
    the JAX layout: fine_states, origins and weights are coarse-to-fine
    sequences, each K-stacked at K > 1 (or, with one refined level, the
    bare state, origins and weights), and parent_sels is a per-level
    tuple, None where the parent has one patch (the `parent_sels`
    property gives it)."""

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
                 grid_buffer_size: int = 0,
                 max_auto_patches: int = 8):
        if ratios is None:
            if ratio is None:
                raise ValueError("give ratio or ratios")
            ratios = [ratio]
        if len(ratios) < 1:
            raise ValueError("no refinement ratio")
        nlev = len(ratios)
        # an explicit per-level list pins every level it names; an int K
        # is the finest level's, pinned unless it is 1 (right-sizing may
        # still widen a pinned level's footprint, never change its K)
        if isinstance(num_patches, (list, tuple)):
            per_K = [int(k) for k in num_patches]
            pinned = [lev < len(per_K) for lev in range(nlev)]
            per_K += [1] * (nlev - len(per_K))
        else:
            per_K = [1] * nlev
            per_K[-1] = int(num_patches)
            pinned = [False] * nlev
            pinned[-1] = int(num_patches) != 1
        self.ratios = [tuple(int(r) for r in rr) for rr in ratios]
        self.level0 = NSLevel(geo0, problem, params)
        self.eta_lambda = float(eta_lambda)
        self.level0.use_vd_correction = self.eta_lambda > 0.0
        self.reflux_fields = (("vel", "scalars", "lam") if reflux is True
                              else tuple(reflux))
        self.implicit_reflux = bool(implicit_reflux)
        self.regrid_smoothing_coeff = float(regrid_smoothing_coeff)
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
        #: the same of the last VD solve (eta_lambda > 0)
        self.last_vd_info = None
        self._geo0 = geo0
        self._pinned_K = pinned
        self._per_level_K = per_K
        self._per_level_K0 = list(per_K)
        #: per-level patch_frac, grown by right-sizing (None: patch_frac)
        self._frac_override = [None] * nlev
        self._patch_frac = float(patch_frac)
        self._use_subcycling = bool(use_subcycling)
        self._max_grid_size = int(max_grid_size)
        self._grid_buffer_size = int(grid_buffer_size)
        #: mapped slots: seconds spent rebuilding them (the map's metric,
        #: the problem fields and the levels with their solver
        #: hierarchies, synchronized on the GPU) and slots built, summed
        #: over every refresh
        self.refresh_seconds = 0.0
        self.slots_built = 0
        self.couplings = []
        self._build_couplings(0)

    def _level_frac(self, lev: int) -> float:
        f = self._frac_override[lev]
        return self._patch_frac if f is None else f

    def _build_couplings(self, start_lev: int):
        """(Re)build couplings[start_lev:] from the per-level K and
        patch_frac; the deeper levels lose their placement."""
        del self.couplings[start_lev:]
        if start_lev == 0:
            parent, parent_grid, parent_halo = None, self.grid0, None
        else:
            parent = self.couplings[start_lev - 1]
            parent_grid, parent_halo = parent.ext_grid, parent._halo_axes()
        for lev in range(start_lev, len(self.ratios)):
            c = PatchCoupling(parent_grid, self.problem, self.params,
                              self.ratios[lev], device=self._geo0.device,
                              geo_source=self._geo0.geo,
                              use_subcycling=self._use_subcycling,
                              max_grid_size=self._max_grid_size,
                              patch_frac=self._level_frac(lev),
                              num_patches=self._per_level_K[lev],
                              parent_halo_axes=parent_halo,
                              nest_buffer=self._grid_buffer_size,
                              use_vd_correction=self.eta_lambda > 0.0)
            c._parent, c._base_level = parent, self.level0
            if self.reflux_fields:
                c.flux_register = PatchFluxRegister(c)
            self.couplings.append(c)
            parent, parent_grid, parent_halo = c, c.ext_grid, c._halo_axes()
        c0 = self.couplings[0]
        self.ext_nx = c0.ext_nx
        self.halo = c0.halo

    def _widen(self, lev: int) -> bool:
        """Widen level lev's footprint (patch_frac x 1.5, to 0.95) and
        rebuild it and the levels below; False when it is at its widest
        already."""
        if self._level_frac(lev) >= 0.95:
            return False
        self._frac_override[lev] = min(0.95, 1.5 * self._level_frac(lev))
        self._build_couplings(lev)
        return True

    def _can_double_K(self, lev: int) -> bool:
        return (not self._pinned_K[lev]
                and self.couplings[lev].K < self.max_auto_patches)

    @property
    def num_levels(self) -> int:
        return 1 + len(self.couplings)

    def levels(self):
        return [self.level0] + [c.level for c in self.couplings]

    @property
    def multi_patch(self) -> bool:
        return any(c.K > 1 for c in self.couplings)

    @property
    def parent_sels(self):
        """Per refined level, the parent patch of each slot (host int64
        arrays) where the parent level has K > 1 patches, None elsewhere;
        None when no such level exists."""
        if not any(c.K > 1 for c in self.couplings[:-1]):
            return None
        out = []
        for lev, c in enumerate(self.couplings):
            parent_K = self.couplings[lev - 1].K if lev > 0 else 1
            out.append(c.parent_sel.copy()
                       if parent_K > 1 and c.parent_sel is not None
                       else None)
        return tuple(out)

    def attach_mesh(self, mesh):
        raise NotImplementedError(
            "attach_mesh (sharded hierarchy steps) comes with the port of "
            "parallel/ (ROADMAP A.7)")

    @property
    def is_mapped(self) -> bool:
        return not self._geo0.geo.is_uniform

    @property
    def geo_bundles(self):
        """Per refined level, its slots' levels (a tuple of K; None on a
        Cartesian map), or None when the map is Cartesian.  Every method
        that takes `geos` uses these without it."""
        if not self.is_mapped:
            return None
        return tuple(tuple(c.levels) for c in self.couplings)

    # ----------------------------------------------------------- arguments
    def _check_geos(self, geos, single: bool = False):
        """`geos` of the JAX signature: None, or per refined level the
        slots' levels this hierarchy holds (`geo_bundles`); entries of a
        Cartesian level are ignored, as in the JAX package."""
        if geos is None:
            return
        gs = [geos] if single else list(geos)
        own = self.geo_bundles
        for lev, g in enumerate(gs):
            if g is None or not self.couplings[lev].is_mapped:
                continue
            if tuple(g) != own[lev]:
                raise ValueError(
                    "geos: a mapped level's slots carry their own levels; "
                    "pass None or this hierarchy's geo_bundles")

    # ----------------------------------------------------------- slots
    def _refresh(self, lev: int):
        """Rebuild the slots of mapped level lev at their current global
        origins: for each, the map's metric as a raw geometry, the
        problem fields and its PatchNSLevel, or the slot of the last
        refresh at the same origin (the same numbers, bitwise), with the
        time it takes added to refresh_seconds."""
        c = self.couplings[lev]
        if not c.is_mapped:
            return
        t0 = time.perf_counter()
        have = {}
        if c.slot_origins is not None:
            for k, g in enumerate(c.slot_origins):
                have.setdefault(g, (c.bundles[k], c.slot_geos[k],
                                    c._slot_levels[k]))
        slots = []
        for k in range(c.K):
            g = tuple(int(x) for x in self._global_origin(lev, patch=k))
            if g not in have:
                bundle, lg = c.build_patch_bundle(g, self.grid0)
                have[g] = (bundle, lg, c.make_level(bundle["geo"],
                                                    bundle["aux"]))
                self.slots_built += 1
            slots.append((g,) + have[g])
        c.slot_origins, c.bundles, c.slot_geos, c._slot_levels = (
            list(x) for x in zip(*slots))
        if c.device.type == "cuda":
            torch.cuda.synchronize(c.device)
        self.refresh_seconds += time.perf_counter() - t0

    def _forms(self, fine_states, origins, weights=None):
        """(fine states, origins, weights or None, single) as per-level
        lists from either call form: coarse-to-fine sequences, or with one
        refined level the bare state, origins and weights."""
        single = not isinstance(fine_states, (list, tuple))
        if single:
            fine_states, origins = [fine_states], [origins]
            if weights is not None and not isinstance(weights,
                                                      (list, tuple)):
                weights = [weights]
        if len(fine_states) != len(self.couplings):
            raise ValueError(f"{len(fine_states)} refined-level states for "
                             f"{len(self.couplings)} refined levels")
        return (list(fine_states), list(origins),
                None if weights is None else list(weights), single)

    def _psel(self, lev: int, parent_sels):
        """The parent patch of each slot of level lev: parent_sels[lev]
        where the parent level has K > 1 patches and it is given, else
        patch 0 (the JAX rule)."""
        K = self.couplings[lev].K
        if (lev == 0 or self.couplings[lev - 1].K == 1
                or parent_sels is None or parent_sels[lev] is None):
            return [0] * K
        return [int(p) for p in _host_ints(parent_sels[lev]).reshape(-1)]

    def _patch_args(self, origins, weights=None, parent_sels=None):
        """Per refined level: (per-patch origins, per-patch weights, None
        at K = 1, per-patch parent index)."""
        return [(c.patch_origins(origins[lev]),
                 c.patch_weights(None if weights is None else weights[lev]),
                 self._psel(lev, parent_sels))
                for lev, c in enumerate(self.couplings)]

    @staticmethod
    def _own_psel(c):
        """The parent index of each slot of coupling c as placed."""
        return ([0] * c.K if c.parent_sel is None
                else [int(p) for p in c.parent_sel])

    # ------------------------------------------------------------- advance
    def _advance_recursive(self, lev: int, pars_old, pars_new, fine_states,
                           args, dt: float, nt_mults=None, par_fluxes=None):
        """Level lev's nt = c.nt * nt_mults[lev] substeps between its
        parent patches' states at t (pars_old) and t + dt (pars_new),
        lists with one entry per parent patch: before each, every patch's
        CF halo refreshed from its parent's time-interpolated state and
        its projections' CF rings from the parent potentials at the
        substep's midpoint; the next level subcycles inside every
        substep, between this level's halo-refreshed and advanced
        states.  fine_states[lev] is updated in place.  Returns the parent
        patches' states with each patch averaged down into its own.

        par_fluxes (refluxing): per parent patch, the advective interface
        fluxes of its step.  Each patch then collects its own on every
        substep into its flux register (weight 1/nt), hands them down to
        the level below, and after the average-down closes the register
        with its parent's fluxes and refluxes the parent patch."""
        c = self.couplings[lev]
        lvls = c.levels
        origs, ws, psel = args[lev]
        nt = c.nt * (1 if nt_mults is None else int(nt_mults[lev]))
        dt_f = dt / nt
        patches = c.unstack(fine_states[lev])
        has_child = lev + 1 < len(self.couplings)
        refluxing = par_fluxes is not None and bool(self.reflux_fields)
        regs = fluxes = None
        if refluxing:
            fr = c.flux_register
            keys = [key for key, _ in self._flux_items(par_fluxes[0])]
            regs = [{key: fr.zeros() for key in keys} for _ in origs]
            fluxes = [None] * len(origs)
        for i in range(nt):
            mid = (i + 0.5) / nt
            donors = {}
            prev = list(patches)
            for p in sorted(set(psel)):
                so, sn = pars_old[p], pars_new[p]
                donors[p] = (time_interp(so, sn, i / nt),
                             (1.0 - mid) * so.mac_phi + mid * sn.mac_phi,
                             (1.0 - mid) * so.cc_phi + mid * sn.cc_phi)
            for k, o in enumerate(origs):
                donor0, mac_mid, cc_mid = donors[psel[k]]
                s_f = c._overwrite_halo(
                    patches[k], c._interp_state_ext(donor0, o, nt=nt))
                prev[k] = s_f
                rings = {"mac": c._ring(mac_mid, o),
                         "cc": c._ring(cc_mid, o, 1.0 / nt)}
                if refluxing:
                    patches[k], fluxes[k] = lvls[k].advance(
                        s_f, dt_f, rings=rings, collect_fluxes=True)
                    for key, flux in self._flux_items(fluxes[k]):
                        regs[k][key] = fr.increment_fine(regs[k][key], flux,
                                                         1.0 / nt)
                else:
                    patches[k] = lvls[k].advance(s_f, dt_f, rings=rings)
            if has_child:
                patches = self._advance_recursive(
                    lev + 1, prev, patches, fine_states, args, dt_f,
                    nt_mults, par_fluxes=fluxes)
        fine_states[lev] = c.stack(patches)
        out = list(pars_new)
        for k, o in enumerate(origs):
            out[psel[k]] = c.average_down(out[psel[k]], patches[k], o,
                                          weight=ws[k], J_f=c.slot_J(k))
        if refluxing:
            for k, o in enumerate(origs):
                p = psel[k]
                out[p] = self._apply_reflux(
                    lev, out[p], regs[k], self._flux_items(par_fluxes[p]),
                    o, ws[k], self._parent_level(lev, p), dt)
        return out

    def _parent_level(self, lev: int, p: int):
        """The level of parent patch p of level lev (the base at lev =
        0): its metric and its implicit-reflux solvers."""
        return self.level0 if lev == 0 else self.couplings[lev - 1].levels[p]

    def _flux_items(self, fluxes: dict):
        """(key, per-direction flux tuple) pairs of the refluxed fields:
        ("vel", m), ("scalars", c) and ("lam",)."""
        items = []
        if "vel" in self.reflux_fields and "vel" in fluxes:
            items += [(("vel", m), fl) for m, fl in enumerate(fluxes["vel"])]
        if "scalars" in self.reflux_fields and "scalars" in fluxes:
            items += [(("scalars", i), fl)
                      for i, fl in enumerate(fluxes["scalars"])]
        if "lam" in self.reflux_fields and "lam" in fluxes:
            items.append((("lam",), fluxes["lam"]))
        return items

    def _apply_reflux(self, lev: int, par: NSState, regs: dict, coarse_items,
                      origin_f, weight, plev, dt: float) -> NSState:
        """Close one patch's registers with its parent patch's interface
        fluxes and add each field's correction to the parent state: the
        explicit reflux, times the patch's weight at K > 1, or with
        implicit refluxing of a viscous / diffusive field the solve of
        (I - dt kappa L) corr = that reflux on the parent level."""
        fr = self.couplings[lev].flux_register
        regs = dict(regs)
        for key, flux in coarse_items:
            regs[key] = fr.increment_coarse(regs[key], flux, origin_f)

        def corr_of(key, field):
            rhs = fr.reflux(torch.zeros_like(field), regs[key], origin_f,
                            dt, plev.geo)
            if weight is not None:
                rhs = rhs * weight
            solver = None
            if self.implicit_reflux:
                if key[0] == "vel" and plev.is_viscous:
                    solver = plev.visc_solvers[key[1]]
                elif key[0] == "scalars":
                    solver = plev.diff_solvers[key[1]]
            if solver is None:
                return rhs
            corr, _ = solver._helmholtz_solve(rhs, 1.0, dt, rhs)
            return corr

        vel, scalars, lam = par.vel.clone(), par.scalars.clone(), par.lam
        for key in regs:
            if key[0] == "lam":
                lam = lam + corr_of(key, lam)
                continue
            field = vel if key[0] == "vel" else scalars
            field[key[1]] += corr_of(key, field[key[1]])
        return dataclasses.replace(par, vel=vel, scalars=scalars, lam=lam)

    def advance(self, s0: NSState, fine_states, origins, dt, geos=None,
                weights=None, nt_mults=None, parent_sels=None):
        """One coarse step of length dt (a Python float): the base
        advance, the nested subcycled patch advances (nt_mults: each
        refined level's dynamic-subcycling factor), average-down, the
        advective refluxing of the fields in reflux_fields, the composite
        sync projection, and with eta_lambda > 0 the composite VD solve
        that sets every level's e_lambda.  fine_states / origins /
        weights: per refined level (or the one level's, bare);
        parent_sels: per level where the parent has K > 1 patches.
        Returns (s0_new, fine_states_new) in the form given.  geos: see
        _check_geos."""
        fs, orgs, ws, single = self._forms(fine_states, origins, weights)
        self._check_geos(geos, single)
        args = self._patch_args(orgs, ws, parent_sels)
        dt = float(dt)
        fl0 = None
        if self.reflux_fields:
            s0_new, fl0 = self.level0.advance(s0, dt, collect_fluxes=True)
        else:
            s0_new = self.level0.advance(s0, dt)
        (s0_new,) = self._advance_recursive(
            0, [s0], [s0_new], fs, args, dt, nt_mults,
            par_fluxes=None if fl0 is None else [fl0])
        if self.params.is_incompressible and self.do_sync_projection:
            for _ in range(self.sync_projection_iters):
                s0_new = self._sync_project(s0_new, fs, args)
        if self.eta_lambda > 0.0:
            s0_new = self._vd_correction(s0_new, fs, args, dt)
        return (s0_new, fs[0]) if single else (s0_new, tuple(fs))

    def _vd_correction(self, s0: NSState, fine_states: list, args,
                       dt: float) -> NSState:
        """The volume-discrepancy (freestream) correction: one composite
        pass (purpose "vd") of L e = eta_lambda (lambda - 1) / dt over
        every level, the base rhs's mean removed and each level's
        e_lambda the warm start; the potentials become every level's
        e_lambda (the K-stacked ones per patch).  fine_states is updated
        in place; returns the base state."""
        eta = self.eta_lambda
        rhs0 = eta * (s0.lam - 1.0) / dt
        rhss = [rhs0 - torch.mean(rhs0)]
        phis0 = [s0.e_lambda]
        for lev, c in enumerate(self.couplings):
            patches = c.unstack(fine_states[lev])
            rhss.append([eta * (p.lam - 1.0) / dt for p in patches])
            phis0.append([p.e_lambda for p in patches])
        solver = AMRCompositeSolver(self, CompositeParams(iters=1,
                                                          purpose="vd"))
        phis, self.last_vd_info = solver.solve_patches(rhss, args,
                                                       phis0=phis0)
        for lev, c in enumerate(self.couplings):
            fine_states[lev] = c.stack([
                dataclasses.replace(p, e_lambda=e) for p, e in zip(
                    c.unstack(fine_states[lev]), phis[lev + 1])])
        return dataclasses.replace(s0, e_lambda=phis[0])

    def init_project(self, s0: NSState, fine_states, origins, geos=None,
                     weights=None, parent_sels=None, iters: int = 1):
        """Composite initial projection(s) over the freshly placed
        hierarchy.  Returns (s0, refined levels' states as a tuple)."""
        fs, orgs, ws, single = self._forms(fine_states, origins, weights)
        self._check_geos(geos, single)
        args = self._patch_args(orgs, ws, parent_sels)
        for _ in range(max(1, int(iters))):
            s0 = self._sync_project(s0, fs, args)
        return s0, tuple(fs)

    def initialize_pressure(self, s0: NSState, fine_states, origins, dt,
                            geos=None, weights=None, parent_sels=None,
                            iters: int = 1):
        """Converge the lagged pressures of every level with dummy coarse
        steps that keep only the pressure fields."""
        fs, orgs, ws, single = self._forms(fine_states, origins, weights)
        self._check_geos(geos, single)
        keep = lambda dst, src: dataclasses.replace(
            dst, pressure=src.pressure, mac_phi=src.mac_phi,
            cc_phi=src.cc_phi)
        for _ in range(max(1, int(iters))):
            t0, tf = self.advance(s0, fs, orgs, dt, weights=ws,
                                  parent_sels=parent_sels)
            s0 = keep(s0, t0)
            fs = [keep(f, t) for f, t in zip(fs, tf)]
        return (s0, fs[0]) if single else (s0, tuple(fs))

    def _sync_project(self, s0: NSState, fine_states: list, args):
        """One composite sync projection over every level: ONE composite
        potential solve of L[phi] = div(u) (each parent's rhs built from
        the composite divergence: its flux on each child patch's CF
        interface faces replaced by the averaged child flux, bottom-up),
        each level's velocity corrected by its own gradient of the
        composite potential (each patch with its parent's potential as
        the CF ring), and the corrected patches averaged down bottom-up.
        fine_states is updated in place; returns the base state."""
        level0 = self.level0
        f0 = level0.projector.cc_fluxes(s0.vel, level0.vel_bcs_trace)
        rhss = [mac_divergence(f0, level0.geo)]
        fluxs = [[f0]]
        patches = []
        for lev, c in enumerate(self.couplings):
            lvls = c.levels
            patches.append(c.unstack(fine_states[lev]))
            fl = [lv.projector.cc_fluxes(p.vel, lv.vel_bcs_trace)
                  for lv, p in zip(lvls, patches[lev])]
            fluxs.append(fl)
            rhss.append([mac_divergence(f, lv.geo)
                         for lv, f in zip(lvls, fl)])
        for lev in range(len(self.couplings) - 1, -1, -1):
            c = self.couplings[lev]
            origs, ws, psel = args[lev]
            par_lvls = ([level0] if lev == 0
                        else self.couplings[lev - 1].levels)
            fr = PatchFluxRegister(c)
            for k, o in enumerate(origs):
                p = psel[k]
                par_geo = par_lvls[p].geo
                reg = fr.increment_fine(fr.zeros(), fluxs[lev + 1][k], 1.0)
                reg = fr.increment_coarse(reg, fluxs[lev][p], o)
                sign = -(1.0 if ws[k] is None else ws[k])
                if lev == 0:
                    rhss[0] = fr.reflux(rhss[0], reg, o, sign, par_geo)
                else:
                    rhss[lev][p] = fr.reflux(rhss[lev][p], reg, o, sign,
                                             par_geo)
        solver = AMRCompositeSolver(
            self, CompositeParams(iters=self.sync_composite_iters,
                                  purpose="sync"))
        phis, self.last_sync_info = solver.solve_patches(rhss, args)
        s0 = dataclasses.replace(
            s0, vel=s0.vel - level0.projector.cc_correction(phis[0]))
        for lev, c in enumerate(self.couplings):
            origs, _, psel = args[lev]
            lvls = c.levels
            for k, o in enumerate(origs):
                ph_par = phis[0] if lev == 0 else phis[lev][psel[k]]
                p_k = patches[lev][k]
                patches[lev][k] = dataclasses.replace(
                    p_k, vel=p_k.vel - lvls[k].projector.cc_correction(
                        phis[lev + 1][k], c._ring(ph_par, o)))
        for lev in range(len(self.couplings) - 1, -1, -1):
            c = self.couplings[lev]
            origs, ws, psel = args[lev]
            parents = [s0] if lev == 0 else patches[lev - 1]
            for k, o in enumerate(origs):
                parents[psel[k]] = c.average_down(
                    parents[psel[k]], patches[lev][k], o, weight=ws[k],
                    J_f=c.slot_J(k))
            if lev == 0:
                s0 = parents[0]
        for lev, c in enumerate(self.couplings):
            fine_states[lev] = c.stack(patches[lev])
        return s0

    def average_down(self, s0: NSState, s1: NSState, origin_f) -> NSState:
        c = self.couplings[0]
        return c.average_down(s0, s1, origin_f, J_f=c.slot_J(0))

    # ----------------------------------------------------------- placement
    def _global_origin(self, upto: int, last_origin=None,
                       patch: int = 0) -> np.ndarray:
        """A patch's origin in its level's global fine index space: its
        own origin (last_origin, else row `patch` of the level's) plus
        its parent's global origin times the ratio, through the chain of
        parent_sel."""
        c = self.couplings[upto]
        if last_origin is not None:
            o = np.asarray(last_origin, dtype=np.int64)
        elif c.K > 1:
            o = np.asarray(c.origin_f[patch], dtype=np.int64)
        else:
            o = np.asarray(c.origin_f, dtype=np.int64)
        if upto == 0:
            return o
        p = int(c.parent_sel[patch]) if c.parent_sel is not None else 0
        g_par = self._global_origin(upto - 1, patch=p)
        r = np.array([c._axis_ratio(ax) for ax in range(self.grid0.ndim)],
                     dtype=np.int64)
        return g_par * r + o

    def _choose(self, c, par_patches, par_w):
        """(origins, weights, parent_sel) of a fresh origin choice on
        coupling c over its parent's patches (weights None at K = 1,
        parent_sel None under a one-patch parent at K = 1)."""
        if len(par_patches) > 1:
            return c.choose_origins_multi(par_patches, par_w,
                                          self.tag_params)
        if c.K > 1:
            org, w = c.choose_origins(par_patches[0], self.tag_params)
            return org, w, np.zeros(c.K, np.int64)
        return c.choose_origin(par_patches[0], self.tag_params), None, None

    def _right_sized_choice(self, lev: int, par_patches, par_w, grow):
        """Probe an origin choice on level lev, grow it (`grow()` True: it
        was rebuilt or re-stacked) and re-probe until nothing is dropped
        or nothing can grow; the warnings of the final probe are
        replayed.  Returns (coupling, (origins, weights, parent_sel))."""
        c = self.couplings[lev]
        for _attempt in range(8):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                got = self._choose(c, par_patches, par_w)
            if not grow():
                for m in caught:
                    warnings.warn_explicit(m.message, m.category,
                                           m.filename, m.lineno)
                break
            c = self.couplings[lev]
        return c, got

    def _set_patches(self, lev: int, org, w, psel, multi_parent: bool):
        """Set level lev's origins, weights and parent selections and
        refresh its slots."""
        c = self.couplings[lev]
        if c.K > 1:
            c.origin_f, c.weights = np.asarray(org, np.int64), w
            c.parent_sel = np.asarray(psel, np.int64)
        else:
            c.origin_f = np.asarray(org[0] if multi_parent else org,
                                    np.int64)
            c.weights = None
            c.parent_sel = (np.asarray(psel[:1], np.int64) if multi_parent
                            else None)
        self._refresh(lev)

    def _result(self, states, origins, weights):
        """(states, origins) tuples and, when a level has K > 1 patches,
        (weights,) as well."""
        if self.multi_patch:
            return tuple(states), tuple(origins), tuple(weights)
        return tuple(states), tuple(origins)

    def initial_patch_states(self, s0: NSState):
        """Tag, choose every level's patch origins and fill the patches
        from their parents, coarse to fine (host work), growing K, then
        the footprint, then the parent level, until no tagged cell is
        dropped.  Returns (states, origins) tuples, one entry per refined
        level, and (weights,) as well when a level has K > 1 patches;
        the parent selections are on the couplings (`parent_sels`)."""
        for _round in range(12):
            try:
                return self._place_initial_patches(s0, allow_restart=True)
            except _RestartPlacement:
                continue
        return self._place_initial_patches(s0, allow_restart=False)

    def _place_initial_patches(self, s0: NSState, allow_restart: bool):
        states, origins, weights = [], [], []
        par_patches, par_w = [s0], None
        for lev in range(len(self.couplings)):
            c, _ = self._right_sized_choice(
                lev, par_patches, par_w,
                lambda: self._grow_for_init_coverage(lev, allow_restart))
            org, w, psel = self._choose(c, par_patches, par_w)
            self._set_patches(lev, org, w, psel, len(par_patches) > 1)
            patches = [c._interp_state_ext(par_patches[p], o)
                       for o, p in zip(c.patch_origins(c.origin_f),
                                       self._own_psel(c))]
            states.append(c.stack(patches))
            origins.append(c.origin_f.copy())
            weights.append(None if c.weights is None else c.weights.copy())
            par_patches, par_w = patches, c.weights
        return self._result(states, origins, weights)

    def _grow_for_init_coverage(self, lev: int,
                                allow_parent_growth: bool = True) -> bool:
        """Placement right-sizing of level lev: when the probe dropped
        tagged cells (or found boxes with no slot), double its patch
        budget K (unless pinned, up to max_auto_patches), else widen its
        footprint (patch_frac x 1.5, to 0.95), else widen its parent's
        and start the placement again (raises _RestartPlacement).  True
        when the level was rebuilt (the caller re-probes)."""
        c = self.couplings[lev]
        if c.tag_coverage[0] <= 0 and c._slot_overflow <= 0:
            return False
        if self._can_double_K(lev):
            self._per_level_K[lev] = min(2 * c.K, self.max_auto_patches)
        elif self._level_frac(lev) < 0.95:
            self._frac_override[lev] = min(0.95, 1.5 * self._level_frac(lev))
        elif (allow_parent_growth and lev > 0
              and self._level_frac(lev - 1) < 0.95):
            self._frac_override[lev - 1] = min(
                0.95, 1.5 * self._level_frac(lev - 1))
            # size this level afresh under the grown parent
            self._per_level_K[lev] = self._per_level_K0[lev]
            self._frac_override[lev] = None
            self._build_couplings(lev - 1)
            raise _RestartPlacement()
        else:
            return False
        self._build_couplings(lev)
        return True

    # -------------------------------------------------------------- regrid
    def _escalate_K(self, lev: int, fine_states: list):
        """Double level lev's patch budget K in place, padding its state
        stack, origins, weights and parent selections with weight-0
        duplicates of slot 0.  Returns (old_k, new_k)."""
        c = self.couplings[lev]
        old_k = c.K
        new_k = min(2 * old_k, self.max_auto_patches)
        pad = new_k - old_k
        parts = c.unstack(fine_states[lev])
        fine_states[lev] = tree_stack(parts + [parts[0]] * pad)
        if c.origin_f is not None:
            origs = c.patch_origins(c.origin_f)
            c.origin_f = np.stack(origs + [origs[0]] * pad)
        w = np.zeros(new_k, np.float32)
        w[:old_k] = 1.0 if c.weights is None else np.asarray(c.weights)
        c.weights = w
        ps = self._own_psel(c)
        c.parent_sel = np.asarray(ps + [ps[0]] * pad, np.int64)
        c._pad_slots(pad)
        c.K = self._per_level_K[lev] = new_k
        c._drop_streak = 0
        return old_k, new_k

    def _maybe_escalate_patches(self, fine_states: list, from_level: int):
        """Double K before this regrid re-chooses origins on each level
        (from from_level down) whose regrids dropped tagged cells twice
        in a row."""
        for lev, c in enumerate(self.couplings):
            if lev < from_level or c._drop_streak < 2 \
                    or not self._can_double_K(lev):
                continue
            old_k, new_k = self._escalate_K(lev, fine_states)
            warnings.warn(
                f"AMR level {lev + 1} dropped tagged cells on consecutive "
                f"regrids; patch budget escalated {old_k} -> {new_k} (cap "
                f"max_auto_patches={self.max_auto_patches}).",
                RuntimeWarning, stacklevel=3)

    def _grow_for_regrid_coverage(self, lev: int, fine_states: list) -> bool:
        """Runtime right-sizing of level lev: when the probe dropped
        tagged cells (or found boxes with no slot), double K (unless
        pinned; the live state stack is padded with weight-0 slots), else
        widen the footprint (rebuilt couplings; the overlap copy bridges
        the shapes).  True when the level changed (the caller
        re-probes)."""
        c = self.couplings[lev]
        if c.tag_coverage[0] <= 0 and c._slot_overflow <= 0:
            return False
        if self._can_double_K(lev):
            self._escalate_K(lev, fine_states)
            return True
        return self._widen(lev)

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
        """Re-tag and move the patches of level from_level + 1 and below,
        coarse to fine (host work): new origins with runtime right-sizing
        (K doubled, then the footprint widened, until no tagged cell is
        dropped), each new patch filled from its parent patch and
        overwritten by the level's old active patches where they overlap
        in the level's global fine index space.  Shallower levels keep
        their patches and data.  With regrid_smoothing_coeff > 0 and dt
        given, the moved data is smoothed: (I - mu L) applied to the
        parents and to the old patches, and solved on every new patch, so
        that data which did not move comes back as it was and freshly
        interpolated cells diffuse with strength mu = coeff dt kappa
        (`_smooth_mus`).  Returns (fine_states,
        origins) in the form given, plus (weights,) when a level has
        K > 1 patches."""
        single = not isinstance(fine_states, (list, tuple))
        fs = [fine_states] if single else list(fine_states)
        if len(fs) != len(self.couplings):
            raise ValueError(f"{len(fs)} refined-level states for "
                             f"{len(self.couplings)} refined levels")
        self._maybe_escalate_patches(fs, from_level)
        # post-regrid smoothing: off without dt, without viscosity or
        # diffusion, and on a mapped base (the JAX package's rule)
        smoothing = (self.regrid_smoothing_coeff > 0.0 and dt is not None
                     and (self.params.nu > 0.0
                          or any(k > 0.0 for k in self.params.kappa))
                     and not self.is_mapped)
        mus = self._smooth_mus(float(dt)) if smoothing else None
        # every level's old active patches (state, global origin) and
        # shape, before any level moves; smoothing applies (I - mu L) to
        # them on their own level
        olds = []
        for lev, c in enumerate(self.couplings):
            old = [] if lev < from_level or c.origin_f is None else [
                (self._apply_smooth_op(c.level, p, *mus) if smoothing
                 else p,
                 self._global_origin(lev, last_origin=o, patch=k))
                for k, (p, o, wk) in enumerate(zip(
                    c.unstack(fs[lev]), c.patch_origins(c.origin_f),
                    c.patch_weights(c.weights)))
                if wk is None or wk != 0.0]
            olds.append((old, c.ext_grid.shape))
        states, origins, weights = [], [], []
        par_patches, par_w = [s0], None
        for lev in range(len(self.couplings)):
            c = self.couplings[lev]
            if lev < from_level:
                states.append(fs[lev])
                origins.append(np.asarray(c.origin_f).copy())
                weights.append(None if c.weights is None
                               else c.weights.copy())
                par_patches, par_w = c.unstack(fs[lev]), c.weights
                continue
            if smoothing:
                # the parents are tagged and interpolated smoothed
                plev = (self.level0 if lev == 0
                        else self.couplings[lev - 1].level)
                par_patches = [self._apply_smooth_op(plev, p, *mus)
                               for p in par_patches]
            c, (org, w, psel) = self._right_sized_choice(
                lev, par_patches, par_w,
                lambda: self._grow_for_regrid_coverage(lev, fs))
            self._set_patches(lev, org, w, psel, len(par_patches) > 1)
            old, old_shape = olds[lev]
            patches = []
            for k, (o, p) in enumerate(zip(c.patch_origins(c.origin_f),
                                           self._own_psel(c))):
                s_k = c._interp_state_ext(par_patches[p], o)
                new_g = self._global_origin(lev, last_origin=o, patch=k)
                for q, old_g in old:
                    s_k = self._overlap_copy(s_k, q, new_g, old_g,
                                             c.ext_grid.shape, old_shape)
                if smoothing:
                    s_k = self._solve_smooth_op(c.level, s_k, *mus)
                patches.append(s_k)
            states.append(c.stack(patches))
            origins.append(c.origin_f.copy())
            weights.append(None if c.weights is None else c.weights.copy())
            par_patches, par_w = patches, c.weights
        if single:
            return states[0], origins[0]
        return self._result(states, origins, weights)

    # -------------------------------------------- post-regrid smoothing
    def _smooth_mus(self, dt: float):
        """The smoothing strengths (mu of the velocity, per scalar mu):
        coeff * dt * nu and coeff * dt * kappa."""
        c = self.regrid_smoothing_coeff
        kap = self.params.kappa
        return c * dt * self.params.nu, [
            c * dt * (kap[i] if i < len(kap) else 0.0)
            for i in range(self.problem.num_scalars)]

    @staticmethod
    def _apply_smooth_op(level, state: NSState, mu_v, mu_s) -> NSState:
        """(I - mu L) applied to the velocity (its viscous operators) and
        to each diffusive scalar (its diffusion operator), with the BC
        values."""
        vel = state.vel
        if mu_v > 0.0:
            vel = torch.stack([
                level._visc_ops[m].apply(state.vel[m], 1.0, -mu_v,
                                         homogeneous=False)
                for m in range(vel.shape[0])])
        scal = torch.stack([
            level.diff_solvers[i]._op.apply(state.scalars[i], 1.0,
                                            -mu_s[i], homogeneous=False)
            if mu_s[i] > 0.0 and level.diff_solvers[i] is not None
            else state.scalars[i] for i in range(state.scalars.shape[0])])
        return dataclasses.replace(state, vel=vel, scalars=scal)

    @staticmethod
    def _solve_smooth_op(level, state: NSState, mu_v, mu_s) -> NSState:
        """Solve (I - mu L) out = field for the velocity and each
        diffusive scalar by BiCGStab from the field, the BC values
        folded into the right-hand side (so that applying, then solving,
        is the identity)."""
        from somar_tpu_torch.solvers.bicgstab import bicgstab

        def solve(op, rhs, mu):
            bc_term = op.apply(torch.zeros_like(rhs), 1.0, -mu,
                               homogeneous=False)
            x, _ = bicgstab(lambda v: op.apply(v, 1.0, -mu),
                            rhs - bc_term, x0=rhs)
            return x

        vel = state.vel
        if mu_v > 0.0:
            vel = torch.stack([solve(level._visc_ops[m], state.vel[m], mu_v)
                               for m in range(vel.shape[0])])
        scal = torch.stack([
            solve(level.diff_solvers[i]._op, state.scalars[i], mu_s[i])
            if mu_s[i] > 0.0 and level.diff_solvers[i] is not None
            else state.scalars[i] for i in range(state.scalars.shape[0])])
        return dataclasses.replace(state, vel=vel, scalars=scal)

    def restore(self, fine_states, origins, weights=None, parent_sels=None):
        """Set the refined levels to a checkpoint's patches, coarse to
        fine: each level's K from its origins' shape, its footprint grown
        (as right-sizing grows it) until its extended shape is the
        patches', then the origins, weights and parent selections.
        Returns (fine_states, origins, weights) as tuples, weights None
        at K = 1."""
        fs, orgs, ws, _ = self._forms(fine_states, origins, weights)
        ndim = self.grid0.ndim
        orgs = [np.asarray(o, dtype=np.int64) for o in orgs]
        for lev in range(len(self.couplings)):
            self._per_level_K[lev] = (orgs[lev].shape[0]
                                      if orgs[lev].ndim == 2 else 1)
            self._frac_override[lev] = None
            self._build_couplings(lev)
            shape = tuple(fs[lev].lam.shape[-ndim:])
            while tuple(self.couplings[lev].ext_grid.shape) != shape:
                if not self._widen(lev):
                    raise ValueError(
                        f"no footprint of this hierarchy has the "
                        f"checkpoint's level-{lev + 1} patch shape {shape}")
        out_w = []
        for lev, c in enumerate(self.couplings):
            w = None if ws is None else ws[lev]
            if c.K > 1:
                w = (np.ones(c.K, np.float32) if w is None
                     else np.asarray(host_weights(w), np.float32))
            else:
                w = None
            ps = (None if parent_sels is None or parent_sels[lev] is None
                  else _host_ints(parent_sels[lev]).reshape(-1))
            if ps is None and c.K > 1:
                ps = np.zeros(c.K, np.int64)
            c.origin_f, c.weights, c.parent_sel = orgs[lev].copy(), w, ps
            out_w.append(None if w is None else w.copy())
        for lev in range(len(self.couplings)):
            self._refresh(lev)
        return tuple(fs), tuple(o.copy() for o in orgs), tuple(out_w)

    # ------------------------------------------------------------------ dt
    def _level_dt_tensors(self, fine_states):
        """Per refined level, one unread dt tensor per patch."""
        fs = (list(fine_states) if isinstance(fine_states, (list, tuple))
              else [fine_states])
        return [[lv.compute_dt_tensor(p)
                 for lv, p in zip(c.levels, c.unstack(s))]
                for c, s in zip(self.couplings, fs)]

    def compute_dt(self, s0: NSState, fine_states, geos=None) -> float:
        """Coarse dt limited so that every subcycled level stays in its
        CFL (a Python float; one host read)."""
        self._check_geos(geos, not isinstance(fine_states, (list, tuple)))
        dts = self.level_dts(s0, fine_states)
        dt, factor = dts[0], 1
        for c, d in zip(self.couplings, dts[1:]):
            factor *= c.nt
            dt = min(dt, factor * d)
        return dt

    def level_dts(self, s0: NSState, fine_states, geos=None):
        """Per-level CFL-limited dts (base first), not scaled by the
        subcycle counts: a refined level's is the least over its patches.
        Python floats, in one host read."""
        self._check_geos(geos, not isinstance(fine_states, (list, tuple)))
        per = self._level_dt_tensors(fine_states)
        vals = read_scalars(self.level0.compute_dt_tensor(s0),
                            *[t for ts in per for t in ts])
        out, i = [vals[0]], 1
        for ts in per:
            out.append(min(vals[i:i + len(ts)]))
            i += len(ts)
        return tuple(out)

    def subcycle_multipliers(self, dt: float, level_dts,
                             tolerance_factor: float = 1.1):
        """Dynamic subcycling: per coupling, double the substep count
        until the level's dt is within tolerance_factor of its
        CFL-limited dt (at most 16x); a deeper level sees the dt its
        parent's doubling left.  Returns a tuple of multipliers."""
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
