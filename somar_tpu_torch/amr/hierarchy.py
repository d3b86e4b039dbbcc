"""The two-level AMR hierarchy: a base level and one refined patch,
subcycled (PyTorch port of the single-patch part of
`somar_tpu.amr.hierarchy`).

  * The refined level is ONE dense rectangular patch of static shape that
    spans the vertical and every periodic direction; its other horizontal
    sides are coarse-fine (CF) interfaces.  The patch carries an
    ADVECT_GROW halo on its CF sides, refreshed from space-time
    interpolated base data before every substep; its projections take the
    CF ghost-potential rings (quadratically interpolated base potentials
    folded into the rhs).
  * Placement is host work: the base state is tagged (amr/tagging.py) and
    the patch is centred on the tags' bounding box (native/), once, by
    `initial_patch_states`.  Origins are host ints (per array axis, in fine
    cells, of the extended patch), so every transfer is plain indexing.
  * One coarse step (`advance`): the base advance, nt = max(ratio)
    subcycled patch advances between the old and new base states,
    average-down of the patch interior, and the composite sync projection
    (amr/composite.py) with the elliptic reflux of the CF interface.

What the JAX package has beyond this (regrid, K > 1 patches, nested
levels, mapped patches, refluxing, the VD correction, dynamic subcycling)
is slice 10 of the port and raises NotImplementedError naming it.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from somar_tpu_torch.amr.tagging import (
    TagParams, compute_tags, patch_origin_from_tags, tag_coverage)
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
from somar_tpu_torch.solvers.parabolic import make_heat_solver
from somar_tpu_torch.solvers.poisson_op import PoissonOp

#: what a feature outside this slice says when it raises
SLICE10 = "slice 10 of the port's AMR (ROADMAP A.5)"


def _slice10(what: str):
    return NotImplementedError(f"{what} is {SLICE10}")


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
    """The refined patch level and its coupling to the base level (K = 1).

    Origins are per ARRAY axis, in fine cells, of the EXTENDED patch
    relative to the base array's corner (host ints)."""

    def __init__(self, parent_geo, problem: Problem, params: NSParams,
                 ratio: Tuple[int, ...], use_subcycling: bool = True,
                 max_grid_size: int = 0, patch_frac: float = 0.5):
        parent_grid: Grid = parent_geo.grid
        if not parent_geo.is_uniform:
            raise _slice10("a mapped base level (patches with their own "
                           "metric)")
        ndim = parent_grid.ndim
        self.parent_grid = parent_grid
        self.problem = problem
        self.params = params
        self.device = parent_geo.device
        self.geo_source = parent_geo.geo
        self.ratio = tuple(int(r) for r in ratio)
        self.nt = max(self.ratio) if use_subcycling else 1
        self.K = 1
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
        #: (dropped, tagged) parent cells of the last placement
        self.tag_coverage = (0, 0)

    # ---------------------------------------------------------------- util
    def _axis_ratio(self, ax: int) -> int:
        return self.ratio[self.parent_grid.dir_of_axis(ax)]

    def covered_origin_c(self, origin_f):
        """Parent-cell origin of the covered region (the patch interior)."""
        return tuple((int(origin_f[ax]) + self.int_start[ax])
                     // self._axis_ratio(ax)
                     for ax in range(self.parent_grid.ndim))

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
                     origin_f) -> NSState:
        """The patch interior's block average written over the parent
        cells it covers (velocity, scalars, lambda)."""
        origin_c = self.covered_origin_c(origin_f)

        def down(coarse, fine):
            block = extract_patch(fine, self.int_start, self.int_shape)
            return insert_patch(coarse, restrict_average(
                block, self.ext_grid, self.ratio), origin_c)

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
        """Store the tag coverage of the chosen patch; warn when tagged
        cells fall outside it."""
        dropped, total = tag_coverage(tags, origins, weights,
                                      self.parent_grid, self.ratio,
                                      interior_axes, halo_axes)
        self.tag_coverage = (dropped, total)
        if dropped > 0:
            warnings.warn(
                f"AMR placement dropped {dropped}/{total} tagged cells: the "
                f"tagged region outgrew the static patch footprint "
                f"(interior {self.interior_nx} fine cells). Raise "
                f"patch_frac / amr.max_grid_size to cover it.",
                RuntimeWarning, stacklevel=3)

    def _masked_tags(self, s_par: NSState, tag_params: TagParams):
        """Tags of the parent state (the base level has no CF halo of its
        own to mask)."""
        return compute_tags(s_par, self._parent_level, tag_params)

    def choose_origin(self, s_par: NSState, tag_params: TagParams
                      ) -> np.ndarray:
        """Tag the parent state and choose the patch origin (host work);
        centred when nothing is tagged."""
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


class AMRHierarchy:
    """Base level + one subcycled refined patch (K = 1).

    The arguments are the JAX package's; those that select a feature of
    slice 10 (more than one ratio, num_patches != 1, reflux, implicit
    reflux, eta_lambda > 0, post-regrid smoothing) raise
    NotImplementedError.  The sync projection's composite solve always
    takes FAS tau and the elliptic reflux (the JAX defaults
    sync_use_tau = sync_use_reflux = True); the JAX package's
    grid_buffer_size (the nesting buffer) has nothing to act on with one
    refined level and is not an argument."""

    def __init__(self, geo0, problem: Problem, params: NSParams,
                 ratio=None, tag_params: TagParams = TagParams(),
                 patch_frac: float = 0.5, eta_lambda: float = 0.0,
                 ratios: Optional[Sequence[Tuple[int, ...]]] = None,
                 reflux: Sequence[str] = (),
                 implicit_reflux: bool = False,
                 regrid_smoothing_coeff: float = 0.0,
                 num_patches: int = 1, use_subcycling: bool = True,
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
            raise _slice10(f"{len(ratios)} refinement ratios (nested "
                           "levels)")
        if isinstance(num_patches, (list, tuple)) or int(num_patches) != 1:
            raise _slice10(f"num_patches={num_patches} (K > 1 patches)")
        if reflux:
            raise _slice10(f"advective refluxing {tuple(reflux)}")
        if implicit_reflux:
            raise _slice10("implicit refluxing")
        if eta_lambda > 0.0:
            raise _slice10("the VD correction (eta_lambda > 0)")
        if regrid_smoothing_coeff > 0.0:
            raise _slice10("post-regrid smoothing")
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
        self._patch_frac = float(patch_frac)
        self._frac_override = None
        self._use_subcycling = bool(use_subcycling)
        self._max_grid_size = int(max_grid_size)
        self._build_couplings()

    def _build_couplings(self):
        frac = (self._frac_override if self._frac_override is not None
                else self._patch_frac)
        c = PatchCoupling(self._geo0, self.problem, self.params,
                          self.ratios[0], use_subcycling=self._use_subcycling,
                          max_grid_size=self._max_grid_size,
                          patch_frac=frac)
        c._parent_level = self.level0
        self.couplings = [c]
        self.ext_nx = c.ext_nx
        self.halo = c.halo

    def attach_mesh(self, mesh):
        raise _slice10("attach_mesh (sharded hierarchy steps)")

    def regrid(self, *args, **kwargs):
        raise _slice10("regrid")

    # ------------------------------------------------------------- advance
    @staticmethod
    def _one(fine_states, origins):
        """The one patch state and origin of either call form (a bare
        state, or one-element sequences)."""
        if isinstance(fine_states, (list, tuple)):
            if len(fine_states) != 1:
                raise _slice10(f"{len(fine_states)} refined levels")
            return fine_states[0], origins[0], False
        return fine_states, origins, True

    @staticmethod
    def _no_extras(geos=None, weights=None, parent_sels=None,
                   nt_mults=None):
        if nt_mults is not None:
            raise _slice10("dynamic subcycling (nt_mults)")
        for name, v in (("geos", geos), ("weights", weights),
                        ("parent_sels", parent_sels)):
            if v is not None and any(x is not None for x in (
                    v if isinstance(v, (list, tuple)) else [v])):
                raise _slice10(f"{name} (mapped or multi-patch levels)")

    def _advance_patch(self, s_old: NSState, s_new: NSState,
                       s_f: NSState, origin, dt: float):
        """The patch's nt subcycles between the base states at t (s_old)
        and t + dt (s_new): before each, the CF halo refreshed from the
        time-interpolated base state and the projections' CF rings from
        the base potentials at the substep's midpoint.  Returns (the
        averaged-down base state, the patch state)."""
        c = self.couplings[0]
        nt = c.nt
        dt_f = dt / nt
        for i in range(nt):
            donor0 = time_interp(s_old, s_new, i / nt)
            mid = (i + 0.5) / nt
            mac_mid = (1.0 - mid) * s_old.mac_phi + mid * s_new.mac_phi
            cc_mid = (1.0 - mid) * s_old.cc_phi + mid * s_new.cc_phi
            s_f = c._overwrite_halo(s_f, c._interp_state_ext(donor0, origin,
                                                             nt=nt))
            rings = {"mac": c._ring(mac_mid, origin),
                     "cc": c._ring(cc_mid, origin, 1.0 / nt)}
            s_f = c.level.advance(s_f, dt_f, rings=rings)
        return c.average_down(s_new, s_f, origin), s_f

    def advance(self, s0: NSState, fine_states, origins, dt, geos=None,
                weights=None, nt_mults=None, parent_sels=None):
        """One coarse step of length dt (a Python float): the base
        advance, the subcycled patch advances, average-down and the
        composite sync projection.  fine_states / origins: the patch
        state and origin, bare or as one-element sequences (the return
        takes the same form).  Returns (s0_new, fine_states_new)."""
        self._no_extras(geos, weights, parent_sels, nt_mults)
        s_f, origin, single = self._one(fine_states, origins)
        dt = float(dt)
        s0_new = self.level0.advance(s0, dt)
        s0_new, s_f = self._advance_patch(s0, s0_new, s_f, origin, dt)
        if self.params.is_incompressible and self.do_sync_projection:
            for _ in range(self.sync_projection_iters):
                s0_new, s_f = self._sync_project(s0_new, s_f, origin)
        return (s0_new, s_f) if single else (s0_new, (s_f,))

    def init_project(self, s0: NSState, fine_states, origins, geos=None,
                     weights=None, parent_sels=None, iters: int = 1):
        """Composite initial projection(s) over the freshly placed
        hierarchy.  Returns (s0, (patch state,))."""
        self._no_extras(geos, weights, parent_sels)
        s_f, origin, _ = self._one(fine_states, origins)
        for _ in range(max(1, int(iters))):
            s0, s_f = self._sync_project(s0, s_f, origin)
        return s0, (s_f,)

    def initialize_pressure(self, s0: NSState, fine_states, origins, dt,
                            geos=None, weights=None, parent_sels=None,
                            iters: int = 1):
        """Converge the lagged pressures of both levels with dummy coarse
        steps that keep only the pressure fields."""
        self._no_extras(geos, weights, parent_sels)
        s_f, origin, single = self._one(fine_states, origins)
        keep = lambda dst, src: dataclasses.replace(
            dst, pressure=src.pressure, mac_phi=src.mac_phi,
            cc_phi=src.cc_phi)
        for _ in range(max(1, int(iters))):
            t0, tf = self.advance(s0, s_f, origin, dt)
            s0, s_f = keep(s0, t0), keep(s_f, tf)
        return (s0, s_f) if single else (s0, (s_f,))

    def _sync_project(self, s0: NSState, s_f: NSState, origin):
        """One composite sync projection: ONE composite potential solve of
        L[phi] = div(u) over both levels (the base rhs built from the
        composite divergence: the base flux on the CF interface faces
        replaced by the averaged patch flux), each level's velocity
        corrected by its own gradient of the composite potential (the
        patch with the base potential's CF ring), and the corrected patch
        averaged down.  Returns (s0, s_f)."""
        from somar_tpu_torch.amr.composite import (AMRCompositeSolver,
                                                   CompositeParams)
        from somar_tpu_torch.amr.flux_register import PatchFluxRegister
        c = self.couplings[0]
        level0, lvl = self.level0, c.level
        f0 = level0.projector.cc_fluxes(s0.vel, level0.vel_bcs_trace)
        rhs0 = mac_divergence(f0, level0.geo)
        f1 = lvl.projector.cc_fluxes(s_f.vel, lvl.vel_bcs_trace)
        rhs1 = mac_divergence(f1, lvl.geo)
        fr = PatchFluxRegister(c)
        reg = fr.increment_fine(fr.zeros(), f1, 1.0)
        reg = fr.increment_coarse(reg, f0, origin)
        rhs0 = fr.reflux(rhs0, reg, origin, -1.0, level0.geo)
        solver = AMRCompositeSolver(
            self, CompositeParams(iters=self.sync_composite_iters,
                                  purpose="sync"))
        phis, self.last_sync_info = solver.solve([rhs0, rhs1], [origin])
        s0 = dataclasses.replace(
            s0, vel=s0.vel - level0.projector.cc_correction(phis[0]))
        s_f = dataclasses.replace(
            s_f, vel=s_f.vel - lvl.projector.cc_correction(
                phis[1], c._ring(phis[0], origin)))
        return c.average_down(s0, s_f, origin), s_f

    def average_down(self, s0: NSState, s1: NSState, origin_f) -> NSState:
        return self.couplings[0].average_down(s0, s1, origin_f)

    # ----------------------------------------------------------- placement
    def _fill_patch_state(self, lev: int, s_par: NSState) -> NSState:
        c = self.couplings[lev]
        return c._interp_state_ext(s_par, c.origin_f)

    def initial_patch_states(self, s0: NSState):
        """Tag the base state, place the patch and fill it from the base
        (host work).  Returns ((patch state,), (origin,)), the origin a
        host int array per array axis."""
        for _attempt in range(8):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                self.couplings[0].choose_origin(s0, self.tag_params)
            if not self._grow_for_init_coverage(0):
                for w in caught:
                    warnings.warn_explicit(w.message, w.category,
                                           w.filename, w.lineno)
                break
        c = self.couplings[0]
        c.origin_f = c.choose_origin(s0, self.tag_params)
        return (self._fill_patch_state(0, s0),), (c.origin_f.copy(),)

    def _grow_for_init_coverage(self, lev: int) -> bool:
        """Placement right-sizing: when the probe dropped tagged cells,
        widen the patch footprint (patch_frac x 1.5, to 0.95) and return
        True (the caller re-probes).  Where the JAX package would first
        double the patch budget K, this raises (K > 1 is slice 10)."""
        c = self.couplings[lev]
        if c.tag_coverage[0] <= 0:
            return False
        if c.K < self.max_auto_patches:
            raise _slice10(
                f"a placement that drops {c.tag_coverage[0]} tagged cells "
                "and doubles the patch budget K")
        frac = (self._frac_override if self._frac_override is not None
                else self._patch_frac)
        if frac >= 0.95:
            return False
        self._frac_override = min(0.95, 1.5 * frac)
        self._build_couplings()
        return True

    # ------------------------------------------------------------------ dt
    def compute_dt(self, s0: NSState, fine_states, geos=None) -> float:
        """Coarse dt limited so that the subcycled patch stays in its CFL
        (a Python float; each level's limit is one host read)."""
        self._no_extras(geos)
        s_f, _, _ = self._one(fine_states, [None])
        c = self.couplings[0]
        return min(self.level0.compute_dt(s0),
                   c.nt * c.level.compute_dt(s_f))

    def level_dts(self, s0: NSState, fine_states, geos=None):
        """Per-level CFL-limited dts (base first), not scaled by the
        subcycle count."""
        self._no_extras(geos)
        s_f, _, _ = self._one(fine_states, [None])
        return (self.level0.compute_dt(s0),
                self.couplings[0].level.compute_dt(s_f))
