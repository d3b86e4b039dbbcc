"""Coarse-fine flux registers (PyTorch port of
`somar_tpu.amr.flux_register`).

Dense single-patch register: the CF interface is the set of coarse faces
under the patch's interior boundary (per CF direction, two face planes).
The register holds, per CF direction, the coarse-face plane deficit

    delta F = sum_substeps w <F_fine> - F_coarse

and `reflux` corrects the coarse cells adjacent to the interface,
u_coarse -= dt/dx * (+/- delta F) / J.  The composite solver folds the
elliptic flux deficit through it, and the sync projection builds the
composite divergence with it.  Origins are host ints per array axis, in
fine cells, of the extended patch.
"""

from __future__ import annotations

from typing import Sequence

import torch

from somar_tpu_torch.core.grid import Grid


class PatchFluxRegister:
    """Per-field flux register of one coupling's CF directions.  The
    coupling exposes cf_dirs, interior_nx, ratio, ext_grid, halo,
    parent_grid and the dtype and device of its level."""

    def __init__(self, coupling):
        self.h = coupling
        self.grid0: Grid = coupling.parent_grid

    def zeros(self):
        """Per CF dir, (lo_plane, hi_plane) coarse face-plane deficits."""
        kw = dict(dtype=self.h.params.dtype, device=self.h.device)
        return {d: (torch.zeros(self._coarse_plane_shape(d), **kw),
                    torch.zeros(self._coarse_plane_shape(d), **kw))
                for d in self.h.cf_dirs}

    def _coarse_plane_shape(self, d: int):
        """One coarse face plane over the patch footprint in the
        tangential dirs."""
        return tuple(self.h.interior_nx[dd] // self.h.ratio[dd]
                     for dd in (self.grid0.dir_of_axis(ax)
                                for ax in range(self.grid0.ndim))
                     if dd != d)

    def _fine_boundary_flux(self, flux_d, d: int, side: int):
        """The fine flux on the patch-interior boundary plane of dir d,
        tangential halos cropped, block-averaged onto coarse faces."""
        h = self.h
        ax = h.ext_grid.axis(d)
        H = h.halo
        idx = H if side == 0 else flux_d.shape[ax] - H - 1
        out = flux_d.select(ax, idx)
        rem_axes = [a for a in range(self.grid0.ndim) if a != ax]
        for pos, a in enumerate(rem_axes):
            if self.grid0.dir_of_axis(a) in h.cf_dirs:
                out = out.narrow(pos, H, out.shape[pos] - 2 * H)
        resh, mean_axes = [], []
        for pos, a in enumerate(rem_axes):
            r = h.ratio[self.grid0.dir_of_axis(a)]
            resh.extend([out.shape[pos] // r, r])
            mean_axes.append(len(resh) - 1)
        return out.reshape(resh).mean(dim=tuple(mean_axes))

    def increment_fine(self, reg, fine_fluxes: Sequence, weight):
        """Accumulate the fine boundary fluxes (weight = dt_f/dt_c)."""
        out = dict(reg)
        for d in self.h.cf_dirs:
            rlo, rhi = out[d]
            out[d] = (rlo + weight * self._fine_boundary_flux(
                fine_fluxes[d], d, 0),
                rhi + weight * self._fine_boundary_flux(
                    fine_fluxes[d], d, 1))
        return out

    def _tangential_start(self, origin_f, ax_skip):
        """Coarse start of the patch interior on every axis but ax_skip."""
        h = self.h
        out = []
        for a in range(self.grid0.ndim):
            if a == ax_skip:
                continue
            dd = self.grid0.dir_of_axis(a)
            out.append((int(origin_f[a]) + (h.halo if dd in h.cf_dirs
                                             else 0)) // h.ratio[dd])
        return out

    def _faces(self, origin_f, d):
        h = self.h
        lo_face = (int(origin_f[self.grid0.axis(d)]) + h.halo) // h.ratio[d]
        return lo_face, lo_face + h.interior_nx[d] // h.ratio[d]

    def _window(self, ax, idx, start, plane_shape, shape):
        """Index of the (1-thick along ax) window at idx x start in an
        array of `shape`, with the JAX package's dynamic_slice and
        dynamic_update_slice index rule: a negative start counts from the
        end of its axis, and every start is clamped so that the window
        fits.  Placement keeps every window inside (the donor slab needs
        a parent cell outside the interface); only a patch whose interface
        is a wall at a ratio above the halo reaches the rule (ROADMAP
        C.30)."""
        sl, k = [], 0
        for a in range(self.grid0.ndim):
            n = 1 if a == ax else plane_shape[k]
            lo = idx if a == ax else start[k]
            lo = lo + shape[a] if lo < 0 else lo
            lo = min(max(lo, 0), shape[a] - n)
            sl.append(slice(lo, lo + n))
            if a != ax:
                k += 1
        return tuple(sl)

    def increment_coarse(self, reg, coarse_fluxes: Sequence, origin_f):
        """Subtract the coarse interface fluxes."""
        out = dict(reg)
        for d in self.h.cf_dirs:
            ax = self.grid0.axis(d)
            lo_face, hi_face = self._faces(origin_f, d)
            start = self._tangential_start(origin_f, ax)
            shape = self._coarse_plane_shape(d)
            flux = coarse_fluxes[d]
            rlo, rhi = out[d]
            out[d] = (
                rlo - flux[self._window(ax, lo_face, start, shape,
                                        flux.shape)].squeeze(ax),
                rhi - flux[self._window(ax, hi_face, start, shape,
                                        flux.shape)].squeeze(ax))
        return out

    def reflux(self, coarse_cc, reg, origin_f, dt, geo0=None):
        """Add the deficit to the coarse cells adjacent to the interface:
        the lo interface is the high face of the cell just outside, so
        the two sides enter with opposite signs (times 1/J on mapped
        parents)."""
        grid0 = self.grid0
        Jinv = None
        if geo0 is not None and isinstance(geo0.Jinv, torch.Tensor) \
                and geo0.Jinv.ndim == grid0.ndim:
            Jinv = geo0.Jinv
        out = coarse_cc.clone()
        for d in self.h.cf_dirs:
            ax = grid0.axis(d)
            dx = grid0.dx[d]
            lo_face, hi_face = self._faces(origin_f, d)
            start = self._tangential_start(origin_f, ax)
            rlo, rhi = reg[d]
            for cell, plane, sign in ((lo_face - 1, rlo, -1.0),
                                      (hi_face, rhi, 1.0)):
                win = self._window(ax, cell, start, plane.shape, out.shape)
                corr = sign * (dt / dx) * plane.unsqueeze(ax)
                if Jinv is not None:
                    corr = corr * Jinv[win]
                out[win] = out[win] + corr
        return out
