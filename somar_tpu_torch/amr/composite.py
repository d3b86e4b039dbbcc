"""Composite two-level elliptic solver over the AMR hierarchy (PyTorch port
of `somar_tpu.amr.composite` for one refined level of K patches).

One composite pass is a multiplicative two-level pass across the
refinement boundary:

  top-down   solve the base level, then each patch with the QUADRATIC CF
             ghost-potential ring interpolated from the new base solution
             folded into its rhs;
  bottom-up  average each patch solution down onto the base cells it
             covers (blended by the patch's weight at K > 1, so that a
             weight-0 slot leaves the base as it is).

With FAS tau, the base level's covered-cell equation becomes the
restricted patch equation (rhs_par := L_par(phi_par) + R(rhs_f -
L_f(phi_f))); with the elliptic reflux, the base rhs at the uncovered
cells next to each interface carries the fine-minus-coarse flux deficit
of the current iterate (times the patch's weight).  Convergence is read
from the COMPOSITE residual: per level r = rhs - L(phi; ring ghosts),
base cells covered by an active patch masked, the base cells next to the
interfaces reflux-corrected, each patch's max-norm times its weight.
Each level solves with its projector's solver (spectral, multigrid,
BiCGStab or leptic) under the solve's `purpose` ("sync").
"""

from __future__ import annotations

import dataclasses

import torch

from somar_tpu_torch.amr.flux_register import PatchFluxRegister
from somar_tpu_torch.amr.transfer import (extract_patch, insert_patch,
                                          restrict_average)


@dataclasses.dataclass(frozen=True)
class CompositeParams:
    iters: int = 4          # composite passes
    purpose: str = "sync"   # the level solvers' multigrid-parameter key


class AMRCompositeSolver:
    """Composite solve of L phi = rhs over [base level, refined level] of
    an AMRHierarchy with one coupling of K patches."""

    def __init__(self, hierarchy, params: CompositeParams = CompositeParams()):
        if len(hierarchy.couplings) != 1:
            raise NotImplementedError(
                "composite solves over nested levels are slice 11 of the "
                "port's AMR (ROADMAP A.5)")
        self.h = hierarchy
        self.params = params

    # --------------------------------------------------- the public forms
    def _patch_args(self, origins, weights):
        c = self.h.couplings[0]
        w = weights[0] if isinstance(weights, (list, tuple)) else weights
        return c.patch_origins(origins[0]), c.patch_weights(w)

    def _as_list(self, field):
        """The per-patch tensors of a refined-level field (K-stacked at
        K > 1, or already a list)."""
        c = self.h.couplings[0]
        if isinstance(field, (list, tuple)):
            return list(field)
        return [field[k] for k in range(c.K)] if c.K > 1 else [field]

    def composite_residual(self, phis, rhss, origins, weights=None):
        """Max-norm of the composite residual (a 0-d tensor).  phis /
        rhss: [base, refined level (K-stacked at K > 1)]."""
        origs, ws = self._patch_args(origins, weights)
        return self._residual(phis[0], self._as_list(phis[1]), rhss[0],
                              self._as_list(rhss[1]), origs, ws)

    def solve(self, rhss, origins, weights=None):
        """Composite solve from zero.  rhss: [base rhs, refined level's
        rhs (K-stacked at K > 1)]; origins / weights: one entry for the
        refined level.  Returns (phis in the same form, (passes, final
        relative composite residual as a 0-d tensor))."""
        origs, ws = self._patch_args(origins, weights)
        (phi0, phi1), info = self.solve_patches(
            [rhss[0], self._as_list(rhss[1])], origs, ws)
        c = self.h.couplings[0]
        return [phi0, torch.stack(phi1) if c.K > 1 else phi1[0]], info

    # ------------------------------------------------------------- pieces
    def _covered_mask(self, origs, ws):
        """True on the base cells that an active patch interior covers."""
        c = self.h.couplings[0]
        mask = torch.zeros(c.parent_grid.shape, dtype=torch.bool,
                           device=c.device)
        for o, w in zip(origs, ws):
            if w is not None and w <= 0.0:
                continue
            mask[tuple(slice(a, a + s) for a, s in zip(
                c.covered_origin_c(o), c.covered_shape_c))] = True
        return mask

    @staticmethod
    def _reflux_fold(c, level, par_level, phi_f, ring, ph_par, origin_f,
                     target, sign, weight=None):
        """target + sign * weight * Jinv * (+/-) deltaF/dx at the
        uncovered base cells next to the interface, deltaF =
        <F_fine(phi_f; ring)> - F_coarse(ph_par)."""
        fr = PatchFluxRegister(c)
        reg = fr.increment_fine(
            fr.zeros(), level.projector._grad_with_ring(phi_f, ring), 1.0)
        reg = fr.increment_coarse(
            reg, par_level.projector._grad_with_ring(ph_par, None), origin_f)
        return fr.reflux(target, reg, origin_f,
                         sign if weight is None else sign * weight,
                         par_level.projector.op.geo)

    def _residual(self, phi0, phi1, rhs0, rhs1, origs, ws):
        h = self.h
        c = h.couplings[0]
        level0, level = h.level0, c.level
        res0 = level0.projector.op.residual(phi0, rhs0)
        worst = []
        for k, (o, w) in enumerate(zip(origs, ws)):
            ring = c._ring(phi0, o)
            rr = level.projector.op.residual(
                phi1[k], rhs1[k] - level.projector._rhs_ring_correction(ring))
            res0 = self._reflux_fold(c, level, level0, phi1[k], ring, phi0,
                                     o, res0, +1.0, w)
            m = rr.abs().max()
            worst.append(m if w is None else m * w)
        res0 = torch.where(self._covered_mask(origs, ws),
                           torch.zeros((), dtype=res0.dtype,
                                       device=res0.device), res0)
        return torch.maximum(res0.abs().max(), torch.stack(worst).max())

    def _tau_corrected(self, phis, rhss, origs, ws, rings):
        """The base rhs with the FAS tau of each patch's residual written
        over the cells it covers (blended by its weight at K > 1)."""
        h = self.h
        c = h.couplings[0]
        level = c.level
        apply_par = h.level0.projector.op.apply(phis[0])
        par = rhss[0]
        for k, (o, w) in enumerate(zip(origs, ws)):
            rf = rhss[1][k] - (level.projector.op.apply(phis[1][k])
                               + level.projector._rhs_ring_correction(
                                   rings[k]))
            Rrf = restrict_average(extract_patch(rf, c.int_start,
                                                 c.int_shape),
                                   c.ext_grid, c.ratio)
            origin_c = c.covered_origin_c(o)
            tau = extract_patch(apply_par, origin_c, Rrf.shape) + Rrf
            if w is not None:
                cur = extract_patch(par, origin_c, Rrf.shape)
                tau = cur + w * (tau - cur)
            par = insert_patch(par, tau, origin_c)
        return par

    def _lagged_reflux(self, phis, par, origs, ws, rings):
        """par plus each patch's elliptic reflux of the last pass's
        potentials at the uncovered base cells next to its interface."""
        h = self.h
        c = h.couplings[0]
        for k, (o, w) in enumerate(zip(origs, ws)):
            par = self._reflux_fold(c, c.level, h.level0, phis[1][k],
                                    rings[k], phis[0], o, par, +1.0, w)
        return par

    def solve_patches(self, rhss, origs, ws):
        """Composite solve from zero on per-patch lists: rhss = [base
        rhs, [patch rhs ...]], origs / ws per patch (ws None entries at
        K = 1).  Returns ((phi0, [phi_k ...]), (passes, relres))."""
        h = self.h
        p = self.params
        c = h.couplings[0]
        phis = [torch.zeros_like(rhss[0]),
                [torch.zeros_like(r) for r in rhss[1]]]

        def one_pass(phis):
            rings = [c._ring(phis[0], o) for o in origs]
            par = self._tau_corrected(phis, rhss, origs, ws, rings)
            par = self._lagged_reflux(phis, par, origs, ws, rings)
            phi0, _ = h.level0.projector._solve(par, phi0=phis[0],
                                                purpose=p.purpose)
            phi1 = []
            for k, o in enumerate(origs):
                rhs_f = rhss[1][k] - c.level.projector._rhs_ring_correction(
                    c._ring(phi0, o))
                out, _ = c.level.projector._solve(rhs_f, phi0=phis[1][k],
                                                  purpose=p.purpose)
                phi1.append(out)
            for k, (o, w) in enumerate(zip(origs, ws)):
                phi0 = self._avg_down_phi(c, phi0, phi1[k], o, w)
            return [phi0, phi1]

        res0 = torch.clamp_min(self._residual(phis[0], phis[1], rhss[0],
                                              rhss[1], origs, ws), 1e-30)
        res = res0
        for _ in range(p.iters):
            phis = one_pass(phis)
            res = self._residual(phis[0], phis[1], rhss[0], rhss[1],
                                 origs, ws)
        return (phis[0], phis[1]), (p.iters, res / res0)

    @staticmethod
    def _avg_down_phi(c, par, phi_f, origin_f, weight=None):
        """The patch potential's interior average written over the base
        cells it covers (blended by weight)."""
        avg = restrict_average(extract_patch(phi_f, c.int_start,
                                             c.int_shape),
                               c.ext_grid, c.ratio)
        origin_c = c.covered_origin_c(origin_f)
        if weight is not None:
            cur = extract_patch(par, origin_c, avg.shape)
            avg = cur + weight * (avg.to(par.dtype) - cur)
        return insert_patch(par, avg, origin_c)
