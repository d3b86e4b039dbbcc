"""Composite two-level elliptic solver over the AMR hierarchy (PyTorch port
of `somar_tpu.amr.composite` for one patch, K = 1).

One composite pass is a multiplicative two-level pass across the
refinement boundary:

  top-down   solve the base level, then the patch with the QUADRATIC CF
             ghost-potential ring interpolated from the new base solution
             folded into its rhs;
  bottom-up  average the patch solution down onto the base cells it
             covers.

With FAS tau on, the base level's covered-cell equation becomes the
restricted patch equation (rhs_par := L_par(phi_par) + R(rhs_f -
L_f(phi_f))); with the elliptic reflux on, the base rhs at the uncovered
cells next to the interface carries the fine-minus-coarse flux deficit of
the current iterate.  Convergence is read from the COMPOSITE residual: per
level r = rhs - L(phi; ring ghosts), covered base cells masked, the base
cells next to the interface reflux-corrected.  Each level solves with its
projector's solver (spectral, multigrid, BiCGStab or leptic) under the
solve's `purpose` ("sync").
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
    """Composite solve of L phi = rhs over [base level, patch] of an
    AMRHierarchy with one coupling."""

    def __init__(self, hierarchy, params: CompositeParams = CompositeParams()):
        if len(hierarchy.couplings) != 1 or hierarchy.couplings[0].K != 1:
            raise NotImplementedError(
                "composite solves over nested or multi-patch levels are "
                "slice 10 of the port's AMR (ROADMAP A.5)")
        self.h = hierarchy
        self.params = params

    def _covered_mask(self, origins):
        """True on the base cells the patch interior covers."""
        c = self.h.couplings[0]
        grid = c.parent_grid
        mask = torch.zeros(grid.shape, dtype=torch.bool, device=c.device)
        mask[tuple(slice(o, o + s) for o, s in zip(
            c.covered_origin_c(origins[0]), c.covered_shape_c))] = True
        return mask

    @staticmethod
    def _reflux_fold(c, level, par_level, phi_f, ring, ph_par, origin_f,
                     target, sign):
        """target + sign * Jinv * (+/-) deltaF/dx at the uncovered base
        cells next to the interface, deltaF = <F_fine(phi_f; ring)> -
        F_coarse(ph_par)."""
        fr = PatchFluxRegister(c)
        reg = fr.increment_fine(
            fr.zeros(), level.projector._grad_with_ring(phi_f, ring), 1.0)
        reg = fr.increment_coarse(
            reg, par_level.projector._grad_with_ring(ph_par, None), origin_f)
        return fr.reflux(target, reg, origin_f, sign,
                         par_level.projector.op.geo)

    def composite_residual(self, phis, rhss, origins):
        """Max-norm of the composite residual (a 0-d tensor)."""
        h = self.h
        c = h.couplings[0]
        level0, level = h.level0, c.level
        org = origins[0]
        res0 = level0.projector.op.residual(phis[0], rhss[0])
        ring = c._ring(phis[0], org)
        res1 = level.projector.op.residual(
            phis[1], rhss[1] - level.projector._rhs_ring_correction(ring))
        res0 = self._reflux_fold(c, level, level0, phis[1], ring, phis[0],
                                 org, res0, +1.0)
        res0 = torch.where(self._covered_mask(origins),
                           torch.zeros((), dtype=res0.dtype,
                                       device=res0.device), res0)
        return torch.maximum(res0.abs().max(), res1.abs().max())

    def _effective_rhss(self, phis, rhss, origins):
        """The base rhs with FAS tau on the covered cells and the lagged
        elliptic reflux at the cells next to the interface."""
        c = self.h.couplings[0]
        ring = c._ring(phis[0], origins[0])
        par = self._tau_corrected(phis, rhss, origins, ring)
        return [self._lagged_reflux(phis, par, origins, ring), rhss[1]]

    def _tau_corrected(self, phis, rhss, origins, ring):
        """The base rhs with the FAS tau of the patch's residual written
        over the covered cells."""
        h = self.h
        c = h.couplings[0]
        level0, level = h.level0, c.level
        rf = rhss[1] - (level.projector.op.apply(phis[1])
                        + level.projector._rhs_ring_correction(ring))
        Rrf = restrict_average(extract_patch(rf, c.int_start, c.int_shape),
                               c.ext_grid, c.ratio)
        origin_c = c.covered_origin_c(origins[0])
        tau = extract_patch(level0.projector.op.apply(phis[0]), origin_c,
                            Rrf.shape) + Rrf
        return insert_patch(rhss[0], tau, origin_c)

    def _lagged_reflux(self, phis, par, origins, ring):
        """par plus the elliptic reflux of the last pass's potentials at
        the uncovered base cells next to the interface."""
        h = self.h
        c = h.couplings[0]
        return self._reflux_fold(c, c.level, h.level0, phis[1], ring,
                                 phis[0], origins[0], par, +1.0)

    def solve(self, rhss, origins):
        """Composite solve from zero.  rhss: [base rhs, patch rhs];
        origins: [patch origin].  Returns (phis, (passes, final relative
        composite residual as a 0-d tensor))."""
        h = self.h
        p = self.params
        c = h.couplings[0]
        org = origins[0]
        phis = [torch.zeros_like(r) for r in rhss]

        def one_pass(phis):
            eff = self._effective_rhss(phis, rhss, origins)
            phi0, _ = h.level0.projector._solve(eff[0], phi0=phis[0],
                                                purpose=p.purpose)
            rhs_f = eff[1] - c.level.projector._rhs_ring_correction(
                c._ring(phi0, org))
            phi1, _ = c.level.projector._solve(rhs_f, phi0=phis[1],
                                               purpose=p.purpose)
            return [self._avg_down_phi(c, phi0, phi1, org), phi1]

        res0 = torch.clamp_min(self.composite_residual(phis, rhss, origins),
                               1e-30)
        res = res0
        for _ in range(p.iters):
            phis = one_pass(phis)
            res = self.composite_residual(phis, rhss, origins)
        return phis, (p.iters, res / res0)

    @staticmethod
    def _avg_down_phi(c, par, phi_f, origin_f):
        """The patch potential's interior average written over the base
        cells it covers."""
        avg = restrict_average(extract_patch(phi_f, c.int_start,
                                             c.int_shape),
                               c.ext_grid, c.ratio)
        return insert_patch(par, avg, c.covered_origin_c(origin_f))
