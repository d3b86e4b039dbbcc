"""Composite multi-level elliptic solver over the AMR hierarchy (PyTorch
port of `somar_tpu.amr.composite`).

One composite pass is a multiplicative pass across every refinement
boundary:

  top-down   solve the base level, then each refined level's patches with
             the QUADRATIC CF ghost-potential ring interpolated from the
             new solution of its parent patch folded into the rhs;
  bottom-up  average each patch solution down onto the parent cells it
             covers (blended by the patch's weight at K > 1, so that a
             weight-0 slot leaves its parent as it is), finest first.

With FAS tau, a parent's covered-cell equation becomes the restricted
child equation (rhs_par := L_par(phi_par; its own ring) + R(rhs_f -
L_f(phi_f))), applied fine to coarse so deeper corrections reach the
base, each child's into its own parent patch; with the elliptic reflux,
the parent's rhs at the uncovered cells next to each interface carries the
fine-minus-coarse flux deficit of the current iterate (times the patch's
weight).  Convergence is read from the COMPOSITE residual: per level r =
rhs - L(phi; ring ghosts), each parent patch's cells covered by an active
child of its own masked, the cells next to the interfaces
reflux-corrected, each patch's max-norm times its weight.  Each patch
solves with its own level's projector solver (spectral, multigrid,
BiCGStab or leptic; on a mapped base each slot's own metric) under the
solve's `purpose`: "sync" for the sync and initial projections, "vd" for
the VD correction (the base level's multigrid then takes NSParams.mg_vd).
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
    """Composite solve of L phi = rhs over the base level and every
    refined level of an AMRHierarchy.

    Fields are per level: the base level's tensor, then per refined level
    its per-patch tensors (`solve_patches`) or, in the JAX form, its
    K-stacked tensor (`solve`, `composite_residual`).  args are the
    hierarchy's per-level (origins, weights, parent index) per patch
    (`AMRHierarchy._patch_args`)."""

    def __init__(self, hierarchy, params: CompositeParams = CompositeParams()):
        self.h = hierarchy
        self.params = params

    # --------------------------------------------------- the public forms
    def _args(self, origins, weights, parent_sels):
        if weights is not None and not isinstance(weights, (list, tuple)):
            weights = [weights]
        return self.h._patch_args(list(origins), weights, parent_sels)

    def _as_lists(self, fields):
        """[base tensor, per refined level its per-patch tensors] of
        fields K-stacked at K > 1 (or already lists)."""
        out = [fields[0]]
        for c, f in zip(self.h.couplings, fields[1:]):
            if isinstance(f, (list, tuple)):
                out.append(list(f))
            else:
                out.append([f[k] for k in range(c.K)] if c.K > 1 else [f])
        return out

    def composite_residual(self, phis, rhss, origins, weights=None,
                           parent_sels=None):
        """Max-norm of the composite residual (a 0-d tensor).  phis /
        rhss: [base, each refined level (K-stacked at K > 1)]; origins,
        weights and parent_sels per refined level."""
        return self._residual(self._as_lists(phis), self._as_lists(rhss),
                              self._args(origins, weights, parent_sels))

    def solve(self, rhss, origins, weights=None, parent_sels=None,
              phis0=None):
        """Composite solve from phis0 (zero when None).  rhss: [base rhs,
        each refined level's rhs (K-stacked at K > 1)], phis0 the same;
        origins, weights and parent_sels per refined level.  Returns (phis
        in the same form, (passes, final composite residual relative to
        the starting one, as a 0-d tensor))."""
        phis, info = self.solve_patches(
            self._as_lists(rhss), self._args(origins, weights, parent_sels),
            phis0=None if phis0 is None else self._as_lists(phis0))
        return [phis[0]] + [torch.stack(p) if c.K > 1 else p[0]
                            for c, p in zip(self.h.couplings,
                                            phis[1:])], info

    # ------------------------------------------------------------- pieces
    def _level(self, lev: int, p: int = 0):
        """The level object of patch p of level lev (0: the base)."""
        return (self.h.level0 if lev == 0
                else self.h.couplings[lev - 1].levels[p])

    def _covered_mask(self, lev: int, p: int, args):
        """True on the cells of level lev (its patch p; the base at lev =
        0) that an active patch of level lev + 1 nested in it covers."""
        c = self.h.couplings[lev]
        mask = torch.zeros(c.parent_grid.shape, dtype=torch.bool,
                           device=c.device)
        for o, w, q in zip(*args[lev]):
            if q != p or (w is not None and w <= 0.0):
                continue
            mask[tuple(slice(a, a + s) for a, s in zip(
                c.covered_origin_c(o), c.covered_shape_c))] = True
        return mask

    @staticmethod
    def _reflux_fold(c, level, par_level, phi_f, ring, ph_par, origin_f,
                     target, sign, weight=None):
        """target + sign * weight * Jinv * (+/-) deltaF/dx at the
        uncovered parent cells next to the interface, deltaF =
        <F_fine(phi_f; ring)> - F_coarse(ph_par)."""
        fr = PatchFluxRegister(c)
        reg = fr.increment_fine(
            fr.zeros(), level.projector._grad_with_ring(phi_f, ring), 1.0)
        reg = fr.increment_coarse(
            reg, par_level.projector._grad_with_ring(ph_par, None), origin_f)
        return fr.reflux(target, reg, origin_f,
                         sign if weight is None else sign * weight,
                         par_level.projector.op.geo)

    def _residual(self, phis, rhss, args):
        h = self.h
        res = [[h.level0.projector.op.residual(phis[0], rhss[0])]]
        for lev, c in enumerate(h.couplings):
            lvls = c.levels
            par_phis = [phis[0]] if lev == 0 else phis[lev]
            rrs = []
            for k, (o, w, p) in enumerate(zip(*args[lev])):
                level, par_level = lvls[k], self._level(lev, p)
                ring = c._ring(par_phis[p], o)
                rrs.append(level.projector.op.residual(
                    phis[lev + 1][k],
                    rhss[lev + 1][k]
                    - level.projector._rhs_ring_correction(ring)))
                res[lev][p] = self._reflux_fold(
                    c, level, par_level, phis[lev + 1][k], ring,
                    par_phis[p], o, res[lev][p], +1.0, w)
            res.append(rrs)
        norms = []
        for lev, rl in enumerate(res):
            ws = [None] if lev == 0 else args[lev - 1][1]
            for p, (r, w) in enumerate(zip(rl, ws)):
                if lev < len(h.couplings):
                    r = torch.where(self._covered_mask(lev, p, args),
                                    torch.zeros((), dtype=r.dtype,
                                                device=r.device), r)
                m = r.abs().max()
                norms.append(m if w is None else m * w)
        return torch.stack(norms).max()

    def _tau_corrected(self, phis, rhss, lev, args, rings, par_rings):
        """Level lev's rhs (the base tensor, or the per-patch list of a
        refined level) with the FAS tau of each child patch's residual
        written over the parent cells it covers, in its own parent patch
        (blended by its weight at K > 1).  phis / rhss: [level lev's,
        level lev + 1's]; rings: the children's CF rings; par_rings: the
        parent patches' own (None for the base)."""
        c = self.h.couplings[lev]
        lvls = c.levels
        par_phis = phis[0] if lev > 0 else [phis[0]]
        par = list(rhss[0]) if lev > 0 else [rhss[0]]
        apply_par = {}
        for k, (o, w, p) in enumerate(zip(*args[lev])):
            level, par_level = lvls[k], self._level(lev, p)
            if p not in apply_par:
                ap = par_level.projector.op.apply(par_phis[p])
                if par_rings is not None:
                    ap = ap + par_level.projector._rhs_ring_correction(
                        par_rings[p])
                apply_par[p] = ap
            rf = rhss[1][k] - (level.projector.op.apply(phis[1][k])
                               + level.projector._rhs_ring_correction(
                                   rings[k]))
            Rrf = restrict_average(extract_patch(rf, c.int_start,
                                                 c.int_shape),
                                   c.ext_grid, c.ratio)
            origin_c = c.covered_origin_c(o)
            tau = extract_patch(apply_par[p], origin_c, Rrf.shape) + Rrf
            if w is not None:
                cur = extract_patch(par[p], origin_c, Rrf.shape)
                tau = cur + w * (tau - cur)
            par[p] = insert_patch(par[p], tau, origin_c)
        return par if lev > 0 else par[0]

    def _lagged_reflux(self, phis, par, lev, args, rings):
        """par (level lev's rhs) plus each child patch's elliptic reflux
        of the last pass's potentials at the uncovered cells next to its
        interface, in its own parent patch."""
        c = self.h.couplings[lev]
        par_phis = phis[0] if lev > 0 else [phis[0]]
        out = list(par) if lev > 0 else [par]
        lvls = c.levels
        for k, (o, w, p) in enumerate(zip(*args[lev])):
            out[p] = self._reflux_fold(c, lvls[k], self._level(lev, p),
                                       phis[1][k], rings[k], par_phis[p],
                                       o, out[p], +1.0, w)
        return out if lev > 0 else out[0]

    def solve_patches(self, rhss, args, phis0=None):
        """Composite solve on per-patch lists from phis0 (zero when None):
        rhss = [base rhs, per refined level [patch rhs ...]], phis0 the
        same.  Returns (phis in the same form, (passes, relres))."""
        h = self.h
        p = self.params
        nc = len(h.couplings)
        if phis0 is None:
            phis = [torch.zeros_like(rhss[0])] + [
                [torch.zeros_like(r) for r in rl] for rl in rhss[1:]]
        else:
            phis = [phis0[0]] + [list(pl) for pl in phis0[1:]]

        def one_pass(phis):
            rings = []
            for lev, c in enumerate(h.couplings):
                par_phis = [phis[0]] if lev == 0 else phis[lev]
                rings.append([c._ring(par_phis[q], o)
                              for o, _, q in zip(*args[lev])])
            eff = list(rhss)
            for lev in range(nc - 1, -1, -1):
                view = [phis[lev], phis[lev + 1]]
                par = self._tau_corrected(view, [eff[lev], eff[lev + 1]],
                                          lev, args, rings[lev],
                                          rings[lev - 1] if lev > 0
                                          else None)
                eff[lev] = self._lagged_reflux(view, par, lev, args,
                                               rings[lev])
            phi0, _ = h.level0.projector._solve(eff[0], phi0=phis[0],
                                                purpose=p.purpose)
            new = [phi0]
            for lev, c in enumerate(h.couplings):
                par_phis = [phi0] if lev == 0 else new[lev]
                lvls = c.levels
                outs = []
                for k, (o, _, q) in enumerate(zip(*args[lev])):
                    rhs_f = eff[lev + 1][k] \
                        - lvls[k].projector._rhs_ring_correction(
                            c._ring(par_phis[q], o))
                    out, _ = lvls[k].projector._solve(
                        rhs_f, phi0=phis[lev + 1][k], purpose=p.purpose)
                    outs.append(out)
                new.append(outs)
            for lev in range(nc - 1, -1, -1):
                c = h.couplings[lev]
                for k, (o, w, q) in enumerate(zip(*args[lev])):
                    if lev == 0:
                        new[0] = self._avg_down_phi(c, new[0], new[1][k],
                                                    o, w)
                    else:
                        new[lev][q] = self._avg_down_phi(
                            c, new[lev][q], new[lev + 1][k], o, w)
            return new

        res0 = torch.clamp_min(self._residual(phis, rhss, args), 1e-30)
        res = res0
        for _ in range(p.iters):
            phis = one_pass(phis)
            res = self._residual(phis, rhss, args)
        return phis, (p.iters, res / res0)

    @staticmethod
    def _avg_down_phi(c, par, phi_f, origin_f, weight=None):
        """The patch potential's interior average written over the parent
        cells it covers (blended by weight)."""
        avg = restrict_average(extract_patch(phi_f, c.int_start,
                                             c.int_shape),
                               c.ext_grid, c.ratio)
        origin_c = c.covered_origin_c(origin_f)
        if weight is not None:
            cur = extract_patch(par, origin_c, avg.shape)
            avg = cur + weight * (avg.to(par.dtype) - cur)
        return insert_patch(par, avg, origin_c)
