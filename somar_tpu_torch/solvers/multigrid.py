"""Semicoarsening geometric multigrid for the Poisson/Helmholtz operator
(PyTorch port of `somar_tpu.solvers.multigrid`).

* The **semicoarsening schedule**: at each MG level, coarsen only the
  directions whose dx is at most half the current max dx (equalize
  anisotropy before coarsening isotropically); if none qualify, coarsen
  every coarsenable direction; stop when nothing is coarsenable.
* Restriction is block full-weighting; prolongation is piecewise
  multilinear (or piecewise constant), with the zero-average variant
  applied automatically for singular (all-Neumann/periodic) problems.
  Both are plain tensor code, as the JAX package leaves them to XLA.
* Coarse-level metrics are re-derived from the GeoSource on the coarsened
  grid, or, for an array-defined (raw) geometry such as the leptic
  solver's flattened level, coarsened as arrays
  (geometry/raw_geometry.py); residuals restrict J-weighted
  (volume-weighted) on mapped levels.
* The V/W-cycle recursion is a Python recursion over the static hierarchy;
  the outer iteration is a Python loop on the residual norm with the
  imin/imax/eps/hang semantics of AMRMG.*, reading one scalar per V-cycle.

Smoother per level: 'gsrb' (kernel K5 on uniform levels, K7 on mapped
ones), 'jacobi', 'line' (vertical tridiagonal line relaxation, for strongly
anisotropic levels), or 'auto' (line where the metric's vertical coupling
dominates).  `solve(jgup_deltas=...)` solves with the altered metric of
implicit gravity: one delta per MG level, whose kernel weights each level
probes once per solve.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from somar_tpu_torch.core.bc import BC, BCType, FieldBCs
from somar_tpu_torch.core.grid import Grid
from somar_tpu_torch.geometry.level_geometry import (
    LevelGeometry, build_level_geometry)
from somar_tpu_torch.geometry.raw_geometry import (
    RawGeoSource, coarsen_raw_geometry)
from somar_tpu_torch.solvers.bicgstab import BiCGStabParams, bicgstab
from somar_tpu_torch.solvers.host_reads import read_scalars
from somar_tpu_torch.solvers.poisson_op import PoissonOp


# --------------------------------------------------------------------------
# anisotropic block transfer operators
# --------------------------------------------------------------------------
def restrict_fullweight(fine, grid_f: Grid, ratio: Sequence[int]):
    """Block average of a fine CC field onto the coarsened grid, one axis
    at a time.  ratio is per *logical* direction; array axes are
    vertical-major."""
    out = fine
    for ax in range(out.ndim):
        r = ratio[grid_f.dir_of_axis(ax)]
        if r == 1:
            continue
        shape = list(out.shape)
        shape[ax] = shape[ax] // r
        shape.insert(ax + 1, r)
        out = out.reshape(shape).mean(dim=ax + 1)
    return out


def prolong_linear_mg(coarse, grid_f: Grid, ratio: Sequence[int],
                      periodic: Sequence[bool]):
    """Unlimited piecewise-multilinear prolongation of an MG correction.

    One order higher than piecewise-constant injection: the coarse-grid
    correction no longer injects O(h) staircase error for the smoother to
    clean up.  Slopes are central in the interior, wrapped on periodic
    axes, one-sided at walls; no limiter (corrections are signed error
    fields)."""
    out = coarse
    for ax in range(coarse.ndim):
        d = grid_f.dir_of_axis(ax)
        r = ratio[d]
        if r == 1:
            continue
        n = out.shape[ax]

        def sl(a, b):
            return out.narrow(ax, a, b - a)

        if n < 2:
            s = torch.zeros_like(out)
        elif periodic[d]:
            s = 0.5 * (torch.roll(out, -1, dims=ax)
                       - torch.roll(out, 1, dims=ax))
        elif n == 2:
            s = torch.cat([sl(1, 2) - sl(0, 1)] * 2, dim=ax)
        else:
            s_int = 0.5 * (sl(2, n) - sl(0, n - 2))
            s = torch.cat(
                [sl(1, 2) - sl(0, 1), s_int, sl(n - 1, n) - sl(n - 2, n - 1)],
                dim=ax)
        offsets = (torch.arange(r, dtype=out.dtype, device=out.device)
                   + 0.5) / r - 0.5
        oshape = [1] * (out.ndim + 1)
        oshape[ax + 1] = r
        vals = out.unsqueeze(ax + 1) \
            + offsets.reshape(oshape) * s.unsqueeze(ax + 1)
        merged = list(out.shape)
        merged[ax] = merged[ax] * r
        out = vals.reshape(merged)
    return out


def prolong_const(coarse, grid_f: Grid, ratio: Sequence[int]):
    """Piecewise-constant injection of a coarse CC field onto the fine
    grid."""
    out = coarse
    for ax in range(coarse.ndim):
        r = ratio[grid_f.dir_of_axis(ax)]
        if r != 1:
            out = out.repeat_interleave(r, dim=ax)
    return out


def semicoarsening_schedule(grid: Grid,
                            max_depth: int = -1) -> List[Tuple[int, ...]]:
    """Per-MG-level coarsening ratios; schedule[k] coarsens MG level k to
    level k+1.  Directions with dx <= max(dx)/2 coarsen first (anisotropy
    equalization); once dx is balanced, coarsening is isotropic."""
    sched = []
    g = grid
    while max_depth < 0 or len(sched) < max_depth:
        dx = np.asarray(g.dx)
        maxdx = dx.max()
        ratio = []
        for d in range(g.ndim):
            wants = dx[d] <= maxdx / 2.0 + 1e-14 * maxdx
            can = g.nx[d] % 2 == 0 and g.nx[d] >= 4
            ratio.append(2 if (wants and can) else 1)
        if not any(r > 1 for r in ratio):
            # anisotropy equalized (or blocked): coarsen everything possible
            ratio = [2 if (g.nx[d] % 2 == 0 and g.nx[d] >= 4) else 1
                     for d in range(g.ndim)]
        if not any(r > 1 for r in ratio):
            break
        sched.append(tuple(ratio))
        g = g.coarsen(ratio)
    return sched


# --------------------------------------------------------------------------
# solver parameters (the AMRMG.* namespace)
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class MGParams:
    eps: float = 1e-6            # AMRMG.eps: relative residual tolerance
    imin: int = 2                # AMRMG.imin: min V-cycles
    imax: int = 20               # AMRMG.imax: max V-cycles
    hang: float = 1e-15          # AMRMG.hang: stall detection
    norm_thresh: float = 1e-30   # AMRMG.normThresh
    num_smooth_down: int = 4     # AMRMG.num_smooth_down
    num_smooth_up: int = 4       # AMRMG.num_smooth_up
    num_smooth_bottom: int = 16  # bottom-level smooth count
    num_mg: int = 1              # 1 = V-cycle, 2 = W-cycle
    max_depth: int = -1          # AMRMG.maxDepth
    #: "none" / "jacobi" / "gsrb" / "line" / "auto" (per-level choice: line
    #: where the metric's vertical coupling dominates, else gsrb)
    relax_mode: str = "auto"
    #: correction prolongation order: 1 = multilinear, 0 = piecewise constant
    prolong_order: int = 1
    verbosity: int = 0
    #: MG bottom solver: "bicgstab" or "smooth" (num_smooth_bottom sweeps
    #: only; adequate on isotropic Cartesian coarse levels)
    bottom_solver: str = "bicgstab"
    # preconditioning of the Krylov bottom solve: num_smooth_precond relax
    # sweeps in precond_mode (-1 none / 0 jacobi / 1 gsrb / 3 line)
    num_smooth_precond: int = 2
    precond_mode: int = 1
    bottom_eps: float = 1e-6     # bottom.eps
    bottom_imax: int = 80        # bottom.imax
    bottom_hang: float = 1e-8    # bottom.hang
    bottom_small: float = 1e-30  # bottom.small
    bottom_reps: float = 1e-12   # bottom.reps
    bottom_num_restarts: int = 5     # bottom.numRestarts
    bottom_norm_type: int = 2        # bottom.normType (0 max / 2 L2)
    bottom_verbosity: int = 0        # bottom.verbosity

    def bottom_params(self) -> BiCGStabParams:
        return BiCGStabParams(
            eps=self.bottom_eps, imax=self.bottom_imax,
            hang=self.bottom_hang, small=self.bottom_small,
            num_restarts=self.bottom_num_restarts,
            reps=self.bottom_reps, norm_type=self.bottom_norm_type)


class LevelMultigrid:
    """Single-level (no AMR) multigrid solver for one PoissonOp.

    Structural data (the grid/geometry hierarchy and its operators) is
    built once; alpha/beta are call-time operands, so a dt-dependent
    Helmholtz coefficient rebuilds nothing."""

    def __init__(self, geo: LevelGeometry, bcs: FieldBCs,
                 params: MGParams = MGParams(), dtype=torch.float32,
                 cf_coarse_dirichlet: bool = False):
        """cf_coarse_dirichlet: the coarse levels' correction equations
        take homogeneous Dirichlet at the face on the CF sides, where the
        finest level has its ghost data (a projection on a patch: with
        the ghost value held at each coarser ghost centre, the coarse
        corrections overshoot the smooth modes and the V-cycle can
        diverge, ROADMAP C.28)."""
        self.params = params
        self.dtype = dtype
        self.ratios = semicoarsening_schedule(geo.grid, params.max_depth)
        self.ops: List[PoissonOp] = [PoissonOp(geo, bcs)]
        cbcs = bcs
        if cf_coarse_dirichlet:
            pin = lambda b: BC.dirichlet(0.0) if b.type == BCType.CF else b
            cbcs = FieldBCs(lo=tuple(pin(b) for b in bcs.lo),
                            hi=tuple(pin(b) for b in bcs.hi))
        raw = isinstance(geo.geo, RawGeoSource)
        g, lg = geo.grid, geo
        for ratio in self.ratios:
            g = g.coarsen(ratio)
            # array-defined coefficients coarsen as arrays; a map's are
            # re-derived on the coarse grid
            lg = (coarsen_raw_geometry(lg, ratio) if raw else
                  build_level_geometry(g, geo.geo, device=geo.device,
                                       dtype=dtype))
            self.ops.append(PoissonOp(lg, cbcs))
        self.depth = len(self.ops)
        self.bcs_singular = self.ops[0].bcs_singular()
        self.modes = [self._level_mode(op) for op in self.ops]

    def _level_mode(self, op: PoissonOp) -> str:
        """Smoother for one MG level.  'auto' picks vertical line
        relaxation wherever the metric makes the vertical coupling dominate
        the strongest horizontal one by more than 4, cell by cell (the
        anisotropy that stalls point smoothers is local), else point GSRB
        (which rides kernel K5 or K7)."""
        mode = self.params.relax_mode
        if mode != "auto":
            return mode
        g = op.grid
        if g.ndim < 2:
            return "gsrb"
        dv = g.vertical_dir
        # cellwise coupling strength per direction: face coefficients
        # averaged to cells, over dx^2 (host numpy, once per level)
        coup = []
        for d in range(g.ndim):
            jg = op.geo.Jgup_diag[d]
            jg = (jg.detach().cpu().double().numpy()
                  if isinstance(jg, torch.Tensor) else float(jg)) \
                * np.ones(g.fc_shape(d))
            ax = g.axis(d)
            n = jg.shape[ax]
            cc = 0.5 * (np.take(jg, range(n - 1), axis=ax)
                        + np.take(jg, range(1, n), axis=ax))
            coup.append(cc / (g.dx[d] ** 2))
        horiz = np.maximum.reduce([c for d, c in enumerate(coup) if d != dv])
        anis = np.max(coup[dv] / np.maximum(horiz, 1e-300))
        return "line" if anis > 4.0 else "gsrb"

    # ------------------------------------------------------------- V-cycle
    def _vcycle(self, lev: int, phi, rhs, alpha, beta, singular: bool,
                deltas=None, overrides=None):
        op = self.ops[lev]
        p = self.params
        mode = self.modes[lev]
        jd = deltas[lev] if deltas is not None else None
        ov = overrides[lev] if overrides is not None else None
        if lev == self.depth - 1:
            return self._bottom_solve(op, phi, rhs, alpha, beta, singular,
                                      mode, jd, ov)

        phi = op.relax(phi, rhs, alpha, beta, p.num_smooth_down, mode,
                       jgup_delta=jd, delta_overrides=ov)
        res = op.residual(phi, rhs, alpha, beta, jgup_delta=jd,
                          delta_overrides=ov)
        ratio = self.ratios[lev]
        crhs = self._restrict_residual(lev, res, ratio)
        cphi = torch.zeros_like(crhs)
        for _ in range(max(1, p.num_mg)):   # num_mg=2 -> W-cycle
            cphi = self._vcycle(lev + 1, cphi, crhs, alpha, beta, singular,
                                deltas, overrides)
        if p.prolong_order >= 1:
            corr = prolong_linear_mg(cphi, op.grid, ratio, op.grid.periodic)
        else:
            corr = prolong_const(cphi, op.grid, ratio)
        if singular:
            corr = corr - torch.mean(corr)
        phi = phi + corr.to(phi.dtype)
        return op.relax(phi, rhs, alpha, beta, p.num_smooth_up, mode,
                        jgup_delta=jd, delta_overrides=ov)

    def _restrict_residual(self, lev: int, res, ratio):
        """Residual restriction: the J-weighted (volume-weighted) block
        average, which on uniform maps (scalar J) is plain full
        weighting."""
        op_f, op_c = self.ops[lev], self.ops[lev + 1]
        Jf, Jc = op_f.geo.J, op_c.geo.J
        if not isinstance(Jf, torch.Tensor) and \
                not isinstance(Jc, torch.Tensor):
            return restrict_fullweight(res, op_f.grid, ratio)
        return restrict_fullweight(Jf * res, op_f.grid, ratio) / Jc

    # -------------------------------------------------------- bottom solve
    def _bottom_solve(self, op: PoissonOp, phi, rhs, alpha, beta,
                      singular: bool, mode: str, jd=None, ov=None):
        """Coarsest-level solve.  Default: a few smooths then BiCGStab to
        bottom.eps, relax-preconditioned; smoothing-only bottoms stall MG
        where the coarsest operator is still strongly anisotropic."""
        p = self.params
        if p.bottom_solver != "bicgstab":
            return op.relax(phi, rhs, alpha, beta, p.num_smooth_bottom, mode,
                            jgup_delta=jd, delta_overrides=ov)
        # cheap pre-smooth knocks out the high-frequency component
        phi = op.relax(phi, rhs, alpha, beta, max(2, p.num_smooth_down),
                       mode, jgup_delta=jd, delta_overrides=ov)

        def A(x):
            return op.apply(x, alpha, beta, jgup_delta=jd)

        M = None
        if p.num_smooth_precond > 0 and p.precond_mode >= 0:
            pm = {0: "jacobi", 1: "gsrb", 3: "line"}.get(p.precond_mode, mode)
            if p.precond_mode == 1 and mode == "line":
                pm = "line"   # anisotropic level: precondition in kind

            def M(v):
                return op.relax(torch.zeros_like(v), v, alpha, beta,
                                p.num_smooth_precond, pm, jgup_delta=jd,
                                delta_overrides=ov)

        r = op.residual(phi, rhs, alpha, beta, jgup_delta=jd,
                        delta_overrides=ov)
        if singular:
            r = op.compat_project(r)
        e, (its, relres) = bicgstab(A, r, M=M, params=p.bottom_params())
        if p.bottom_verbosity >= 2:
            print(f"    MG bottom BiCGStab: {its} iters, relres {relres:.2e}")
        if singular:
            e = e - torch.mean(e)
        return phi + e

    # --------------------------------------------------------------- solve
    def solve(self, rhs, phi0=None, alpha=0.0, beta=1.0,
              homogeneous: bool = True, singular: Optional[bool] = None,
              jgup_deltas=None):
        """Iterate V-cycles until converged (imin/imax/eps/hang semantics).
        Returns (phi, info) where info = (iters, final_relative_residual),
        an int and a float.

        singular: default True iff the BCs admit a constant null space AND
        alpha is the float 0.0.
        With homogeneous=False, inhomogeneous BC values are folded into the
        RHS by linearity (L_inhom(phi) = L_hom(phi) + L_inhom(0)).
        jgup_deltas: per-MG-level altered-metric deltas (implicit gravity).
        """
        op = self.ops[0]
        p = self.params
        f32 = np.float32
        rhs = rhs.to(self.dtype)
        if singular is None:
            singular = self.bcs_singular and isinstance(alpha, float) \
                and alpha == 0.0
        jd0 = jgup_deltas[0] if jgup_deltas is not None else None
        # per-level kernel weights with the delta folded in, probed ONCE
        # here (loop-invariant across V-cycles); a level whose plan cannot
        # represent the delta gets None and takes the ghost-fill path
        overrides = None
        if jgup_deltas is not None:
            overrides = [o.delta_kernel_overrides(jd)
                         for o, jd in zip(self.ops, jgup_deltas)]
        ov0 = overrides[0] if overrides is not None else None
        if not homogeneous:
            rhs = rhs - op.apply(torch.zeros_like(rhs), alpha, beta,
                                 homogeneous=False, jgup_delta=jd0)
        if singular:
            rhs = op.compat_project(rhs)
        phi = torch.zeros_like(rhs) if phi0 is None else phi0.to(self.dtype)

        # Convergence reference: ||rhs||, NOT the initial-guess residual.
        # A warm start (the projectors chain the previous step's
        # potential) makes the guess residual tiny; eps relative to IT
        # would demand eps of an already-converged answer.  For phi0 = 0
        # the two references coincide (residual(0) = rhs).  r0 (the guess
        # residual) still seeds the hang/best-iterate tracking.
        r_ref, r0 = map(f32, read_scalars(
            op.norm(rhs), op.norm(op.residual(phi, rhs, alpha, beta,
                                              jgup_delta=jd0,
                                              delta_overrides=ov0))))
        r_ref = max(r_ref, f32(p.norm_thresh))
        r0 = max(r0, f32(p.norm_thresh))
        target = f32(p.eps) * r_ref

        # Best-iterate tracking: a Krylov bottom makes the per-cycle
        # residual non-monotone.  Stall means two consecutive cycles
        # without improving on the BEST residual, and the returned iterate
        # is the best one seen.  A warm start already below target skips
        # even the imin cycles.
        best, phi_best, stall, it = r0, phi, 0, 0
        while (it < p.imin or stall < 2) and it < p.imax and best > target:
            phi = self._vcycle(0, phi, rhs, alpha, beta, singular,
                               jgup_deltas, overrides)
            if singular:
                phi = phi - torch.mean(phi)
            rnew = f32(read_scalars(op.norm(op.residual(
                phi, rhs, alpha, beta, jgup_delta=jd0,
                delta_overrides=ov0)))[0])
            if p.verbosity >= 2:
                print(f"    MG V-cycle {it + 1}: |r|/|r0| = {rnew / r0:.3e}")
            if rnew < f32(1.0 - p.hang) * best:
                phi_best, stall = phi, 0
            else:
                stall += 1
            best = min(best, rnew)
            it += 1
        return phi_best, (it, float(best / r_ref))
