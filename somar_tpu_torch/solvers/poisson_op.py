"""The mapped-grid Helmholtz operator
L[phi] = alpha*phi + beta*(1/J) d_d (J g^{dj} d_j phi)  (PyTorch port of
`somar_tpu.solvers.poisson_op`).

One operator object per (geometry, BCs): apply/residual are stencils on
ghost-filled arrays; relaxation is red-black Gauss-Seidel, damped Jacobi,
or vertical line relaxation via batched tridiagonal solves.  alpha and
beta are call-time operands (the viscous Helmholtz coefficient contains
dt); structural data (Laplacian diagonal, red-black masks, line
coefficients) is built on first use and kept.

The kernel gate, decided at construction on every device: when the level
qualifies for the uniform-metric kernels (uniform metric, two or more
dimensions, BCs that fold into boundary-face factors; ops/gsrb_kernels.py)
the operator holds a `FusedPlan` and the homogeneous `residual` and
`relax_gsrb` go through K5-K6; otherwise, when the operator's probed 3^nd
stencil exists and reproduces it (ops/stencil_gsrb_kernels.py), it holds a
`StencilPlan` and they go through K7-K8 (the plain twins for CPU tensors).
A level with neither plan computes the same quantities from ghost fills.

`jgup_delta` is the altered metric of implicit gravity (an additive
per-face modification of J g^ij, projection/altered_metric.py).  Its solves
pass `delta_overrides`, the stencil weights with the delta folded in
(`delta_kernel_overrides`, probed once per solve), so they stay on K7-K8;
without overrides a delta takes the ghost-fill path.
"""

from __future__ import annotations

import torch

from somar_tpu_torch.core.bc import BCType, FieldBCs
from somar_tpu_torch.geometry.level_geometry import LevelGeometry
from somar_tpu_torch.ops import gsrb_kernels
from somar_tpu_torch.ops import stencil_gsrb_kernels as sgk
from somar_tpu_torch.ops.stencil import mac_divergence, mac_gradient, slc
from somar_tpu_torch.solvers.tridiag import pcr_apply, pcr_factor


class PoissonOp:
    """alpha*I + beta*div(Jgup grad) on one level, with BCs baked in."""

    def __init__(self, geo: LevelGeometry, bcs: FieldBCs):
        self.geo = geo
        self.bcs = bcs
        self.hom_bcs = bcs.homogeneous()
        self.grid = geo.grid
        # structural arrays, built on first use (the spectral path and the
        # kernel path need none of them)
        self._diag_lap = None
        self._bc_face_factors = None
        self._rb_masks = None
        self._line_coefs = None
        #: (key, pcr_factor) of the last line relaxation's matrix
        self._line_factor = (None, None)
        self._fused_plan = gsrb_kernels.make_plan(self.grid, self.hom_bcs,
                                                  geo)
        self._stencil_plan = (sgk.build_stencil_plan(self)
                              if self._fused_plan is None else None)

    # ------------------------------------------------------------ operator
    def apply(self, phi, alpha=0.0, beta=1.0, homogeneous: bool = True,
              jgup_delta=None):
        bcs = self.hom_bcs if homogeneous else self.bcs
        lap = mac_divergence(
            mac_gradient(phi, self.geo, bcs, jgup_delta=jgup_delta),
            self.geo)
        return alpha * phi + beta * lap

    def residual(self, phi, rhs, alpha=0.0, beta=1.0,
                 homogeneous: bool = True, jgup_delta=None,
                 delta_overrides=None):
        if homogeneous and jgup_delta is None:
            if self._fused_plan is not None:
                return gsrb_kernels.helm_residual(self._fused_plan, phi, rhs,
                                                  alpha, beta)
            if self._stencil_plan is not None:
                return sgk.stencil_helm_residual(self._stencil_plan, phi,
                                                 rhs, alpha, beta)
        if homogeneous and delta_overrides is not None \
                and self._stencil_plan is not None:
            Wn, R, _ = delta_overrides
            return sgk.stencil_helm_residual(self._stencil_plan, phi, rhs,
                                             alpha, beta, Wn=Wn, R=R)
        return rhs - self.apply(phi, alpha, beta, homogeneous, jgup_delta)

    def delta_kernel_overrides(self, jgup_delta):
        """(Wn, R, w0) operands of K7-K8 with jgup_delta folded in, or None
        when the level has no stencil plan or the plan's offsets may not
        cover the delta's support.  Costs 2 * (ncolours + 1) operator
        applications: once per solve, never per relax call."""
        if jgup_delta is None or self._stencil_plan is None:
            return None
        plan = self._stencil_plan
        got = sgk.delta_stencil_weights(plan, self, jgup_delta)
        if got is None:
            return None
        dWn, dR = got
        w0 = self.diag(0.0, 1.0, jgup_delta) * torch.ones_like(plan.R)
        return plan.Wn + dWn, plan.R + dR, w0

    def compat_project(self, rhs):
        """Remove the rhs component outside the singular (pure-Neumann)
        operator's range: the J-weighted mean."""
        J = self.geo.J * torch.ones_like(rhs)
        return rhs - torch.sum(J * rhs) / torch.sum(J)

    def diag(self, alpha=0.0, beta=1.0, jgup_delta=None):
        if self._diag_lap is None:
            self._diag_lap = self._diag_lap_of(self.geo.Jgup_diag)
        d = self._diag_lap
        if jgup_delta is not None and jgup_delta[0] is not None:
            d = d + self._diag_lap_of(jgup_delta[0])
        return alpha + beta * d

    # ------------------------------------------------------------ diagonal
    @staticmethod
    def _bc_factor(bc):
        """Boundary-face coupling multiplier from the ghost formula."""
        if bc.type == BCType.DIRICHLET:
            return 2.0
        if bc.type == BCType.NEUMANN:
            return 0.0
        if bc.type in (BCType.PERIODIC, BCType.CF):
            return 1.0
        return 0.0  # extrap ~ one-sided; treat as Neumann for the diag

    def _build_bc_face_factors(self):
        """Per-direction (lo_factor, hi_factor) CC fields encoding the BC
        ghost-formula effect on the boundary-face coupling."""
        grid, geo = self.grid, self.geo
        shape = grid.shape
        kw = dict(dtype=geo.dtype, device=geo.device)
        out = []
        for d in range(grid.ndim):
            ax = grid.axis(d)
            lo_f = torch.ones(shape, **kw)
            lo_f.select(ax, 0).fill_(self._bc_factor(self.bcs.lo[d]))
            hi_f = torch.ones(shape, **kw)
            hi_f.select(ax, shape[ax] - 1).fill_(
                self._bc_factor(self.bcs.hi[d]))
            out.append((lo_f, hi_f))
        return out

    def _diag_lap_of(self, jgup_diag_per_d):
        """Laplacian diagonal of the given per-direction face coefficients
        (None skips a direction), with the BC ghost-formula effect on each
        boundary-face coupling."""
        grid, geo = self.grid, self.geo
        shape = grid.shape
        kw = dict(dtype=geo.dtype, device=geo.device)
        if self._bc_face_factors is None:
            self._bc_face_factors = self._build_bc_face_factors()
        diag = torch.zeros(shape, **kw)
        for d in range(grid.ndim):
            if jgup_diag_per_d[d] is None:
                continue
            ax = grid.axis(d)
            lo_f, hi_f = self._bc_face_factors[d]
            Jg = jgup_diag_per_d[d] * torch.ones(grid.fc_shape(d), **kw)
            lo = slc(Jg, ax, 0, -1)
            hi = slc(Jg, ax, 1, None)
            diag = diag - (lo * lo_f + hi * hi_f) / (grid.dx[d] ** 2)
        return geo.Jinv * diag

    # ---------------------------------------------------------- relaxation
    def _build_rb_masks(self):
        shape = self.grid.shape
        nd = len(shape)
        parity = torch.zeros(shape, dtype=torch.int32, device=self.geo.device)
        for ax, n in enumerate(shape):
            view = [1] * nd
            view[ax] = n
            parity = parity + torch.arange(
                n, dtype=torch.int32, device=self.geo.device).reshape(view)
        red = (parity % 2) == 0
        return red, ~red

    def _masks(self):
        if self._rb_masks is None:
            self._rb_masks = self._build_rb_masks()
        return self._rb_masks

    def relax_jacobi(self, phi, rhs, alpha, beta, iters: int,
                     weight: float = 0.6, jgup_delta=None):
        inv_diag = weight / self.diag(alpha, beta, jgup_delta)
        for _ in range(iters):
            phi = phi + inv_diag * self.residual(phi, rhs, alpha, beta,
                                                 jgup_delta=jgup_delta)
        return phi

    def relax_gsrb(self, phi, rhs, alpha, beta, iters: int,
                   weight: float = 1.0, jgup_delta=None,
                   delta_overrides=None):
        """Red-black Gauss-Seidel with exact BC-folded coefficients at
        every cell: kernel K5 or K7 where the level has a plan (K7 with the
        delta's overrides under an altered metric), else half sweeps of
        the ghost-fill residual under the checkerboard masks."""
        if jgup_delta is None:
            if self._fused_plan is not None:
                return gsrb_kernels.gsrb_sweeps(self._fused_plan, phi, rhs,
                                                alpha, beta, iters, weight)
            if self._stencil_plan is not None:
                return sgk.stencil_gsrb_sweeps(self._stencil_plan, phi, rhs,
                                               alpha, beta, iters, weight)
        if delta_overrides is not None and self._stencil_plan is not None:
            Wn, R, w0 = delta_overrides
            return sgk.stencil_gsrb_sweeps(self._stencil_plan, phi, rhs,
                                           alpha, beta, iters, weight,
                                           Wn=Wn, R=R, w0=w0)
        red, black = self._masks()
        inv_diag = weight / self.diag(alpha, beta, jgup_delta)
        for _ in range(iters):
            for mask in (red, black):
                r = self.residual(phi, rhs, alpha, beta,
                                  jgup_delta=jgup_delta)
                phi = torch.where(mask, phi + inv_diag * r, phi)
        return phi

    def _line_coupling(self, jgup_vert):
        """Vertical tridiagonal couplings (A_lo, A_hi) of the face
        coefficients jgup_vert, scaled by Jinv/dz^2, edge rows zeroed."""
        grid, geo = self.grid, self.geo
        dz = grid.dx[grid.vertical_dir]
        nz = grid.shape[0]
        Jg = jgup_vert * torch.ones(grid.fc_shape(grid.vertical_dir),
                                    dtype=geo.dtype, device=geo.device)
        scale = geo.Jinv / (dz * dz)
        a = (slc(Jg, 0, 0, -1) * scale).clone()
        a[0] = 0.0
        c = (slc(Jg, 0, 1, None) * scale).clone()
        c[nz - 1] = 0.0
        return a, c

    def _vertical_line_parts(self):
        if self._line_coefs is None:
            self._line_coefs = self._line_coupling(
                self.geo.Jgup_diag[self.grid.vertical_dir])
        return self._line_coefs

    def relax_line_vertical(self, phi, rhs, alpha, beta, iters: int,
                            jgup_delta=None):
        """Vertical line relaxation: exact tridiagonal solve along z per
        column with horizontal terms lagged.  The line-block diagonal is
        the FULL operator diagonal: dropping the horizontal self-coupling
        makes line-constant modes diverge.  The solve is parallel cyclic
        reduction (the system is diagonally dominant): log2 nz steps of
        whole-level operations, where the Thomas loop over the planes
        took 2 nz launch-bound steps; its matrix part is kept for the
        last (alpha, beta) of plain Python floats."""
        b = self.diag(alpha, beta, jgup_delta) * torch.ones_like(phi)
        key = ((float(alpha), float(beta))
               if jgup_delta is None and isinstance(alpha, (int, float))
               and isinstance(beta, (int, float)) else None)
        if key is not None and self._line_factor[0] == key:
            factor = self._line_factor[1]
        else:
            a_s, c_s = self._vertical_line_parts()
            a = beta * a_s
            c = beta * c_s
            if jgup_delta is not None and jgup_delta[0] is not None:
                dd = jgup_delta[0][self.grid.vertical_dir]
                if dd is not None:
                    da, dc = self._line_coupling(dd)
                    a = a + beta * da
                    c = c + beta * dc
            factor = pcr_factor(a, b, c)
            if key is not None:
                self._line_factor = (key, factor)
        red, black = self._masks()
        inv_diag = 1.0 / b
        for _ in range(iters):
            # the line solve kills vertical error; the GSRB sweep smooths
            # the horizontal high frequencies the line solve cannot
            r = self.residual(phi, rhs, alpha, beta, jgup_delta=jgup_delta)
            phi = phi + pcr_apply(factor, r)
            for mask in (red, black):
                r = self.residual(phi, rhs, alpha, beta,
                                  jgup_delta=jgup_delta)
                phi = torch.where(mask, phi + inv_diag * r, phi)
        return phi

    def relax(self, phi, rhs, alpha, beta, iters: int, mode: str = "gsrb",
              jgup_delta=None, delta_overrides=None):
        if mode == "jacobi":
            return self.relax_jacobi(phi, rhs, alpha, beta, iters,
                                     jgup_delta=jgup_delta)
        if mode == "gsrb":
            return self.relax_gsrb(phi, rhs, alpha, beta, iters,
                                   jgup_delta=jgup_delta,
                                   delta_overrides=delta_overrides)
        if mode == "line":
            return self.relax_line_vertical(phi, rhs, alpha, beta, iters,
                                            jgup_delta=jgup_delta)
        if mode == "none":
            return phi
        raise ValueError(f"unknown relax mode {mode}")

    # ---------------------------------------------------------------- misc
    @staticmethod
    def norm(r, p: int = 2):
        """Max norm (p = 0) or root mean square, the latter accumulated in
        float32 whatever the dtype of r (a 0-d tensor)."""
        if p == 0:
            return torch.max(torch.abs(r))
        return torch.sqrt(torch.mean(r.to(torch.float32) ** 2))

    def bcs_singular(self) -> bool:
        """True when the BCs admit the constant null space (all Neumann /
        periodic / extrap); the operator is then singular iff alpha == 0.
        A CF side (given ghost values, zero when homogeneous) pins the
        potential as a Dirichlet side does, as in FFTPoissonSolver: a
        patch's projection solved as singular would lose the mean of its
        answer every V-cycle and stall at a residual of a few percent
        (ROADMAP C.28)."""
        for d in range(self.grid.ndim):
            for bc in (self.bcs.lo[d], self.bcs.hi[d]):
                if bc.type in (BCType.DIRICHLET, BCType.CF):
                    return False
        return True
