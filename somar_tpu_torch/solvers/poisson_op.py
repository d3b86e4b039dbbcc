"""The mapped-grid Helmholtz operator
L[phi] = alpha*phi + beta*(1/J) d_d (J g^{dj} d_j phi)  (PyTorch port of
`somar_tpu.solvers.poisson_op`).

One operator object per (geometry, BCs): apply/residual are stencils on
ghost-filled arrays; relaxation is red-black Gauss-Seidel, damped Jacobi,
or vertical line relaxation via batched tridiagonal solves.  alpha and
beta are call-time operands (the viscous Helmholtz coefficient contains
dt); structural data (Laplacian diagonal, red-black masks, line
coefficients) is built on first use and kept.

The kernel gate: when the level qualifies (uniform metric, two or more
dimensions, BCs that fold into boundary-face factors; see
ops/gsrb_kernels.py) the operator holds a `FusedPlan`, and the homogeneous
`residual` and `relax_gsrb` go through the GSRB kernels K5-K6 (their plain
twins for CPU tensors).  The gate is static, decided at construction: a
level without a plan computes the same quantities from ghost fills.  The
altered metric of implicit gravity (`jgup_delta`) and the probed-stencil
kernels of mapped metrics come with slice 3 (ROADMAP).
"""

from __future__ import annotations

import torch

from somar_tpu_torch.core.bc import BCType, FieldBCs
from somar_tpu_torch.geometry.level_geometry import LevelGeometry
from somar_tpu_torch.ops import gsrb_kernels
from somar_tpu_torch.ops.stencil import mac_divergence, mac_gradient, slc
from somar_tpu_torch.solvers.tridiag import thomas_solve


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
        self._rb_masks = None
        self._line_coefs = None
        self._fused_plan = gsrb_kernels.make_plan(self.grid, self.hom_bcs,
                                                  geo)

    # ------------------------------------------------------------ operator
    def apply(self, phi, alpha=0.0, beta=1.0, homogeneous: bool = True):
        bcs = self.hom_bcs if homogeneous else self.bcs
        lap = mac_divergence(mac_gradient(phi, self.geo, bcs), self.geo)
        return alpha * phi + beta * lap

    def residual(self, phi, rhs, alpha=0.0, beta=1.0,
                 homogeneous: bool = True):
        if homogeneous and self._fused_plan is not None:
            return gsrb_kernels.helm_residual(self._fused_plan, phi, rhs,
                                              alpha, beta)
        return rhs - self.apply(phi, alpha, beta, homogeneous)

    def compat_project(self, rhs):
        """Remove the rhs component outside the singular (pure-Neumann)
        operator's range: the J-weighted mean."""
        J = self.geo.J * torch.ones_like(rhs)
        return rhs - torch.sum(J * rhs) / torch.sum(J)

    def diag(self, alpha=0.0, beta=1.0):
        if self._diag_lap is None:
            self._diag_lap = self._build_diag_lap()
        return alpha + beta * self._diag_lap

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

    def _build_diag_lap(self):
        """Laplacian diagonal with the BC ghost-formula effect on each
        boundary-face coupling."""
        grid, geo = self.grid, self.geo
        shape = grid.shape
        kw = dict(dtype=geo.dtype, device=geo.device)
        factors = self._build_bc_face_factors()
        diag = torch.zeros(shape, **kw)
        for d in range(grid.ndim):
            ax = grid.axis(d)
            lo_f, hi_f = factors[d]
            Jg = geo.Jgup_diag[d] * torch.ones(grid.fc_shape(d), **kw)
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
                     weight: float = 0.6):
        inv_diag = weight / self.diag(alpha, beta)
        for _ in range(iters):
            phi = phi + inv_diag * self.residual(phi, rhs, alpha, beta)
        return phi

    def relax_gsrb(self, phi, rhs, alpha, beta, iters: int,
                   weight: float = 1.0):
        """Red-black Gauss-Seidel with exact BC-folded coefficients at
        every cell: kernel K5 where the level has a plan, else half sweeps
        of the ghost-fill residual under the checkerboard masks."""
        if self._fused_plan is not None:
            return gsrb_kernels.gsrb_sweeps(self._fused_plan, phi, rhs,
                                            alpha, beta, iters, weight)
        red, black = self._masks()
        inv_diag = weight / self.diag(alpha, beta)
        for _ in range(iters):
            for mask in (red, black):
                r = self.residual(phi, rhs, alpha, beta)
                phi = torch.where(mask, phi + inv_diag * r, phi)
        return phi

    def _build_vertical_line_parts(self):
        """Static vertical tridiagonal structure: (A_lo, A_hi) face coefs
        scaled by Jinv/dz^2, edge rows zeroed."""
        grid, geo = self.grid, self.geo
        dvert = grid.vertical_dir
        dz = grid.dx[dvert]
        nz = grid.shape[0]
        Jg = geo.Jgup_diag[dvert] * torch.ones(
            grid.fc_shape(dvert), dtype=geo.dtype, device=geo.device)
        scale = geo.Jinv / (dz * dz)
        a = (slc(Jg, 0, 0, -1) * scale).clone()
        a[0] = 0.0
        c = (slc(Jg, 0, 1, None) * scale).clone()
        c[nz - 1] = 0.0
        return a, c

    def _vertical_line_parts(self):
        if self._line_coefs is None:
            self._line_coefs = self._build_vertical_line_parts()
        return self._line_coefs

    def relax_line_vertical(self, phi, rhs, alpha, beta, iters: int):
        """Vertical line relaxation: exact tridiagonal solve along z per
        column with horizontal terms lagged.  The line-block diagonal is
        the FULL operator diagonal: dropping the horizontal self-coupling
        makes line-constant modes diverge."""
        a_s, c_s = self._vertical_line_parts()
        a = beta * a_s
        c = beta * c_s
        b = self.diag(alpha, beta) * torch.ones_like(phi)
        red, black = self._masks()
        inv_diag = 1.0 / b
        for _ in range(iters):
            # the line solve kills vertical error; the GSRB sweep smooths
            # the horizontal high frequencies the line solve cannot
            r = self.residual(phi, rhs, alpha, beta)
            phi = phi + thomas_solve(a, b, c, r)
            for mask in (red, black):
                r = self.residual(phi, rhs, alpha, beta)
                phi = torch.where(mask, phi + inv_diag * r, phi)
        return phi

    def relax(self, phi, rhs, alpha, beta, iters: int, mode: str = "gsrb"):
        if mode == "jacobi":
            return self.relax_jacobi(phi, rhs, alpha, beta, iters)
        if mode == "gsrb":
            return self.relax_gsrb(phi, rhs, alpha, beta, iters)
        if mode == "line":
            return self.relax_line_vertical(phi, rhs, alpha, beta, iters)
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
        periodic / extrap); the operator is then singular iff alpha == 0."""
        for d in range(self.grid.ndim):
            for bc in (self.bcs.lo[d], self.bcs.hi[d]):
                if bc.type == BCType.DIRICHLET:
                    return False
        return True
