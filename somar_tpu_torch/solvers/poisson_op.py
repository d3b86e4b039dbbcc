"""The mapped-grid Helmholtz operator
L[phi] = alpha*phi + beta*(1/J) d_d (J g^{dj} d_j phi)  (PyTorch port of
`somar_tpu.solvers.poisson_op`).

This slice ports the operator application, the plain residual, the
BC-folded diagonal and the singular-operator helpers.  The relaxation
smoothers (and the GSRB kernels behind them) come with the multigrid
slice.
"""

from __future__ import annotations

import torch

from somar_tpu_torch.core.bc import BCType, FieldBCs
from somar_tpu_torch.geometry.level_geometry import LevelGeometry
from somar_tpu_torch.ops.stencil import mac_divergence, mac_gradient, slc


class PoissonOp:
    """alpha*I + beta*div(Jgup grad) on one level, with BCs baked in."""

    def __init__(self, geo: LevelGeometry, bcs: FieldBCs):
        self.geo = geo
        self.bcs = bcs
        self.hom_bcs = bcs.homogeneous()
        self.grid = geo.grid
        self._diag_lap = None   # built on first use (the spectral path skips it)

    def apply(self, phi, alpha=0.0, beta=1.0, homogeneous: bool = True):
        bcs = self.hom_bcs if homogeneous else self.bcs
        lap = mac_divergence(mac_gradient(phi, self.geo, bcs), self.geo)
        return alpha * phi + beta * lap

    def residual(self, phi, rhs, alpha=0.0, beta=1.0,
                 homogeneous: bool = True):
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

    def _build_diag_lap(self):
        """Laplacian diagonal with the BC ghost-formula effect on each
        boundary-face coupling."""
        grid, geo = self.grid, self.geo
        shape = grid.shape
        kw = dict(dtype=geo.dtype, device=geo.device)
        diag = torch.zeros(shape, **kw)
        for d in range(grid.ndim):
            ax = grid.axis(d)
            n = shape[ax]
            lo_f = torch.ones(shape, **kw)
            lo_f.select(ax, 0).fill_(self._bc_factor(self.bcs.lo[d]))
            hi_f = torch.ones(shape, **kw)
            hi_f.select(ax, n - 1).fill_(self._bc_factor(self.bcs.hi[d]))
            Jg = geo.Jgup_diag[d] * torch.ones(grid.fc_shape(d), **kw)
            lo = slc(Jg, ax, 0, -1)
            hi = slc(Jg, ax, 1, None)
            diag = diag - (lo * lo_f + hi * hi_f) / (grid.dx[d] ** 2)
        return geo.Jinv * diag

    def bcs_singular(self) -> bool:
        """True when the BCs admit the constant null space (all Neumann /
        periodic / extrap); the operator is then singular iff alpha == 0."""
        for d in range(self.grid.ndim):
            for bc in (self.bcs.lo[d], self.bcs.hi[d]):
                if bc.type == BCType.DIRICHLET:
                    return False
        return True
