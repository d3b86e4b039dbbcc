"""The leptic solver: a perturbative vertical-line plus horizontal-
multigrid Poisson iteration for very flat (leptic) domains (PyTorch port
of `somar_tpu.solvers.leptic`).

On domains whose depth H is small against the horizontal cell size dx_h,
the expansion parameter eps_leptic = (H / dx_h)^2 < 1 and
phi = sum_k phi^(k).  Each order couples per-column vertical two-point
problems (Neumann data) to a (D-1)-dimensional horizontal Poisson
problem for the column-incompatible part:

  repeat:
    r = rhs - L phi
    phi += vertical NN line solves of d_z(Jg^zz d_z .) = J (r - excess),
           excess(x_h) = (integral_z J r dz) / (integral_z J dz)
    r = rhs - L phi
    phi += extrude(horizontal MG solve of C phi_h = integral_z J r dz)
  until converged, max_order, or no longer reducing the residual,
  with C = integral_z Jg^hh dz.

Each sweep is accepted only if it lowers the residual norm (the choice is
made on the device).  The vertical pass is one batched tridiagonal solve
over all columns (solvers/tridiag.thomas_solve); the horizontal pass is a
multigrid on the flattened raw geometry (geometry/raw_geometry.py), whose
levels take the probed-stencil kernels K7-K8 in 2D.  The loop over orders
is a Python loop that reads one scalar an order (solvers/host_reads.py).
Outside its regime the expansion stops reducing the residual (HANG) and
`solve_with_fallback` finishes with a line-relaxed multigrid on the full
operator.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from somar_tpu_torch.core.bc import FieldBCs
from somar_tpu_torch.geometry.level_geometry import LevelGeometry
from somar_tpu_torch.geometry.raw_geometry import raw_level_geometry
from somar_tpu_torch.ops.stencil import slc
from somar_tpu_torch.solvers.host_reads import read_scalars
from somar_tpu_torch.solvers.multigrid import LevelMultigrid, MGParams
from somar_tpu_torch.solvers.poisson_op import PoissonOp
from somar_tpu_torch.solvers.tridiag import thomas_solve
from somar_tpu_torch.utils.subspace import extrude, flatten_grid


class LepticStatus:
    NONE = 0
    CONVERGED = 1
    ITER = 2
    HANG = 3
    DIVERGE = 4
    KABOOM = 5


@dataclasses.dataclass(frozen=True)
class LepticParams:
    max_order: int = 8          # max vertical/horizontal sweep pairs
    eps: float = 1e-6           # relative residual target
    hang: float = 1e-2          # reduction-per-order below this = hang
    horiz_rhs_tol: float = 1e-12  # skip horizontal solve below this
    horiz_mg: MGParams = MGParams(eps=1e-2, imin=1, imax=4,
                                  num_smooth_down=2, num_smooth_up=2)


class LevelLepticSolver:
    """Single-level leptic iteration for L phi = rhs with Neumann or
    periodic BCs (the pressure-projection problem on flat domains)."""

    def __init__(self, geo: LevelGeometry, bcs: FieldBCs,
                 params: LepticParams = LepticParams(), dtype=torch.float32):
        self.geo = geo
        self.bcs = bcs
        self.params = params
        self.dtype = dtype
        grid = geo.grid
        self.grid = grid
        vert = grid.vertical_dir
        if grid.axis(vert) != 0:
            raise ValueError("the leptic solver needs the vertical on "
                             "array axis 0")
        self.op = PoissonOp(geo, bcs)
        kw = dict(dtype=dtype, device=geo.device)

        # vertical line coefficients: Jg^zz at z-faces, per column
        Jg = geo.Jgup_diag[vert] * torch.ones(grid.fc_shape(vert), **kw)
        A_lo = slc(Jg, 0, 0, -1)
        A_hi = slc(Jg, 0, 1, None)
        self._Jcc = geo.J * torch.ones(grid.shape, **kw)
        self._dz = grid.dx[vert]

        # flattened horizontal geometry: C^hh = integral_z Jg^hh dz
        hgrid = flatten_grid(grid)
        h_coefs = [torch.sum(geo.Jgup_diag[d]
                             * torch.ones(grid.fc_shape(d), **kw), dim=0)
                   * self._dz
                   for d in range(grid.ndim) if d != vert]
        J_h = torch.sum(self._Jcc, dim=0) * self._dz
        hgeo = raw_level_geometry(hgrid, J_h, h_coefs, device=geo.device,
                                  dtype=dtype)
        h_bcs = FieldBCs(
            lo=tuple(bcs.lo[d] for d in range(grid.ndim) if d != vert),
            hi=tuple(bcs.hi[d] for d in range(grid.ndim) if d != vert))
        self.h_mg = LevelMultigrid(hgeo, h_bcs, params=params.horiz_mg,
                                   dtype=dtype)
        self._h_singular = self.h_mg.ops[0].bcs_singular()

        # vertical tridiagonal rows (times J r on the rhs); the top cell of
        # each column is pinned (a singular NN line), the column mean is
        # re-gauged after the solve
        dz2 = self._dz * self._dz
        nz = grid.shape[0]
        a = (A_lo / dz2).clone()
        c = (A_hi / dz2).clone()
        a[0] = 0.0
        c[nz - 1] = 0.0
        b = -(a + c)
        c[0] = 0.0
        b[0] = 1.0
        self._tri = (a, b, c)
        self._fallback_mg = None    # built on first use

    # ------------------------------------------------------------ pieces
    def _vertical_sweep(self, r):
        """One batch of NN vertical line solves of d_z(A d_z x) = J rc,
        rc = r - excess (the column-compatible part)."""
        Jr = self._Jcc * r
        excess = torch.sum(Jr, dim=0) / torch.sum(self._Jcc, dim=0)
        rhs = Jr - self._Jcc * excess.unsqueeze(0)
        rhs[0] = 0.0                                 # pinned row
        x = thomas_solve(*self._tri, rhs)
        return x - torch.mean(x, dim=0, keepdim=True)

    def _horizontal_sweep(self, r):
        """Flattened horizontal MG solve of C phi_h = integral J r dz (the
        flattened operator divides by J_h)."""
        rhs_h = torch.sum(self._Jcc * r, dim=0) * self._dz
        rhs_h = rhs_h / (torch.sum(self._Jcc, dim=0) * self._dz)
        phi_h, _ = self.h_mg.solve(rhs_h, singular=self._h_singular)
        return extrude(phi_h, self.grid.shape[0])

    # ------------------------------------------------------------- solve
    def solve(self, rhs, phi0=None):
        """Returns (phi, (orders_used, relres, status)): an int, a float
        and a LepticStatus value."""
        p = self.params
        f32 = np.float32
        rhs = rhs.to(self.dtype)
        singular = self.op.bcs_singular()
        if singular:
            rhs = self.op.compat_project(rhs)
        phi = torch.zeros_like(rhs) if phi0 is None else phi0.to(self.dtype)

        r0_t = torch.clamp_min(self.op.norm(self.op.residual(phi, rhs)),
                               1e-30)
        r0 = f32(read_scalars(r0_t)[0])

        def accept(phi, rnorm, cand):
            """Keep the candidate only if it lowers the residual norm: a
            sweep outside the expansion's regime can overshoot, and the
            fallback starts from the best iterate."""
            if singular:
                cand = cand - torch.mean(cand)
            rcand = self.op.norm(self.op.residual(cand, rhs))
            better = rcand < rnorm
            return torch.where(better, cand, phi), torch.where(better, rcand,
                                                               rnorm)

        rnorm_t, rnorm, rprev, it = r0_t, r0, f32(2.0) * r0, 0
        while (it < p.max_order and rnorm > f32(p.eps) * r0
               and rnorm < f32(1.0 - p.hang) * rprev):
            r = self.op.residual(phi, rhs)
            phi, rnorm_t = accept(phi, rnorm_t, phi + self._vertical_sweep(r))
            r = self.op.residual(phi, rhs)
            phi, rnorm_t = accept(phi, rnorm_t,
                                  phi + self._horizontal_sweep(r))
            rprev, rnorm = rnorm, f32(read_scalars(rnorm_t)[0])
            it += 1

        if rnorm <= f32(p.eps) * r0:
            status = LepticStatus.CONVERGED
        elif it >= p.max_order:
            status = LepticStatus.ITER
        elif rnorm > f32(2.0) * r0:
            status = LepticStatus.DIVERGE
        else:
            status = LepticStatus.HANG
        return phi, (it, float(rnorm / r0), status)

    @property
    def fallback_mg(self) -> LevelMultigrid:
        """Line-relaxed semicoarsening MG on the same operator: the
        finisher when the expansion hangs or diverges."""
        if self._fallback_mg is None:
            self._fallback_mg = LevelMultigrid(
                self.geo, self.bcs,
                params=dataclasses.replace(self.params.horiz_mg,
                                           eps=self.params.eps, imax=20,
                                           num_smooth_down=4,
                                           num_smooth_up=4,
                                           relax_mode="line"),
                dtype=self.dtype)
        return self._fallback_mg

    def solve_with_fallback(self, rhs, phi0=None):
        """Leptic first; finish with the line-relaxed MG where the leptic
        attempt did not reach eps.  Returns (phi, (orders, relres,
        status)) with relres the true residual of the returned phi,
        ||rhs - L phi|| / ||rhs||."""
        phi, (iters, relres, status) = self.solve(rhs, phi0)
        rhs = rhs.to(self.dtype)
        singular = self.op.bcs_singular()
        if singular:
            rhs = self.op.compat_project(rhs)
        if relres > self.params.eps:
            phi, _ = self.fallback_mg.solve(rhs, phi0=phi, singular=singular)
        rnorm = torch.linalg.vector_norm(rhs)
        rel_out = torch.linalg.vector_norm(rhs - self.op.apply(phi)) \
            / torch.clamp_min(rnorm, 1e-30)
        return phi, (iters, read_scalars(rel_out)[0], status)
