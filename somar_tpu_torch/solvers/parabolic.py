"""Implicit viscous/diffusive integrators: Backward Euler, Crank-Nicolson,
TGA (PyTorch port of `somar_tpu.solvers.parabolic`).

Each scheme advances  ds/dt = kappa * L s + S  one step by one or two
Helmholtz solves  (I - c*dt*kappa*L) s_new = rhs.  On uniform grids with
homogeneous BCs every factor of each scheme is diagonal in the
FFTPoissonSolver eigenbasis, so an update is one forward and one inverse
transform; elsewhere (e.g. inhomogeneous Dirichlet values) each solve is a
LevelMultigrid Helmholtz solve, warm-started from the old field.
"""

from __future__ import annotations

import math

import torch

from somar_tpu_torch.core.bc import FieldBCs
from somar_tpu_torch.geometry.level_geometry import LevelGeometry
from somar_tpu_torch.solvers.fft_poisson import FFTPoissonSolver, axis_transform
from somar_tpu_torch.solvers.multigrid import LevelMultigrid, MGParams
from somar_tpu_torch.solvers.poisson_op import PoissonOp


class BaseHeatSolver:
    """Shared machinery: Helmholtz solves (I - c*dt*kappa*L) s = rhs,
    spectral where the BCs and the metric allow it, else multigrid.  One
    MG hierarchy serves every coefficient: alpha/beta are call-time
    operands of LevelMultigrid.solve."""

    def __init__(self, geo: LevelGeometry, bcs: FieldBCs, kappa: float,
                 mg_params: MGParams = MGParams(), dtype=torch.float32):
        self.geo = geo
        self.bcs = bcs
        self.kappa = float(kappa)
        self._mg_params = mg_params
        self._dtype = dtype
        self._mg = None      # built lazily (the spectral path skips it)
        self._op = PoissonOp(geo, bcs)
        self._fft = (FFTPoissonSolver(geo, bcs, dtype)
                     if FFTPoissonSolver.supports(geo, bcs) else None)

    @property
    def mg(self) -> LevelMultigrid:
        if self._mg is None:
            self._mg = LevelMultigrid(self.geo, self.bcs,
                                      params=self._mg_params,
                                      dtype=self._dtype)
        return self._mg

    def _helmholtz_solve(self, rhs, coef, dt, phi0):
        """Solve (I - coef*dt*kappa*L) out = rhs; returns (out, info)."""
        beta = -coef * dt * self.kappa
        if self._fft is not None:
            return self._fft.solve(rhs, alpha=1.0, beta=beta), (1, 0.0)
        return self.mg.solve(rhs, phi0=phi0, alpha=1.0, beta=beta,
                             homogeneous=False, singular=False)

    def _apply_lap(self, s, homogeneous=False):
        return self._op.apply(s, 0.0, 1.0, homogeneous=homogeneous)


class BackwardEuler(BaseHeatSolver):
    """(I - dt kappa L) s^{n+1} = s^n + dt S."""

    def update(self, s, src, dt):
        rhs = s + dt * src if src is not None else s
        return self._helmholtz_solve(rhs, 1.0, dt, s)


class CrankNicolson(BaseHeatSolver):
    """(I - dt/2 kappa L) s^{n+1} = (I + dt/2 kappa L) s^n + dt S; on the
    spectral path one forward + one inverse transform round-trip."""

    def update(self, s, src, dt):
        if self._fft is not None:
            f = self._fft
            h = 0.5 * dt * self.kappa
            num = (1.0 + h * f.lam) * f.fwd(s)
            if src is not None:
                num = num + dt * f.fwd(src)
            return f.inv(num / (1.0 - h * f.lam)), (1, 0.0)
        half = 0.5 * dt * self.kappa
        rhs = s + half * self._apply_lap(s)
        if src is not None:
            rhs = rhs + dt * src
        return self._helmholtz_solve(rhs, 0.5, dt, s)


class TGA(BaseHeatSolver):
    """Twizell-Gumel-Arigu 2nd-order L0-stable two-stage scheme.

    With a = 2 - sqrt(2) - eps and discr = sqrt(a^2 - 4a + 2):

        u^{n+1} = (I - mu1 k dt L)^{-1} (I - mu2 k dt L)^{-1}
                  [ (I + mu3 k dt L) u^n  +  dt (I + mu4 k dt L) S ]

        mu1 = (a - discr)/2,  mu2 = (a + discr)/2,
        mu3 = 1 - a,          mu4 = 1/2 - a.
    """

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        eps = 1e-8
        a = 2.0 - math.sqrt(2.0) - eps
        discr = math.sqrt(a * a - 4.0 * a + 2.0)
        self.mu1 = (a - discr) / 2.0
        self.mu2 = (a + discr) / 2.0
        self.mu3 = 1.0 - a
        self.mu4 = 0.5 - a

    def update(self, s, src, dt):
        kdt = self.kappa * dt
        if self._fft is not None:
            # every factor is diagonal in the same eigenbasis: one forward
            # + one inverse transform with a combined diagonal
            f = self._fft
            lam = f.lam
            num = (1.0 + self.mu3 * kdt * lam) * f.fwd(s)
            if src is not None:
                num = num + dt * (1.0 + self.mu4 * kdt * lam) * f.fwd(src)
            den = (1.0 - self.mu1 * kdt * lam) * (1.0 - self.mu2 * kdt * lam)
            return f.inv(num / den), (1, 0.0)
        rhs = s + self.mu3 * kdt * self._apply_lap(s)
        if src is not None:
            rhs = rhs + dt * (src + self.mu4 * kdt * self._apply_lap(src))
        mid, _ = self._helmholtz_solve(rhs, self.mu2, dt, s)
        return self._helmholtz_solve(mid, self.mu1, dt, mid)


def make_heat_solver(scheme: int, geo, bcs, kappa, mg_params=MGParams(),
                     dtype=torch.float32) -> BaseHeatSolver:
    """scheme: 0=BackwardEuler, 1=CrankNicolson, 2=TGA."""
    cls = {0: BackwardEuler, 1: CrankNicolson, 2: TGA}[scheme]
    return cls(geo, bcs, kappa, mg_params, dtype)


class BatchedSpectralHeat:
    """Fused implicit update for C same-scheme, same-kappa heat solvers
    whose spectral paths all exist (the NS step's per-velocity-component
    viscous solves: same nu, per-component BCs and hence eigenbases).  The
    C per-axis matrices stack into (C, n, n) batched matmuls."""

    def __init__(self, solvers):
        if not self.supports(solvers):
            raise ValueError("batched heat solvers differ in scheme or "
                             "kappa, or one of them has no spectral path")
        s0 = solvers[0]
        self.scheme = type(s0)
        self.kappa = s0.kappa
        ffts = [s._fft for s in solvers]
        self.Qstacks = [
            (ax, torch.stack([f.Q[i][1] for f in ffts]))
            for i, (ax, _) in enumerate(ffts[0].Q)]
        self.lam = torch.stack([f.lam for f in ffts])
        self.dtype = s0._dtype
        if isinstance(s0, TGA):
            self.mus = (s0.mu1, s0.mu2, s0.mu3, s0.mu4)

    @staticmethod
    def supports(solvers) -> bool:
        if not solvers:
            return False
        s0 = solvers[0]
        return all(type(s) is type(s0) and s.kappa == s0.kappa
                   and s._fft is not None for s in solvers)

    def _apply(self, x, transpose: bool):
        for ax, Qs in self.Qstacks:
            x = axis_transform(Qs.transpose(1, 2) if transpose else Qs,
                               x, ax, lead=1)
        return x

    def update(self, fields, srcs, dt):
        """fields/srcs: stacked (C,)+grid.shape (srcs may be None)."""
        kdt = self.kappa * dt
        lam = self.lam
        s_hat = self._apply(fields.to(self.dtype), False)
        f_hat = (self._apply(srcs.to(self.dtype), False)
                 if srcs is not None else None)
        if self.scheme is TGA:
            mu1, mu2, mu3, mu4 = self.mus
            num = (1.0 + mu3 * kdt * lam) * s_hat
            if f_hat is not None:
                num = num + dt * (1.0 + mu4 * kdt * lam) * f_hat
            den = (1.0 - mu1 * kdt * lam) * (1.0 - mu2 * kdt * lam)
        elif self.scheme is CrankNicolson:
            h = 0.5 * kdt
            num = (1.0 + h * lam) * s_hat
            if f_hat is not None:
                num = num + dt * f_hat
            den = 1.0 - h * lam
        else:   # BackwardEuler
            num = s_hat if f_hat is None else s_hat + dt * f_hat
            den = 1.0 - kdt * lam
        return self._apply(num / den, True).to(self.dtype)
