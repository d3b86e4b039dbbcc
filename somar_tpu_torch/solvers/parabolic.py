"""Implicit viscous/diffusive integrators: Backward Euler, Crank-Nicolson,
TGA (PyTorch port of `somar_tpu.solvers.parabolic`).

Each scheme advances  ds/dt = kappa * L s + S  one step.  This slice ports
the spectral branch: on uniform grids with homogeneous BCs every factor of
each scheme is diagonal in the FFTPoissonSolver eigenbasis, so an update is
one forward and one inverse transform.  Configurations that need the
multigrid branch raise NotImplementedError (multigrid is slice 2).
"""

from __future__ import annotations

import math

import torch

from somar_tpu_torch.core.bc import FieldBCs
from somar_tpu_torch.geometry.level_geometry import LevelGeometry
from somar_tpu_torch.solvers.fft_poisson import FFTPoissonSolver, axis_transform


class BaseHeatSolver:
    """Shared machinery: Helmholtz solves (I - c*dt*kappa*L) s = rhs."""

    def __init__(self, geo: LevelGeometry, bcs: FieldBCs, kappa: float,
                 dtype=torch.float32):
        self.geo = geo
        self.bcs = bcs
        self.kappa = float(kappa)
        self._dtype = dtype
        if not FFTPoissonSolver.supports(geo, bcs):
            raise NotImplementedError(
                "implicit heat solves off the spectral path need multigrid, "
                "which is ported in slice 2, see ROADMAP")
        self._fft = FFTPoissonSolver(geo, bcs, dtype)

    def _helmholtz_solve(self, rhs, coef, dt):
        """Solve (I - coef*dt*kappa*L) out = rhs."""
        return self._fft.solve(rhs, alpha=1.0, beta=-coef * dt * self.kappa)


class BackwardEuler(BaseHeatSolver):
    """(I - dt kappa L) s^{n+1} = s^n + dt S."""

    def update(self, s, src, dt):
        rhs = s + dt * src if src is not None else s
        return self._helmholtz_solve(rhs, 1.0, dt), (1, 0.0)


class CrankNicolson(BaseHeatSolver):
    """(I - dt/2 kappa L) s^{n+1} = (I + dt/2 kappa L) s^n + dt S, as one
    forward + one inverse transform round-trip."""

    def update(self, s, src, dt):
        f = self._fft
        h = 0.5 * dt * self.kappa
        num = (1.0 + h * f.lam) * f.fwd(s)
        if src is not None:
            num = num + dt * f.fwd(src)
        return f.inv(num / (1.0 - h * f.lam)), (1, 0.0)


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
        f = self._fft
        lam = f.lam
        num = (1.0 + self.mu3 * kdt * lam) * f.fwd(s)
        if src is not None:
            num = num + dt * (1.0 + self.mu4 * kdt * lam) * f.fwd(src)
        den = (1.0 - self.mu1 * kdt * lam) * (1.0 - self.mu2 * kdt * lam)
        return f.inv(num / den), (1, 0.0)


def make_heat_solver(scheme: int, geo, bcs, kappa,
                     dtype=torch.float32) -> BaseHeatSolver:
    """scheme: 0=BackwardEuler, 1=CrankNicolson, 2=TGA."""
    cls = {0: BackwardEuler, 1: CrankNicolson, 2: TGA}[scheme]
    return cls(geo, bcs, kappa, dtype)


class BatchedSpectralHeat:
    """Fused implicit update for C same-scheme, same-kappa heat solvers
    whose spectral paths all exist (the NS step's per-velocity-component
    viscous solves: same nu, per-component BCs and hence eigenbases).  The
    C per-axis matrices stack into (C, n, n) batched matmuls."""

    def __init__(self, solvers):
        s0 = solvers[0]
        if not all(type(s) is type(s0) and s.kappa == s0.kappa
                   for s in solvers):
            raise ValueError("batched heat solvers differ in scheme or kappa")
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
