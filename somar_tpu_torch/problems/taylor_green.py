"""Taylor-Green vortex: the exact-solution validation problem (PyTorch
port of `somar_tpu.problems.taylor_green`).

    u =  sin(kx (x - U0 t)) cos(ky y) F(t) + U0
    v = -cos(kx (x - U0 t)) sin(ky y) F(t)
    p = (F(t)^2 / 4)(cos(2 kx (x - U0 t)) + cos(2 ky y))
    F(t) = exp(-nu (kx^2 + ky^2) t)

with kx = 2 pi / Lx, ky = 2 pi / Ly, periodic in both directions.
"""

from __future__ import annotations

import numpy as np

from somar_tpu_torch.geometry.level_geometry import LevelGeometry
from somar_tpu_torch.problems.base import Problem


class TaylorGreen(Problem):
    name = "TaylorGreen"
    num_scalars = 1               # passive here (gravity off)
    use_background_scalar = False

    def __init__(self, lengths=(1.0, 1.0), nu: float = 0.0, u0: float = 0.0):
        self.L = tuple(float(v) for v in lengths)
        self.nu = float(nu)
        self.u0 = float(u0)
        self.kx = 2.0 * np.pi / self.L[0]
        self.ky = 2.0 * np.pi / self.L[-1]

    def _phys(self, geo: LevelGeometry):
        xs = geo.phys_coords_cc()
        shape = geo.grid.shape
        return (np.broadcast_to(xs[0], shape),
                np.broadcast_to(xs[geo.ndim - 1], shape))

    def f_of_t(self, t):
        return np.exp(-self.nu * (self.kx**2 + self.ky**2) * t)

    def vel_soln(self, geo: LevelGeometry, t) -> np.ndarray:
        x, y = self._phys(geo)
        F = self.f_of_t(t)
        ax = self.kx * (x - self.u0 * t)
        ay = self.ky * y
        u = np.sin(ax) * np.cos(ay) * F + self.u0
        v = -np.cos(ax) * np.sin(ay) * F
        if geo.ndim == 2:
            return np.stack([u, v])
        return np.stack([u, np.zeros_like(u), v])  # vortex in the x-z plane

    def pressure_soln(self, geo: LevelGeometry, t) -> np.ndarray:
        x, y = self._phys(geo)
        F = self.f_of_t(t)
        ax = 2.0 * self.kx * (x - self.u0 * t)
        ay = 2.0 * self.ky * y
        return 0.25 * F * F * (np.cos(ax) + np.cos(ay))

    def vel_ic(self, geo: LevelGeometry) -> np.ndarray:
        return self.vel_soln(geo, 0.0)

    def scalar_ic(self, geo: LevelGeometry, comp: int = 0) -> np.ndarray:
        return np.zeros(geo.grid.shape)
