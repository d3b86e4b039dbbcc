"""Lock exchange: two-density gravity-current benchmark (PyTorch port of
`somar_tpu.problems.lock_exchange`).

The buoyancy IC is bmin left / bmax right of a vertical interface at x=0
(sinusoidally perturbed in y for 3D), with a tanh smoothing of the
partially-covered interface cell; velocity starts at rest; solid walls
(free-slip unless viscous) on non-periodic sides.
"""

from __future__ import annotations

import numpy as np

from somar_tpu_torch.geometry.level_geometry import LevelGeometry
from somar_tpu_torch.problems.base import Problem


class LockExchange(Problem):
    name = "LockExchange"
    num_scalars = 1
    use_background_scalar = False

    def __init__(self, interface_x: float = 0.0, bmin: float = 0.0,
                 bmax: float = 1.0, pert_amp: float = 0.025,
                 smoothing: float = 2.0):
        self.x0 = float(interface_x)
        self.bmin, self.bmax = float(bmin), float(bmax)
        self.pert_amp = float(pert_amp)
        self.smoothing = float(smoothing)

    def scalar_ic(self, geo: LevelGeometry, comp: int = 0) -> np.ndarray:
        if comp != 0:
            raise ValueError("the lock exchange has one scalar")
        grid = geo.grid
        shape = grid.shape
        # physical x at the low/high x-faces of each cell
        xf = geo.phys_coords_fc(0)[0]
        ax = grid.axis(0)

        def take(arr, lo, hi):
            s = [slice(None)] * np.ndim(arr)
            s[ax] = slice(lo, hi)
            return arr[tuple(s)]

        xl = np.broadcast_to(take(xf, 0, -1), shape)
        xr = np.broadcast_to(take(xf, 1, None), shape)

        ifx = self.x0
        if grid.ndim == 3 and self.pert_amp != 0.0:
            y = np.broadcast_to(geo.phys_coords_cc()[1], shape)
            k = 2.0 * np.pi / grid.domain_length(1)
            ifx = self.x0 + self.pert_amp * np.sin(k * y)

        # partially-covered interface cell: tanh-smoothed volume fraction
        frac = np.clip((ifx - xr) / np.where(np.abs(xl - xr) > 0,
                                             xl - xr, 1.0), 0.0, 1.0)
        frac = np.tanh(self.smoothing * (2.0 * frac - 1.0))
        smooth = self.bmin + self.bmax * 0.5 * (frac + 1.0)
        return np.where(xr < ifx, self.bmin,
                        np.where(ifx < xl, self.bmax, smooth))
