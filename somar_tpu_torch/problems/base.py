"""Problem definitions: ICs, BCs, background stratification, forcing
(PyTorch port of `somar_tpu.problems.base`).

Initial conditions and host-derived fields are computed in float64 numpy;
the level moves them to its device and dtype.  Velocity BCs are per
Cartesian component; `viscous` toggles no-slip (Dirichlet 0 on tangential
components at walls) vs free-slip (Neumann 0).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np

from somar_tpu_torch.core.bc import BC, FieldBCs
from somar_tpu_torch.core.grid import Grid
from somar_tpu_torch.geometry.level_geometry import LevelGeometry


# --------------------------------------------------------------------------
# Background buoyancy profiles
# --------------------------------------------------------------------------
class BackgroundProfile:
    """bbar(z): the vertical background buoyancy; only the deviation
    b' = b - bbar is evolved."""

    def value(self, z):
        raise NotImplementedError

    def deriv(self, z):
        raise NotImplementedError

    def nsq(self, z):
        """N^2 = -d(bbar)/dz (buoyancy convention: force = -b zhat)."""
        return -self.deriv(z)


class NoBackground(BackgroundProfile):
    def value(self, z):
        return np.zeros_like(z)

    def deriv(self, z):
        return np.zeros_like(z)


class LinearProfile(BackgroundProfile):
    """bbar = b0 + slope * z."""

    def __init__(self, b0: float = 0.0, slope: float = -1.0):
        self.b0, self.slope = float(b0), float(slope)

    def value(self, z):
        return self.b0 + self.slope * z

    def deriv(self, z):
        return self.slope * np.ones_like(z)


class QuadraticProfile(BackgroundProfile):
    """bbar = b0 + c1 z + c2 z^2."""

    def __init__(self, b0=0.0, c1=-1.0, c2=0.0):
        self.b0, self.c1, self.c2 = map(float, (b0, c1, c2))

    def value(self, z):
        return self.b0 + self.c1 * z + self.c2 * z * z

    def deriv(self, z):
        return self.c1 + 2.0 * self.c2 * z


class TanhProfile(BackgroundProfile):
    """bbar = b0 - 0.5*db*tanh((z - z0)/delta): a pycnocline."""

    def __init__(self, b0=0.5, db=1.0, z0=-0.5, delta=0.1):
        self.b0, self.db, self.z0, self.delta = map(float, (b0, db, z0, delta))

    def value(self, z):
        return self.b0 - 0.5 * self.db * np.tanh((z - self.z0) / self.delta)

    def deriv(self, z):
        sech2 = 1.0 / np.cosh((z - self.z0) / self.delta) ** 2
        return -0.5 * self.db / self.delta * sech2


# --------------------------------------------------------------------------
# Sponge layers
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SpongeSpec:
    """Rayleigh-damping strips at domain edges: src += ramp/(time_coeff*dt)
    * (target - field).  width is a fraction of the domain length per side;
    0 disables a side."""

    width_lo: Tuple[float, ...]
    width_hi: Tuple[float, ...]
    time_coeff: float = 15.0


def sponge_ramp(grid: Grid, spec: SpongeSpec) -> np.ndarray:
    """Precomputed ramp field in [0,1]: 1 at the wall, ->0 inward
    (smooth cubic), combined over all sponge sides."""
    ramp = np.zeros(grid.shape)
    coords = grid.coords()
    for d in range(grid.ndim):
        L = grid.domain_length(d)
        lo_x = grid.x0[d]
        hi_x = grid.x0[d] + L
        xi = np.broadcast_to(np.asarray(coords[d]), grid.shape)
        wlo = spec.width_lo[d] * L
        whi = spec.width_hi[d] * L
        if wlo > 0:
            t = np.clip((lo_x + wlo - xi) / wlo, 0.0, 1.0)
            ramp = np.maximum(ramp, t * t * (3 - 2 * t))
        if whi > 0:
            t = np.clip((xi - (hi_x - whi)) / whi, 0.0, 1.0)
            ramp = np.maximum(ramp, t * t * (3 - 2 * t))
    return ramp


# --------------------------------------------------------------------------
# Tidal forcing
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class TidalSpec:
    """Body force U0*omega*cos(omega t) in x (and y), time-averaged over
    the step (finite difference of sin)."""

    u0: Tuple[float, ...]
    omega: float


def tidal_source(spec: TidalSpec, ndim: int, t_old: float, dt: float):
    """Per-component body force (Python floats) averaged over
    [t_old, t_old+dt]."""
    w = spec.omega
    force = [0.0] * ndim
    if w != 0.0:
        a_old, a_new = w * t_old, w * (t_old + dt)
        force[0] = spec.u0[0] * (math.sin(a_new) - math.sin(a_old)) / dt
        if ndim == 3 and len(spec.u0) > 1 and spec.u0[1] != 0.0:
            force[1] = spec.u0[1] * (math.cos(a_new) - math.cos(a_old)) / dt
    return force


# --------------------------------------------------------------------------
# The problem base class
# --------------------------------------------------------------------------
class Problem:
    """Defines ICs, BCs and forcing for a run."""

    name = "abstract"
    num_scalars = 1
    use_background_scalar = False
    background: BackgroundProfile = NoBackground()
    sponge: Optional[SpongeSpec] = None
    tidal: Optional[TidalSpec] = None

    # ---- initial conditions (physical coordinates; float64 numpy) -------
    def vel_ic(self, geo: LevelGeometry) -> np.ndarray:
        """Cartesian-basis CC velocity, shape (ndim,)+shape."""
        return np.zeros((geo.ndim,) + geo.grid.shape)

    def scalar_ic(self, geo: LevelGeometry, comp: int = 0) -> np.ndarray:
        return np.zeros(geo.grid.shape)

    # ---- boundary conditions --------------------------------------------
    def vel_bcs(self, grid: Grid, viscous: bool) -> Tuple[FieldBCs, ...]:
        """Per Cartesian component: Dirichlet 0 on the normal component at
        walls; tangential no-slip (Dirichlet 0, viscous) or free-slip
        (Neumann 0).  Periodic directions wrap."""
        out = []
        for m in range(grid.ndim):
            lo, hi = [], []
            for d in range(grid.ndim):
                if grid.periodic[d]:
                    lo.append(BC.periodic())
                    hi.append(BC.periodic())
                elif d == m:
                    lo.append(BC.dirichlet(0.0))
                    hi.append(BC.dirichlet(0.0))
                else:
                    bc = BC.dirichlet(0.0) if viscous else BC.neumann(0.0)
                    lo.append(bc)
                    hi.append(bc)
            out.append(FieldBCs(lo=tuple(lo), hi=tuple(hi)))
        return tuple(out)

    def scalar_bcs(self, grid: Grid) -> FieldBCs:
        """Default: 1st-order extrapolation at physical walls."""
        return FieldBCs.from_periodic(grid, BC.extrap(1))

    # ---- derived (float64 numpy) ----------------------------------------
    def background_cc(self, geo: LevelGeometry) -> np.ndarray:
        """bbar at cell centers (physical z)."""
        z = np.broadcast_to(geo.phys_coords_cc()[geo.ndim - 1],
                            geo.grid.shape)
        return self.background.value(z)

    def nsq_cc(self, geo: LevelGeometry) -> np.ndarray:
        z = np.broadcast_to(geo.phys_coords_cc()[geo.ndim - 1],
                            geo.grid.shape)
        return self.background.nsq(z)

    def sponge_targets(self, geo: LevelGeometry):
        """(vel_target (ndim,)+shape, scal_target shape) for the sponge."""
        return (np.zeros((geo.ndim,) + geo.grid.shape),
                np.zeros(geo.grid.shape))
