"""The problem library (PyTorch port of `somar_tpu.problems.library`):
AdvectionTest, InternalWave, VortexStreet, HorizConv, BeamGeneration,
SolitaryWave and DJL.  Each class supplies the initial conditions, BCs
and forcing of one `ibc.problem`.

Initial conditions are float64 numpy arrays (the level moves them to its
device and dtype), built exactly as the JAX package builds them, so both
packages start from the same fields.  Two problems carry BC values that
are not scalars: HorizConv's top buoyancy, a profile along x, and
VortexStreet's ramped inflow, a callable of time.
"""

from __future__ import annotations

import numpy as np
import torch

from somar_tpu_torch.core.bc import BC, FieldBCs
from somar_tpu_torch.core.grid import Grid
from somar_tpu_torch.geometry.level_geometry import LevelGeometry
from somar_tpu_torch.problems.base import (
    LinearProfile, Problem, SpongeSpec, TanhProfile, TidalSpec)
from somar_tpu_torch.utils.strat import StructurePool


class AdvectionTest(Problem):
    """Zalesak slotted-circle advection: uniform diagonal velocity (1,1) /
    (1,0,1); scalar = 1 inside radius 0.1 of the point (0.5, ...) with a
    notch (|x - x0| < 0.02, z < z0 + 0.02) cut out."""

    name = "AdvectionTest"

    def vel_ic(self, geo: LevelGeometry):
        shape = geo.grid.shape
        if geo.ndim == 3:
            return np.stack([np.ones(shape), np.zeros(shape),
                             np.ones(shape)])
        return np.stack([np.ones(shape), np.ones(shape)])

    def scalar_ic(self, geo: LevelGeometry, comp: int = 0):
        xs = geo.phys_coords_cc()
        shape = geo.grid.shape
        d = [np.broadcast_to(x, shape) - 0.5 for x in xs]
        rsq = sum(v * v for v in d)
        s = (rsq <= 0.01).astype(np.float64)
        notch = (d[0] ** 2 < 0.0004) & (d[geo.ndim - 1] < 0.02)
        return np.where(notch, 0.0, s)


class InternalWave(Problem):
    """Collapsing mixed region radiating internal waves: linear background
    stratification with b' = -0.5 - bbar in the upper-right region (right
    1/8 of x, top 1/2 of z)."""

    name = "InternalWave"
    use_background_scalar = True

    def __init__(self, background=None):
        self.background = background or LinearProfile(b0=0.0, slope=-1.0)

    def scalar_ic(self, geo: LevelGeometry, comp: int = 0):
        grid = geo.grid
        shape = grid.shape
        xs = geo.phys_coords_cc()
        x = np.broadcast_to(xs[0], shape)
        z = np.broadcast_to(xs[geo.ndim - 1], shape)
        bbar = np.asarray(self.background.value(z))
        x_hi = grid.x0[0] + grid.domain_length(0)
        z_hi = grid.x0[grid.ndim - 1] + grid.domain_length(grid.ndim - 1)
        mixed = (x > x_hi - grid.domain_length(0) / 8.0) & \
                (z > z_hi - grid.domain_length(grid.ndim - 1) / 2.0)
        # total b = -0.5 in the mixed region, = bbar elsewhere
        return np.where(mixed, -0.5 - bbar, 0.0)


def _ramp(u0: float, T: float):
    """t -> u0 * min(1, t / T), on the device for a tensor t."""
    def value(t):
        if isinstance(t, torch.Tensor):
            return u0 * torch.clamp_max(t / T, 1.0)
        return u0 * min(1.0, t / T)
    return value


class VortexStreet(Problem):
    """Flow past an obstacle shedding a vortex street: uniform inflow plus
    small random perturbations (numpy's default_rng(seed), as the JAX
    package draws them); sponge layers relax to the inflow.  The obstacle
    comes from the coordinate map (e.g. a cylinder)."""

    name = "VortexStreet"

    def __init__(self, inflow_vel=(1.0, 0.0, 0.0), pert_mag: float = 1e-2,
                 seed: int = 0, sponge: SpongeSpec | None = None,
                 ramp_time: float = 0.0):
        self.inflow = tuple(inflow_vel)
        self.pert_mag = float(pert_mag)
        self.seed = seed
        self.sponge = sponge
        #: ramp_time > 0: the inflow Dirichlet value is the time-dependent
        #: u0 * min(1, t / ramp_time)
        self.ramp_time = float(ramp_time)

    def _inflow_value(self, m: int):
        u0 = self.inflow[m]
        if self.ramp_time <= 0.0:
            return u0
        return _ramp(u0, self.ramp_time)

    def vel_ic(self, geo: LevelGeometry):
        rng = np.random.default_rng(self.seed)
        shape = geo.grid.shape
        comps = []
        for m in range(geo.ndim):
            base = self.inflow[m] * np.ones(shape)
            comps.append(base + self.pert_mag
                         * rng.uniform(-0.5, 0.5, shape))
        return np.stack(comps)

    def vel_bcs(self, grid: Grid, viscous: bool):
        """Inflow at x-lo (Dirichlet), outflow at x-hi (extrapolation)."""
        out = []
        for m in range(grid.ndim):
            lo, hi = [], []
            for d in range(grid.ndim):
                if grid.periodic[d]:
                    lo.append(BC.periodic())
                    hi.append(BC.periodic())
                elif d == 0:
                    lo.append(BC.dirichlet(self._inflow_value(m)))
                    hi.append(BC.extrap(1))
                elif d == m:
                    lo.append(BC.dirichlet(0.0))
                    hi.append(BC.dirichlet(0.0))
                else:
                    bc = BC.dirichlet(0.0) if viscous else BC.neumann(0.0)
                    lo.append(bc)
                    hi.append(bc)
            out.append(FieldBCs(lo=tuple(lo), hi=tuple(hi)))
        return tuple(out)

    def sponge_targets(self, geo: LevelGeometry):
        shape = geo.grid.shape
        vt = np.stack([self.inflow[m] * np.ones(shape)
                       for m in range(geo.ndim)])
        return vt, np.zeros(shape)


class HorizConv(Problem):
    """Horizontal convection: uniform initial buoyancy 0.5; differential
    buoyancy at the top surface (a Dirichlet value from b_cold over one
    half of x to b_hot over the other), adiabatic (Neumann 0) elsewhere.
    Buoyancy diffusion drives the overturning."""

    name = "HorizConv"

    def __init__(self, b_cold: float = 0.0, b_hot: float = 1.0):
        self.b_cold, self.b_hot = float(b_cold), float(b_hot)

    def scalar_ic(self, geo: LevelGeometry, comp: int = 0):
        return 0.5 * np.ones(geo.grid.shape)

    def diffusive_solve_bcs(self, grid: Grid) -> FieldBCs:
        """The hot/cold top forcing enters through the diffusion solve."""
        return self.scalar_bcs(grid)

    def scalar_bcs(self, grid: Grid) -> FieldBCs:
        # top Dirichlet value varying with x: a tanh step of absolute
        # transition width 1e-2 from the cold half to the hot half
        xc = grid.cc_coord_1d(0)
        xmid = grid.x0[0] + 0.5 * grid.domain_length(0)
        width = 1.0e-2
        prof = self.b_cold + (self.b_hot - self.b_cold) * 0.5 * (
            1.0 + np.tanh((xc - xmid) / width))
        # shaped to broadcast against a top-boundary slice (1, [1,] nx)
        shape = [1] * grid.ndim
        shape[grid.axis(0)] = xc.size
        top_val = prof.reshape(shape)

        lo, hi = [], []
        for d in range(grid.ndim):
            if grid.periodic[d]:
                lo.append(BC.periodic())
                hi.append(BC.periodic())
            elif d == grid.vertical_dir:
                lo.append(BC.neumann(0.0))
                hi.append(BC.dirichlet(top_val))
            else:
                lo.append(BC.neumann(0.0))
                hi.append(BC.neumann(0.0))
        return FieldBCs(lo=tuple(lo), hi=tuple(hi))


class BeamGeneration(Problem):
    """Internal-tide beam generation over a ridge: linear background
    stratification, oscillating tidal body force, sponges at the
    horizontal boundaries.  The ridge lives in the BeamGeneratorMap
    geometry."""

    name = "BeamGeneration"
    use_background_scalar = True

    def __init__(self, background=None, tidal_u0=0.01, tidal_omega=1.0,
                 sponge_frac: float = 0.05, sponge_time_coeff: float = 15.0,
                 ndim: int = 2):
        self.background = background or LinearProfile(b0=0.0, slope=-1.0)
        self.tidal = TidalSpec(u0=(float(tidal_u0),) + (0.0,) * 2,
                               omega=float(tidal_omega))
        w = [0.0] * ndim
        w[0] = sponge_frac
        self.sponge = SpongeSpec(width_lo=tuple(w), width_hi=tuple(w),
                                 time_coeff=sponge_time_coeff)


class SolitaryWave(Problem):
    """Mode-1 internal solitary wave on a pycnocline:
    b = A(x) phi(z) N^2(z) / c0 with a sech^2 envelope A; u = A dphi/dz,
    w = -dA/dx phi (the 1/c0 rides on b only), which makes the packet a
    right-mover at about c0."""

    name = "SolitaryWave"
    use_background_scalar = True

    def __init__(self, background=None, amplitude: float = 0.1,
                 width: float = 0.5, x0: float = 0.0):
        self.background = background or TanhProfile(
            b0=0.0, db=1.0, z0=-0.15, delta=0.05)
        self.amp = float(amplitude)
        self.width = float(width)
        self.xc = float(x0)
        self._cache = None

    def _modes(self, geo: LevelGeometry):
        if self._cache is None:
            grid = geo.grid
            dvert = grid.vertical_dir
            c, phi, dphi, nsq = StructurePool().get(
                self.background, grid.x0[dvert], grid.nx[dvert],
                grid.dx[dvert])
            self._cache = (float(c[0]), phi[0], dphi[0], nsq)
        return self._cache

    def _envelope(self, x):
        return self.amp / np.cosh((x - self.xc) / self.width) ** 2

    def _env_deriv(self, x):
        s = np.tanh((x - self.xc) / self.width)
        return -2.0 * self.amp * s / (
            np.cosh((x - self.xc) / self.width) ** 2 * self.width)

    def _column_shapes(self, geo):
        grid = geo.grid
        c0, phi, dphi, nsq = self._modes(geo)
        vshape = [1] * grid.ndim
        vshape[grid.axis(grid.vertical_dir)] = grid.nx[grid.vertical_dir]
        return (c0, phi.reshape(vshape), dphi.reshape(vshape),
                nsq.reshape(vshape))

    def scalar_ic(self, geo: LevelGeometry, comp: int = 0):
        shape = geo.grid.shape
        x = np.broadcast_to(geo.phys_coords_cc()[0], shape)
        c0, phi, dphi, nsq = self._column_shapes(geo)
        return self._envelope(x) * phi * nsq / c0

    def vel_ic(self, geo: LevelGeometry):
        grid = geo.grid
        shape = grid.shape
        x = np.broadcast_to(geo.phys_coords_cc()[0], shape)
        c0, phi, dphi, nsq = self._column_shapes(geo)
        u = np.broadcast_to(self._envelope(x) * dphi, shape)
        w = -np.broadcast_to(self._env_deriv(x) * phi, shape)
        comps = [u] + [np.zeros(shape)] * (grid.ndim - 2) + [w]
        return np.stack(comps)


class DJL(Problem):
    """Dubreil-Jacotin-Long solitary wave from the isopycnal displacement
    eta(x, z): b = bbar(z - eta) - bbar(z), u = c deta/dz, w = -c deta/dx.
    eta comes from the reference's DJLIC binary (`from_binary`) or
    defaults to the weakly nonlinear (KdV) eta = A sech^2((x-x0)/w) phi(z)
    of the first vertical mode."""

    name = "DJL"
    use_background_scalar = True

    def __init__(self, background=None, eta: np.ndarray | None = None,
                 c: float | None = None, amplitude: float = 0.1,
                 width: float = 0.5, x0: float = 0.0):
        self.background = background or TanhProfile(
            b0=0.0, db=1.0, z0=-0.15, delta=0.05)
        self._eta = eta
        self._c = c
        self._kdv = SolitaryWave(self.background, amplitude, width, x0)

    @classmethod
    def from_binary(cls, path: str, nx: int, nz: int, **kw):
        """Read the reference's DJLIC binary: doubles, c then the
        (nz+1) x (nx+1) node-centred eta rows."""
        raw = np.fromfile(path, dtype=np.float64)
        c = raw[0]
        eta = raw[1:1 + (nx + 1) * (nz + 1)].reshape(nz + 1, nx + 1)
        return cls(eta=eta, c=float(c), **kw)

    def _eta_cc(self, geo: LevelGeometry):
        if self._eta is None:
            shape = geo.grid.shape
            x = np.broadcast_to(geo.phys_coords_cc()[0], shape)
            c0, phi, dphi, nsq = self._kdv._column_shapes(geo)
            return np.broadcast_to(self._kdv._envelope(x) * phi, shape), c0
        eta_nc = self._eta
        # node-centred -> cell-centred average
        eta_cc = 0.25 * (eta_nc[:-1, :-1] + eta_nc[1:, :-1]
                         + eta_nc[:-1, 1:] + eta_nc[1:, 1:])
        return eta_cc, self._c

    def scalar_ic(self, geo: LevelGeometry, comp: int = 0):
        shape = geo.grid.shape
        z = np.broadcast_to(geo.phys_coords_cc()[geo.ndim - 1], shape)
        eta, c = self._eta_cc(geo)
        # b_total(x, z) = bbar(z - eta): the displaced isopycnals; rounded
        # to float32 as the JAX package does at every precision
        btot = self.background.value(z - eta)
        bbar = self.background.value(z)
        return (btot - bbar).astype(np.float32)

    def vel_ic(self, geo: LevelGeometry):
        grid = geo.grid
        shape = grid.shape
        eta, c = self._eta_cc(geo)
        dvert = grid.vertical_dir
        deta_dz = np.gradient(eta, grid.dx[dvert], axis=grid.axis(dvert))
        deta_dx = np.gradient(eta, grid.dx[0], axis=grid.axis(0))
        u = np.broadcast_to(c * deta_dz, shape)
        w = np.broadcast_to(-c * deta_dx, shape)
        comps = [u] + [np.zeros(shape)] * (grid.ndim - 2) + [w]
        return np.stack(comps)
