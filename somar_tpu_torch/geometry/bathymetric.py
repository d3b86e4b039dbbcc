"""Terrain-following (bathymetric) coordinate maps, PyTorch port of
`somar_tpu.geometry.bathymetric` (numpy only; the port keeps its own copy).

A sigma-style vertical map over a water-depth function D(x_h):

    x_h = f_h(xi_h)                      (optional horizontal stretching)
    z(xi_h, zeta) = -D(x_h) * (1 - Phi(sigma)),   sigma = (zeta - z0)/H

with Phi: [0,1] -> [0,1] an optional monotone vertical stretching
(identity by default), so z = -D at the bottom (sigma=0) and z = 0 at the
surface (sigma=1).  The Jacobian is lower-triangular: horizontal motion
drags the terrain-following layers, so the metric is non-diagonal and the
elliptic solves see the full Jgup coupling.

Depth profiles:
  * LedgeMap         shelf-break transition hl -> hr;
  * BeamGeneratorMap smoothed critical-slope ridge for internal-tide beam
    generation;
  * DEMMap           measured bathymetry, spline-interpolated from an HDF5
    file of X[/Y]/Depth vectors.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

from somar_tpu_torch.geometry.geo_source import GeoSource


class BathymetricMap(GeoSource):
    """Abstract terrain-following map over depth D(x_h) > 0."""

    is_diagonal = False
    is_uniform = False
    name = "Bathymetric"

    def __init__(
        self,
        vert_domain: tuple[float, float],
        horiz_stretch: Callable[[np.ndarray], np.ndarray] | None = None,
        vert_stretch: Callable[[np.ndarray], np.ndarray] | None = None,
    ):
        """vert_domain = (zeta0, zeta0 + H): the mapped vertical extent."""
        self.z0 = float(vert_domain[0])
        self.H = float(vert_domain[1]) - self.z0
        assert self.H > 0
        self._fh = horiz_stretch
        self._phi = vert_stretch

    # -- subclass API ------------------------------------------------------
    def depth(self, xh: Sequence[np.ndarray]) -> np.ndarray:
        """Water depth D > 0 at horizontal physical coords xh."""
        raise NotImplementedError

    def depth_grad(self, xh: Sequence[np.ndarray], d: int) -> np.ndarray:
        """dD/dx_d; default finite difference."""
        scale = max(float(np.max(np.abs(xh[d]))), 1.0)
        h = 6.0e-6 * scale
        xp, xm = list(xh), list(xh)
        xp[d] = xh[d] + h
        xm[d] = xh[d] - h
        return (self.depth(xp) - self.depth(xm)) / (2.0 * h)

    # -- helpers -----------------------------------------------------------
    def _xh(self, xi):
        """Horizontal physical coords from the horizontal mapped coords."""
        nh = len(xi) - 1
        if self._fh is None:
            return [np.asarray(xi[d], dtype=np.float64) for d in range(nh)]
        return [self._fh(np.asarray(xi[d], dtype=np.float64))
                for d in range(nh)]

    def _sigma(self, zeta):
        return (np.asarray(zeta, dtype=np.float64) - self.z0) / self.H

    def _phi_of(self, s):
        return s if self._phi is None else self._phi(s)

    def _dphi(self, s):
        if self._phi is None:
            return np.ones_like(s)
        h = 1.0e-6
        return (self._phi(s + h) - self._phi(s - h)) / (2.0 * h)

    # -- GeoSource ---------------------------------------------------------
    def phys_coor(self, mu, xi):
        d = len(xi)
        if mu < d - 1:
            return self._xh(xi)[mu]
        s = self._phi_of(self._sigma(xi[d - 1]))
        D = self.depth(self._xh(xi))
        return -D * (1.0 - s)

    def dxdxi(self, mu, nu, xi):
        d = len(xi)
        vert = d - 1
        if mu < vert:
            # horizontal coords depend only on their own xi
            if mu != nu:
                return np.zeros(np.broadcast_shapes(
                    *[np.shape(x) for x in (xi[mu], xi[nu])]))
            if self._fh is None:
                return np.ones_like(np.asarray(xi[mu], dtype=np.float64))
            return super().dxdxi(mu, nu, xi)  # FD of the stretching
        # mu == vert: z depends on everything
        xh = self._xh(xi)
        s = self._phi_of(self._sigma(xi[vert]))
        if nu == vert:
            ds = self._dphi(self._sigma(xi[vert])) / self.H
            return self.depth(xh) * ds
        # dz/dxi_h = -(1 - s) * dD/dx_h * dx_h/dxi_h
        dDdx = self.depth_grad(xh, nu)
        dxdxi_h = 1.0 if self._fh is None else super().dxdxi(nu, nu, xi)
        return -(1.0 - s) * dDdx * dxdxi_h


class LedgeMap(BathymetricMap):
    """Shelf-break bathymetry: depth hl for x < xl, hr for x > xr, with a
    linear or cubic (C1) transition between."""

    name = "Ledge"

    def __init__(self, vert_domain, hl: float, hr: float, xl: float,
                 xr: float, transition_order: int = 3, **kw):
        super().__init__(vert_domain, **kw)
        self.hl, self.hr = float(hl), float(hr)
        self.xl, self.xr = float(xl), float(xr)
        assert self.xr > self.xl
        assert transition_order in (1, 3)
        self.order = transition_order

    def depth(self, xh):
        x = np.asarray(xh[0], dtype=np.float64)
        t = np.clip((x - self.xl) / (self.xr - self.xl), 0.0, 1.0)
        if self.order == 3:
            t = t * t * (3.0 - 2.0 * t)  # C1 cubic smoothstep
        return self.hl + (self.hr - self.hl) * t

    def depth_grad(self, xh, d):
        x = np.asarray(xh[0], dtype=np.float64)
        if d != 0:
            return np.zeros_like(x)
        w = self.xr - self.xl
        t = np.clip((x - self.xl) / w, 0.0, 1.0)
        if self.order == 3:
            dt = 6.0 * t * (1.0 - t) / w
        else:
            dt = np.where((t > 0.0) & (t < 1.0), 1.0 / w, 0.0)
        return (self.hr - self.hl) * dt


class BeamGeneratorMap(BathymetricMap):
    """Smoothed critical-slope ridge for internal-tide beam generation.

    A triangular ridge of slope tan(angle) centered at x=0, height set by
    the critical-slope length `l`, with quadratic C1 smoothing over width
    `B` at the base and half-width `P` at the peak; (l, B, P) are given as
    fractions of the domain width `lx`."""

    name = "BeamGenerator"

    def __init__(self, vert_domain, full_depth: float, angle: float,
                 lx: float, l_frac: float = 0.009714, b_frac: float = 0.01173,
                 p_frac: float = 0.0183542, center: float = 0.0, **kw):
        super().__init__(vert_domain, **kw)
        self.H0 = float(full_depth)
        self.angle = float(angle)
        self.center = float(center)
        l = l_frac * lx
        B = b_frac * lx
        P = p_frac * lx
        ta = np.tan(self.angle)
        # triangle half-width: critical region l along the slope plus the
        # smoothing allowances at base and peak
        self.half_width = l * np.cos(self.angle) + B + P
        self.peak = self.half_width * ta
        self.smooth = 0.5 * (B + P)
        self.ta = ta

    def _elevation(self, x):
        """Smoothed triangle elevation >= 0 via quadratic blends."""
        r = np.abs(np.asarray(x, dtype=np.float64) - self.center)
        tri = np.maximum(self.peak - r * self.ta, 0.0)
        # C1 mollification: quadratic blend of the |.| kinks at r=0 and at
        # the base r = half_width, each over width `smooth`.
        s = self.smooth
        if s <= 0:
            return tri
        # peak kink: replace peak - r*ta by peak - (r^2/(2s) + s/2)*ta, r<s
        peak_zone = r < s
        tri = np.where(peak_zone,
                       self.peak - (r * r / (2 * s) + s / 2) * self.ta, tri)
        # base kink at r0 = half_width: smooth max(., 0)
        r0 = self.half_width
        base_zone = np.abs(r - r0) < s
        q = (r - r0) / s  # in (-1, 1)
        tri = np.where(base_zone, self.ta * s * (1.0 - q) ** 2 / 4.0, tri)
        return np.maximum(tri, 0.0)

    def depth(self, xh):
        return self.H0 - self._elevation(xh[0])

    def depth_grad(self, xh, d):
        x = np.asarray(xh[0], dtype=np.float64)
        if d != 0:
            return np.zeros_like(x)
        h = 1.0e-6 * max(self.half_width, 1.0)
        return -(self._elevation(x + h) - self._elevation(x - h)) / (2.0 * h)


class DEMMap(BathymetricMap):
    """Measured bathymetry interpolated with cubic splines (or linearly):
    scipy's CubicSpline / RegularGridInterpolator, evaluated on the host at
    set-up."""

    name = "DEM"

    def __init__(self, vert_domain, x: np.ndarray, depth_samples: np.ndarray,
                 y: np.ndarray | None = None, min_depth_frac: float = 0.01,
                 interp_order: int = 1, **kw):
        """interp_order is geometry.Interpolation_Order: 0 = (bi)linear,
        > 0 = cubic."""
        super().__init__(vert_domain, **kw)
        from scipy.interpolate import (CubicSpline, interp1d,
                                       RegularGridInterpolator)

        # floor the depth: measured bathymetry can run to zero (shoreline),
        # which would collapse terrain-following columns to zero thickness
        # (J -> 0); clamp to a fraction of the vertical extent
        self.min_depth = float(min_depth_frac) * self.H
        x = np.asarray(x, dtype=np.float64)
        dep = np.maximum(np.asarray(depth_samples, dtype=np.float64),
                         self.min_depth)
        cubic = int(interp_order) > 0
        if y is None:
            if cubic:
                self._interp = CubicSpline(x, dep, bc_type="natural",
                                           extrapolate=True)
                self._interp_dx = self._interp.derivative()
            else:
                self._interp = interp1d(x, dep, kind="linear",
                                        bounds_error=False,
                                        fill_value=(dep[0], dep[-1]))
                self._interp_dx = None
            self._is2d = False
        else:
            y = np.asarray(y, dtype=np.float64)
            self._rgi = RegularGridInterpolator(
                (x, y), dep, method="cubic" if cubic else "linear",
                bounds_error=False, fill_value=None
            )
            self._is2d = True

    @classmethod
    def from_hdf5(cls, vert_domain, path: str, ndim: int, **kw):
        """Reads a DEM file of X[/Y]/Depth vectors; a 3D depth stored
        (ny, nx) is transposed to the (x, y) grid order.  h5py is imported
        here, so the package imports without it."""
        import h5py

        with h5py.File(path, "r") as f:
            x = np.asarray(f["X"])
            dep = np.asarray(f["Depth"])
            y = np.asarray(f["Y"]) if ndim == 3 and "Y" in f else None
        if y is not None and dep.shape == (y.size, x.size):
            dep = dep.T
        return cls(vert_domain, x, dep, y=y, **kw)

    def depth(self, xh):
        if not self._is2d:
            d = self._interp(np.asarray(xh[0], dtype=np.float64))
            return np.maximum(d, self.min_depth)
        x = np.asarray(xh[0], dtype=np.float64)
        y = np.asarray(xh[1], dtype=np.float64)
        bx, by = np.broadcast_arrays(x, y)
        pts = np.stack([bx.ravel(), by.ravel()], axis=-1)
        return np.maximum(self._rgi(pts).reshape(bx.shape), self.min_depth)

    def depth_grad(self, xh, d):
        if not self._is2d and d == 0 and self._interp_dx is not None:
            return self._interp_dx(np.asarray(xh[0], dtype=np.float64))
        return super().depth_grad(xh, d)
