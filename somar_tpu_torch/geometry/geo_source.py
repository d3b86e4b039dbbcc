"""Coordinate maps (metric sources), PyTorch port of
`somar_tpu.geometry.geo_source`.

A map supplies x_mu = X_mu(xi) and, where cheap, analytic Jacobian
entries; everything else (J, g^ij, J g^ij, basis transforms) is derived
once per level on the host in float64 numpy (geometry/level_geometry.py).
This module is numpy only: the port keeps its own copy so that it never
imports the JAX package.

Conventions:
  e[mu][nu]   = dx_mu / dxi_nu          (Jacobian matrix)
  J           = det(e)                  (volume element)
  dxidx[i][k] = dxi_i / dx_k            (inverse Jacobian)
  gup[i][j]   = sum_k dxidx[i][k] dxidx[j][k]   (contravariant metric)
  gdn[i][j]   = sum_k e[k][i] e[k][j]           (covariant metric)
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

# Step of the finite-difference fallback derivative: cbrt(eps_f64) times
# the coordinate scale gives the optimal central-difference step.
_FD_REL_STEP = 6.0e-6


class GeoSource:
    """Abstract coordinate map xi -> x.  Subclasses implement `phys_coor`;
    `dxdxi` falls back to a central finite difference."""

    #: True when the Jacobian is everywhere diagonal
    is_diagonal: bool = False
    #: True when the map is the identity up to constant scalings
    is_uniform: bool = False

    name: str = "abstract"

    def phys_coor(self, mu: int, xi: Sequence[np.ndarray]) -> np.ndarray:
        """x_mu evaluated at mapped coordinates xi (broadcastable arrays)."""
        raise NotImplementedError

    def dxdxi(self, mu: int, nu: int, xi: Sequence[np.ndarray]) -> np.ndarray:
        """dx_mu/dxi_nu; default central finite difference of phys_coor."""
        scale = max(abs(float(np.max(xi[nu]))), abs(float(np.min(xi[nu]))),
                    1.0)
        h = _FD_REL_STEP * scale
        xp = list(xi)
        xm = list(xi)
        xp[nu] = xi[nu] + h
        xm[nu] = xi[nu] - h
        return (self.phys_coor(mu, xp) - self.phys_coor(mu, xm)) / (2.0 * h)

    # ------------------------------------------------------------- derived
    def jacobian(self, xi: Sequence[np.ndarray]) -> np.ndarray:
        """Full Jacobian e[mu, nu] broadcast to a common shape."""
        d = len(xi)
        shape = np.broadcast_shapes(*[np.shape(x) for x in xi])
        e = np.zeros((d, d) + shape)
        for mu in range(d):
            for nu in range(d):
                e[mu, nu] = np.broadcast_to(self.dxdxi(mu, nu, xi), shape)
        return e

    def metrics(self, xi: Sequence[np.ndarray]):
        """(J, gup, gdn, e, einv) at the given points."""
        e = self.jacobian(xi)
        # det / inv over the leading (d, d) axes -> move them last
        em = np.moveaxis(e, (0, 1), (-2, -1))
        J = np.linalg.det(em)
        einv_m = np.linalg.inv(em)  # dxi_i/dx_k at [..., i, k]
        einv = np.moveaxis(einv_m, (-2, -1), (0, 1))
        gup = np.einsum("ik...,jk...->ij...", einv, einv)
        gdn = np.einsum("ki...,kj...->ij...", e, e)
        return J, gup, gdn, e, einv


class CartesianMap(GeoSource):
    """Identity map."""

    is_diagonal = True
    is_uniform = True
    name = "Cartesian"

    def phys_coor(self, mu, xi):
        return xi[mu]

    def dxdxi(self, mu, nu, xi):
        return np.asarray(1.0 if mu == nu else 0.0)


class StretchedCartesianMap(GeoSource):
    """Per-direction smooth stretching x_mu = f_mu(xi_mu) (diagonal
    metric)."""

    is_diagonal = True
    is_uniform = False
    name = "StretchedCartesian"

    def __init__(self, stretch: Sequence[Callable[[np.ndarray], np.ndarray]]):
        self._f = tuple(stretch)

    def phys_coor(self, mu, xi):
        return self._f[mu](np.asarray(xi[mu], dtype=np.float64))

    def dxdxi(self, mu, nu, xi):
        if mu != nu:
            return np.zeros_like(np.asarray(xi[mu], dtype=np.float64))
        return super().dxdxi(mu, nu, xi)


class TwistedMap(GeoSource):
    """Sinusoidally tangled mesh, a solver stress test:
    x_mu = xi_mu + pert_mu * prod_{nu != mu} sin(2 pi xi_nu / L_nu)
    (the mesh tangles for pert > ~0.159 L)."""

    is_diagonal = False
    is_uniform = False
    name = "Twisted"

    def __init__(self, perturbations: Sequence[float],
                 lengths: Sequence[float]):
        self.pert = tuple(float(p) for p in perturbations)
        self.L = tuple(float(v) for v in lengths)

    def phys_coor(self, mu, xi):
        d = len(xi)
        out = np.asarray(xi[mu], dtype=np.float64).copy()
        twist = self.pert[mu]
        for nu in range(d):
            if nu != mu:
                twist = twist * np.sin(2.0 * np.pi * xi[nu] / self.L[nu])
        return out + twist

    def dxdxi(self, mu, nu, xi):
        d = len(xi)
        if mu == nu:
            return np.ones_like(np.asarray(xi[mu], dtype=np.float64))
        # d/dxi_nu of pert * prod_{k != mu} sin(2 pi xi_k / L_k)
        w = 2.0 * np.pi / self.L[nu]
        deriv = self.pert[mu] * w * np.cos(
            w * np.asarray(xi[nu], dtype=np.float64))
        for k in range(d):
            if k != mu and k != nu:
                deriv = deriv * np.sin(2.0 * np.pi * xi[k] / self.L[k])
        return deriv


class CylindricalMap(GeoSource):
    """(r, theta[, z]) -> (x, y[, z])."""

    is_diagonal = False
    is_uniform = False
    name = "Cylindrical"

    def phys_coor(self, mu, xi):
        r = np.asarray(xi[0], dtype=np.float64)
        th = np.asarray(xi[1], dtype=np.float64)
        if mu == 0:
            return r * np.cos(th)
        if mu == 1:
            return r * np.sin(th)
        return np.asarray(xi[2], dtype=np.float64)

    def dxdxi(self, mu, nu, xi):
        r = np.asarray(xi[0], dtype=np.float64)
        th = np.asarray(xi[1], dtype=np.float64)
        if mu == 0:
            if nu == 0:
                return np.cos(th)
            if nu == 1:
                return -r * np.sin(th)
        elif mu == 1:
            if nu == 0:
                return np.sin(th)
            if nu == 1:
                return r * np.cos(th)
        elif mu == 2 and nu == 2:
            return np.ones(np.broadcast_shapes(r.shape, th.shape))
        return np.zeros(np.broadcast_shapes(np.shape(r), np.shape(th)))
