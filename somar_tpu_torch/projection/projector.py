"""Incompressibility projections: MAC (exact) and CC (approximate)
(PyTorch port of `somar_tpu.projection.projector`).

Scaling conventions (flux form):
  * A MAC velocity is the J-scaled contravariant flux F_d = J u^d on faces.
  * mac_divergence(F) = (1/J) sum_d diff(F_d)/dx_d.
  * The pressure Poisson problem: L[phi] = mac_divergence(F*); the
    correction F -= mac_gradient(phi) gives mac_divergence(F) == 0.
  * The CC projection is the standard approximate projection: velocity is
    averaged to faces, projected, and the face-averaged correction is
    subtracted at CC.

This slice ports the spectral solver only (method "fft", or "auto" where
the spectral path applies).  Every other pressure solver raises
NotImplementedError; nothing is picked silently.
"""

from __future__ import annotations

from typing import Sequence

import torch

from somar_tpu_torch.core.bc import BC, FieldBCs
from somar_tpu_torch.geometry.level_geometry import LevelGeometry
from somar_tpu_torch.ops.stencil import (
    cc_to_fc, fc_to_cc, mac_divergence, mac_gradient)
from somar_tpu_torch.solvers.fft_poisson import FFTPoissonSolver
from somar_tpu_torch.solvers.poisson_op import PoissonOp


def pressure_bcs(grid) -> FieldBCs:
    """Pressure-Poisson BCs: periodic where the domain is, homogeneous
    Neumann elsewhere."""
    return FieldBCs.from_periodic(grid, BC.neumann(0.0))


class LevelProjector:
    """Pressure Poisson solves and projections on one level."""

    def __init__(self, geo: LevelGeometry, method: str = "auto",
                 dtype=torch.float32):
        self.geo = geo
        self.grid = geo.grid
        self.phi_bcs = pressure_bcs(geo.grid)
        self.op = PoissonOp(geo, self.phi_bcs)
        self.singular = self.op.bcs_singular()
        if method == "auto":
            if not FFTPoissonSolver.supports(geo, self.phi_bcs):
                raise NotImplementedError(
                    "this level needs the multigrid pressure solver, which "
                    "is ported in slice 2, see ROADMAP")
            method = "fft"
        if method != "fft":
            raise NotImplementedError(
                f"pressure solver {method!r} is not ported yet, see ROADMAP")
        self.fft = FFTPoissonSolver(geo, self.phi_bcs, dtype)
        self.method = method

    def _solve(self, rhs):
        return self.fft.solve(rhs), (1, 0.0)

    # ------------------------------------------------------------- helpers
    def cc_grad_cart(self, phi):
        """Cartesian-basis CC gradient of a CC potential via face-average
        of the MAC gradient (the discrete gradient the projection
        subtracts)."""
        geo, grid = self.geo, self.grid
        grad_fc = mac_gradient(phi, geo, self.phi_bcs)
        grad_cc = torch.stack([fc_to_cc(grad_fc[d], d, grid) * geo.Jinv
                               for d in range(grid.ndim)])
        return geo.to_cartesian(grad_cc)

    # ------------------------------------------------------ MAC projection
    def project_mac(self, fluxes: Sequence, phi0=None):
        """Exact level projection of MAC fluxes F_d = J u^d.  Returns
        (corrected fluxes, phi, info).  phi0 (the previous potential) is
        accepted for interface parity; the direct solve does not need it."""
        div = mac_divergence(fluxes, self.geo)
        phi, info = self._solve(div)
        grad = mac_gradient(phi, self.geo, self.phi_bcs)
        out = tuple(f - g for f, g in zip(fluxes, grad))
        return out, phi, info

    # ------------------------------------------------------- CC projection
    def cc_fluxes(self, vel_cart, vel_bcs: Sequence[FieldBCs]):
        """Face-averaged MAC fluxes J u^d of a CC Cartesian-basis velocity."""
        geo, grid = self.geo, self.grid
        u_mapped = geo.to_mapped(vel_cart)
        return tuple(cc_to_fc(geo.mult_by_J(u_mapped[d]), d, grid, vel_bcs[d])
                     for d in range(grid.ndim))

    def cc_div(self, vel_cart, vel_bcs: Sequence[FieldBCs]):
        """Divergence of the face-averaged MAC flux: the CC-projection
        Poisson RHS."""
        return mac_divergence(self.cc_fluxes(vel_cart, vel_bcs), self.geo)

    def cc_correction(self, phi):
        """Cartesian-basis CC correction velocity
        to_cartesian(g^{dj} d_j phi |_cc) for a solved potential: the same
        discrete gradient as cc_grad_cart."""
        return self.cc_grad_cart(phi)

    def project_cc(self, vel_cart, vel_bcs: Sequence[FieldBCs], phi0=None,
                   scale: float = 1.0):
        """Approximate projection of a CC Cartesian-basis velocity:
        vel -= scale * to_cartesian(g^{dj} d_j phi |_cc).
        Returns (vel_corrected, phi, info)."""
        div = self.cc_div(vel_cart, vel_bcs)
        phi, info = self._solve(div)
        return vel_cart - scale * self.cc_correction(phi), phi, info
