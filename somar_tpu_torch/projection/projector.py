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

The pressure solver is the `method` knob: "fft" (the spectral direct
solve), "mg" (LevelMultigrid), "bicgstab", "leptic" (the leptic solver
with its multigrid finisher, solvers/leptic.py; `projection.solver = 2`)
or "auto" (spectral where it applies, else multigrid; never leptic).  A
solve with the altered metric of implicit gravity (`jgup_deltas`) takes
multigrid even where the spectral or the leptic solve exists.

AMR patch levels pass `phi_bcs` with CF sides and a `ring`: a padded-shape
array (one ghost layer) of coarse-fine ghost potentials, zero in the
interior and on non-CF sides.  The projections fold it into the rhs by
linearity (`_rhs_ring_correction`) and add it to the ghost fill of the
gradient (`_grad_with_ring`).

The projections subtract the plain MAC gradient of the potential,
without the Neumann cross-term zeroing of the operator's gradient, as the
JAX package's projector does.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from somar_tpu_torch.core.bc import BC, FieldBCs, fill_ghosts_cc
from somar_tpu_torch.geometry.level_geometry import LevelGeometry
from somar_tpu_torch.ops.stencil import (
    cc_to_fc, fc_to_cc, mac_divergence, mac_gradient, mac_gradient_prepadded)
from somar_tpu_torch.solvers.bicgstab import BiCGStabParams, bicgstab
from somar_tpu_torch.solvers.fft_poisson import FFTPoissonSolver
from somar_tpu_torch.solvers.leptic import LevelLepticSolver
from somar_tpu_torch.solvers.multigrid import LevelMultigrid, MGParams
from somar_tpu_torch.solvers.poisson_op import PoissonOp


def pressure_bcs(grid) -> FieldBCs:
    """Pressure-Poisson BCs: periodic where the domain is, homogeneous
    Neumann elsewhere."""
    return FieldBCs.from_periodic(grid, BC.neumann(0.0))


class LevelProjector:
    """Pressure Poisson solves and projections on one level; the MAC and
    the CC projection share one solver."""

    METHODS = ("fft", "mg", "bicgstab", "leptic")

    def __init__(self, geo: LevelGeometry, mg_params: MGParams = MGParams(),
                 method: str = "auto", dtype=torch.float32,
                 mg_params_by_purpose: Optional[dict] = None,
                 phi_bcs: Optional[FieldBCs] = None):
        """mg_params_by_purpose: optional {"mac" | "cc" | "sync" | "vd":
        MGParams} overrides; missing purposes fall back to mg_params.
        phi_bcs: the potential's BCs (default `pressure_bcs`; AMR patch
        levels give CF sides)."""
        self.geo = geo
        self.grid = geo.grid
        self.phi_bcs = phi_bcs or pressure_bcs(geo.grid)
        self._mg_params = mg_params
        self._mg_by_purpose = dict(mg_params_by_purpose or {})
        self._dtype = dtype
        self._mg = None       # built lazily (the spectral path skips it)
        self._mgs = {}        # per-purpose lazy LevelMultigrid overrides
        #: purpose -> (iterations, final relative residual) of its last solve
        self.last_info = {}
        self.op = PoissonOp(geo, self.phi_bcs)
        self.singular = self.op.bcs_singular()
        if method == "auto":
            method = "fft" if FFTPoissonSolver.supports(geo, self.phi_bcs) \
                else "mg"
        if method not in self.METHODS:
            raise ValueError(f"unknown pressure solver {method!r}")
        self.fft = (FFTPoissonSolver(geo, self.phi_bcs, dtype)
                    if method == "fft" else None)
        self.leptic = (LevelLepticSolver(geo, self.phi_bcs, dtype=dtype)
                       if method == "leptic" else None)
        self.method = method

    @property
    def mg(self) -> LevelMultigrid:
        if self._mg is None:
            self._mg = LevelMultigrid(self.geo, self.phi_bcs,
                                      params=self._mg_params,
                                      dtype=self._dtype,
                                      cf_coarse_dirichlet=True)
        return self._mg

    def _params_for(self, purpose) -> MGParams:
        return self._mg_by_purpose.get(purpose, self._mg_params)

    def _mg_for(self, purpose) -> LevelMultigrid:
        if purpose not in self._mg_by_purpose:
            return self.mg
        if purpose not in self._mgs:
            self._mgs[purpose] = LevelMultigrid(
                self.geo, self.phi_bcs,
                params=self._mg_by_purpose[purpose], dtype=self._dtype,
                cf_coarse_dirichlet=True)
        return self._mgs[purpose]

    # ----------------------------------------------------------- solves
    def _solve(self, rhs, phi0=None, purpose="mac", jgup_deltas=None):
        """(phi, (iterations, final relative residual)); phi0 warm-starts
        the iterative solvers."""
        phi, info = self._solve_by_method(rhs, phi0, purpose, jgup_deltas)
        self.last_info[purpose] = info
        return phi, info

    def _solve_by_method(self, rhs, phi0, purpose, jgup_deltas):
        if self.method == "fft" and jgup_deltas is None:
            return self.fft.solve(rhs), (1, 0.0)
        if self.method == "leptic" and jgup_deltas is None:
            phi, (it, rr, _) = self.leptic.solve_with_fallback(rhs, phi0)
            return phi, (it, rr)
        if self.method == "bicgstab":
            mp = self._params_for(purpose)
            bp = BiCGStabParams(eps=mp.bottom_eps, imax=mp.bottom_imax,
                                hang=mp.bottom_hang, small=mp.bottom_small,
                                num_restarts=mp.bottom_num_restarts)
            if self.singular:
                rhs = self.op.compat_project(rhs)
            jd0 = jgup_deltas[0] if jgup_deltas is not None else None
            return bicgstab(lambda v: self.op.apply(v, jgup_delta=jd0), rhs,
                            x0=phi0, params=bp, remove_mean=self.singular)
        return self._mg_for(purpose).solve(rhs, phi0=phi0,
                                           singular=self.singular,
                                           jgup_deltas=jgup_deltas)

    # ------------------------------------------------------------- helpers
    def cc_grad_cart(self, phi):
        """Cartesian-basis CC gradient of a CC potential via face-average
        of the MAC gradient with the pressure BCs (Neumann cross terms
        zeroed at walls, unlike the projections' correction)."""
        geo, grid = self.geo, self.grid
        grad_fc = mac_gradient(phi, geo, self.phi_bcs)
        grad_cc = torch.stack([fc_to_cc(grad_fc[d], d, grid) * geo.Jinv
                               for d in range(grid.ndim)])
        return geo.to_cartesian(grad_cc)

    # ------------------------------------------------------------- rings
    def _grad_with_ring(self, phi, ring, jd0=None):
        """MAC gradient of phi from its BC ghost fill plus the CF ghost
        ring (None: no ring; jd0: the finest level's altered-metric
        delta)."""
        p = fill_ghosts_cc(phi, self.grid, self.phi_bcs, 1)
        if ring is not None:
            p = p + ring
        return mac_gradient_prepadded(p, self.geo, jgup_delta=jd0)

    def _rhs_ring_correction(self, ring, jd0=None):
        """L(ring-only potential): the inhomogeneous CF ghost data folded
        into the rhs by linearity."""
        grad = mac_gradient_prepadded(ring, self.geo, jgup_delta=jd0)
        return mac_divergence(grad, self.geo)

    # ------------------------------------------------------ MAC projection
    def project_mac(self, fluxes: Sequence, phi0=None, ring=None):
        """Exact level projection of MAC fluxes F_d = J u^d, with the CF
        ghost ring of a patch level when given.  Returns (corrected
        fluxes, phi, info).  phi0 (the previous potential) warm-starts an
        iterative solve."""
        div = mac_divergence(fluxes, self.geo)
        if ring is not None:
            div = div - self._rhs_ring_correction(ring)
        phi, info = self._solve(div, phi0, purpose="mac")
        grad = self._grad_with_ring(phi, ring)
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

    def cc_correction(self, phi, ring=None, jd0=None):
        """Cartesian-basis CC correction velocity
        to_cartesian(g^{dj} d_j phi |_cc) for a solved potential (ring: CF
        ghost data; jd0: the finest level's altered-metric delta)."""
        geo, grid = self.geo, self.grid
        grad_fc = self._grad_with_ring(phi, ring, jd0)
        grad_cc = torch.stack([fc_to_cc(grad_fc[d], d, grid) * geo.Jinv
                               for d in range(grid.ndim)])
        return geo.to_cartesian(grad_cc)

    def project_cc(self, vel_cart, vel_bcs: Sequence[FieldBCs], phi0=None,
                   scale: float = 1.0, purpose: str = "cc",
                   jgup_deltas=None, ring=None):
        """Approximate projection of a CC Cartesian-basis velocity:
        vel -= scale * to_cartesian(g^{dj} d_j phi |_cc), solved with the
        per-MG-level altered metric jgup_deltas and the CF ghost ring when
        given.  Returns (vel_corrected, phi, info)."""
        jd0 = jgup_deltas[0] if jgup_deltas is not None else None
        div = self.cc_div(vel_cart, vel_bcs)
        if ring is not None:
            div = div - self._rhs_ring_correction(ring, jd0)
        phi, info = self._solve(div, phi0, purpose=purpose,
                                jgup_deltas=jgup_deltas)
        return (vel_cart - scale * self.cc_correction(phi, ring, jd0), phi,
                info)
