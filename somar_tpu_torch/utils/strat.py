"""Stratification utilities (PyTorch port of `somar_tpu.utils.strat`):
N^2 and the vertical normal modes on the host in numpy/scipy, computed
once per level like the metric (cached per column by `StructurePool`),
and the gradient Richardson number of a state in torch.

The vertical normal-mode problem  phi'' = -(N^2 / c^2) phi,
phi(0) = phi(-H) = 0, discretized on cell centers, is the generalized
symmetric problem -D2 phi = (1/c^2) diag(N^2) phi.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch


def compute_bv_freq(background, z: np.ndarray) -> np.ndarray:
    """N^2(z) = -d(bbar)/dz."""
    return np.asarray(background.nsq(z))


def solve_vert_eigen_problem(nsq: np.ndarray, dz: float, nmodes: int = 1
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """First `nmodes` vertical modes (c_j, phi_j(z)) on a cell-centered
    column with phi = 0 at both boundaries.

    nsq: N^2 at the nz cell centers (>= 0, nonzero somewhere).  Returns
    (c, phi) with c shape (nmodes,) sorted descending and phi shape
    (nmodes, nz) normalized to max |phi| = 1, positive mean."""
    from scipy.linalg import eigh

    nz = nsq.shape[0]
    # Dirichlet second-difference operator at cell centers (ghost = -interior)
    main = np.full(nz, -2.0)
    main[0] -= 1.0
    main[-1] -= 1.0
    D2 = (np.diag(main) + np.diag(np.ones(nz - 1), 1)
          + np.diag(np.ones(nz - 1), -1)) / (dz * dz)
    B = np.diag(np.maximum(nsq, 1e-12))
    w, v = eigh(-D2, B)
    # w = 1/c^2 ascending -> c descending
    c = 1.0 / np.sqrt(np.maximum(w[:nmodes], 1e-30))
    phi = v[:, :nmodes].T
    phi = phi / np.max(np.abs(phi), axis=1, keepdims=True)
    sgn = np.sign(phi.sum(axis=1))
    sgn[sgn == 0] = 1.0
    return c, phi * sgn[:, None]


def compute_max_bv_freq(nsq) -> float:
    return float(np.sqrt(np.maximum(np.max(nsq), 0.0)))


def gradient_richardson_number(vel, b_total, geo, eps: float = 1e-12):
    """Ri = N^2_local / (du/dz)^2 with N^2_local = -db/dz, by centred
    differences along the vertical axis (one-sided at its ends)."""
    dvert = geo.grid.vertical_dir
    ax = geo.grid.axis(dvert)
    dz = geo.grid.dx[dvert]

    def ddz(f):
        return torch.gradient(f, dim=ax)[0] / dz

    nsq_loc = -ddz(b_total)
    shear2 = sum(ddz(vel[m]) ** 2 for m in range(geo.ndim)) + eps
    return nsq_loc / shear2


class StructurePool:
    """Cache of the vertical structure (c, phi, dphi/dz, N^2) per
    (profile, z0, nz, dz, nmodes): c and phi as solve_vert_eigen_problem
    returns them, dphi/dz by centred differences."""

    def __init__(self):
        self._cache: Dict = {}

    def get(self, background, z0: float, nz: int, dz: float,
            nmodes: int = 1):
        key = (id(background), round(z0, 12), nz, round(dz, 12), nmodes)
        if key not in self._cache:
            z = z0 + (np.arange(nz) + 0.5) * dz
            nsq = compute_bv_freq(background, z)
            c, phi = solve_vert_eigen_problem(nsq, dz, nmodes)
            dphi = np.gradient(phi, dz, axis=1)
            self._cache[key] = (c, phi, dphi, nsq)
        return self._cache[key]
