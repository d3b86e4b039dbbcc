"""Direct Poisson/Helmholtz solver by fast diagonalization on uniform grids
(PyTorch port of `somar_tpu.solvers.fft_poisson`).

On uniform Cartesian grids the discrete operator is diagonal in a
separable eigenbasis:

  * periodic axis      -> real Fourier modes, lam = (2 cos(2 pi m/n)-2)/dx^2
  * hom-Neumann axis   -> DCT-II modes,       lam = (2 cos(pi k/n) -2)/dx^2
  * hom-Dirichlet axis -> DST-II modes,       lam = (2 cos(pi(k+1)/n)-2)/dx^2
  * mixed / CF ends    -> eigenvectors of the 1D 3-point matrix (eigh)

Each per-axis transform is a dense orthonormal n x n matrix, built in
float64 numpy exactly as the JAX package builds it and applied as a batched
matmul (torch.matmul), so inverses are transposes.  The matmuls run in
full float32 on the GPU: TF32 would leave the projection ~1e-3
non-solenoidal, so the constructor switches TF32 off for matmuls and cuDNN.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from somar_tpu_torch.core.bc import BCType, FieldBCs
from somar_tpu_torch.geometry.level_geometry import LevelGeometry


def _dct2_matrix(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Orthonormal DCT-II rows + mode indices k (hom-Neumann modes)."""
    j = np.arange(n)
    k = np.arange(n)[:, None]
    Q = np.cos(np.pi * k * (2 * j + 1) / (2 * n))
    s = np.full(n, np.sqrt(2.0 / n))
    s[0] = np.sqrt(1.0 / n)
    return s[:, None] * Q, np.arange(n)


def _dst2_matrix(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Orthonormal DST-II rows (hom-Dirichlet modes)."""
    j = np.arange(n)
    k = np.arange(n)[:, None]
    Q = np.sin(np.pi * (k + 1) * (2 * j + 1) / (2 * n))
    t = np.full(n, np.sqrt(2.0 / n))
    t[n - 1] = np.sqrt(1.0 / n)
    return t[:, None] * Q, np.arange(n) + 1


def _axis_eigenbasis(n: int, lo_type: BCType,
                     hi_type: BCType) -> Tuple[np.ndarray, np.ndarray]:
    """Diagonalize the 1D 3-point operator for any mix of non-periodic
    homogeneous end conditions (NEUMANN mirror, DIRICHLET anti-mirror, CF
    ghost zero)."""
    A = np.diag(np.full(n, -2.0)) + np.diag(np.ones(n - 1), 1) \
        + np.diag(np.ones(n - 1), -1)
    end = {BCType.NEUMANN: -1.0, BCType.DIRICHLET: -3.0, BCType.CF: -2.0}
    A[0, 0] = end[lo_type]
    A[n - 1, n - 1] = end[hi_type]
    lam, V = np.linalg.eigh(A)
    return V.T, lam


def _fourier_matrix(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Real orthonormal Fourier rows + per-row wavenumber m (periodic)."""
    j = np.arange(n)
    rows = [np.full(n, 1.0 / np.sqrt(n))]
    ms = [0]
    for m in range(1, (n + 1) // 2):
        rows.append(np.sqrt(2.0 / n) * np.cos(2 * np.pi * m * j / n))
        ms.append(m)
        rows.append(np.sqrt(2.0 / n) * np.sin(2 * np.pi * m * j / n))
        ms.append(m)
    if n % 2 == 0:
        rows.append(((-1.0) ** j) / np.sqrt(n))
        ms.append(n // 2)
    return np.stack(rows), np.asarray(ms)


def axis_transform(M, x, ax: int, lead: int = 0):
    """Contract array axis `ax` of x (after `lead` batch axes) with the
    rows of M: out[.., k, ..] = sum_j M[.., k, j] x[.., j, ..].  M is
    (n, n), or (C, n, n) with lead == 1 for a batch of C transforms."""
    shape = x.shape
    a = ax + lead
    n = shape[a]
    if a == x.ndim - 1:
        # contiguous axis: one (rows, n) x (n, n) product
        if M.ndim == 3:
            M = M.reshape(M.shape[0], *([1] * (a - 2)), n, n)
        return torch.matmul(x, M.transpose(-1, -2))
    xs = x.reshape(*shape[:a], n, -1)
    if M.ndim == 3:     # per-batch matrices broadcast over the middle axes
        M = M.reshape(M.shape[0], *([1] * (a - 1)), n, n)
    return torch.matmul(M, xs).reshape(shape)


def disable_tf32():
    """Full-f32 matmuls for the spectral transforms (TF32 keeps ~3 digits,
    which leaves the exact projection visibly non-solenoidal)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class FFTPoissonSolver:
    """Fast-diagonalization direct solver on uniform grids (J=1, g=I)."""

    def __init__(self, geo: LevelGeometry, bcs: FieldBCs,
                 dtype=torch.float32):
        grid = geo.grid
        if not geo.is_uniform:
            raise ValueError("spectral path requires a uniform map")
        disable_tf32()
        device = geo.device
        self.grid = grid
        self.dtype = dtype
        self.Q: List = []        # per logical dir: (axis, Q matrix)
        lam32 = None
        for d in range(grid.ndim):
            ax = grid.axis(d)
            n = grid.nx[d]
            dx = grid.dx[d]
            blo, bhi = bcs.lo[d], bcs.hi[d]
            if blo.type == BCType.PERIODIC:
                Qm, modes = _fourier_matrix(n)
                lam = (2.0 * np.cos(2.0 * np.pi * modes / n) - 2.0) / dx**2
            elif blo.type == BCType.NEUMANN and bhi.type == BCType.NEUMANN:
                Qm, modes = _dct2_matrix(n)
                lam = (2.0 * np.cos(np.pi * modes / n) - 2.0) / dx**2
            elif blo.type == BCType.DIRICHLET \
                    and bhi.type == BCType.DIRICHLET:
                Qm, modes = _dst2_matrix(n)
                lam = (2.0 * np.cos(np.pi * modes / n) - 2.0) / dx**2
            else:
                Qm, lam = _axis_eigenbasis(n, blo.type, bhi.type)
                lam = lam / dx**2
            err = np.abs(Qm @ Qm.T - np.eye(n)).max()
            if err >= 1e-10:
                raise ValueError(f"transform not orthonormal: {err}")
            self.Q.append((ax, torch.as_tensor(Qm, dtype=dtype,
                                                device=device)))
            shape = [1] * grid.ndim
            shape[ax] = n
            # eigenvalues are float32 and summed in float32 in the JAX
            # package at every precision; the port keeps those values
            la = torch.as_tensor(lam.reshape(shape).astype(np.float32),
                                 device=device)
            lam32 = la if lam32 is None else lam32 + la
        #: total eigenvalue field (full shape), float32 values held in
        #: the solver dtype
        self.lam = lam32.expand(grid.shape).to(dtype).contiguous()
        self.singular = all(
            bcs.lo[d].type in (BCType.PERIODIC, BCType.NEUMANN)
            and bcs.hi[d].type in (BCType.PERIODIC, BCType.NEUMANN)
            for d in range(grid.ndim))

    @staticmethod
    def supports(geo: LevelGeometry, bcs: FieldBCs) -> bool:
        if not geo.is_uniform:
            return False

        def hom_end(b):
            return (b.type in (BCType.NEUMANN, BCType.DIRICHLET, BCType.CF)
                    and not callable(b.value) and np.ndim(b.value) == 0
                    and float(b.value) == 0.0)

        for d in range(geo.grid.ndim):
            lo, hi = bcs.lo[d], bcs.hi[d]
            ok = (lo.type == BCType.PERIODIC
                  and hi.type == BCType.PERIODIC) \
                or (hom_end(lo) and hom_end(hi))
            if not ok:
                return False
        return True

    def fwd(self, x):
        """Forward transform to the eigenbasis."""
        return self._apply(x.to(self.dtype), transpose=False)

    def inv(self, x):
        """Inverse (transpose) transform from the eigenbasis."""
        return self._apply(x, transpose=True).to(self.dtype)

    def _apply(self, x, transpose: bool):
        for ax, Qm in self.Q:
            x = axis_transform(Qm.T if transpose else Qm, x, ax)
        return x

    def solve(self, rhs, alpha=0.0, beta=1.0):
        """Exact solve; the zero (constant) mode is nulled when singular."""
        X = self._apply(rhs.to(self.dtype), transpose=False)
        denom = alpha + beta * self.lam
        ok = torch.abs(denom) > 1e-12
        X = torch.where(ok, X / torch.where(ok, denom, 1.0), 0.0)
        return self._apply(X, transpose=True).to(self.dtype)
