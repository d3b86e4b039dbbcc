"""Batched tridiagonal solvers along the vertical axis (PyTorch port of
`somar_tpu.solvers.tridiag`).

`thomas_solve`: one forward and one backward Python loop over array axis
0 solve every column of the level at once, each loop step a handful of
elementwise operations on a whole horizontal plane (2n steps).
`pcr_factor` / `pcr_apply`: parallel cyclic reduction, ceil(log2 n) steps
of whole-array operations, for diagonally dominant systems (the multigrid
line smoother's, whose matrix part is factored once per operator and
coefficient pair), where a loop over the planes would be bound by its
launches.
"""

from __future__ import annotations

import torch


def thomas_solve(a, b, c, d):
    """Solve tridiagonal systems along axis 0 (vectorized over other axes).

    a: sub-diagonal   (n, ...) with a[0] ignored
    b: diagonal       (n, ...)
    c: super-diagonal (n, ...) with c[n-1] ignored
    d: right-hand side (n, ...)
    Returns x with the same shape as d.
    """
    n = d.shape[0]
    cp_prev = torch.zeros_like(d[0])
    dp_prev = torch.zeros_like(d[0])
    cps, dps = [], []
    for i in range(n):
        denom = b[i] - a[i] * cp_prev
        cp_prev, dp_prev = c[i] / denom, (d[i] - a[i] * dp_prev) / denom
        cps.append(cp_prev)
        dps.append(dp_prev)
    x = torch.zeros_like(d[0])
    out = [None] * n
    for i in range(n - 1, -1, -1):
        x = dps[i] - cps[i] * x
        out[i] = x
    return torch.stack(out)


def _shift(t, s: int, fill: float = 0.0):
    """t moved s planes along axis 0 (s > 0: t[i - s] at i; s < 0:
    t[i + |s|] at i), `fill` where that plane is outside."""
    n = t.shape[0]
    pad = torch.full((min(abs(s), n),) + tuple(t.shape[1:]), fill,
                     dtype=t.dtype, device=t.device)
    if s > 0:
        return torch.cat([pad, t[:n - s]]) if s < n else pad
    return torch.cat([t[-s:], pad]) if -s < n else pad


def pcr_factor(a, b, c):
    """The matrix part of a parallel cyclic reduction along axis 0 (the
    arguments as thomas_solve's): per step s = 1, 2, 4, ... the factors
    that eliminate every row's couplings at distance s with its two
    neighbours there, and 1 / the reduced diagonal.  Stable where the
    matrix is diagonally dominant, as Thomas is.  A row's coupling to a
    plane outside is zero, so those neighbours enter with diagonal 1."""
    n = b.shape[0]
    a = torch.cat([torch.zeros_like(a[:1]), a[1:]])
    c = torch.cat([c[:-1], torch.zeros_like(c[:1])])
    steps = []
    s = 1
    while s < n:
        k_lo = -a / _shift(b, s, 1.0)
        k_hi = -c / _shift(b, -s, 1.0)
        b = b + k_lo * _shift(c, s) + k_hi * _shift(a, -s)
        a = k_lo * _shift(a, s)
        c = k_hi * _shift(c, -s)
        steps.append((s, k_lo, k_hi))
        s *= 2
    return steps, 1.0 / b


def pcr_apply(factor, d):
    """Solve for right-hand sides d (batched as in pcr_factor) with a
    factorization of pcr_factor: ceil(log2 n) steps of whole-array
    operations."""
    steps, binv = factor
    for s, k_lo, k_hi in steps:
        d = d + k_lo * _shift(d, s) + k_hi * _shift(d, -s)
    return d * binv


def vertical_poisson_nn(rhs, acoef_lo, acoef_hi, dz):
    """Neumann-Neumann vertical Poisson line solves.

    Solves (1/dz) * [ A_hi (x_{k+1}-x_k)/dz - A_lo (x_k - x_{k-1})/dz ] = rhs
    along axis 0 with homogeneous Neumann at both ends, where A_lo/A_hi are
    the face coefficients below/above each cell (tensors of rhs's shape).
    The system is singular: the column mean of rhs (the incompatible part)
    is removed, x[0] is pinned for the solve, and the zero-mean solution is
    returned.
    """
    n = rhs.shape[0]
    rhs = rhs - rhs.mean(dim=0, keepdim=True)
    inv_dz2 = 1.0 / (dz * dz)
    a = (acoef_lo * inv_dz2).clone()    # coupling to k-1
    c = (acoef_hi * inv_dz2).clone()    # coupling to k+1
    a[0] = 0.0                          # zero-flux faces at the ends
    c[n - 1] = 0.0
    b = -(a + c)
    # pin x[0] = 0: first row -> identity
    c[0] = 0.0
    b[0] = 1.0
    d = rhs.clone()
    d[0] = 0.0
    x = thomas_solve(a, b, c, d)
    return x - x.mean(dim=0, keepdim=True)
