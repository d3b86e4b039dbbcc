"""Batched tridiagonal solvers along the vertical axis (PyTorch port of
`somar_tpu.solvers.tridiag`).

One forward and one backward Python loop over array axis 0 solve every
column of the level at once: each loop step is a handful of elementwise
operations on a whole horizontal plane.
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
