"""BiCGStab Krylov solver: the multigrid bottom solve and a pressure solver
of its own (PyTorch port of `somar_tpu.solvers.bicgstab`).

The operator is any closure A(x) -> Ax on CC tensors.  Parameters mirror
the `bottom.*` namespace: eps, reps, imax, hang, small, numRestarts.

The iteration RESTARTS (fresh shadow residual r0 = r, zeroed search
directions) on rho/omega breakdown or when the residual stalls: BiCGStab's
per-iteration residual is non-monotone, so a plain "no improvement this
iteration" exit aborts otherwise-healthy solves.  Stall = no improvement
over the best residual for several iterations.

The iteration is a Python loop: the vectors and the scalars rho, alpha,
omega stay on the device, and one read per iteration brings the residual
norm and the breakdown test to the host, whose float32 arithmetic on them
is the JAX package's.  Inner products and norms accumulate in float32
whatever the dtype of the vectors.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from somar_tpu_torch.solvers.host_reads import read_scalars


@dataclasses.dataclass(frozen=True)
class BiCGStabParams:
    eps: float = 1e-6      # bottom.eps: tolerance relative to the initial resid
    imax: int = 80         # bottom.imax
    hang: float = 1e-8     # bottom.hang: min relative gain per stall window
    small: float = 1e-30   # bottom.small
    num_restarts: int = 5  # bottom.numRestarts
    stall_iters: int = 8   # iterations without a new best before restart
    #: bottom.reps: secondary convergence floor relative to |rhs|: the
    #: solve also exits when |r| <= reps * |rhs|
    reps: float = 1e-12
    #: bottom.normType: 0 = max norm, otherwise L2
    norm_type: int = 2


def _dot(a, b):
    return torch.sum(a.to(torch.float32) * b.to(torch.float32))


def _norm(a, norm_type: int):
    if norm_type == 0:
        return torch.max(torch.abs(a)).to(torch.float32)
    return torch.sqrt(_dot(a, a))


def bicgstab(A: Callable, rhs, x0=None, M: Optional[Callable] = None,
             params: BiCGStabParams = BiCGStabParams(),
             remove_mean: bool = False):
    """Solve A x = rhs.  M is an optional (right) preconditioner closure.

    remove_mean projects out the constant null space each iteration (for
    singular pure-Neumann problems).  Returns (x, (iters, relres)) with
    iters an int and relres a float."""
    p = params
    f32 = np.float32
    x = torch.zeros_like(rhs) if x0 is None else x0
    if remove_mean:
        rhs = rhs - torch.mean(rhs)

    r = rhs - A(x)
    r0 = r                      # shadow residual
    rho = _dot(r0, r)
    norm0, normb = map(f32, read_scalars(_norm(r, p.norm_type),
                                         _norm(rhs, p.norm_type)))
    norm0s = max(norm0, f32(p.small))
    normb = max(normb, f32(p.small))

    prec = (lambda v: v) if M is None else M
    small = torch.tensor(p.small, dtype=torch.float32, device=rhs.device)
    one = torch.ones((), dtype=rhs.dtype, device=rhs.device)

    def safe(d):
        return torch.where(torch.abs(d) > small, d, small)

    v = torch.zeros_like(rhs)
    pvec = torch.zeros_like(rhs)
    alpha = omega = one
    rnorm = rbest = norm0
    stall = restarts = it = 0
    while it < p.imax and rnorm > f32(p.eps) * norm0s \
            and rnorm > f32(p.reps) * normb and restarts <= p.num_restarts:
        rho_old = rho
        rho = _dot(r0, r)
        beta = (rho / safe(rho_old)) * (alpha / safe(omega))
        pvec = r + beta * (pvec - omega * v)
        phat = prec(pvec)
        v = A(phat)
        alpha = rho / safe(_dot(r0, v))
        s_vec = r - alpha * v
        shat = prec(s_vec)
        t = A(shat)
        tt = _dot(t, t)
        omega = _dot(t, s_vec) / torch.where(tt > small, tt,
                                             torch.ones_like(tt))
        x = x + alpha * phat + omega * shat
        if remove_mean:
            x = x - torch.mean(x)
        r = s_vec - omega * t
        rnew, arho, aomega = map(f32, read_scalars(
            _norm(r, p.norm_type), torch.abs(rho), torch.abs(omega)))

        improved = rnew < f32(1.0 - p.hang) * rbest
        rbest = min(rbest, rnew)
        stall = 0 if improved else stall + 1
        breakdown = arho <= f32(p.small) or aomega <= f32(p.small)
        if breakdown or stall >= p.stall_iters:
            r = rhs - A(x)
            r0 = r
            rho = _dot(r, r)
            pvec = torch.zeros_like(r)
            v = torch.zeros_like(r)
            alpha = omega = one
            rnew = f32(read_scalars(_norm(r, p.norm_type))[0])
            restarts += 1
            stall = 0
        rnorm = rnew
        rbest = min(rbest, rnew)
        it += 1
    return x, (it, float(rnorm / norm0s))
