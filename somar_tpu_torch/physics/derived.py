"""Derived diagnostic fields of a level's state (PyTorch port of
`somar_tpu.physics.derived`): vorticity, the 2D stream function, the
vector Laplacian of the velocity, the gradient Richardson number and the
kinetic energy.  The total energy is `NSLevel.total_energy`."""

from __future__ import annotations

import numpy as np
import torch

from somar_tpu_torch.core.bc import bind_bcs_time
from somar_tpu_torch.ops.stencil import vorticity
from somar_tpu_torch.utils.strat import gradient_richardson_number


def compute_vorticity(level, state):
    return vorticity(state.vel, level.geo,
                     bind_bcs_time(level.vel_bcs_trace, state.time))


def compute_stream_function(level, state):
    """2D stream function psi: lap(psi) = -omega, gauge mean(psi) = 0 (one
    pressure-operator solve)."""
    assert level.grid.ndim == 2, "the stream function is a 2D diagnostic"
    rhs = -compute_vorticity(level, state)
    psi, _ = level.projector._solve(rhs - torch.mean(rhs))
    return psi - torch.mean(psi)


def compute_lap_vel(level, state):
    """Vector Laplacian of the Cartesian velocity, per component."""
    with level._bound_time_bcs(state.time):
        return torch.stack([
            level._visc_ops[m].apply(state.vel[m], 0.0, 1.0,
                                     homogeneous=False)
            for m in range(level.grid.ndim)])


def compute_ri_number(level, state):
    """Gradient Richardson number of the total buoyancy."""
    b_total = state.scalars[0]
    if level.problem.use_background_scalar:
        b_total = b_total + level._tensor(level.problem.background_cc(
            level.geo))
    return gradient_richardson_number(state.vel, b_total, level.geo)


def kinetic_energy(level, state):
    """Volume integral of 0.5 |u|^2 J dV (a 0-d tensor)."""
    ke = 0.5 * torch.sum(state.vel * state.vel, dim=0)
    dv = float(np.prod(level.grid.dx))
    return torch.sum(ke * level.geo.J) * dv
