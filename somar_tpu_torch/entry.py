"""Entry points of the port: the 3D lock-exchange level of the JAX
package's `__graft_entry__`, the single-level time loop of its `RunDriver`
(somar_tpu/driver.py), and the state carriers between the two packages.

    level, grid = build_level(nx=64, nz=32, ny=16, device="cuda")
    state = run(level, level.initial_state(), nsteps=10)
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from somar_tpu_torch.core.grid import Grid
from somar_tpu_torch.geometry.geo_source import CartesianMap
from somar_tpu_torch.geometry.level_geometry import (
    build_level_geometry, require_device)
from somar_tpu_torch.physics.navier_stokes import NSLevel, NSParams, NSState
from somar_tpu_torch.problems.lock_exchange import LockExchange
from somar_tpu_torch.solvers.multigrid import MGParams

STATE_FIELDS = tuple(f.name for f in dataclasses.fields(NSState))


def build_level(nx: int, nz: int, ny: int | None = None, *, device="cuda",
                dtype=torch.float32, pressure_solver: str = "auto",
                mg: MGParams = MGParams()):
    """The lock exchange on a 15 x [2 x] 2 box: 2D (x, z) without ny, 3D
    periodic in y with it.  Explicit gravity, Crank-Nicolson viscosity and
    diffusion (nu = kappa = 1e-4), CFL 0.9.  pressure_solver "auto" takes
    the spectral pressure solves; "mg" with mg=MGParams(eps=1e-5, imax=12)
    is the multigrid-forced level of the JAX package's bench.  Runs on the
    GPU unless `device` says otherwise, and raises without one.
    Returns (level, grid)."""
    Lx, Lz = 15.0, 2.0
    if ny is None:
        grid = Grid(nx=(nx, nz), dx=(Lx / nx, Lz / nz), x0=(-Lx / 2, 0.0))
        prob = LockExchange(pert_amp=0.0)
    else:
        Ly = 2.0
        grid = Grid(nx=(nx, ny, nz), dx=(Lx / nx, Ly / ny, Lz / nz),
                    x0=(-Lx / 2, 0.0, 0.0), periodic=(False, True, False))
        prob = LockExchange()
    geo = build_level_geometry(grid, CartesianMap(), device=device,
                               dtype=dtype)
    params = NSParams(nu=1e-4, kappa=(1e-4,), gravity_method=1, cfl=0.9,
                      pressure_solver=pressure_solver, mg=mg, dtype=dtype)
    return NSLevel(geo, prob, params), grid


def run(level: NSLevel, state: NSState, nsteps: int,
        on_step: Optional[Callable[[int, NSState, float], None]] = None
        ) -> NSState:
    """RunDriver's single-level loop: initial projections, a first dt of
    init_dt_multiplier times the CFL dt, lagged-pressure initialization,
    then `nsteps` steps with dt = min(compute_dt, max_dt_grow * dt,
    max_dt).  compute_dt is one host read per step (the iterative pressure
    solvers add theirs).  on_step(i, state, dt) is called after step i (and
    with i = -1 on the initialized state)."""
    p = level.params
    state = level.post_initialize(state)
    dt = min(level.compute_dt(state) * p.init_dt_multiplier, p.max_dt)
    if p.fixed_dt > 0.0:
        dt = p.fixed_dt
    state = level.initialize_pressure(state, dt)
    if on_step is not None:
        on_step(-1, state, dt)
    for i in range(nsteps):
        if i > 0:
            dt = min(level.compute_dt(state), p.max_dt_grow * dt, p.max_dt)
            if p.fixed_dt > 0.0:
                dt = p.fixed_dt
        state = level.advance(state, dt)
        if on_step is not None:
            on_step(i, state, dt)
    return state


def ns_state_from_numpy(fields: Dict[str, np.ndarray], device="cuda",
                        dtype=torch.float32) -> NSState:
    """An NSState on `device` (the GPU unless told otherwise) from host
    arrays keyed by field name (e.g. a JAX NSState read out with
    np.asarray per field)."""
    device = require_device(device)
    return NSState(**{
        name: torch.tensor(np.array(fields[name]), dtype=dtype,
                           device=device)
        for name in STATE_FIELDS})


def ns_state_to_numpy(state: NSState) -> Dict[str, np.ndarray]:
    """Host copies of every NSState field, keyed by field name."""
    return {name: getattr(state, name).detach().cpu().numpy()
            for name in STATE_FIELDS}
