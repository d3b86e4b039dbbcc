"""Multigrid solves with the altered metric of implicit gravity: the port's
LevelMultigrid.solve(jgup_deltas=...) against the JAX package's on the
same terrain-following level and rhs.

The level is the 16x12 ledge of tests/test_stencil_gsrb_pallas.py's family
(shelf break, all-Neumann pressure BCs, 4 MG levels, probed-stencil plans
on the 3 finest), N^2 = 25 and dt*theta = 0.12, so that the delta is a
quarter of the vertical metric.  In the port the finest levels run the
K7/K8 twins with the delta weights probed once per solve; the JAX package
is run both on its jnp path and with SOMAR_FUSED_GSRB=1 (its Pallas
kernels in interpret mode, with the same delta weights).

  * f32 (BiCGStab bottom): the same V-cycle count as each JAX path, and
    phi within 1e-4 of max|phi|;
  * f64 with the smoothing bottom solver (the JAX BiCGStab cannot run under
    jax_enable_x64): the same V-cycle count, phi within 1e-9 of max|phi|.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from somar_tpu.core import bc as jbc
from somar_tpu.core.grid import Grid as JGrid
from somar_tpu.geometry.bathymetric import LedgeMap as JLedge
from somar_tpu.geometry.level_geometry import build_level_geometry as jgeo
from somar_tpu.problems.base import LinearProfile as JLinear
from somar_tpu.projection.altered_metric import AlteredMetric as JAltered
from somar_tpu.solvers.multigrid import LevelMultigrid as JMultigrid
from somar_tpu.solvers.multigrid import MGParams as JMG

from somar_tpu_torch.core import bc as tbc
from somar_tpu_torch.core.grid import Grid
from somar_tpu_torch.geometry.bathymetric import LedgeMap
from somar_tpu_torch.geometry.geo_source import TwistedMap
from somar_tpu_torch.geometry.level_geometry import build_level_geometry
from somar_tpu_torch.problems.base import LinearProfile
from somar_tpu_torch.projection.altered_metric import AlteredMetric
from somar_tpu_torch.solvers.multigrid import LevelMultigrid, MGParams
from tests.torch_jax_reference import jax_unoptimized  # noqa: F401 (autouse)

torch.set_num_threads(1)

NX, NZ = 16, 12
DT_THETA = 0.12
NSQ = 25.0
MG = {"f32": dict(eps=1e-6, imax=20, relax_mode="gsrb"),
      "f64": dict(eps=1e-6, imax=20, relax_mode="gsrb",
                  bottom_solver="smooth")}
TOL = {"f32": 1e-4, "f64": 1e-9}
GRID = dict(nx=(NX, NZ), dx=(2.0 / NX, 1.0 / NZ), x0=(-1.0, 0.0))
LEDGE = dict(hl=0.5, hr=1.0, xl=-0.5, xr=0.5)
#: (precision, JAX SOMAR_FUSED_GSRB flag)
RUNS = [("f32", "0"), ("f32", "1"), ("f64", "0")]


def _rhs():
    g = Grid(**GRID)
    x = g.cc_coord_1d(0)[None, :] * np.ones(g.shape)
    z = g.cc_coord_1d(1)[:, None] * np.ones(g.shape)
    return np.sin(2 * np.pi * x) * np.cos(np.pi * z)


def _jax_solve(prec, flag, monkeypatch):
    jd = jnp.float64 if prec == "f64" else jnp.float32
    monkeypatch.setenv("SOMAR_FUSED_GSRB", flag)
    jax.config.update("jax_enable_x64", prec == "f64")
    try:
        geo = jgeo(JGrid(**GRID), JLedge((0.0, 1.0), **LEDGE), dtype=jd)
        bcs = jbc.FieldBCs.from_periodic(geo.grid, jbc.BC.neumann(0.0))
        mg = JMultigrid(geo, bcs, params=JMG(**MG[prec]), dtype=jd)
        if flag == "1":
            assert mg.ops[0]._stencil_plan is not None
        deltas = JAltered(mg, JLinear(0.0, -NSQ), jd).jgup_delta_list(
            jnp.asarray(DT_THETA, jd))
        phi, (iters, relres) = mg.solve(jnp.asarray(_rhs(), jd),
                                        jgup_deltas=deltas)
        return np.asarray(phi), int(iters), float(relres)
    finally:
        jax.config.update("jax_enable_x64", False)


def _port_solve(prec):
    td = torch.float64 if prec == "f64" else torch.float32
    geo = build_level_geometry(Grid(**GRID), LedgeMap((0.0, 1.0), **LEDGE),
                               device="cpu", dtype=td)
    bcs = tbc.FieldBCs.from_periodic(geo.grid, tbc.BC.neumann(0.0))
    mg = LevelMultigrid(geo, bcs, MGParams(**MG[prec]), dtype=td)
    assert [op._stencil_plan is not None for op in mg.ops] == \
        [True, True, True, False]
    deltas = AlteredMetric(mg, LinearProfile(0.0, -NSQ), td).jgup_delta_list(
        DT_THETA)
    overrides = [op.delta_kernel_overrides(d)
                 for op, d in zip(mg.ops, deltas)]
    assert [o is not None for o in overrides] == [True, True, True, False]
    phi, (iters, relres) = mg.solve(torch.as_tensor(_rhs(), dtype=td),
                                    jgup_deltas=deltas)
    return phi.numpy(), iters, relres


@pytest.fixture(scope="module")
def port():
    return {prec: _port_solve(prec) for prec in ("f32", "f64")}


@pytest.mark.parametrize("prec,flag", RUNS,
                         ids=[f"{p}-fused{f}" for p, f in RUNS])
def test_ig_solve_matches_jax(port, prec, flag, monkeypatch):
    want, iters, relres = _jax_solve(prec, flag, monkeypatch)
    got, got_iters, got_relres = port[prec]
    assert got_iters == iters, (got_iters, iters, got_relres, relres)
    assert got_relres <= 1e-5 and relres <= 1e-5
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= TOL[prec] * scale


def test_auto_relax_mode_reads_the_metric():
    """'auto' smooths by vertical lines where the metric's vertical
    coupling beats the horizontal one by more than 4, cell by cell: on a
    ledge level at dx/dz = 10, not on a mildly twisted isotropic grid."""
    geo = build_level_geometry(
        Grid(nx=(40, 16), dx=(4.0 / 40, 0.16 / 16), x0=(-2.0, 0.0)),
        LedgeMap((0.0, 0.16), hl=0.08, hr=0.16, xl=-0.5, xr=0.5),
        device="cpu")
    bcs = tbc.FieldBCs.from_periodic(geo.grid, tbc.BC.neumann(0.0))
    assert LevelMultigrid(geo, bcs, MGParams()).modes[0] == "line"
    geo = build_level_geometry(Grid(nx=(16, 16), dx=(1 / 16, 1 / 16)),
                               TwistedMap((0.07, 0.07), (1.0, 1.0)),
                               device="cpu")
    assert LevelMultigrid(geo, bcs, MGParams()).modes[0] == "gsrb"
