"""The leptic pressure solver of the port and its substrate (subspace
utilities, raw geometries and their multigrid coarsening) against the JAX
package's, eagerly, in float64 (jax_enable_x64; every multigrid bottom is
the smoothing bottom, as the JAX BiCGStab cannot run in f64):

  * `flatten_grid`, `vertical_integral`, `vertical_mean`, `extrude`
    (1e-12);
  * `raw_level_geometry` fed through `entry.raw_geometry_from_numpy`,
    `raw_from_level_geometry` of a terrain-following level (full metric),
    and `coarsen_raw_geometry` along a semicoarsening schedule (1e-12);
    `LevelMultigrid` on a raw level coarsens its arrays as JAX's does,
    and on a 2D raw level builds the probed-stencil plans (K7-K8's twins);
  * `LevelLepticSolver.solve` and `solve_with_fallback` on the JAX tests'
    flat periodic 2D domains (a 1D horizontal level) and on a flat 3D box
    (a 2D horizontal level): orders and status exactly, phi within 1e-8
    of max|phi|, the final relative residual within 1e-6 of JAX's or both
    below 1e-9; a box outside the leptic regime, where the expansion
    hangs and the line-relaxed multigrid finishes;
  * the projector's leptic branch (`LevelProjector(method="leptic")`):
    MAC and CC projections against JAX's (1e-8).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from somar_tpu.core.bc import BC as JBC, FieldBCs as JFieldBCs
from somar_tpu.core.grid import Grid as JGrid
from somar_tpu.geometry import raw_geometry as jraw
from somar_tpu.geometry.bathymetric import BeamGeneratorMap as JBeamMap
from somar_tpu.geometry.geo_source import CartesianMap as JCartesian
from somar_tpu.geometry.level_geometry import build_level_geometry as jgeo
from somar_tpu.projection.projector import LevelProjector as JProjector
from somar_tpu.solvers.leptic import LepticParams as JLP
from somar_tpu.solvers.leptic import LevelLepticSolver as JLeptic
from somar_tpu.solvers.multigrid import LevelMultigrid as JMG
from somar_tpu.solvers.multigrid import MGParams as JMGParams
from somar_tpu.utils import subspace as jsub

from somar_tpu_torch import entry
from somar_tpu_torch.core.bc import BC as TBC, FieldBCs as TFieldBCs
from somar_tpu_torch.core.grid import Grid as TGrid
from somar_tpu_torch.geometry import raw_geometry as traw
from somar_tpu_torch.geometry.bathymetric import BeamGeneratorMap as TBeamMap
from somar_tpu_torch.geometry.geo_source import CartesianMap as TCartesian
from somar_tpu_torch.geometry.level_geometry import build_level_geometry
from somar_tpu_torch.projection.projector import LevelProjector as TProjector
from somar_tpu_torch.solvers.leptic import LepticParams as TLP
from somar_tpu_torch.solvers.leptic import LevelLepticSolver as TLeptic
from somar_tpu_torch.solvers.multigrid import LevelMultigrid as TMG
from somar_tpu_torch.solvers.multigrid import MGParams as TMGParams
from somar_tpu_torch.utils import subspace as tsub
from tests.torch_jax_reference import jax_unoptimized  # noqa: F401 (autouse)

torch.set_num_threads(1)

RTOL = 1e-12
PHI_RTOL = 1e-8
#: the leptic horizontal multigrid with the smoothing bottom (f64)
HORIZ = dict(eps=1e-2, imin=1, imax=4, num_smooth_down=2, num_smooth_up=2,
             bottom_solver="smooth")


@pytest.fixture(autouse=True)
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _np(x):
    return (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, dtype=np.float64))


def _close(got, want, rtol=RTOL):
    g, w = _np(got), _np(want)
    g = np.broadcast_to(g, np.broadcast_shapes(g.shape, w.shape))
    scale = max(float(np.abs(w).max()), 1e-30)
    err = float(np.abs(g - w).max())
    assert err <= rtol * scale, (err, scale)


def _levels(kw, geo=("cartesian",)):
    if geo[0] == "beam":
        jsrc = JBeamMap((0.0, 3000.0), full_depth=3000.0, angle=0.26,
                        lx=38400.0)
        tsrc = TBeamMap((0.0, 3000.0), full_depth=3000.0, angle=0.26,
                        lx=38400.0)
    else:
        jsrc, tsrc = JCartesian(), TCartesian()
    return (jgeo(JGrid(**kw), jsrc, jnp.float64),
            build_level_geometry(TGrid(**kw), tsrc, device="cpu",
                                 dtype=torch.float64))


def _neumann(jg, tg):
    return (JFieldBCs.from_periodic(jg.grid, JBC.neumann(0.0)),
            TFieldBCs.from_periodic(tg.grid, TBC.neumann(0.0)))


#: the JAX tests' flat periodic 2D domain (tests/test_leptic.py), a flat
#: 3D box in the leptic regime (dx_h = 2H), and a box outside it
FLAT_2D = dict(nx=(32, 8), dx=(32.0 / 32, 1.0 / 8), periodic=(True, False))
FLAT_3D = dict(nx=(8, 8, 8), dx=(2.0, 2.0, 1.0 / 8),
               periodic=(False, False, False))
SQUARE_2D = dict(nx=(16, 16), dx=(1.0 / 16, 1.0 / 16),
                 periodic=(False, False))


# --------------------------------------------------------------------------
# subspace and raw geometry
# --------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [FLAT_2D, FLAT_3D], ids=["2d", "3d"])
def test_subspace_matches_jax(kw):
    jg, tg = JGrid(**kw), TGrid(**kw)
    h = tsub.flatten_grid(tg)
    assert h == TGrid(**{k: v for k, v in
                         vars(jsub.flatten_grid(jg)).items()})
    rng = np.random.default_rng(0)
    f = rng.standard_normal(tg.shape)
    w = 1.0 + rng.random(tg.shape)
    tf, jf = torch.from_numpy(f), jnp.asarray(f)
    tw, jw = torch.from_numpy(w), jnp.asarray(w)
    _close(tsub.vertical_integral(tf, tg), jsub.vertical_integral(jf, jg))
    _close(tsub.vertical_integral(tf, tg, tw),
           jsub.vertical_integral(jf, jg, jw))
    _close(tsub.vertical_mean(tf, tg), jsub.vertical_mean(jf, jg))
    _close(tsub.vertical_mean(tf, tg, tw), jsub.vertical_mean(jf, jg, jw))
    flat = tsub.vertical_mean(tf, tg)
    _close(tsub.extrude(flat, tg.shape[0]),
           jsub.extrude(jsub.vertical_mean(jf, jg), jg.shape[0]))


def _same_geometry(t, j):
    assert t.grid.nx == j.grid.nx and t.grid.dx == j.grid.dx
    _close(t.J, j.J)
    _close(t.Jinv, j.Jinv)
    for d in range(t.grid.ndim):
        _close(t.Jgup_diag[d], j.Jgup_diag[d])
    for f in ("Jgup_full", "e_cc", "einv_cc", "gdn_cc"):
        tv, jv = getattr(t, f), getattr(j, f)
        assert (tv is None) == (jv is None), f
        if tv is not None:
            if f == "Jgup_full":
                for d in range(t.grid.ndim):
                    _close(tv[d], jv[d])
            else:
                _close(tv, jv)


@pytest.mark.parametrize("kw", [FLAT_2D, FLAT_3D], ids=["2d", "3d"])
def test_raw_geometry_and_coarsening(kw):
    """Random positive arrays through the numpy carrier, coarsened along
    the semicoarsening schedule."""
    from somar_tpu.solvers.multigrid import semicoarsening_schedule
    g = TGrid(**kw)
    rng = np.random.default_rng(1)
    J = 1.0 + rng.random(g.shape)
    Jg = [0.5 + rng.random(g.fc_shape(d)) for d in range(g.ndim)]
    jl = jraw.raw_level_geometry(JGrid(**kw), jnp.asarray(J),
                                 [jnp.asarray(a) for a in Jg], jnp.float64)
    tl = entry.raw_geometry_from_numpy(g, J, Jg, device="cpu",
                                       dtype=torch.float64)
    assert isinstance(tl.geo, traw.RawGeoSource) and not tl.is_uniform
    _same_geometry(tl, jl)
    for ratio in semicoarsening_schedule(JGrid(**kw))[:3]:
        jl = jraw.coarsen_raw_geometry(jl, ratio)
        tl = traw.coarsen_raw_geometry(tl, ratio)
        _same_geometry(tl, jl)


def test_raw_from_mapped_level_keeps_the_full_metric():
    kw = dict(nx=(32, 16), dx=(38400.0 / 32, 3000.0 / 16),
              x0=(-19200.0, 0.0))
    jg, tg = _levels(kw, ("beam",))
    jl, tl = jraw.raw_from_level_geometry(jg), traw.raw_from_level_geometry(tg)
    assert tl.geo == traw.RawGeoSource(is_diagonal=False)
    _same_geometry(tl, jl)
    for ratio in ((2, 2), (2, 1)):
        jl = jraw.coarsen_raw_geometry(jl, ratio)
        tl = traw.coarsen_raw_geometry(tl, ratio)
        _same_geometry(tl, jl)


def test_multigrid_on_a_raw_level():
    """A 2D raw level (the flattened 3D box's): the hierarchy's arrays
    coarsen as JAX's, every level with an extent of 4 or more gets a
    probed-stencil plan, and an f64 solve matches JAX's."""
    jg, tg = _levels(FLAT_3D)
    jb, tb = _neumann(jg, tg)
    js = JLeptic(jg, jb, JLP(horiz_mg=JMGParams(**HORIZ)), jnp.float64)
    ts = TLeptic(tg, tb, TLP(horiz_mg=TMGParams(**HORIZ)), torch.float64)
    assert ts.h_mg.ratios == js.h_mg.ratios
    for top, jop in zip(ts.h_mg.ops, js.h_mg.ops):
        _same_geometry(top.geo, jop.geo)
        assert (top._stencil_plan is not None) == (min(top.grid.nx) > 2)
    assert ts.h_mg.modes == js.h_mg.modes
    params = dict(eps=1e-10, imax=8, bottom_solver="smooth")
    jm = JMG(js.h_mg.ops[0].geo, js.h_mg.ops[0].bcs, JMGParams(**params),
             jnp.float64)
    tm = TMG(ts.h_mg.ops[0].geo, ts.h_mg.ops[0].bcs, TMGParams(**params),
             torch.float64)
    rhs = np.random.default_rng(2).standard_normal(tg.grid.shape[1:])
    rhs -= rhs.mean()
    pj, ij = jm.solve(jnp.asarray(rhs), singular=True)
    pt, it = tm.solve(torch.from_numpy(rhs), singular=True)
    assert it[0] == int(ij[0])
    _close(pt, pj, PHI_RTOL)


# --------------------------------------------------------------------------
# the leptic solver
# --------------------------------------------------------------------------
def _solvers(kw, max_order=12, eps=1e-6):
    jg, tg = _levels(kw)
    jb, tb = _neumann(jg, tg)
    js = JLeptic(jg, jb, JLP(eps=eps, max_order=max_order,
                             horiz_mg=JMGParams(**HORIZ)), jnp.float64)
    ts = TLeptic(tg, tb, TLP(eps=eps, max_order=max_order,
                             horiz_mg=TMGParams(**HORIZ)), torch.float64)
    return js, ts, tg.grid


def _same_info(got, want):
    it, rr, status = got
    assert it == int(want[0]) and status == int(want[2]), (got, want)
    w = float(want[1])
    assert abs(rr - w) <= 1e-6 * w or max(rr, w) < 1e-9, (rr, w)


def _smooth_rhs(grid):
    """The sin/cos rhs of tests/test_leptic.py (periodic in x)."""
    kx = 2 * np.pi / grid.domain_length(0)
    x, z = grid.coords()
    return (-(kx ** 2) * np.sin(kx * np.asarray(x)) * np.ones(grid.shape)
            - 0.1 * np.pi ** 2 * np.cos(np.pi * np.asarray(z))
            * np.ones(grid.shape))


def _random_rhs(grid, seed=3):
    rhs = np.random.default_rng(seed).standard_normal(grid.shape)
    return rhs - rhs.mean()


def test_leptic_solve():
    """The smooth rhs of tests/test_leptic.py on its flat periodic 2D
    domain, leptic orders alone."""
    js, ts, grid = _solvers(FLAT_2D)
    rhs = _smooth_rhs(grid)
    pj, ij = js.solve(jnp.asarray(rhs))
    pt, it = ts.solve(torch.from_numpy(rhs))
    _same_info(it, ij)
    _close(pt, pj, PHI_RTOL)


@pytest.mark.parametrize("kw", [FLAT_2D, FLAT_3D, SQUARE_2D],
                         ids=["flat2d", "flat3d", "square2d-hang"])
def test_leptic_solve_with_fallback(kw):
    """A random compatible rhs; the orders, status and phi of the leptic
    attempt plus the multigrid finisher where it is needed."""
    js, ts, grid = _solvers(kw)
    rhs = _random_rhs(grid)
    pj, ij = js.solve_with_fallback(jnp.asarray(rhs))
    pt, it = ts.solve_with_fallback(torch.from_numpy(rhs))
    _same_info(it, ij)
    _close(pt, pj, PHI_RTOL)
    assert it[1] < 1e-5
    if kw is SQUARE_2D:
        # outside the leptic regime the expansion stops reducing the
        # residual and the multigrid finisher does the work
        assert it[2] == 3   # LepticStatus.HANG


def test_projector_leptic_branch():
    """LevelProjector(method="leptic") on a flat 2D lock-exchange-like
    level (walls all round): its MAC and CC projections against JAX's,
    both projectors' leptic solvers given the smoothing bottom."""
    kw = dict(nx=(32, 8), dx=(15.0 / 32, 0.25 / 8), x0=(-7.5, 0.0))
    jg, tg = _levels(kw)
    jp = JProjector(jg, method="leptic", dtype=jnp.float64)
    tp = TProjector(tg, method="leptic", dtype=torch.float64)
    assert tp.method == "leptic" and isinstance(tp.leptic, TLeptic)
    jp.leptic = JLeptic(jg, jp.phi_bcs, JLP(horiz_mg=JMGParams(**HORIZ)),
                        jnp.float64)
    tp.leptic = TLeptic(tg, tp.phi_bcs, TLP(horiz_mg=TMGParams(**HORIZ)),
                        torch.float64)
    rng = np.random.default_rng(4)
    flux = [rng.standard_normal(tg.grid.fc_shape(d)) for d in range(2)]
    jout, jphi, jinfo = jp.project_mac([jnp.asarray(f) for f in flux])
    tout, tphi, tinfo = tp.project_mac([torch.from_numpy(f) for f in flux])
    _close(tphi, jphi, PHI_RTOL)
    for d in range(2):
        _close(tout[d], jout[d], PHI_RTOL)
    assert tinfo[0] == int(jinfo[0]) and tp.last_info["mac"] == tinfo
    from somar_tpu.problems.lock_exchange import LockExchange as JLock
    from somar_tpu_torch.problems.lock_exchange import LockExchange as TLock
    vel = rng.standard_normal((2,) + tg.grid.shape)
    jv, jphi, _ = jp.project_cc(jnp.asarray(vel),
                                JLock().vel_bcs(jg.grid, False))
    tv, tphi, _ = tp.project_cc(torch.from_numpy(vel),
                                TLock().vel_bcs(tg.grid, False))
    _close(tphi, jphi, PHI_RTOL)
    _close(tv, jv, PHI_RTOL)
