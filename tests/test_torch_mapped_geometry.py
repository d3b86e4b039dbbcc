"""Mapped metrics in the port against the JAX package, on the same maps.

  * LevelGeometry fields (J, Jinv, J g^dd, J g^d:, e, einv, gdn at cells
    and faces) of the stretched, twisted, cylindrical, ledge and
    beam-generator maps in 2D and 3D: both packages evaluate the same
    float64 numpy, so they agree to 1e-12 of each field's max in f64;
  * the basis transforms (to_mapped, to_cartesian, contract_vectors),
    written out as elementwise sums in the port;
  * mapped mac_gradient (cross-metric terms, Neumann cross zeroing),
    mac_divergence, cc_gradient and PoissonOp.apply, with and without an
    altered-metric delta: 1e-5 of max|ref| in f32, 1e-12 in f64;
  * AlteredMetric.jgup_delta_list on every MG level: the same tolerances;
  * the multigrid schedule of the 640x512 BeamGeneration stand-in level is
    the one the JAX package recorded (docs/PROFILE_MAPPED_r05.txt:12);
  * the stratification utilities (N^2, vertical modes) and the
    BeamGeneration problem's sponge and tide, in float64 to 1e-12.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from somar_tpu.core import bc as jbc
from somar_tpu.core.grid import Grid as JGrid
from somar_tpu.geometry import bathymetric as jbath
from somar_tpu.geometry import geo_source as jsrc
from somar_tpu.geometry.level_geometry import build_level_geometry as jgeo
from somar_tpu.ops import stencil as jst
from somar_tpu.problems import base as jbase
from somar_tpu.problems.base import LinearProfile as JLinear
from somar_tpu.problems.library import BeamGeneration as JBeam
from somar_tpu.projection.altered_metric import AlteredMetric as JAltered
from somar_tpu.solvers.multigrid import semicoarsening_schedule as jsched
from somar_tpu.solvers.poisson_op import PoissonOp as JOp
from somar_tpu.utils import strat as jstrat

from somar_tpu_torch import entry
from somar_tpu_torch.core import bc as tbc
from somar_tpu_torch.core.grid import Grid
from somar_tpu_torch.geometry import bathymetric as tbath
from somar_tpu_torch.geometry import geo_source as tsrc
from somar_tpu_torch.geometry.level_geometry import build_level_geometry
from somar_tpu_torch.ops import stencil as tst
from somar_tpu_torch.problems import base as tbase
from somar_tpu_torch.problems.base import LinearProfile
from somar_tpu_torch.problems.library import BeamGeneration
from somar_tpu_torch.projection.altered_metric import AlteredMetric
from somar_tpu_torch.solvers.multigrid import semicoarsening_schedule
from somar_tpu_torch.solvers.poisson_op import PoissonOp
from somar_tpu_torch.utils import strat as tstrat
from tests.torch_jax_reference import jax_unoptimized  # noqa: F401 (autouse)

torch.set_num_threads(1)

TOL = {"f32": 1e-5, "f64": 1e-12}


def _stretched(nd, src, bath):
    s = 3.0
    fns = [lambda x: x] * (nd - 1) + [
        lambda z: (np.exp(s * z) - 1.0) / (np.exp(s) - 1.0)]
    return {}, src.StretchedCartesianMap(tuple(fns))


def _twisted(nd, src, bath):
    return {}, src.TwistedMap((0.07,) * nd, (1.0,) * nd)


def _cylindrical(nd, src, bath):
    # r in [0.5, 1.5], theta in [0, pi/2]
    return dict(x0=(0.5, 0.0, 0.0)[:nd],
                dx=(1.0 / 16, 0.5 * np.pi / 12, 1.0 / 10)[:nd]), \
        src.CylindricalMap()


def _ledge(nd, src, bath):
    return dict(x0=(-1.0,) * (nd - 1) + (0.0,),
                dx=tuple(2.0 / n for n in (16, 12, 10)[:nd])), \
        bath.LedgeMap((0.0, 1.0), hl=0.5, hr=1.0, xl=-0.5, xr=0.5)


def _beam(nd, src, bath):
    Lx, H = 38400.0, 3000.0
    nx = (16, 12, 10)[:nd]
    return dict(x0=(-Lx / 2,) + (0.0,) * (nd - 1),
                dx=(Lx / nx[0],) + (Lx / nx[1],) * (nd - 2)
                + (H / nx[-1],)), \
        bath.BeamGeneratorMap((0.0, H), full_depth=H,
                              angle=float(np.deg2rad(15.0)), lx=Lx)


MAPS = {"stretched": _stretched, "twisted": _twisted,
        "cylindrical": _cylindrical, "ledge": _ledge, "beam": _beam}
GEO_CASES = [(m, nd) for m in MAPS for nd in (2, 3)]


def _grids(name, nd, periodic=None):
    """(JAX grid + map, port grid + map) of one map."""
    nx = (16, 12, 10)[:nd]
    out = []
    for grid_cls, src, bath in ((JGrid, jsrc, jbath), (Grid, tsrc, tbath)):
        kw, geo_src = MAPS[name](nd, src, bath)
        kw.setdefault("dx", tuple(1.0 / n for n in nx))
        if periodic is not None:
            kw["periodic"] = periodic
        out.append((grid_cls(nx=nx, **kw), geo_src))
    return out


def _x64(prec):
    jax.config.update("jax_enable_x64", prec == "f64")


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _close(got, want, tol, what=""):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    scale = np.abs(want).max() + 1e-300
    err = np.abs(got - np.broadcast_to(want, got.shape)).max()
    assert err <= tol * scale, (what, err, scale)


@pytest.mark.parametrize("name,nd", GEO_CASES,
                         ids=[f"{m}-{nd}d" for m, nd in GEO_CASES])
def test_geometry_fields_match_jax_f64(x64, name, nd):
    (jg, jsrc_), (tg, tsrc_) = _grids(name, nd)
    want = jgeo(jg, jsrc_, dtype=jnp.float64)
    got = build_level_geometry(tg, tsrc_, device="cpu", dtype=torch.float64)
    assert got.J.dtype == torch.float64 and not got.is_uniform
    for f in ("J", "Jinv", "e_cc", "einv_cc", "gdn_cc"):
        _close(getattr(got, f), getattr(want, f), 1e-12, f)
    for d in range(nd):
        _close(got.Jgup_diag[d], want.Jgup_diag[d], 1e-12, f"Jgup_diag{d}")
    assert (got.Jgup_full is None) == (want.Jgup_full is None)
    if got.Jgup_full is not None:
        for d in range(nd):
            _close(got.Jgup_full[d], want.Jgup_full[d], 1e-12,
                   f"Jgup_full{d}")
    # basis transforms on a random velocity
    v = np.random.RandomState(2).randn(nd, *tg.shape)
    tv = torch.from_numpy(v)
    _close(got.to_mapped(tv), want.to_mapped(jnp.asarray(v)), 1e-12)
    _close(got.to_cartesian(tv), want.to_cartesian(jnp.asarray(v)), 1e-12)
    _close(got.contract_vectors(tv, tv),
           want.contract_vectors(jnp.asarray(v), jnp.asarray(v)), 1e-12)


# operator cases: (map, ndim, periodic, lo BCs, hi BCs)
OP_CASES = [
    ("ledge", 2, (False, False), "NN", "NN"),
    ("beam", 2, (False, False), "ND", "NN"),
    ("twisted", 3, (True, False, False), "PDN", "PNN"),
]
OP_PARAMS = [(c, prec, delta) for c in OP_CASES for prec in ("f32", "f64")
             for delta in (False, True)]


def _bcs(mod, letters):
    mk = {"N": mod.BC.neumann, "D": mod.BC.dirichlet, "P": mod.BC.periodic}
    return tuple(mk[c]() for c in letters)


@pytest.mark.parametrize(
    "case,prec,delta", OP_PARAMS,
    ids=[f"{c[0]}-{c[1]}d-{p}-{'delta' if dl else 'plain'}"
         for c, p, dl in OP_PARAMS])
def test_mapped_operators_match_jax(case, prec, delta):
    name, nd, periodic, lo, hi = case
    _x64(prec)
    try:
        (jg, jsrc_), (tg, tsrc_) = _grids(name, nd, periodic)
        jd = jnp.float64 if prec == "f64" else jnp.float32
        td = torch.float64 if prec == "f64" else torch.float32
        npd = np.float64 if prec == "f64" else np.float32
        jgeo_ = jgeo(jg, jsrc_, dtype=jd)
        tgeo = build_level_geometry(tg, tsrc_, device="cpu", dtype=td)
        jb = jbc.FieldBCs(lo=_bcs(jbc, lo), hi=_bcs(jbc, hi))
        tb = tbc.FieldBCs(lo=_bcs(tbc, lo), hi=_bcs(tbc, hi))
        rng = np.random.RandomState(5)
        phi = rng.randn(*tg.shape).astype(npd)
        jdel = tdel = None
        if delta:
            diag = [(-0.1 * rng.rand(*tg.fc_shape(d))).astype(npd)
                    for d in range(nd)]
            full = [(0.05 * rng.randn(nd, *tg.fc_shape(d))).astype(npd)
                    for d in range(nd)]
            jdel = (tuple(map(jnp.asarray, diag)),
                    tuple(map(jnp.asarray, full)))
            tdel = (tuple(map(torch.from_numpy, diag)),
                    tuple(map(torch.from_numpy, full)))
        tol = TOL[prec]
        jphi, tphi = jnp.asarray(phi), torch.from_numpy(phi)
        jgrad = jst.mac_gradient(jphi, jgeo_, jb, jgup_delta=jdel)
        tgrad = tst.mac_gradient(tphi, tgeo, tb, jgup_delta=tdel)
        for d in range(nd):
            _close(tgrad[d], jgrad[d], tol, f"mac_gradient {d}")
        _close(tst.mac_divergence(tgrad, tgeo),
               jst.mac_divergence(jgrad, jgeo_), tol, "mac_divergence")
        _close(PoissonOp(tgeo, tb).apply(tphi, 0.3, 1.2, jgup_delta=tdel),
               JOp(jgeo_, jb).apply(jphi, 0.3, 1.2, jgup_delta=jdel), tol,
               "PoissonOp.apply")
        if not delta:
            _close(tst.cc_gradient(tphi, tgeo, tb),
                   jst.cc_gradient(jphi, jgeo_, jb), tol, "cc_gradient")
    finally:
        _x64("f32")


@pytest.mark.parametrize("prec", ["f32", "f64"])
def test_altered_metric_deltas_match_jax(prec):
    """Every MG level's (delta_diag, delta_full) of a small BeamGeneration
    level; the JAX AlteredMetric reads only the levels' geometries."""
    _x64(prec)
    try:
        jd = jnp.float64 if prec == "f64" else jnp.float32
        td = torch.float64 if prec == "f64" else torch.float32
        (jg, jsrc_), (tg, tsrc_) = _grids("beam", 2)
        sched = semicoarsening_schedule(tg)
        jgeos, tgeos = [], []
        for k in range(len(sched) + 1):
            jgeos.append(jgeo(jg, jsrc_, dtype=jd))
            tgeos.append(build_level_geometry(tg, tsrc_, device="cpu",
                                              dtype=td))
            if k < len(sched):
                jg, tg = jg.coarsen(sched[k]), tg.coarsen(sched[k])
        jmg = types.SimpleNamespace(ops=[types.SimpleNamespace(geo=g)
                                         for g in jgeos])
        tmg = types.SimpleNamespace(ops=[types.SimpleNamespace(geo=g)
                                         for g in tgeos])
        jam = JAltered(jmg, JLinear(0.0, -1.493e-5), jd)
        tam = AlteredMetric(tmg, LinearProfile(0.0, -1.493e-5), td)
        dt_theta = 0.6 * 84.19
        want = jam.jgup_delta_list(jnp.asarray(dt_theta, jd))
        got = tam.jgup_delta_list(dt_theta)
        assert len(got) == len(want) == len(sched) + 1
        for (tdiag, tfull), (jdiag, jfull) in zip(got, want):
            for a, b in zip(tdiag, jdiag):
                _close(a, b, TOL[prec], "delta_diag")
            for a, b in zip(tfull, jfull):
                _close(a, b, TOL[prec], "delta_full")
        _close(tam.nsq_cc(), jam.nsq_cc(None), TOL[prec], "nsq_cc")
    finally:
        _x64("f32")


def test_beam_level_multigrid_schedule():
    """The 640x512 stand-in (dx/dz = 10.24) coarsens as the JAX package's
    mapped bench recorded: 11 levels from (512, 640) to (2, 5), with a
    probed-stencil plan wherever every extent is at least 3."""
    grid = Grid(nx=(640, 512), dx=(entry.BEAM_LENGTH / 640,
                                   entry.BEAM_DEPTH / 512))
    shapes = [grid.shape]
    for ratio in semicoarsening_schedule(grid):
        grid = grid.coarsen(ratio)
        shapes.append(grid.shape)
    assert shapes == [(512, 640), (256, 640), (128, 640), (64, 640),
                      (32, 320), (16, 160), (8, 80), (4, 40), (2, 20),
                      (2, 10), (2, 5)]
    jgrid = JGrid(nx=(640, 512), dx=(entry.BEAM_LENGTH / 640,
                                     entry.BEAM_DEPTH / 512))
    assert semicoarsening_schedule(Grid(nx=(640, 512), dx=jgrid.dx)) \
        == jsched(jgrid)


@pytest.mark.parametrize("nmodes", [1, 3])
def test_vertical_modes_match_jax(nmodes):
    """solve_vert_eigen_problem on a pycnocline profile and on the
    BeamGeneration one: the same host float64 computation."""
    z = -3000.0 + (np.arange(64) + 0.5) * (3000.0 / 64)
    for nsq in (1e-4 * (1.0 + 0.5 * np.tanh((z + 1500.0) / 300.0)),
                np.full(64, 1.493e-5)):
        c, phi = tstrat.solve_vert_eigen_problem(nsq, 3000.0 / 64, nmodes)
        jc, jphi = jstrat.solve_vert_eigen_problem(nsq, 3000.0 / 64, nmodes)
        np.testing.assert_allclose(c, jc, rtol=1e-12)
        np.testing.assert_allclose(phi, jphi, rtol=0, atol=1e-10)
        assert tstrat.compute_max_bv_freq(nsq) == \
            jstrat.compute_max_bv_freq(nsq)
    # the JAX profile evaluates in jnp (float32 without x64)
    bg = LinearProfile(0.0, -1.493e-5)
    np.testing.assert_allclose(
        tstrat.compute_bv_freq(bg, z),
        jstrat.compute_bv_freq(JLinear(0.0, -1.493e-5), z), rtol=1e-7)


def test_beam_problem_forcing_matches_jax(x64):
    """BeamGeneration's sponge ramp, tide and background match the JAX
    problem's (the port evaluates the tide in Python floats)."""
    (jg, _), (tg, _) = _grids("beam", 2)
    kw = dict(tidal_u0=0.01, tidal_omega=1e-3, ndim=2)
    tp = BeamGeneration(background=LinearProfile(0.0, -1.493e-5), **kw)
    jp = JBeam(background=JLinear(0.0, -1.493e-5), **kw)
    assert tp.use_background_scalar and jp.use_background_scalar
    assert (tp.sponge.width_lo, tp.sponge.width_hi, tp.sponge.time_coeff) \
        == (jp.sponge.width_lo, jp.sponge.width_hi, jp.sponge.time_coeff)
    np.testing.assert_allclose(tbase.sponge_ramp(tg, tp.sponge),
                               jbase.sponge_ramp(jg, jp.sponge), atol=1e-14)
    for t_old, dt in ((0.0, 5.0), (1234.5, 7.25)):
        got = tbase.tidal_source(tp.tidal, 2, t_old, dt)
        want = jbase.tidal_source(jp.tidal, 2, jnp.asarray(t_old),
                                  jnp.asarray(dt))
        np.testing.assert_allclose(got, [float(w) for w in want],
                                   rtol=1e-12, atol=1e-20)
