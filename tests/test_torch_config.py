"""The port's input layer against the JAX package's on inline decks, with
no JAX compile:

  * ParmParse: the same table and the same typed reads from a string and
    from a file with command-line overrides (exact);
  * ProblemContext: every field, field by field, on the lock exchange 2D
    and 3D, Taylor-Green, BeamGeneration, Ledge, per-solver multigrid
    overrides and a DEM deck (exact; JAX dtypes map to torch.float32 /
    float64);
    amr.precision = 64 against the JAX context built in a subprocess (JAX
    turns on x64 process-wide there), and a garbage precision raising;
  * make_problem and new_geo_source: the same classes and parameters; the
    factory's geometry equal to a direct construction (exact); DEMMap's
    map against JAX's in float64 (1e-12);
  * chip_smoke.py's decks D1-D3 build the runs of entry.build_level and
    entry.build_beam_level (NSParams, grid, problem, map).
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from somar_tpu.config.context import ProblemContext as JContext
from somar_tpu.config.parmparse import ParmParse as JPP

from somar_tpu_torch.config.context import ProblemContext as TContext
from somar_tpu_torch.config.parmparse import ParmParse as TPP
from somar_tpu_torch.core.grid import Grid as TGrid
from somar_tpu_torch.geometry.bathymetric import (
    BeamGeneratorMap as TBeamMap, LedgeMap as TLedge)
from somar_tpu_torch.geometry.level_geometry import build_level_geometry
from tests.torch_jax_reference import jax_unoptimized  # noqa: F401 (autouse)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

LOCK_2D = """
amr.nx = 48 16
amr.length = 15.0 2.0
amr.nx_offset = -24 0
ibc.problem = 1
amr.gravityMethod = 1
amr.viscosity = 0.0001
amr.scal_diffusion_coeffs = 0.0001
amr.maxsteps = 3  # a comment
plot.plot_interval = 2
advection.useLimitingScal = 1
"""

LOCK_3D = """
amr.nx = 32 8 16
amr.length = 15 2 2
amr.nx_offset = -16 0 0
amr.isPeriodic = 0 1 0
amr.cfl = 0.9
amr.viscosity = 1e-4
amr.scal_diffusion_coeffs = 1e-4
projection.initial_projection_iters = 2
projection.initial_pressure_iters = 2
AMRMG.imin = 2
AMRMG.num_smooth_down = 4
AMRMG.num_smooth_up = 4
AMRMG.num_smooth_bottom = 4
"""

TAYLOR_GREEN = """
amr.nx = 32 32
amr.length = 1.0 1.0
amr.isPeriodic = 1 1
ibc.problem = 4
amr.gravityMethod = 0
amr.viscosity = 0.001
amr.fixed_dt = 0.002
amr.updateScheme = 2
AMRMG.eps = 1e-5
plot.writeVorticity = 1
plot.writeStreamFunction = 1
"""

BEAM = """
amr.nx = 64 32
amr.length = 38400 3000
amr.nx_offset = -32 0
geometry.coordMap = 2
geometry.beamGenMapAlpha = 15
ibc.problem = 2
ibc.useBackgroundScalar = 1
ibc.bgScalarProfile = 1
ibc.tidalU0 = 0.01
ibc.tidalOmega = 1e-3
amr.gravityMethod = 2
amr.gravityTheta = 0.6
amr.limitDtViaInternalWaveSpeed = 1
AMRMG.relax_mode = 1
ibc.useSpongeLayer = 1
ibc.spongeWidthLo = 1920 0
ibc.spongeWidthHi = 1920 0
ibc.spongeTimeCoeff = 10
"""

LEDGE = """
amr.nx = 32 16
amr.length = 8.0 2.0
amr.nx_offset = -16 0
geometry.coordMap = 5
geometry.ledgeMapHl = 1.0
geometry.ledgeMapHr = 0.0
geometry.ledgeMapXl = -1.0
geometry.ledgeMapXr = 1.0
geometry.ledgeMapTransitionOrder = 1
ibc.problem = 1
amr.viscousSolverType = 2
amr.viscous_solver_type = 2
amr.diffusive_solver_type = 0
"""

MG_OVERRIDES = LOCK_2D + """
AMRMG.eps = 1e-7
AMRMG.imax = 30
AMRMG.relax_mode = 3
bottom.imax = 40
MACprojection_AMRMG.eps = 1e-9
CCprojection_AMRMG.num_smooth_up = 6
syncProjection_AMRMG.imax = 7
VD_bottom.eps = 1e-4
viscous_AMRMG.maxDepth = 3
diffusive_bottom.numRestarts = 2
projection.solver = 1
projection.level_projection_iters = 2
amr.maxlevel = 2
amr.refratio_lev0 = 4 2
amr.regrid_intervals = 4 2
amr.max_patches = 2 3
plot.writeRi = 1
"""

DEM_DECK = """
amr.nx = 24 8 16
amr.length = 6.0 2.0 1.0
amr.nx_offset = -12 0 0
amr.isPeriodic = 0 1 0
geometry.coordMap = 8
geometry.Interpolation_Order = 1
ibc.problem = 1
"""

DECKS = {"lock2d": LOCK_2D, "lock3d": LOCK_3D, "taylor_green": TAYLOR_GREEN,
         "beam": BEAM, "ledge": LEDGE, "mg_overrides": MG_OVERRIDES}


def _norm(v):
    """A plain comparable value: dataclasses and objects as dicts, dtypes
    as their names, numpy scalars as Python numbers."""
    if v is jnp.float32 or v is torch.float32:
        return "float32"
    if v is jnp.float64 or v is torch.float64:
        return "float64"
    if dataclasses.is_dataclass(v):
        return {f.name: _norm(getattr(v, f.name))
                for f in dataclasses.fields(v)}
    if isinstance(v, (list, tuple)):
        return tuple(_norm(x) for x in v)
    if isinstance(v, np.ndarray):
        return ("array", v.tolist())
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, dict):
        return {k: _norm(x) for k, x in v.items()}
    if hasattr(v, "__dict__") and not isinstance(v, type):
        return (type(v).__name__, _norm(vars(v)))
    return v


def _ctx_dicts(jctx, tctx):
    """Both contexts as plain dicts."""
    return _norm(jctx), _norm(tctx)


def _dem_file(path, ndim):
    """A synthetic X[/Y]/Depth DEM file; 3D depth stored (ny, nx)."""
    import h5py

    rng = np.random.default_rng(7)
    x = np.linspace(-3.0, 3.0, 25)
    with h5py.File(path, "w") as f:
        f["X"] = x
        if ndim == 2:
            f["Depth"] = 0.6 + 0.3 * np.tanh(x) + 0.02 * rng.random(x.size)
        else:
            y = np.linspace(0.0, 2.0, 9)
            f["Y"] = y
            f["Depth"] = (0.6 + 0.3 * np.tanh(x)[None, :]
                          + 0.1 * np.sin(np.pi * y)[:, None]
                          + 0.02 * rng.random((y.size, x.size)))
    return str(path)


def _contexts(deck):
    return (JContext.from_parmparse(JPP.from_string(deck)),
            TContext.from_parmparse(TPP.from_string(deck)))


def test_parmparse_from_string_matches_jax():
    text = MG_OVERRIDES + "weird = 1 2 [3]\nempty =\nlater = a\nlater = b\n"
    jp, tp = JPP.from_string(text), TPP.from_string(text)
    assert tp._table == jp._table
    for get, key, args in [("get_int", "amr.maxsteps", ()),
                           ("get_real", "AMRMG.eps", ()),
                           ("get_str", "later", ()),
                           ("get_bool", "plot.writeRi", ()),
                           ("get_int_vect", "amr.nx", (2,)),
                           ("get_real_vect", "amr.length", (3,)),
                           ("get_int_vect", "weird", (3,)),
                           ("get_int", "missing", (5,)),
                           ("get_real_vect", "empty", (2, None))]:
        assert getattr(tp, get)(key, *args) == getattr(jp, get)(key, *args)
    with pytest.raises(KeyError):
        tp.require_real("missing")


def test_parmparse_from_file_with_overrides_matches_jax(tmp_path):
    path = tmp_path / "inputs.deck"
    path.write_text(LOCK_3D)
    over = ["amr.maxsteps=7", "amr.nx=64 16 32", "plot.plot_interval = 5"]
    jp, tp = JPP.from_file(str(path), over), TPP.from_file(str(path), over)
    assert tp._table == jp._table
    assert tp.get_int_vect("amr.nx", 3) == (64, 16, 32)


@pytest.mark.parametrize("name", sorted(DECKS))
def test_context_matches_jax(name):
    jctx, tctx = _contexts(DECKS[name])
    want, got = _ctx_dicts(jctx, tctx)
    assert got == want
    assert tctx.ns.dtype is torch.float32
    assert tctx.base_grid() == TGrid(**dataclasses.asdict(jctx.base_grid()))


@pytest.mark.parametrize("ndim", [2, 3])
def test_dem_context_and_map_match_jax(tmp_path, ndim):
    deck = DEM_DECK if ndim == 3 else DEM_DECK.replace(
        "amr.nx = 24 8 16", "amr.nx = 24 16").replace(
        "amr.length = 6.0 2.0 1.0", "amr.length = 6.0 1.0").replace(
        "amr.nx_offset = -12 0 0", "amr.nx_offset = -12 0").replace(
        "amr.isPeriodic = 0 1 0", "amr.isPeriodic = 0 0")
    dem = _dem_file(tmp_path / "dem.hdf5", ndim)
    path = tmp_path / "inputs.dem"
    # a DEM path relative to the input file resolves next to it
    path.write_text(deck + "geometry.DemFile = dem.hdf5\n")
    jctx = JContext.from_file(str(path))
    tctx = TContext.from_file(str(path))
    assert tctx.dem_file == jctx.dem_file == dem
    want, got = _ctx_dicts(jctx, tctx)
    assert got == want
    jsrc, tsrc = jctx.new_geo_source(), tctx.new_geo_source()
    assert type(tsrc).__name__ == type(jsrc).__name__ == "DEMMap"
    xi = tctx.base_grid().coords()
    for mu in range(ndim):
        want = np.asarray(jsrc.phys_coor(mu, xi), np.float64)
        got = np.asarray(tsrc.phys_coor(mu, xi), np.float64)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
        for nu in range(ndim):
            want = np.asarray(jsrc.dxdxi(mu, nu, xi), np.float64)
            got = np.asarray(tsrc.dxdxi(mu, nu, xi), np.float64)
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("name", ["lock2d", "lock3d", "taylor_green", "beam",
                                  "ledge"])
def test_make_problem_matches_jax(name):
    jctx, tctx = _contexts(DECKS[name])
    jp, tp = jctx.new_problem(), tctx.new_problem()
    assert type(tp).__name__ == type(jp).__name__
    assert _norm(vars(tp)) == _norm(vars(jp))
    for attr in ("num_scalars", "use_background_scalar"):
        assert getattr(tp, attr) == getattr(jp, attr)
    jg, tg = jctx.new_geo_source(), tctx.new_geo_source()
    assert type(tg).__name__ == type(jg).__name__
    assert _norm(vars(tg)) == _norm(vars(jg))


def test_unported_problems_raise():
    """Every ibc.problem is ported now: the six that used to raise build
    the JAX package's class with its parameters (tests/test_torch_problems
    .py holds their fields)."""
    for t in (0, 3, 5, 6, 7, 8):
        deck = LOCK_2D + f"ibc.problem = {t}\n"
        jctx, tctx = _contexts(deck)
        jp, tp = jctx.new_problem(), tctx.new_problem()
        assert type(tp).__name__ == type(jp).__name__
        for attr in ("num_scalars", "use_background_scalar"):
            assert getattr(tp, attr) == getattr(jp, attr)


@pytest.mark.parametrize("name,direct", [
    ("beam", lambda: TBeamMap((0.0, 3000.0), full_depth=3000.0,
                              angle=float(np.deg2rad(15.0)), lx=38400.0)),
    ("ledge", lambda: TLedge((0.0, 2.0), hl=1.0, hr=2.0, xl=-1.0, xr=1.0,
                             transition_order=1)),
])
def test_factory_geometry_equals_direct_construction(name, direct):
    _, tctx = _contexts(DECKS[name])
    grid = tctx.base_grid()
    a = build_level_geometry(grid, tctx.new_geo_source(), device="cpu",
                             dtype=torch.float64)
    b = build_level_geometry(grid, direct(), device="cpu",
                             dtype=torch.float64)
    for f in ("J", "Jinv", "e_cc", "einv_cc", "gdn_cc"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    for d in range(grid.ndim):
        assert torch.equal(a.Jgup_diag[d], b.Jgup_diag[d])


def test_precision_64_matches_jax_subprocess():
    """The JAX context with amr.precision = 64 turns on x64 process-wide,
    so it is built in a subprocess; the port's selects torch.float64 and
    changes nothing global."""
    deck = TAYLOR_GREEN + "amr.precision = 64\n"
    script = (
        "import json, sys\n"
        "from somar_tpu.config.context import ProblemContext\n"
        "from somar_tpu.config.parmparse import ParmParse\n"
        "from tests.test_torch_config import _norm\n"
        "ctx = ProblemContext.from_parmparse(ParmParse.from_string("
        "sys.stdin.read()))\n"
        "print(json.dumps(_norm(ctx.ns)))\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", script], input=deck,
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    want = json.loads(proc.stdout.strip().splitlines()[-1])
    default = torch.get_default_dtype()
    tctx = TContext.from_parmparse(TPP.from_string(deck))
    assert torch.get_default_dtype() == default
    assert tctx.ns.dtype is torch.float64
    got = _norm(tctx.ns)
    assert json.loads(json.dumps(got)) == want
    assert want["dtype"] == "float64"


def test_precision_rejects_garbage():
    with pytest.raises(ValueError, match="amr.precision"):
        TContext.from_parmparse(TPP.from_string(
            TAYLOR_GREEN + "amr.precision = banana\n"))


def test_chip_smoke_decks_build_the_entry_levels():
    """chip_smoke.py's decks D1-D3 set every key that makes the context's
    run that of entry.build_level(512, 128, 128) (D2: with RK3) and of
    entry.build_beam_level(640, 512): NSParams field by field (per-solver
    multigrid blocks resolved), the grid, the problem and the map.  The
    parameters do not depend on the size, so the entry levels are built
    small here."""
    import chip_smoke
    from somar_tpu_torch import entry

    def fields(obj):
        return {k: (fields(v) if hasattr(v, "__dict__") else v)
                for k, v in vars(obj).items()}

    lock, _ = entry.build_level(16, 8, 8, device="cpu")
    beam, _ = entry.build_beam_level(40, 32, device="cpu")
    rk3 = dataclasses.replace(lock.params, update_scheme="rk3")
    cases = [
        (chip_smoke.D1_DECK, lock.params, lock,
         TGrid(nx=(512, 128, 128), dx=(15 / 512, 2 / 128, 2 / 128),
               x0=(-7.5, 0.0, 0.0), periodic=(False, True, False))),
        (chip_smoke.D2_DECK, rk3, lock,
         TGrid(nx=(512, 128, 128), dx=(15 / 512, 2 / 128, 2 / 128),
               x0=(-7.5, 0.0, 0.0), periodic=(False, True, False))),
        (chip_smoke.D3_DECK, beam.params, beam,
         TGrid(nx=(640, 512), dx=(38400 / 640, 3000 / 512),
               x0=(-19200.0, 0.0))),
    ]
    for deck, params, level, grid in cases:
        ctx = TContext.from_parmparse(TPP.from_string(deck))
        assert (chip_smoke.resolved_params(ctx.ns)
                == chip_smoke.resolved_params(params))
        assert ctx.base_grid() == grid
        prob, src = ctx.new_problem(), ctx.new_geo_source()
        assert type(prob) is type(level.problem)
        assert fields(prob) == fields(level.problem)
        assert type(src) is type(level.geo.geo)
        assert vars(src) == vars(level.geo.geo)
    d2_small = TContext.from_parmparse(TPP.from_string(
        chip_smoke.D2_DECK + chip_smoke.D2_SMALL))
    assert d2_small.amr.nx == (64, 16, 32)
    assert d2_small.ns.update_scheme == "rk3"
