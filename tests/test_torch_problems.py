"""The problem library and the time-dependent and array-valued BC values
of the port against the JAX package's, eagerly (no JAX compile), in
float64 (jax_enable_x64 for this module's JAX arrays):

  * every problem that `make_problem` builds from an inline deck
    (AdvectionTest, InternalWave, VortexStreet, HorizConv, SolitaryWave,
    DJL with its KdV eta, BeamGeneration): initial conditions, sponge
    targets, background and N^2, and every BC set (types exactly; values
    within 1e-12, callables at several times): 1e-12 of max|field|, but
    1e-11 for the fields SolitaryWave and DJL derive from the vertical
    mode: the JAX profile's N^2 comes from XLA's cosh, one ulp off
    numpy's, and the eigen solve amplifies that to ~1e-12;
  * DJL read from a DJLIC binary written from a seed (1e-12);
  * StructurePool's c0, phi, dphi/dz and N^2 on one profile whose N^2 is
    numpy in both (1e-12);
  * `fill_ghosts_cc` with VortexStreet's ramped inflow bound at a time
    (a Python float and a 0-d tensor) and with HorizConv's top profile,
    four ghost layers in 2D and 3D, where the earlier directions' fills
    have widened the profile's tangential axes (1e-12), and
    `apply_fc_bc` with a bound inflow (1e-12);
  * binding adds no host read (the ramp of a 0-d tensor stays a tensor);
  * a numpy profile and its `FieldBCs.on_device` tensor fill alike.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import somar_tpu.core.bc as jbc
from somar_tpu.config.context import ProblemContext as JContext
from somar_tpu.config.parmparse import ParmParse as JPP
from somar_tpu.geometry.level_geometry import build_level_geometry as jgeo
from somar_tpu.utils.strat import StructurePool as JPool

import somar_tpu_torch.core.bc as tbc
from somar_tpu_torch.config.context import ProblemContext as TContext
from somar_tpu_torch.config.parmparse import ParmParse as TPP
from somar_tpu_torch.geometry.level_geometry import build_level_geometry
from somar_tpu_torch.problems import TanhProfile, VortexStreet
from somar_tpu_torch.problems.library import HorizConv
from somar_tpu_torch.utils.strat import StructurePool as TPool
from tests.torch_jax_reference import jax_unoptimized  # noqa: F401 (autouse)

torch.set_num_threads(1)

RTOL = 1e-12
#: SolitaryWave and DJL fields derived from the vertical mode (see above)
MODE_RTOL = 1e-11

ADVECTION = """
amr.nx = 32 32
amr.length = 1 1
amr.isPeriodic = 1 1
ibc.problem = 0
projection.isIncompressible = 0
"""
INTERNAL_WAVE = """
amr.nx = 32 16
amr.length = 8 1
amr.nx_offset = -16 -16
ibc.problem = 3
ibc.useBackgroundScalar = 1
ibc.bgScalarProfile = 1
"""
VORTEX_STREET = """
amr.nx = 32 16
amr.length = 4 2
amr.nx_offset = 0 -8
amr.isPeriodic = 0 1
ibc.problem = 5
amr.viscosity = 1e-3
ibc.useSpongeLayer = 1
ibc.spongeWidthLo = 0.4 0
ibc.spongeWidthHi = 0.4 0
"""
HORIZ_CONV = """
amr.nx = 16 4 8
amr.length = 15 2 2
amr.isPeriodic = 0 1 0
ibc.problem = 6
amr.viscosity = 1e-4
amr.scal_diffusion_coeffs = 1e-4
"""
SOLITARY = """
amr.nx = 32 16
amr.length = 8 1
amr.nx_offset = -16 -16
ibc.problem = {problem}
ibc.useBackgroundScalar = 1
ibc.bgScalarProfile = 3
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
ibc.useSpongeLayer = 1
ibc.spongeWidthLo = 1920 0
ibc.spongeWidthHi = 1920 0
"""
DECKS = {"AdvectionTest": ADVECTION, "InternalWave": INTERNAL_WAVE,
         "VortexStreet": VORTEX_STREET, "HorizConv": HORIZ_CONV,
         "SolitaryWave": SOLITARY.format(problem=7),
         "DJL": SOLITARY.format(problem=8), "BeamGeneration": BEAM}


@pytest.fixture(autouse=True)
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _close(got, want, rtol=RTOL):
    g = (got.detach().cpu().numpy() if isinstance(got, torch.Tensor)
         else np.asarray(got, dtype=np.float64))
    w = np.asarray(want, dtype=np.float64)
    g = np.broadcast_to(g, np.broadcast_shapes(g.shape, w.shape))
    scale = max(float(np.abs(w).max()), 1e-30)
    err = float(np.abs(g - w).max())
    assert err <= rtol * scale, (err, scale)


def _levels(deck):
    jctx = JContext.from_parmparse(JPP.from_string(deck))
    tctx = TContext.from_parmparse(TPP.from_string(deck))
    jg = jgeo(jctx.base_grid(), jctx.new_geo_source(), jnp.float64)
    tg = build_level_geometry(tctx.base_grid(), tctx.new_geo_source(),
                              device="cpu", dtype=torch.float64)
    return jctx.new_problem(), tctx.new_problem(), jg, tg


def _same_bcs(tb, jb, times=(0.0, 0.3, 2.5)):
    assert len(tb.lo) == len(jb.lo)
    for t, j in zip(tb.lo + tb.hi, jb.lo + jb.hi):
        assert int(t.type) == int(j.type) and t.order == j.order
        assert t.time_dependent == j.time_dependent
        if j.time_dependent:
            for time in times:
                _close(tbc.BC.bind_time(t, time).value,
                       j.bind_time(jnp.asarray(time)).value)
        else:
            _close(t.value, j.value)


@pytest.mark.parametrize("name", list(DECKS))
def test_problem_matches_jax(name):
    jp, tp, jg, tg = _levels(DECKS[name])
    assert type(tp).__name__ == type(jp).__name__ == name
    assert tp.use_background_scalar == jp.use_background_scalar
    rtol = MODE_RTOL if name in ("SolitaryWave", "DJL") else RTOL
    _close(tp.vel_ic(tg), jp.vel_ic(jg), rtol)
    _close(tp.scalar_ic(tg, 0), jp.scalar_ic(jg, 0), rtol)
    if tp.use_background_scalar:
        _close(tp.background_cc(tg), jp.background_cc(jg))
        _close(tp.nsq_cc(tg), jp.nsq_cc(jg))
    assert (tp.sponge is None) == (jp.sponge is None)
    if tp.sponge is not None:
        assert tuple(tp.sponge.width_lo) == tuple(jp.sponge.width_lo)
        for t, j in zip(tp.sponge_targets(tg), jp.sponge_targets(jg)):
            _close(t, j)
    grid = tg.grid
    for viscous in (False, True):
        for t, j in zip(tp.vel_bcs(grid, viscous), jp.vel_bcs(jg.grid,
                                                               viscous)):
            _same_bcs(t, j)
    _same_bcs(tp.scalar_bcs(grid), jp.scalar_bcs(jg.grid))
    if hasattr(jp, "diffusive_solve_bcs"):
        _same_bcs(tp.diffusive_solve_bcs(grid),
                  jp.diffusive_solve_bcs(jg.grid))


def test_vortex_street_ramp_and_seed_match_jax():
    """The entry-level options a deck cannot set: the ramped inflow and
    another seed."""
    from somar_tpu.problems.library import VortexStreet as JVS
    _, _, jg, tg = _levels(VORTEX_STREET)
    jp = JVS(inflow_vel=(1.0, 0.0), seed=7, ramp_time=0.5)
    tp = VortexStreet(inflow_vel=(1.0, 0.0), seed=7, ramp_time=0.5)
    _close(tp.vel_ic(tg), jp.vel_ic(jg))
    for t, j in zip(tp.vel_bcs(tg.grid, True), jp.vel_bcs(jg.grid, True)):
        _same_bcs(t, j, times=(0.0, 0.1, 0.5, 0.9))


def test_djl_from_binary_matches_jax(tmp_path):
    """DJL.from_binary on a DJLIC file written from a seed (c, then the
    node-centred eta rows): both packages read the same wave."""
    from somar_tpu.problems.library import DJL as JDJL
    from somar_tpu_torch.problems.library import DJL as TDJL
    _, _, jg, tg = _levels(DECKS["DJL"])
    nz, nx = tg.grid.shape
    rng = np.random.default_rng(4)
    path = tmp_path / f"DJLIC_{nx}x{nz}.bin"
    np.concatenate([[0.7], 0.01 * rng.standard_normal((nz + 1) * (nx + 1))
                    ]).astype(np.float64).tofile(path)
    jp = JDJL.from_binary(str(path), nx, nz)
    tp = TDJL.from_binary(str(path), nx, nz)
    _close(tp.vel_ic(tg), jp.vel_ic(jg))
    _close(tp.scalar_ic(tg, 0), jp.scalar_ic(jg, 0))


def test_structure_pool_matches_jax():
    bg_t = TanhProfile(b0=0.0, db=1.0, z0=-0.15, delta=0.05)
    for nz, dz in ((16, 1.0 / 16), (40, 0.025)):
        got = TPool().get(bg_t, -1.0, nz, dz, nmodes=2)
        want = JPool().get(bg_t, -1.0, nz, dz, nmodes=2)
        for g, w in zip(got, want):
            _close(g, w)
    pool = TPool()
    assert pool.get(bg_t, -1.0, 16, 0.0625) is pool.get(bg_t, -1.0, 16,
                                                        0.0625)


@pytest.mark.parametrize("deck", ["2d", "3d"])
def test_time_dependent_fill_matches_jax(deck):
    """VortexStreet's ramped inflow bound at a time fills four ghost
    layers as JAX's does, bound at a float or at a 0-d tensor."""
    from somar_tpu.problems.library import VortexStreet as JVS
    text = VORTEX_STREET if deck == "2d" else (
        "amr.nx = 16 4 8\namr.length = 4 1 2\namr.isPeriodic = 0 1 0\n"
        "ibc.problem = 5\n")
    _, _, jg, tg = _levels(text)
    nd = tg.grid.ndim
    inflow = (1.0,) + (0.0,) * (nd - 1)
    jp = JVS(inflow_vel=inflow, ramp_time=0.5)
    tp = VortexStreet(inflow_vel=inflow, ramp_time=0.5)
    rng = np.random.default_rng(4)
    field = rng.standard_normal(tg.grid.shape)
    for m, (tb, jb) in enumerate(zip(tp.vel_bcs(tg.grid, True),
                                     jp.vel_bcs(jg.grid, True))):
        for time in (0.2, 0.75):
            want = jbc.fill_ghosts_cc(jnp.asarray(field), jg.grid,
                                      jb.at_time(jnp.asarray(time)), 4)
            t0 = torch.tensor(time, dtype=torch.float64)
            for bound in (tb.at_time(time), tb.at_time(t0),
                          tbc.bind_bcs_time((tb,), t0)[0]):
                got = tbc.fill_ghosts_cc(torch.from_numpy(field), tg.grid,
                                         bound, 4)
                _close(got, want)
            if m == 0:
                # a 0-d tensor time binds to a 0-d tensor: no host read
                assert isinstance(tb.at_time(t0).lo[0].value, torch.Tensor)
        with pytest.raises(ValueError, match="not bound"):
            tbc.fill_ghosts_cc(torch.from_numpy(field), tg.grid, tb, 4)


def test_fc_bc_with_a_bound_inflow_matches_jax():
    from somar_tpu.problems.library import VortexStreet as JVS
    _, _, jg, tg = _levels(VORTEX_STREET)
    jp = JVS(inflow_vel=(1.0, 0.0), ramp_time=0.5)
    tp = VortexStreet(inflow_vel=(1.0, 0.0), ramp_time=0.5)
    flux = np.random.default_rng(5).standard_normal(tg.grid.fc_shape(0))
    t0 = torch.tensor(0.3, dtype=torch.float64)
    want = jbc.apply_fc_bc(jnp.asarray(flux), 0, jg.grid,
                           jp.vel_bcs(jg.grid, False)[0].at_time(
                               jnp.asarray(0.3)))
    src = torch.from_numpy(flux)
    got = tbc.apply_fc_bc(src, 0, tg.grid,
                          tp.vel_bcs(tg.grid, False)[0].at_time(t0))
    _close(got, want)
    assert float(src[..., 0].abs().max()) > 0.0   # input left as it was


@pytest.mark.parametrize("deck", ["2d", "3d"])
def test_array_value_fill_matches_jax(deck):
    """HorizConv's top profile (1, [1,] nx) against a field whose x (and
    y) axes the earlier fills widened by the ghost layers."""
    from somar_tpu.problems.library import HorizConv as JHC
    text = HORIZ_CONV if deck == "3d" else (
        "amr.nx = 32 8\namr.length = 15 2\nibc.problem = 6\n")
    _, _, jg, tg = _levels(text)
    jb = JHC().scalar_bcs(jg.grid)
    tb = HorizConv().scalar_bcs(tg.grid)
    field = np.random.default_rng(6).standard_normal(tg.grid.shape)
    for ng in (1, 4):
        want = jbc.fill_ghosts_cc(jnp.asarray(field), jg.grid, jb, ng)
        for bcs in (tb, tb.on_device("cpu", torch.float64)):
            got = tbc.fill_ghosts_cc(torch.from_numpy(field), tg.grid, bcs,
                                     ng)
            _close(got, want)
    on = tb.on_device("cpu", torch.float32)
    top = on.hi[tg.grid.vertical_dir].value
    assert isinstance(top, torch.Tensor) and top.dtype == torch.float32
    assert on.lo[0].value == 0.0 and not on.time_dependent
