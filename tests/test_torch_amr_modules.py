"""The port's AMR leaf modules against the JAX package's, module by module,
eagerly, in float64 (jax_enable_x64) unless named:

  * transfers (prolong_linear / _quadratic, restrict_average and the
    face-centred pair, extract / insert_patch with clamping, time_interp)
    on 2D and 3D shapes at ratios (4,1), (4,1,1) and (2,2): 1e-13;
  * the flux register (increment_fine / _coarse, reflux) with one and two
    CF directions: 1e-13;
  * mapped sums and norms, and their composite (hierarchy) versions on a
    2D 32x8 hierarchy at ratio (4,1): 1e-13;
  * the coupling's transfers on that hierarchy (halo fill, halo
    overwrite, CF ring, average-down): 1e-13;
  * the clustering library: the port's boxes and bounding boxes equal
    somar_tpu.native's on random and lock-exchange tag fields, and it
    builds into build/, not beside its source;
  * compute_tags: identical booleans on the 2D and 3D lock exchange, at
    the initial state and after 3 single-level steps, for every tagger;
  * the patch footprint: `patch_footprint` equals the JAX PatchCoupling's
    interior_nx and ext_nx on shapes that reach each branch (span, the
    max_grid_size cap, the 4H floor, the cap, the 128-multiple x-snap up,
    down and without a candidate) and at the chip smoke's A1 and A2
    shapes;
  * NSLevel.advance(collect_fluxes=True) against the jitted JAX step on a
    2D level: state and interface fluxes to 1e-12;
  * the hierarchy's compute_dt and level_dts on one state: 1e-13;
  * entry.amr_hierarchy_from_context against the JAX RunDriver's
    hierarchy from the same deck (footprint, nt, tag parameters, sync
    knobs, the regrid cadence, the placed origin; amr.max_patches = 2
    pinning K), and the deck keys of slice 11c (refluxing, implicit
    refluxing, post-regrid smoothing, the VD correction) set as the JAX
    driver sets them;
  * placement right-sizing as in JAX: the footprint widened with
    max_auto_patches = 1, K doubled without it;
  * the features that slices 10 and 11 ported (K pinned by num_patches,
    regrid, dynamic subcycling, weights, refluxing, the VD correction,
    post-regrid smoothing, RK3 with CF rings) run; attach_mesh raises
    naming ROADMAP A.7;
  * chip_smoke.py's limit on the sync solve's final relres: the sound
    solve stays below it after each of 3 coarse steps on A0's 3D and 2D
    hierarchies, and each fault of SYNC_FAULTS (one composite pass, no
    FAS tau, no lagged elliptic reflux) crosses it (port only).
"""

import dataclasses
import types

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from somar_tpu import native as jnative
from somar_tpu.amr import transfer as jtr
from somar_tpu.amr.flux_register import PatchFluxRegister as JRegister
from somar_tpu.amr.hierarchy import AMRHierarchy as JHierarchy
from somar_tpu.amr.hierarchy import PatchCoupling as JCoupling
from somar_tpu.amr.tagging import TagParams as JTags
from somar_tpu.amr.tagging import compute_tags as jcompute_tags
from somar_tpu.config.context import ProblemContext as JContext
from somar_tpu.config.parmparse import ParmParse as JPP
from somar_tpu.core.grid import Grid as JGrid
from somar_tpu.driver import RunDriver as JDriver
from somar_tpu.geometry.geo_source import CartesianMap as JCartesian
from somar_tpu.geometry.level_geometry import build_level_geometry as jgeo
from somar_tpu.ops import norms as jnorms
from somar_tpu.physics.navier_stokes import NSLevel as JLevel
from somar_tpu.physics.navier_stokes import NSParams as JParams
from somar_tpu.physics.navier_stokes import NSState as JState
from somar_tpu.problems.lock_exchange import LockExchange as JLock
from somar_tpu.solvers.multigrid import MGParams as JMG

from somar_tpu_torch import entry, native as tnative
from somar_tpu_torch.amr import transfer as ttr
from somar_tpu_torch.amr.flux_register import PatchFluxRegister as TRegister
from somar_tpu_torch.amr.hierarchy import patch_footprint
from somar_tpu_torch.amr.tagging import TagParams as TTags
from somar_tpu_torch.amr.tagging import compute_tags as tcompute_tags
from somar_tpu_torch.config.context import ProblemContext as TContext
from somar_tpu_torch.config.parmparse import ParmParse as TPP
from somar_tpu_torch.core.grid import Grid as TGrid
from somar_tpu_torch.ops import norms as tnorms
from somar_tpu_torch.physics.navier_stokes import NSState as TState
from somar_tpu_torch.solvers.multigrid import MGParams as TMG
from tests.torch_jax_reference import jax_unoptimized  # noqa: F401 (autouse)

torch.set_num_threads(1)

TOL = 1e-13
F64 = torch.float64


@pytest.fixture(scope="module", autouse=True)
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _t(a):
    return torch.tensor(np.array(a), dtype=F64)


def _close(got, want, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-300)
    err = np.abs(got - want).max()
    assert err <= tol * scale, (err, scale)


def _grids(nx, periodic=None):
    periodic = periodic or (False,) * len(nx)
    dx = tuple(1.0 / n for n in nx)
    return (JGrid(nx=nx, dx=dx, periodic=periodic),
            TGrid(nx=nx, dx=dx, periodic=periodic))


# ------------------------------------------------------------- transfers
TRANSFER_CASES = {
    "2d r41": ((8, 6), (4, 1)),
    "3d r411": ((6, 5, 4), (4, 1, 1)),
    "2d r22": ((8, 6), (2, 2)),
    "2d r22 extent 2": ((8, 2), (2, 2)),
}


@pytest.mark.parametrize("case", list(TRANSFER_CASES))
def test_transfers_match_jax(case):
    nx, ratio = TRANSFER_CASES[case]
    jg, tg = _grids(nx)
    jgf, tgf = _grids(tuple(n * r for n, r in zip(nx, ratio)))
    rng = np.random.default_rng(hash(case) % 2**32)
    c = rng.normal(size=jg.shape)
    c[..., : jg.shape[-1] // 2] += 3.0        # a jump for the limiter
    for jf, tf in ((jtr.prolong_linear, ttr.prolong_linear),
                   (jtr.prolong_quadratic, ttr.prolong_quadratic)):
        _close(tf(_t(c), tg, ratio), jf(jnp.asarray(c), jg, ratio))
    f = rng.normal(size=jgf.shape)
    _close(ttr.restrict_average(_t(f), tgf, ratio),
           jtr.restrict_average(jnp.asarray(f), jgf, ratio))
    for d in range(len(nx)):
        ffc = rng.uniform(0.5, 2.0, size=jgf.fc_shape(d))
        for harmonic in (False, True):
            _close(ttr.restrict_average_fc(_t(ffc), d, tgf, ratio, harmonic),
                   jtr.restrict_average_fc(jnp.asarray(ffc), d, jgf, ratio,
                                           harmonic))
        cfc = rng.normal(size=jg.fc_shape(d))
        _close(ttr.prolong_linear_fc(_t(cfc), d, tg, ratio),
               jtr.prolong_linear_fc(jnp.asarray(cfc), d, jg, ratio))
    # patches at origins inside, and past the edge (clamped as
    # lax.dynamic_slice clamps)
    shape = tuple(max(1, n // 2) for n in jg.shape)
    for origin in ((1,) * len(nx), tuple(n - 1 for n in jg.shape)):
        _close(ttr.extract_patch(_t(c), origin, shape),
               jtr.extract_patch(jnp.asarray(c), origin, shape))
        p = rng.normal(size=shape)
        _close(ttr.insert_patch(_t(c), _t(p), origin),
               jtr.insert_patch(jnp.asarray(c), jnp.asarray(p), origin))


def _random_states(shape, ndim, rng):
    fields = {f: rng.normal(size=((ndim,) if f == "vel" else (1,)
                                  if f == "scalars" else ()) + shape)
              for f in entry.STATE_FIELDS if f != "time"}
    fields["time"] = np.asarray(rng.uniform())
    return fields


def test_time_interp_matches_jax():
    rng = np.random.default_rng(3)
    a, b = (_random_states((4, 6), 2, rng) for _ in range(2))
    want = jtr.time_interp(JState(**{k: jnp.asarray(v) for k, v in a.items()}),
                           JState(**{k: jnp.asarray(v) for k, v in b.items()}),
                           0.375)
    got = ttr.time_interp(TState(**{k: _t(v) for k, v in a.items()}),
                          TState(**{k: _t(v) for k, v in b.items()}), 0.375)
    for f in entry.STATE_FIELDS:
        _close(getattr(got, f), getattr(want, f))


# --------------------------------------------------------- flux register
REGISTER_CASES = {
    # parent nx, periodic, ratio, interior (fine), origin (array axes)
    "2d one cf dir": ((16, 4), (False, False), (4, 1), (32, 4), (0, 12)),
    "2d r22": ((16, 8), (False, False), (2, 2), (16, 16), (0, 6)),
    "3d two cf dirs": ((16, 16, 4), (False, False, False), (4, 1, 1),
                       (32, 8, 4), (0, 2, 12)),
}


def _coupling_ns(nx, periodic, ratio, interior):
    """The attributes a flux register reads from a coupling, for both
    packages."""
    ndim = len(nx)
    H = 4
    cf = tuple(d for d in range(ndim) if d != ndim - 1 and not periodic[d])
    ext = tuple(interior[d] + (2 * H if d in cf else 0) for d in range(ndim))
    out = []
    for G in (JGrid, TGrid):
        pg = G(nx=nx, dx=tuple(1.0 / n for n in nx), periodic=periodic)
        eg = G(nx=ext, dx=tuple(pg.dx[d] / ratio[d] for d in range(ndim)))
        out.append(types.SimpleNamespace(
            cf_dirs=cf, interior_nx=interior, ratio=ratio, ext_grid=eg,
            halo=H, parent_grid=pg, device=torch.device("cpu"),
            params=types.SimpleNamespace(dtype=F64)))
    return out


@pytest.mark.parametrize("case", list(REGISTER_CASES))
def test_flux_register_matches_jax(case):
    nx, periodic, ratio, interior, origin = REGISTER_CASES[case]
    jc, tc = _coupling_ns(nx, periodic, ratio, interior)
    jr, tr = JRegister(jc), TRegister(tc)
    rng = np.random.default_rng(11)
    ndim = len(nx)
    fine = [rng.normal(size=jc.ext_grid.fc_shape(d)) for d in range(ndim)]
    coarse = [rng.normal(size=jc.parent_grid.fc_shape(d))
              for d in range(ndim)]
    jreg = jr.increment_fine(jr.zeros(), [jnp.asarray(f) for f in fine], 0.25)
    treg = tr.increment_fine(tr.zeros(), [_t(f) for f in fine], 0.25)
    jreg = jr.increment_coarse(jreg, [jnp.asarray(f) for f in coarse],
                               origin)
    treg = tr.increment_coarse(treg, [_t(f) for f in coarse], origin)
    for d in jc.cf_dirs:
        for side in (0, 1):
            _close(treg[d][side], jreg[d][side])
    cc = rng.normal(size=jc.parent_grid.shape)
    _close(tr.reflux(_t(cc), treg, origin, 0.7),
           jr.reflux(jnp.asarray(cc), jreg, origin, 0.7))


# ------------------------------------------------- a 2D hierarchy pair
def _jax_hierarchy(nx=32, nz=8, sync=True):
    g = JGrid(nx=(nx, nz), dx=(15 / nx, 2 / nz), x0=(-7.5, 0.0))
    params = JParams(nu=1e-4, kappa=(1e-4,), gravity_method=1, cfl=0.9,
                     mg=JMG(bottom_solver="smooth"), dtype=jnp.float64)
    return JHierarchy(jgeo(g, JCartesian(), dtype=jnp.float64),
                      JLock(pert_amp=0.0), params, ratio=(4, 1),
                      tag_params=JTags(buoyancy_tag_tol=0.2, tags_grow=1),
                      do_sync_projection=sync)


@pytest.fixture(scope="module")
def pair():
    jh = _jax_hierarchy()
    th = entry.build_amr_hierarchy(32, None, 8, (4, 1), device="cpu",
                                   dtype=F64, mg=TMG(bottom_solver="smooth"))
    return jh, th


def test_norms_match_jax(pair):
    jh, th = pair
    rng = np.random.default_rng(5)
    jgeo0, tgeo0 = jh.level0.geo, th.level0.geo
    f = rng.normal(size=jgeo0.grid.shape)
    mask = rng.uniform(size=f.shape) > 0.3
    for m in (None, mask):
        jm = None if m is None else jnp.asarray(m)
        tm = None if m is None else torch.tensor(m)
        _close(tnorms.mapped_sum(_t(f), tgeo0, tm),
               jnorms.mapped_sum(jnp.asarray(f), jgeo0, jm))
        for p in (0, 1, 2):
            _close(tnorms.mapped_norm(_t(f), tgeo0, p, tm),
                   jnorms.mapped_norm(jnp.asarray(f), jgeo0, p, jm))
    fields = [f, rng.normal(size=jh.couplings[0].ext_grid.shape)]
    origin = np.array([0, 28])
    _close(tnorms.composite_mapped_sum(th, [_t(x) for x in fields],
                                       [origin]),
           jnorms.composite_mapped_sum(jh, [jnp.asarray(x) for x in fields],
                                       [jnp.asarray(origin)]))
    for p in (0, 2):
        _close(tnorms.composite_mapped_norm(th, [_t(x) for x in fields],
                                            [origin], p),
               jnorms.composite_mapped_norm(
                   jh, [jnp.asarray(x) for x in fields],
                   [jnp.asarray(origin)], p))


def test_coupling_transfers_match_jax(pair):
    jh, th = pair
    jc, tc = jh.couplings[0], th.couplings[0]
    assert (tc.interior_nx, tc.ext_nx, tc.cf_dirs, tc.donor_shape_c) == (
        jc.interior_nx, jc.ext_nx, jc.cf_dirs, jc.donor_shape_c)
    rng = np.random.default_rng(9)
    base = _random_states(jh.grid0.shape, 2, rng)
    fine = _random_states(jc.ext_grid.shape, 2, rng)
    jb = JState(**{k: jnp.asarray(v) for k, v in base.items()})
    jf = JState(**{k: jnp.asarray(v) for k, v in fine.items()})
    tb, tf, origin = entry.amr_states_from_numpy(base, fine, [0, 28],
                                                 device="cpu", dtype=F64)
    jo = jnp.asarray(origin)
    pairs = [
        (tc._interp_state_ext(tb, origin), jc._interp_state_ext(jb, jo)),
        (tc._overwrite_halo(tf, tc._interp_state_ext(tb, origin)),
         jc._overwrite_halo(jf, jc._interp_state_ext(jb, jo))),
        (tc.average_down(tb, tf, origin), jc.average_down(jb, jf, jo))]
    for got, want in pairs:
        for f in entry.STATE_FIELDS:
            _close(getattr(got, f), getattr(want, f))
    for scale in (1.0, 0.25):
        _close(tc._ring(tb.cc_phi, origin, scale),
               jc._ring(jb.cc_phi, jo, scale))


def test_compute_dt_matches_jax(pair):
    jh, th = pair
    rng = np.random.default_rng(13)
    base = _random_states(jh.grid0.shape, 2, rng)
    fine = _random_states(jh.couplings[0].ext_grid.shape, 2, rng)
    jb = JState(**{k: jnp.asarray(v) for k, v in base.items()})
    jf = JState(**{k: jnp.asarray(v) for k, v in fine.items()})
    tb, tf, _ = entry.amr_states_from_numpy(base, fine, [0, 28],
                                            device="cpu", dtype=F64)
    _close(np.asarray(th.compute_dt(tb, tf)), jh.compute_dt(jb, jf))
    for got, want in zip(th.level_dts(tb, tf), jh.level_dts(jb, jf)):
        _close(np.asarray(got), want)


AMR_DECK = """amr.nx = 32 8
amr.length = 15 2
amr.nx_offset = -16 0
ibc.problem = 1
amr.viscosity = 1e-4
amr.scal_diffusion_coeffs = 1e-4
amr.maxlevel = 1
amr.refratio_lev0 = 4 1
amr.buoyancy_tag_tol = 0.2
amr.tags_grow = 1
amr.vert_extrude_tags = 1
amr.precision = 64
plot.plot_interval = -1
plot.checkpoint_interval = -1
amr.verbosity = 0
"""


def test_amr_hierarchy_from_context_matches_jax_driver(tmp_path):
    jh = JDriver(JContext.from_parmparse(JPP.from_string(AMR_DECK)),
                 out_dir=str(tmp_path)).hierarchy
    th = entry.amr_hierarchy_from_context(
        TContext.from_parmparse(TPP.from_string(AMR_DECK)), device="cpu")
    jc, tc = jh.couplings[0], th.couplings[0]
    assert (tc.ratio, tc.nt, tc.interior_nx, tc.ext_nx, tc.cf_dirs) == (
        jc.ratio, jc.nt, jc.interior_nx, jc.ext_nx, jc.cf_dirs)
    assert dataclasses.asdict(th.tag_params) == dataclasses.asdict(
        jh.tag_params)
    for knob in ("do_sync_projection", "sync_projection_iters",
                 "sync_composite_iters"):
        assert getattr(th, knob) == getattr(jh, knob), knob
    # the port's sync solve always takes FAS tau and the elliptic reflux
    assert jh.sync_use_tau and jh.sync_use_reflux
    assert th.level0.params.dtype is torch.float64
    js = jh.level0.post_initialize(jh.level0.initial_state())
    ts = entry.ns_state_from_numpy(
        {f: np.asarray(getattr(js, f)) for f in entry.STATE_FIELDS},
        device="cpu", dtype=F64)
    (_,), (jo,) = jh.initial_patch_states(js)
    (_,), (to,) = th.initial_patch_states(ts)
    np.testing.assert_array_equal(to, np.asarray(jo))
    jdrv = JDriver(JContext.from_parmparse(JPP.from_string(AMR_DECK)),
                   out_dir=str(tmp_path))
    assert th.regrid_intervals == jdrv.regrid_intervals == [10]
    # amr.max_patches = 2 pins K = 2, as the JAX driver's hierarchy
    deck2 = AMR_DECK + "amr.max_patches = 2\namr.regrid_intervals = 3\n"
    jh2 = JDriver(JContext.from_parmparse(JPP.from_string(deck2)),
                  out_dir=str(tmp_path)).hierarchy
    th2 = entry.amr_hierarchy_from_context(
        TContext.from_parmparse(TPP.from_string(deck2)), device="cpu")
    assert th2.couplings[0].K == jh2.couplings[0].K == 2
    assert th2._pinned_K == jh2._pinned_K == [True]
    assert th2.regrid_intervals == [3]
    _, (jo2,), (jw2,) = jh2.initial_patch_states(js)
    _, (to2,), (tw2,) = th2.initial_patch_states(ts)
    np.testing.assert_array_equal(to2, np.asarray(jo2))
    np.testing.assert_array_equal(tw2, np.asarray(jw2))
    # amr.maxlevel = 2 builds the nested hierarchy of the JAX driver
    deck3 = AMR_DECK.replace("amr.maxlevel = 1", "amr.maxlevel = 2") \
        + "amr.refratio_lev1 = 2 1\namr.regrid_intervals = 4 2\n" \
        + "amr.grid_buffer_size = 2\n"
    jh3 = JDriver(JContext.from_parmparse(JPP.from_string(deck3)),
                  out_dir=str(tmp_path)).hierarchy
    th3 = entry.amr_hierarchy_from_context(
        TContext.from_parmparse(TPP.from_string(deck3)), device="cpu")
    assert th3.ratios == jh3.ratios == [(4, 1), (2, 1)]
    assert th3.regrid_intervals == [4, 2]
    for jc, tc in zip(jh3.couplings, th3.couplings):
        assert (tc.ext_nx, tc.nt, tc.nest_buffer, tc.parent_halo_axes) == (
            jc.ext_nx, jc.nt, jc.nest_buffer, jc.parent_halo_axes)
    for extra in ("amr.advective_scalar_reflux = 1\n"
                  "amr.advective_lambda_reflux = 1\n"
                  "amr.implicit_scalar_reflux = 1\n",
                  "amr.advective_momentum_reflux = 1\n"
                  "amr.implicit_momentum_reflux = 1\n",
                  "amr.smooth_after_regrid = 1\n"
                  "amr.postRegrid_smoothing_coeff = 1.0\n",
                  "projection.applyVDCorrection = 1\n"
                  "projection.etaLambda = 0.9\n",
                  "projection.applyVDCorrection = 0\n"
                  "projection.etaLambda = 0.9\n"):
        deck = AMR_DECK + extra
        jx = JDriver(JContext.from_parmparse(JPP.from_string(deck)),
                     out_dir=str(tmp_path)).hierarchy
        tx = entry.amr_hierarchy_from_context(
            TContext.from_parmparse(TPP.from_string(deck)), device="cpu")
        for knob in ("reflux_fields", "implicit_reflux",
                     "regrid_smoothing_coeff", "eta_lambda"):
            assert getattr(tx, knob) == getattr(jx, knob), (extra, knob)
        assert tx.level0.use_vd_correction == jx.level0.use_vd_correction
        assert tx.couplings[0].level.use_vd_correction \
            == jx.couplings[0].level.use_vd_correction
        assert (tx.couplings[0].flux_register is None) == (
            getattr(jx.couplings[0], "flux_register", None) is None)


# ------------------------------------------------------------ clustering
def _lock_tags(ndim):
    if ndim == 2:
        t = np.zeros((8, 32), bool)
        t[:, 14:18] = True
        t[:2, 3:6] = True
    else:
        t = np.zeros((8, 8, 16), bool)
        t[:, :, 7:9] = True
        t[:, 2:4, 12:14] = True
    return t


@pytest.mark.parametrize("kind", ["random 2d", "random 3d", "lock 2d",
                                  "lock 3d", "empty"])
def test_clustering_matches_jax(kind):
    rng = np.random.default_rng(21)
    if kind.startswith("random"):
        shape = (12, 20) if kind.endswith("2d") else (6, 10, 12)
        tags = rng.uniform(size=shape) > 0.85
    elif kind == "empty":
        tags = np.zeros((6, 9), bool)
    else:
        tags = _lock_tags(int(kind[-2]))
    for fill, side in ((0.7, 4), (0.8, 2), (0.5, 1)):
        got = tnative.berger_rigoutsos(tags, fill_ratio=fill, min_side=side)
        want = jnative.berger_rigoutsos(tags, fill_ratio=fill,
                                        min_side=side)
        np.testing.assert_array_equal(got, want)
    got, want = tnative.tag_bounding_box(tags), jnative.tag_bounding_box(tags)
    assert (got is None) == (want is None)
    if want is not None:
        np.testing.assert_array_equal(got, want)
    lib = tnative.library_path()
    assert lib.is_file() and lib.parent.name == "somar_tpu_torch"
    assert lib.parent.parent.name == "build"


# --------------------------------------------------------------- tagging
TAGGERS = {
    "buoyancy": dict(buoyancy_tag_tol=0.2, tags_grow=1),
    "velocity and pressure": dict(vel_tag_tol=1e-3, pressure_tag_tol=1e-5,
                                  vert_extrude=False),
    "vorticity": dict(magvort_tag_quota=0.3, vort_tag_tol=(1e-3, 1e-3, 1e-3),
                      tags_grow=2),
    "richardson": dict(do_ri_tagging=True, ri_tag_tol=0.25,
                       vert_extrude=False),
}


@pytest.fixture(scope="module")
def lock_states():
    """(JAX level, port level, [initial state, after 3 steps]) in 2D and
    3D, the states as host arrays."""
    out = {}
    for ndim in (2, 3):
        ny = None if ndim == 2 else 8
        nx = 32 if ndim == 2 else 16
        tl, _ = entry.build_level(nx, 8, ny, device="cpu", dtype=F64)
        if ndim == 2:
            jg = JGrid(nx=(nx, 8), dx=(15 / nx, 2 / 8), x0=(-7.5, 0.0))
            prob = JLock(pert_amp=0.0)
        else:
            jg = JGrid(nx=(nx, 8, 8), dx=(15 / nx, 2 / 8, 2 / 8),
                       x0=(-7.5, 0.0, 0.0), periodic=(False, True, False))
            prob = JLock()
        jl = JLevel(jgeo(jg, JCartesian(), dtype=jnp.float64), prob,
                    JParams(nu=1e-4, kappa=(1e-4,), dtype=jnp.float64))
        s = tl.post_initialize(tl.initial_state())
        states = [entry.ns_state_to_numpy(s)]
        for _ in range(3):
            s = tl.advance(s, 0.05)
        states.append(entry.ns_state_to_numpy(s))
        out[ndim] = (jl, tl, states)
    return out


@pytest.mark.parametrize("tagger", list(TAGGERS))
@pytest.mark.parametrize("ndim", [2, 3])
def test_compute_tags_match_jax(lock_states, ndim, tagger):
    jl, tl, states = lock_states[ndim]
    for k, fields in enumerate(states):
        js = JState(**{f: jnp.asarray(v) for f, v in fields.items()})
        ts = entry.ns_state_from_numpy(fields, device="cpu", dtype=F64)
        want = jcompute_tags(js, jl, JTags(**TAGGERS[tagger]))
        got = tcompute_tags(ts, tl, TTags(**TAGGERS[tagger]))
        assert got.dtype == np.bool_ and got.shape == want.shape
        np.testing.assert_array_equal(got, want, err_msg=f"state {k}")
        if tagger == "buoyancy":
            assert got.any()


# ------------------------------------------------------------- footprint
FOOTPRINTS = {
    # parent nx, periodic, ratio, patch_frac, max_grid_size
    "no snap (32x8)": ((32, 8), (False, False), (4, 1), 0.5, 0),
    "snap down (64x16)": ((64, 16), (False, False), (4, 1), 0.5, 0),
    "snap up (100x8)": ((100, 8), (False, False), (4, 1), 0.5, 0),
    "no snap candidate (r=8)": ((32, 8), (False, False), (8, 1), 0.5, 0),
    "max_grid_size": ((64, 8), (False, False), (4, 1), 0.5, 40),
    "4H floor": ((16, 8), (False, False), (2, 1), 0.1, 0),
    "cap": ((16, 8), (False, False), (4, 1), 0.9, 0),
    "x periodic: all spanned": ((16, 8), (True, False), (2, 1), 0.5, 0),
    "3d y periodic (16x8x8)": ((16, 8, 8), (False, True, False),
                               (4, 1, 1), 0.5, 0),
    "3d two cf dirs": ((24, 16, 8), (False, False, False), (2, 2, 1),
                       0.5, 0),
    "A1 (64x96x64)": ((64, 96, 64), (False, True, False), (4, 1, 1),
                      0.5, 0),
    "A2 (128x128x128)": ((128, 128, 128), (False, True, False), (4, 1, 1),
                         0.5, 0),
}


@pytest.mark.parametrize("case", list(FOOTPRINTS))
def test_patch_footprint_matches_jax(case):
    nx, periodic, ratio, frac, mgs = FOOTPRINTS[case]
    jg = JGrid(nx=nx, dx=tuple(1.0 / n for n in nx), periodic=periodic)
    jc = JCoupling(jgeo(jg, JCartesian()), (0,) * len(nx), JLock(),
                   JParams(), ratio, max_grid_size=mgs, patch_frac=frac)
    assert patch_footprint(nx, periodic, ratio, frac, mgs) == (
        jc.interior_nx, jc.ext_nx)
    if case.startswith("A1"):
        assert jc.ext_nx == (128, 96, 64)
    if case.startswith("A2"):
        assert jc.ext_nx == (384, 128, 128)


# ----------------------------------------------- NSLevel flux collection
def test_collect_fluxes_matches_jax():
    nx, nz = 16, 8
    jg = JGrid(nx=(nx, nz), dx=(15 / nx, 2 / nz), x0=(-7.5, 0.0))
    jl = JLevel(jgeo(jg, JCartesian(), dtype=jnp.float64),
                JLock(pert_amp=0.0),
                JParams(nu=1e-4, kappa=(1e-4,), cfl=0.9, dtype=jnp.float64))
    tl, _ = entry.build_level(nx, nz, device="cpu", dtype=F64)
    js = jl.post_initialize(jl.initial_state())
    ts = entry.ns_state_from_numpy(
        {f: np.asarray(getattr(js, f)) for f in entry.STATE_FIELDS},
        device="cpu", dtype=F64)
    step = jax.jit(lambda s, d: jl.advance(s, d, collect_fluxes=True))
    for _ in range(2):
        js, jfl = step(js, jnp.asarray(0.05, jnp.float64))
        ts, tfl = tl.advance(ts, 0.05, collect_fluxes=True)
        for f in entry.STATE_FIELDS:
            _close(getattr(ts, f), getattr(js, f), 1e-12)
        assert set(tfl) == set(jfl) == {"vel", "scalars", "lam"}
        for key in ("vel", "scalars"):
            for a, b in zip(tfl[key], jfl[key]):
                for d in range(2):
                    _close(a[d], b[d], 1e-12)
        for d in range(2):
            _close(tfl["lam"][d], jfl["lam"][d], 1e-12)
    # without collect_fluxes the step is the fused one, and equal
    plain = tl.advance(ts, 0.05)
    again, _ = tl.advance(ts, 0.05, collect_fluxes=True)
    for f in entry.STATE_FIELDS:
        _close(getattr(again, f), getattr(plain, f), 1e-12)


def test_placement_widens_the_footprint_as_jax():
    """Tags outgrowing a narrow footprint: with max_auto_patches = 1 the
    footprint widens (patch_frac x 1.5) until they fit, and with the
    default budget K doubles first, both as in JAX."""
    g = JGrid(nx=(32, 8), dx=(15 / 32, 2 / 8), x0=(-7.5, 0.0))
    tags = JTags(buoyancy_tag_tol=0.05, tags_grow=3)
    tl, _ = entry.build_level(32, 8, device="cpu", dtype=F64)
    from somar_tpu_torch.amr.hierarchy import AMRHierarchy
    for kw in (dict(ratio=(4, 1), patch_frac=0.1, max_auto_patches=1),
               dict(ratio=(4, 1), patch_frac=0.1)):
        jh = JHierarchy(jgeo(g, JCartesian(), dtype=jnp.float64),
                        JLock(pert_amp=0.0), JParams(dtype=jnp.float64),
                        tag_params=tags, **kw)
        th = AMRHierarchy(tl.geo, tl.problem, tl.params,
                          tag_params=TTags(buoyancy_tag_tol=0.05,
                                           tags_grow=3), **kw)
        js = jh.level0.initial_state()
        ts = entry.ns_state_from_numpy(
            {f: np.asarray(getattr(js, f)) for f in entry.STATE_FIELDS},
            device="cpu", dtype=F64)
        jgot = jh.initial_patch_states(js)
        tgot = th.initial_patch_states(ts)
        tc, jc = th.couplings[0], jh.couplings[0]
        assert len(tgot) == len(jgot)
        assert (tc.K, tc.interior_nx) == (jc.K, jc.interior_nx)
        assert tc.tag_coverage == jc.tag_coverage
        np.testing.assert_array_equal(tgot[1][0], np.asarray(jgot[1][0]))
        if "max_auto_patches" in kw:
            assert tc.K == 1 and tc.interior_nx != (16, 8)
        else:
            assert tc.K > 1
            np.testing.assert_array_equal(tgot[2][0],
                                          np.asarray(jgot[2][0]))


def test_initialize_pressure_keeps_only_the_pressures(pair):
    _, th = pair
    s0, fine, origin = entry.place_amr(th)
    s0, fine = entry.run_amr(th, s0, fine, origin, 0.02, 1)
    t0, tf = th.advance(s0, fine, origin, 0.02)
    p0, pf = th.initialize_pressure(s0, fine, origin, 0.02)
    for got, keep, trial in ((p0, s0, t0), (pf, fine, tf)):
        for f in ("pressure", "mac_phi", "cc_phi"):
            _close(getattr(got, f), getattr(trial, f), 0.0)
        for f in ("vel", "scalars", "lam", "time"):
            _close(getattr(got, f), getattr(keep, f), 0.0)


def test_aux_fields_stand_in_for_the_derived_ones():
    """NSLevel(aux_fields=...) takes N^2 and the sponge from the given
    tensors: the same step as the level that derives them."""
    from somar_tpu_torch.physics.navier_stokes import NSLevel
    level, _ = entry.build_beam_level(40, 32, device="cpu")
    aux = {"nsq_cc": level._nsq_cc, "sponge_ramp": level._sponge_ramp,
           "sponge_targets": level._sponge_targets}
    other = NSLevel(level.geo, level.problem, level.params, aux_fields=aux)
    assert other._nsq_cc is aux["nsq_cc"]
    assert other._sponge_ramp is aux["sponge_ramp"]
    s = level.post_initialize(level.initial_state())
    a, b = level.advance(s, 0.5), other.advance(s, 0.5)
    for f in entry.STATE_FIELDS:
        _close(getattr(b, f), getattr(a, f), 0.0)


# ------------------------------------------------------------- slice 10
def test_slice10_features_raise(pair):
    """What slices 10 and 11 ported runs (K pinned by num_patches, regrid,
    dynamic subcycling, weights at K = 1, nested levels, mapped patches
    and the `geos` argument; refluxing, implicit refluxing, the VD
    correction, post-regrid smoothing, RK3 with CF rings and flux
    collection); sharded steps raise naming ROADMAP A.7."""
    jh, th = pair
    level = th.level0
    kw = dict(ratio=(4, 1))
    from somar_tpu_torch.amr.hierarchy import AMRHierarchy
    for k, pinned in ((2, [True]), ((1, 1), [True]), (1, [False])):
        h = AMRHierarchy(level.geo, level.problem, level.params,
                         num_patches=k, **kw)
        assert h.couplings[0].K == (k if isinstance(k, int) else k[0])
        assert h._pinned_K == pinned
    h3 = AMRHierarchy(level.geo, level.problem, level.params,
                      ratios=[(4, 1), (2, 1)], num_patches=(1, 2))
    assert [c.K for c in h3.couplings] == [1, 2]
    assert h3._pinned_K == [True, True] and h3.num_levels == 3
    for feat in (dict(reflux=("vel",), **kw),
                 dict(reflux=True, implicit_reflux=True, **kw),
                 dict(eta_lambda=0.9, **kw),
                 dict(regrid_smoothing_coeff=1.0, **kw)):
        hf = AMRHierarchy(level.geo, level.problem, level.params, **feat)
        assert hf.reflux_fields == {
            (): (), ("vel",): ("vel",), True: ("vel", "scalars", "lam")}[
            feat.get("reflux", ())]
        assert (hf.couplings[0].flux_register is not None) \
            == bool(hf.reflux_fields)
        assert hf.implicit_reflux == feat.get("implicit_reflux", False)
        vd = feat.get("eta_lambda", 0.0) > 0.0
        assert hf.level0.use_vd_correction == vd
        assert hf.couplings[0].level.use_vd_correction == vd
        assert hf.regrid_smoothing_coeff == feat.get(
            "regrid_smoothing_coeff", 0.0)
        f0, ff, fo = entry.place_amr(hf)
        f0, ff = hf.advance(f0, ff, fo, 0.01)
        assert bool(torch.isfinite(ff.vel).all()) and bool(
            torch.isfinite(f0.e_lambda).all())
        assert bool((ff.e_lambda != 0).any()) == vd
    s0, fine, origin = entry.place_amr(th)
    fine2, origin2 = th.regrid(s0, fine)
    assert fine2.vel.shape == fine.vel.shape and origin2.shape == (2,)
    a0, af = th.advance(s0, fine, origin, 0.01, nt_mults=(2,))
    b0, bf = th.advance(s0, fine, origin, 0.01, weights=[np.ones(1)])
    for x in (af, bf):
        np.testing.assert_allclose(float(x.time), float(fine.time) + 0.01)
    # the nested hierarchy places, steps and regrids
    s3 = h3.level0.post_initialize(h3.level0.initial_state())
    f3, o3, w3 = h3.initial_patch_states(s3)
    a3, g3 = h3.advance(s3, f3, o3, 0.01, weights=w3,
                        parent_sels=h3.parent_sels)
    assert len(g3) == 2 and g3[1].vel.shape[0] == 2
    assert all(bool(torch.isfinite(g.vel).all()) for g in g3)
    r3 = h3.regrid(a3, g3, from_level=1)
    assert torch.equal(r3[0][0].vel, g3[0].vel)
    with pytest.raises(ValueError, match="refined levels"):
        th.advance(s0, (fine, fine), (origin, origin), 0.01)
    # geos: a Cartesian level's entries are ignored, as in the JAX package
    assert th.geo_bundles is None
    g0, gf = th.advance(s0, fine, origin, 0.01, geos=[{"geo": None}])
    p0, pf = th.advance(s0, fine, origin, 0.01)
    for a, b in ((g0, p0), (gf, pf)):
        assert torch.equal(a.vel, b.vel) and torch.equal(a.scalars,
                                                         b.scalars)
    # a mapped base (slice 11b): each slot on its own level; the geos
    # call of the JAX signature runs with the hierarchy's own levels
    from somar_tpu_torch.geometry.bathymetric import LedgeMap
    from somar_tpu_torch.geometry.level_geometry import build_level_geometry
    g = level.geo.grid
    hm = AMRHierarchy(build_level_geometry(
        g, LedgeMap((0.0, 2.0), hl=1.0, hr=2.0, xl=-1.0, xr=1.0),
        device="cpu", dtype=F64), level.problem, level.params, **kw)
    m0, mf, mo = entry.place_amr(hm)
    assert hm.is_mapped and hm.couplings[0].level.geo.J.shape == \
        tuple(hm.couplings[0].ext_grid.shape)
    n0, nf = hm.advance(m0, mf, mo, 0.01, geos=hm.geo_bundles[0])
    assert bool(torch.isfinite(nf.vel).all())
    with pytest.raises(ValueError, match="geo_bundles"):
        hm.advance(m0, mf, mo, 0.01, geos=[{"geo": None}])
    with pytest.raises(NotImplementedError, match="ROADMAP A.7"):
        th.attach_mesh(None)
    # RK3 on a patch level takes the CF rings and collects the fluxes
    from somar_tpu_torch.physics.rk3 import advance_rk3
    c0 = th.couplings[0]
    phi = torch.as_tensor(np.random.default_rng(5).normal(
        size=tuple(s0.lam.shape)), dtype=s0.lam.dtype)
    rings = {"mac": c0._ring(phi, origin), "cc": c0._ring(phi, origin, 0.25)}
    collect = {}
    r1 = advance_rk3(c0.level, fine, 0.01, rings=rings, collect=collect)
    r0 = advance_rk3(c0.level, fine, 0.01)
    assert bool(torch.isfinite(r1.vel).all())
    assert not torch.equal(r1.vel, r0.vel)
    assert sorted(collect) == ["lam", "scalars", "vel"]
    assert [f.shape for f in collect["lam"]] == [
        tuple(n + (ax == 1) for ax, n in enumerate(c0.ext_grid.shape)),
        tuple(n + (ax == 0) for ax, n in enumerate(c0.ext_grid.shape))]


# ------------------------------------------------- the sync relres gate
@pytest.mark.parametrize("fault", ["sound", "one pass", "no tau",
                                   "no reflux"])
@pytest.mark.parametrize("case", ["3d", "2d"])
def test_sync_relres_limit_catches_solver_faults(case, fault):
    import contextlib
    import chip_smoke
    assert fault == "sound" or fault in chip_smoke.SYNC_FAULTS
    shape, ratio = ((32, 16, 16), (4, 1, 1)) if case == "3d" else \
        ((48, None, 16), (4, 1))
    relres = []
    with contextlib.ExitStack() as stack:
        kw = ({} if fault == "sound"
              else chip_smoke.sync_fault(stack, fault))
        h = entry.build_amr_hierarchy(*shape, ratio, device="cpu",
                                      mg=TMG(eps=1e-5, imax=12), **kw)
        s0, fine, origin = entry.place_amr(h)
        entry.run_amr(h, s0, fine, origin, 0.02, 3,
                      on_step=lambda i, a, b: relres.append(
                          float(h.last_sync_info[1])))
    if fault == "sound":
        assert max(relres) < chip_smoke.SYNC_RELRES, relres
    else:
        assert max(relres) >= chip_smoke.SYNC_RELRES, relres
