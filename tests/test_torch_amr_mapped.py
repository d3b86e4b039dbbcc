"""Mapped AMR patches (each slot on its own terrain-following metric)
against the JAX package on the CPU, in float64 with the smoothing bottom
solver (ROADMAP C.7):

  * the Ledge hierarchy of tests/test_amr.py:236-249 (2D 48x16, the
    shelf-break map, ratio (2, 2), K = 1; inviscid): each slot's
    geometry at the placement and after a regrid that moves it (the base
    buoyancy shifted by 12 cells first) equals JAX's bundle, J and every
    face metric array, to 1e-12, and a direct evaluation of the map on
    the patch window (tests/test_amr.py:252); two coarse steps with the
    sync, the regrid and one more step equal the jitted JAX advance with
    geos = h.geo_bundles (the module's one jitted JAX step) within 1e-8
    of max|field|; compute_dt and level_dts; the composite norms;
  * the J-weighted average-down of one patch against JAX's;
  * the aux fields (N^2 and the sponge) of a BeamGeneration base
    (background scalar and sponge, coordMap 2) at placement;
  * trap 1: a patch level built on the map at the patch's position (not
    on the raw geometry) has the same finest metric but departs from
    JAX's on the multigrid levels that coarsen x;
  * a slot whose origin did not move keeps its level, and its numbers
    equal a fresh build's bitwise.

The K = 2 slots are tests/test_torch_amr_mapped_multipatch.py's; float32
against JAX is the deck tests' (tests/test_torch_amr_mapped_driver.py).

A mapped patch's projections are multigrid solves with CF sides, where the
port corrects two faults of the JAX package (ROADMAP C.28): a CF side pins
the potential (the operator is not singular), and the coarse levels of a
projection's multigrid take homogeneous Dirichlet at the CF faces.  The
mapped test modules hold the port against the JAX package with the same
two rules applied to its classes for their duration (`jax_c28`); nothing
in the JAX package is edited.
"""

from unittest import mock

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from somar_tpu.amr.hierarchy import AMRHierarchy as JH
from somar_tpu.amr.tagging import TagParams as JTags
from somar_tpu.config.context import ProblemContext as JContext
from somar_tpu.config.parmparse import ParmParse as JPP
from somar_tpu.core.grid import Grid as JGrid
from somar_tpu.driver import RunDriver as JDriver
from somar_tpu.geometry.bathymetric import LedgeMap as JLedge
from somar_tpu.geometry.level_geometry import build_level_geometry as jgeo
from somar_tpu.ops import norms as jnorms
from somar_tpu.physics.navier_stokes import NSParams as JParams
from somar_tpu.physics.navier_stokes import NSState as JState
from somar_tpu.problems.lock_exchange import LockExchange as JLock
from somar_tpu.solvers.multigrid import MGParams as JMG

from somar_tpu_torch import entry
from somar_tpu_torch.amr.hierarchy import AMRHierarchy
from somar_tpu_torch.amr.tagging import TagParams
from somar_tpu_torch.config.context import ProblemContext as TContext
from somar_tpu_torch.config.parmparse import ParmParse as TPP
from somar_tpu_torch.core.grid import Grid
from somar_tpu_torch.geometry.bathymetric import LedgeMap
from somar_tpu_torch.geometry.level_geometry import build_level_geometry
from somar_tpu_torch.ops import norms as tnorms
from somar_tpu_torch.physics.navier_stokes import NSParams
from somar_tpu_torch.problems.lock_exchange import LockExchange
from somar_tpu_torch.solvers.multigrid import MGParams
from tests.torch_jax_reference import jax_unoptimized  # noqa: F401 (autouse)

torch.set_num_threads(1)

NX, NZ, LX = 48, 16, 8.0
LEDGE = dict(hl=0.5, hr=1.0, xl=-1.0, xr=1.0)
MG = dict(eps=1e-5, imax=12, relax_mode="line", bottom_solver="smooth")
DT = 0.01
SHIFT = 12          # base cells the buoyancy moves before the regrid
FIELDS = ("vel", "scalars", "lam", "mac_phi", "cc_phi", "pressure")
GEO_TOL = 1e-12
STEP_TOL = 1e-8


@pytest.fixture(scope="module", autouse=True)
def jax_c28():
    """The JAX package's PoissonOp.bcs_singular and its projectors'
    LevelMultigrid with the port's two C.28 rules, for the module."""
    from somar_tpu.core.bc import BC as JBC
    from somar_tpu.core.bc import BCType as JBCType
    from somar_tpu.core.bc import FieldBCs as JFieldBCs
    from somar_tpu.projection import projector as jprojector
    from somar_tpu.solvers.multigrid import LevelMultigrid as JLevelMG
    from somar_tpu.solvers.poisson_op import PoissonOp as JOp

    def bcs_singular(self):
        return not any(b.type in (JBCType.DIRICHLET, JBCType.CF)
                       for b in tuple(self.bcs.lo) + tuple(self.bcs.hi))

    class CoarseDirichlet(JLevelMG):
        def __init__(self, geo, bcs, *a, **kw):
            super().__init__(geo, bcs, *a, **kw)
            pin = lambda b: JBC.dirichlet(0.0) if b.type == JBCType.CF \
                else b
            cbcs = JFieldBCs(lo=tuple(pin(b) for b in bcs.lo),
                             hi=tuple(pin(b) for b in bcs.hi))
            with jax.ensure_compile_time_eval():
                self.ops[1:] = [JOp(op.geo, cbcs) for op in self.ops[1:]]
            self.modes = [self._level_mode(op) for op in self.ops]

    with mock.patch.object(JOp, "bcs_singular", bcs_singular), \
            mock.patch.object(jprojector, "LevelMultigrid", CoarseDirichlet):
        yield


def _host(state):
    return {f: np.asarray(getattr(state, f)) for f in entry.STATE_FIELDS}


def _geo_arrays(geo):
    """J and the face metric arrays of a geometry, as host arrays on their
    full shapes."""
    g = geo.grid
    out = {"J": np.broadcast_to(np.asarray(geo.J), g.shape)}
    for d in range(g.ndim):
        out[f"Jgup_diag{d}"] = np.broadcast_to(np.asarray(geo.Jgup_diag[d]),
                                               g.fc_shape(d))
        if geo.Jgup_full is not None:
            out[f"Jgup_full{d}"] = np.asarray(geo.Jgup_full[d])
    return out


def _ledge_pair():
    """The Ledge hierarchy in both packages (float64), inviscid: the
    jitted JAX step then compiles in less than half the time.  The
    patches' viscous and diffusive solves are the heat solvers that
    tests/test_torch_amr_step.py holds against JAX on uniform patches,
    here on a raw metric, which the multigrid tests hold; chip_smoke M0
    runs them viscous, card against CPU."""
    kw = dict(nx=(NX, NZ), dx=(LX / NX, 1.0 / NZ), x0=(-LX / 2, 0.0))
    jh = JH(jgeo(JGrid(**kw), JLedge((0.0, 1.0), **LEDGE),
                 dtype=jnp.float64),
            JLock(pert_amp=0.0),
            JParams(nu=0.0, kappa=(0.0,), gravity_method=1, mg=JMG(**MG),
                    dtype=jnp.float64),
            ratio=(2, 2), tag_params=JTags(buoyancy_tag_tol=0.2,
                                           tags_grow=1))
    th = AMRHierarchy(
        build_level_geometry(Grid(**kw), LedgeMap((0.0, 1.0), **LEDGE),
                             device="cpu", dtype=torch.float64),
        LockExchange(pert_amp=0.0),
        NSParams(nu=0.0, kappa=(0.0,), gravity_method=1,
                 mg=MGParams(**MG), dtype=torch.float64),
        ratio=(2, 2), tag_params=TagParams(buoyancy_tag_tol=0.2,
                                           tags_grow=1))
    return jh, th


def _shift_b(base):
    """Host base fields with the buoyancy moved SHIFT cells along +x (the
    leftmost column repeated)."""
    out = dict(base)
    b = base["scalars"]
    out["scalars"] = np.concatenate(
        [np.repeat(b[..., :1], SHIFT, axis=-1), b[..., :-SHIFT]], axis=-1)
    return out


@pytest.fixture(scope="module")
def ledge():
    """Placement, two coarse steps, a moving regrid and one more step of
    both packages; the geometry of every slot at the placement and after
    the regrid; dts and norms at the end.  Host arrays only."""
    jax.config.update("jax_enable_x64", True)
    try:
        jh, th = _ledge_pair()
        jc, tc = jh.couplings[0], th.couplings[0]
        js = jh.level0.post_initialize(jh.level0.initial_state())
        base = _host(js)
        ts = entry.ns_state_from_numpy(base, device="cpu",
                                       dtype=torch.float64)
        jf, jo = jh.initial_patch_states(js)
        tf, to = th.initial_patch_states(ts)
        out = {"origins": [(np.asarray(jo[0]), to[0].copy())],
               "geo": [(_geo_arrays(jc.bundle["geo"]),
                        _geo_arrays(tc.bundles[0]["geo"]),
                        th._global_origin(0))],
               "states": {"placed": ((base, _host(jf[0])),
                                     (entry.ns_state_to_numpy(ts),
                                      entry.ns_state_to_numpy(tf[0])))}}
        step = jax.jit(jh.advance)
        dt = jnp.asarray(DT, jnp.float64)

        def record(stage):
            out["states"][stage] = ((_host(js), _host(jf[0])),
                                    (entry.ns_state_to_numpy(ts),
                                     entry.ns_state_to_numpy(tf[0])))

        for i in range(2):
            js, jf = step(js, jf, jo, dt, jh.geo_bundles)
            ts, tf = th.advance(ts, tf, to, DT, geos=th.geo_bundles)
            record(f"step{i + 1}")
        # move the front, then regrid both from the same base fields
        jb = _shift_b(_host(js))
        js = JState(**{f: jnp.asarray(v) for f, v in jb.items()})
        ts = entry.ns_state_from_numpy(_shift_b(entry.ns_state_to_numpy(
            ts)), device="cpu", dtype=torch.float64)
        jf, jo = jh.regrid(js, jf)
        tf, to = th.regrid(ts, tf)
        out["origins"].append((np.asarray(jo[0]), to[0].copy()))
        out["geo"].append((_geo_arrays(jc.bundle["geo"]),
                           _geo_arrays(tc.bundles[0]["geo"]),
                           th._global_origin(0)))
        record("regrid")
        js, jf = step(js, jf, jo, dt, jh.geo_bundles)
        ts, tf = th.advance(ts, tf, to, DT)
        record("step3")
        out["dts"] = (
            [float(x) for x in jh.level_dts(js, jf, jh.geo_bundles)],
            th.level_dts(ts, tf),
            float(jh.compute_dt(js, jf[0], jh.geo_bundles[0])),
            th.compute_dt(ts, tf[0], th.geo_bundles[0]))
        fields_j = [js.scalars[0], jf[0].scalars[0]]
        fields_t = [ts.scalars[0], tf[0].scalars[0]]
        out["norms"] = [
            (float(jnorms.composite_mapped_sum(jh, fields_j, jo)),
             float(tnorms.composite_mapped_sum(th, fields_t, to)))] + [
            (float(jnorms.composite_mapped_norm(jh, fields_j, jo, p)),
             float(tnorms.composite_mapped_norm(th, fields_t, to, p)))
            for p in (0, 1, 2)]
        out["hierarchies"] = (jh, th)
        out["last"] = (ts, tf[0], to[0])
        return out
    finally:
        jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("stage", [0, 1], ids=["placed", "regridded"])
def test_slot_geometry_matches_jax_and_the_map(ledge, stage):
    jo, to = ledge["origins"][stage]
    np.testing.assert_array_equal(to, jo)
    want, got, g = ledge["geo"][stage]
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=0,
                                   atol=GEO_TOL * np.abs(want[name]).max(),
                                   err_msg=name)
    # the map evaluated directly on the patch window
    _, th = ledge["hierarchies"]
    c = th.couplings[0]
    dx = c.ext_grid.dx
    x0 = tuple(th.grid0.x0[d] + g[th.grid0.axis(d)] * dx[d]
               for d in range(2))
    win = Grid(nx=c.ext_nx, dx=dx, x0=x0, periodic=c.ext_grid.periodic)
    lg = build_level_geometry(win, th.level0.geo.geo, device="cpu",
                              dtype=torch.float64)
    direct = _geo_arrays(lg)
    for name in want:
        np.testing.assert_allclose(got[name], direct[name], rtol=0,
                                   atol=GEO_TOL * np.abs(direct[name]).max(),
                                   err_msg=name)


def test_regrid_moved_the_patch(ledge):
    (o0, _), (o1, _) = ledge["origins"]
    assert o1[1] != o0[1]
    (g0, _, _), (g1, _, _) = ledge["geo"]
    assert np.abs(g1["J"] - g0["J"]).max() > 1e-3


@pytest.mark.parametrize("stage", ["placed", "step1", "step2", "regrid",
                                   "step3"])
def test_coarse_steps_and_regrid_match_jax(ledge, stage):
    (jb, jf), (tb, tf) = ledge["states"][stage]
    tol = 1e-13 if stage == "placed" else STEP_TOL
    for level, want, got in (("base", jb, tb), ("patch", jf, tf)):
        for f in FIELDS:
            assert got[f].shape == want[f].shape, (level, f)
            scale = max(np.abs(want[f]).max(), 1e-30)
            err = np.abs(got[f] - want[f]).max()
            assert err <= tol * scale, (level, f, err, scale)
        np.testing.assert_allclose(got["time"], want["time"], rtol=1e-12)


def test_dts_match_jax(ledge):
    jl, tl, jdt, tdt = ledge["dts"]
    np.testing.assert_allclose(tl, jl, rtol=1e-12)
    np.testing.assert_allclose(tdt, jdt, rtol=1e-12)


def test_composite_norms_match_jax(ledge):
    for want, got in ledge["norms"]:
        assert abs(got - want) <= 1e-12 * abs(want), (got, want)


def test_geos_other_than_the_hierarchy_raise(ledge):
    _, th = ledge["hierarchies"]
    ts, tf, to = ledge["last"]
    with pytest.raises(ValueError, match="geo_bundles"):
        th.compute_dt(ts, (tf,), geos=[{"geo": None}])


def test_j_weighted_average_down_matches_jax(ledge):
    jh, th = ledge["hierarchies"]
    jc, tc = jh.couplings[0], th.couplings[0]
    rng = np.random.default_rng(5)
    base = {f: rng.normal(size=v.shape) for f, v in
            ledge["states"]["step3"][0][0].items() if f != "time"}
    fine = {f: rng.normal(size=v.shape) for f, v in
            ledge["states"]["step3"][0][1].items() if f != "time"}
    base["time"] = fine["time"] = np.zeros(())
    origin = ledge["origins"][1][1]
    J = tc.slot_J(0)
    got = tc.average_down(
        entry.ns_state_from_numpy(base, device="cpu", dtype=torch.float64),
        entry.ns_state_from_numpy(fine, device="cpu", dtype=torch.float64),
        origin, J_f=J)
    jax.config.update("jax_enable_x64", True)
    try:
        want = _host(jc.average_down(
            JState(**{f: jnp.asarray(v) for f, v in base.items()}),
            JState(**{f: jnp.asarray(v) for f, v in fine.items()}),
            jnp.asarray(origin), J_f=jnp.asarray(J.numpy())))
    finally:
        jax.config.update("jax_enable_x64", False)
    plain = tc.average_down(
        entry.ns_state_from_numpy(base, device="cpu", dtype=torch.float64),
        entry.ns_state_from_numpy(fine, device="cpu", dtype=torch.float64),
        origin)
    got = entry.ns_state_to_numpy(got)
    for f in ("vel", "scalars", "lam"):
        np.testing.assert_allclose(got[f], want[f], rtol=0,
                                   atol=1e-13 * np.abs(want[f]).max())
    # the J weighting is not the plain average on the Ledge's slope
    assert np.abs(got["scalars"] - plain.scalars.numpy()).max() > 1e-6


BEAM_DECK = """
amr.nx = 40 32
amr.length = 38400 3000
amr.nx_offset = -20 0
geometry.coordMap = 2
geometry.beamGenMapAlpha = 15
ibc.problem = 2
ibc.useBackgroundScalar = 1
ibc.bgScalarProfile = 1
ibc.tidalU0 = 0.01
ibc.tidalOmega = 1e-3
amr.viscosity = 1e-4
amr.scal_diffusion_coeffs = 1e-4
amr.maxlevel = 1
amr.refratio_lev0 = 2 2
amr.buoyancy_tag_tol = 0.2
amr.precision = 64
"""


def test_aux_fields_match_jax_on_a_beam_base(tmp_path):
    """N^2 and the sponge of the patch at its placement, each slot's own:
    the BeamGeneration base (a background scalar and a sponge) in float64;
    nothing is tagged, so the patch is centred in both packages."""
    jax.config.update("jax_enable_x64", True)
    try:
        jh = JDriver(JContext.from_parmparse(JPP.from_string(BEAM_DECK)),
                     out_dir=str(tmp_path)).hierarchy
        th = entry.amr_hierarchy_from_context(
            TContext.from_parmparse(TPP.from_string(BEAM_DECK)),
            device="cpu")
        assert jh.problem.sponge is not None
        assert th.problem.sponge is not None
        js = jh.level0.initial_state()
        ts = entry.ns_state_from_numpy(_host(js), device="cpu",
                                       dtype=torch.float64)
        jh.initial_patch_states(js)
        th.initial_patch_states(ts)
        want = jax.tree_util.tree_map(np.asarray,
                                      jh.couplings[0].bundle["aux"])
    finally:
        jax.config.update("jax_enable_x64", False)
    got = th.couplings[0].bundles[0]["aux"]
    assert set(got) == set(want) == {"nsq_cc", "sponge_ramp",
                                     "sponge_targets"}
    pairs = [(got["nsq_cc"], want["nsq_cc"]),
             (got["sponge_ramp"], want["sponge_ramp"])] + list(
        zip(got["sponge_targets"], want["sponge_targets"]))
    for g, w in pairs:
        np.testing.assert_allclose(g.numpy(), np.broadcast_to(w, g.shape),
                                   rtol=0, atol=1e-12 * max(
                                       np.abs(w).max(), 1e-30))
    lvl = th.couplings[0].level
    assert lvl._nsq_cc is got["nsq_cc"]
    assert lvl._sponge_ramp is got["sponge_ramp"]


def test_map_built_level_departs_from_jax_on_coarse_levels(ledge):
    """Trap 1: the slot's level runs on the raw geometry, whose multigrid
    coarsens the arrays, as JAX's does (1e-12 on every multigrid level).
    A level built on the map at the patch's position has the same finest
    metric but re-evaluates the map on each coarser multigrid level, and
    departs from JAX's once x is coarsened (the first coarsening here is
    vertical only, where the Ledge's metric coarsens exactly)."""
    jh, th = ledge["hierarchies"]
    c = th.couplings[0]
    on_map = c.make_level(c.slot_geos[0], c.bundles[0]["aux"])
    jax.config.update("jax_enable_x64", True)
    try:
        jlvl = jh._levels_for(0, jh.geo_bundles)[0]
        want = [_geo_arrays(op.geo) for op in jlvl.projector.mg.ops]
    finally:
        jax.config.update("jax_enable_x64", False)
    got_raw = [_geo_arrays(op.geo) for op in c.level.projector.mg.ops]
    got_map = [_geo_arrays(op.geo) for op in on_map.projector.mg.ops]
    assert len(want) == len(got_raw) == len(got_map) > 2
    rel = lambda a, b: max(np.abs(a[k] - b[k]).max() / np.abs(b[k]).max()
                           for k in b)
    assert max(rel(r, w) for r, w in zip(got_raw, want)) <= GEO_TOL
    departs = [rel(m, w) for m, w in zip(got_map, want)]
    assert departs[0] <= GEO_TOL
    x_coarsened = [lev for lev, op in enumerate(c.level.projector.mg.ops)
                   if op.grid.nx[0] < c.ext_nx[0]]
    assert x_coarsened
    assert all(departs[lev] > 1e-4 for lev in x_coarsened), departs


def test_unmoved_slot_keeps_its_level_bitwise(ledge):
    """A refresh at an unchanged origin keeps the slot's level; a fresh
    build at that origin gives the same numbers bitwise: the geometry,
    and one coarse step from the same state."""
    _, th = ledge["hierarchies"]
    c = th.couplings[0]
    ts, tf, to = ledge["last"]
    kept = c.level
    built = th.slots_built
    th._refresh(0)
    assert c.level is kept and th.slots_built == built
    a0, af = th.advance(ts, tf, to, DT)
    c.slot_origins = None                  # forget: the next is fresh
    th._refresh(0)
    assert c.level is not kept and th.slots_built == built + 1
    for x, y in zip(_geo_arrays(kept.geo).values(),
                    _geo_arrays(c.level.geo).values()):
        assert np.array_equal(x, y)
    b0, bf = th.advance(ts, tf, to, DT)
    for x, y in ((a0, b0), (af, bf)):
        for f in entry.STATE_FIELDS:
            assert torch.equal(getattr(x, f), getattr(y, f)), f
