"""A mapped refined level of K = 2 patches, each slot on its own metric,
against the JAX package on the CPU, in float64 with the smoothing bottom
solver (ROADMAP C.7): the TwistedMap two fronts of
tests/test_amr.py:296-320 (2D 96x12, perturbations (0.2, 0.02), buoyancy
lumps at x = -4 and 4, buoyancy_tag_tol 0.12, tags_grow 1, patch_frac
0.2) at one refined level, ratio (2, 1), K = 2 pinned, inviscid:

  * each slot's geometry at the placement and after a regrid that moves
    both lumps 6 cells along +x: J and every face metric array equal
    slot k of JAX's stacked bundle and a direct evaluation of the map on
    the slot's window, to 1e-12; the two slots' metrics differ;
  * two coarse steps with the sync, the regrid and one more step equal
    the jitted JAX advance with geos = h.geo_bundles within 1e-8 of
    max|field|, origins and weights exactly; level_dts and compute_dt to
    1e-12;
  * the same hierarchy with all three fields refluxed and the VD
    correction (eta_lambda 0.9), as tests/test_amr.py:296 runs it (each
    slot refluxes into the base through the base's metric and takes its
    own e_lambda): two coarse steps from the same placement equal the
    jitted JAX advance within 1e-8 of max|field|, e_lambda included, and
    the two features move the JAX state by more than 100x that;
  * the composite sums and norms (p = 0, 1, 2) equal the direct sum over
    the base and each slot on its own J, to 1e-12, where JAX's weigh
    slot 1 by slot 0's J (ROADMAP C.26): the two differ.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from somar_tpu.amr.hierarchy import AMRHierarchy as JH
from somar_tpu.amr.hierarchy import _tree_index
from somar_tpu.amr.tagging import TagParams as JTags
from somar_tpu.core.grid import Grid as JGrid
from somar_tpu.geometry.geo_source import TwistedMap as JTwisted
from somar_tpu.geometry.level_geometry import build_level_geometry as jgeo
from somar_tpu.ops import norms as jnorms
from somar_tpu.physics.navier_stokes import NSParams as JParams
from somar_tpu.physics.navier_stokes import NSState as JState
from somar_tpu.problems.lock_exchange import LockExchange as JLock
from somar_tpu.solvers.multigrid import MGParams as JMG

from somar_tpu_torch import entry
from somar_tpu_torch.amr.hierarchy import AMRHierarchy
from somar_tpu_torch.amr.tagging import TagParams
from somar_tpu_torch.core.grid import Grid
from somar_tpu_torch.geometry.geo_source import TwistedMap
from somar_tpu_torch.geometry.level_geometry import build_level_geometry
from somar_tpu_torch.ops import norms as tnorms
from somar_tpu_torch.physics.navier_stokes import NSParams
from somar_tpu_torch.problems.lock_exchange import LockExchange
from somar_tpu_torch.solvers.multigrid import MGParams
from tests.test_torch_amr_mapped import FIELDS, GEO_TOL, STEP_TOL, \
    _geo_arrays, _host, jax_c28  # noqa: F401 (jax_c28: an autouse fixture)
from tests.torch_jax_reference import jax_unoptimized  # noqa: F401 (autouse)

torch.set_num_threads(1)

NX, NZ, LX, LZ = 96, 12, 15.0, 2.0
PERT = (0.2, 0.02)
#: every solve runs its imax V-cycles (eps is out of reach): on the tangled
#: mesh a tolerance test near its threshold could stop the packages one
#: cycle apart
MG = dict(eps=1e-13, imax=6, relax_mode="line", bottom_solver="smooth")
DT = 0.02
SHIFT = 6


def _fronts(x, shift=0.0):
    return ((np.abs(x + 4.0 - shift) < 0.8)
            | (np.abs(x - 4.0 - shift) < 0.8)).astype(np.float64)


def _pair(**features):
    kw = dict(nx=(NX, NZ), dx=(LX / NX, LZ / NZ), x0=(-LX / 2, 0.0))
    hkw = dict(ratio=(2, 1), patch_frac=0.2, num_patches=2, **features)
    jh = JH(jgeo(JGrid(**kw), JTwisted(PERT, (LX, LZ)), dtype=jnp.float64),
            JLock(pert_amp=0.0),
            JParams(nu=0.0, kappa=(0.0,), gravity_method=1, mg=JMG(**MG),
                    dtype=jnp.float64),
            tag_params=JTags(buoyancy_tag_tol=0.12, tags_grow=1), **hkw)
    th = AMRHierarchy(
        build_level_geometry(Grid(**kw), TwistedMap(PERT, (LX, LZ)),
                             device="cpu", dtype=torch.float64),
        LockExchange(pert_amp=0.0),
        NSParams(nu=0.0, kappa=(0.0,), gravity_method=1, mg=MGParams(**MG),
                 dtype=torch.float64),
        tag_params=TagParams(buoyancy_tag_tol=0.12, tags_grow=1), **hkw)
    return jh, th


def _slot_geos(jh, th):
    jc, tc = jh.couplings[0], th.couplings[0]
    return [(_geo_arrays(_tree_index(jc.bundle, k)["geo"]),
             _geo_arrays(tc.bundles[k]["geo"]),
             th._global_origin(0, patch=k)) for k in range(tc.K)]


def _placed(jh, th):
    """Both packages' base states with the two lumps, and their placed
    patches: ((js, jf, jo, jw), (ts, tf, to, tw), x)."""
    js = jh.level0.post_initialize(jh.level0.initial_state())
    x = np.asarray(jh.level0.geo.phys_coords_cc()[0])
    base = _host(js)
    base["scalars"] = base["scalars"].copy()
    base["scalars"][0] = np.broadcast_to(_fronts(x), base["lam"].shape)
    js = JState(**{f: jnp.asarray(v) for f, v in base.items()})
    ts = entry.ns_state_from_numpy(base, device="cpu", dtype=torch.float64)
    return ((js,) + tuple(jh.initial_patch_states(js)),
            (ts,) + tuple(th.initial_patch_states(ts)), x)


@pytest.fixture(scope="module")
def fronts():
    jax.config.update("jax_enable_x64", True)
    try:
        jh, th = _pair()
        (js, jf, jo, jw), (ts, tf, to, tw), x = _placed(jh, th)
        out = {"placed": [(np.asarray(jo[0]), to[0].copy(),
                           np.asarray(jw[0]), tw[0].copy())],
               "geo": [_slot_geos(jh, th)], "states": {}}

        def record(stage):
            out["states"][stage] = ((_host(js), _host(jf[0])),
                                    (entry.ns_state_to_numpy(ts),
                                     entry.ns_state_to_numpy(tf[0])))

        record("placed")
        step = jax.jit(jh.advance)
        dt = jnp.asarray(DT, jnp.float64)
        for i in range(2):
            js, jf = step(js, jf, jo, dt, jh.geo_bundles, jw)
            ts, tf = th.advance(ts, tf, to, DT, weights=tw)
            record(f"step{i + 1}")
        moved = _host(js)
        moved["scalars"] = moved["scalars"].copy()
        moved["scalars"][0] = np.broadcast_to(
            _fronts(x, SHIFT * LX / NX), moved["lam"].shape)
        js = JState(**{f: jnp.asarray(v) for f, v in moved.items()})
        tmoved = entry.ns_state_to_numpy(ts)
        tmoved["scalars"] = tmoved["scalars"].copy()
        tmoved["scalars"][0] = moved["scalars"][0]
        ts = entry.ns_state_from_numpy(tmoved, device="cpu",
                                       dtype=torch.float64)
        jf, jo, jw = jh.regrid(js, jf)
        tf, to, tw = th.regrid(ts, tf)
        out["placed"].append((np.asarray(jo[0]), to[0].copy(),
                              np.asarray(jw[0]), tw[0].copy()))
        out["geo"].append(_slot_geos(jh, th))
        record("regrid")
        js, jf = step(js, jf, jo, dt, jh.geo_bundles, jw)
        ts, tf = th.advance(ts, tf, to, DT, weights=tw)
        record("step3")
        out["dts"] = (
            [float(v) for v in jh.level_dts(js, jf, jh.geo_bundles)],
            th.level_dts(ts, tf),
            float(jh.compute_dt(js, jf, jh.geo_bundles)),
            th.compute_dt(ts, tf, th.geo_bundles))
        rng = np.random.default_rng(7)
        fields = [rng.normal(size=jh.grid0.shape),
                  rng.normal(size=(2,) + tuple(
                      jh.couplings[0].ext_grid.shape))]
        jfl = [jnp.asarray(f) for f in fields]
        tfl = [torch.as_tensor(f) for f in fields]
        out["norms"] = [(float(jnorms.composite_mapped_sum(jh, jfl, jo)),
                         float(tnorms.composite_mapped_sum(th, tfl, to)))]
        out["norms"] += [
            (float(jnorms.composite_mapped_norm(jh, jfl, jo, p)),
             float(tnorms.composite_mapped_norm(th, tfl, to, p)))
            for p in (0, 1, 2)]
        out["fields"] = fields
        out["th"] = th
        return out
    finally:
        jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("stage", [0, 1], ids=["placed", "regridded"])
def test_two_slots_each_on_its_own_metric(fronts, stage):
    jo, to, jw, tw = fronts["placed"][stage]
    np.testing.assert_array_equal(to, jo)
    np.testing.assert_array_equal(tw, jw)
    assert tw.tolist() == [1.0, 1.0]
    th = fronts["th"]
    c = th.couplings[0]
    slots = fronts["geo"][stage]
    assert len(slots) == 2
    for want, got, g in slots:
        assert set(got) == set(want)
        dx = c.ext_grid.dx
        win = Grid(nx=c.ext_nx, dx=dx, periodic=c.ext_grid.periodic,
                   x0=tuple(th.grid0.x0[d] + g[th.grid0.axis(d)] * dx[d]
                            for d in range(2)))
        direct = _geo_arrays(build_level_geometry(
            win, th.level0.geo.geo, device="cpu", dtype=torch.float64))
        for name in want:
            for ref in (want, direct):
                np.testing.assert_allclose(
                    got[name], ref[name], rtol=0,
                    atol=GEO_TOL * np.abs(ref[name]).max(), err_msg=name)
    (_, a, _), (_, b, _) = slots
    assert np.abs(a["J"] - b["J"]).max() > 1e-3


def test_regrid_moved_both_slots(fronts):
    (_, o0, _, _), (_, o1, _, _) = fronts["placed"]
    assert all(o1[k][1] > o0[k][1] for k in range(2))


@pytest.mark.parametrize("stage", ["placed", "step1", "step2", "regrid",
                                   "step3"])
def test_k2_steps_and_regrid_match_jax(fronts, stage):
    (jb, jf), (tb, tf) = fronts["states"][stage]
    tol = 1e-13 if stage == "placed" else STEP_TOL
    for level, want, got in (("base", jb, tb), ("patches", jf, tf)):
        for f in FIELDS:
            assert got[f].shape == want[f].shape, (level, f)
            scale = max(np.abs(want[f]).max(), 1e-30)
            err = np.abs(got[f] - want[f]).max()
            assert err <= tol * scale, (level, f, err, scale)
    assert tf["vel"].shape[0] == 2


def test_k2_dts_match_jax(fronts):
    jl, tl, jdt, tdt = fronts["dts"]
    np.testing.assert_allclose(tl, jl, rtol=1e-12)
    np.testing.assert_allclose(tdt, jdt, rtol=1e-12)


def test_k2_norms_on_each_slots_own_volumes(fronts):
    """The port against a direct sum over the base's uncovered cells and
    each slot's halo-free cells weighted by its own J; JAX weighs every
    slot by slot 0's J (ROADMAP C.26), so at K = 2 on the TwistedMap the
    two differ."""
    th = fronts["th"]
    c = th.couplings[0]
    f0, f1 = fronts["fields"]
    J0 = th.level0.geo.J.expand(th.grid0.shape).numpy()
    dv0, dv1 = np.prod(th.grid0.dx), np.prod(c.ext_grid.dx)
    m0 = np.ones(th.grid0.shape, bool)
    for o in c.patch_origins(c.origin_f):
        oc = c.covered_origin_c(o)
        m0[tuple(slice(a, a + s) for a, s in zip(oc, c.covered_shape_c))] \
            = False
    m1 = np.zeros(c.ext_grid.shape, bool)
    m1[tuple(slice(a, a + s) for a, s in zip(c.int_start, c.int_shape))] \
        = True
    parts = [(f0, J0, m0, dv0)] + [
        (f1[k], c.levels[k].geo.J.numpy(), m1, dv1) for k in range(2)]
    # the fields rounded to float32 first, |f|^p taken in float32, as
    # both packages' norms do (ops/norms.py)
    f32 = lambda f: f.astype(np.float32)
    want = [sum(np.sum(f32(f).astype(np.float64) * J * m) * dv
                for f, J, m, dv in parts)]
    want.append(max(np.abs(f[m]).max() for f, _, m, _ in parts))
    for p in (1, 2):
        want.append(sum(np.sum((np.abs(f32(f)) ** p).astype(np.float64)
                               * J * m) * dv
                        for f, J, m, dv in parts) ** (1.0 / p))
    for (jv, tv), w in zip(fronts["norms"], want):
        assert abs(tv - w) <= 1e-12 * abs(w), (tv, w)
    assert any(abs(jv - tv) > 1e-6 * abs(tv)
               for jv, tv in fronts["norms"][:1] + fronts["norms"][2:])


@pytest.fixture(scope="module")
def fronts_reflux_vd(fronts):
    """Two coarse steps of the hierarchy with all three fields refluxed and
    the VD correction, from the same placement as `fronts`."""
    jax.config.update("jax_enable_x64", True)
    try:
        jh, th = _pair(reflux=True, eta_lambda=0.9)
        (js, jf, jo, jw), (ts, tf, to, tw), _ = _placed(jh, th)
        assert th.reflux_fields == ("vel", "scalars", "lam")
        assert th.level0.use_vd_correction
        assert all(lv.use_vd_correction for lv in th.couplings[0].levels)
        step = jax.jit(jh.advance)
        dt = jnp.asarray(DT, jnp.float64)
        out = {}
        for i in range(2):
            js, jf = step(js, jf, jo, dt, jh.geo_bundles, jw)
            ts, tf = th.advance(ts, tf, to, DT, weights=tw)
            out[f"step{i + 1}"] = ((_host(js), _host(jf[0])),
                                   (entry.ns_state_to_numpy(ts),
                                    entry.ns_state_to_numpy(tf[0])))
        return out
    finally:
        jax.config.update("jax_enable_x64", False)


def _max_rel(want, got, fields):
    return max(np.abs(g[f] - w[f]).max() / max(np.abs(w[f]).max(), 1e-30)
               for w, g in zip(want, got) for f in fields)


@pytest.mark.parametrize("stage", ["step1", "step2"])
def test_k2_reflux_vd_steps_match_jax(fronts_reflux_vd, stage):
    (jb, jf), (tb, tf) = fronts_reflux_vd[stage]
    for level, want, got in (("base", jb, tb), ("patches", jf, tf)):
        for f in FIELDS + ("e_lambda",):
            assert got[f].shape == want[f].shape, (level, f)
    assert _max_rel((jb, jf), (tb, tf), FIELDS + ("e_lambda",)) \
        <= STEP_TOL
    assert np.abs(tf["e_lambda"]).max() > 0.0


def test_k2_reflux_vd_moves_the_jax_step(fronts, fronts_reflux_vd):
    """Refluxing and the VD correction move the JAX state more than 100x
    the step tolerance from the plain hierarchy's, on both levels."""
    plain = fronts["states"]["step2"][0]
    (jb, jf), _ = fronts_reflux_vd["step2"]
    for want, got in zip(plain, (jb, jf)):
        assert _max_rel((want,), (got,), FIELDS) > 100 * STEP_TOL
