"""Refluxing and the VD correction of the port's AMR hierarchy against the
JAX package's, on the CPU, with eager JAX and inputs made from a seed:

  * the flux register (increment_fine over two substeps, increment_coarse,
    reflux) against JAX's PatchFluxRegister on seeded random fluxes in 2D
    and 3D, at a ratio of 1 along an axis, on a mapped parent's Jinv, and
    with the interface at the domain's lo and hi walls (the JAX package's
    index rule there, ROADMAP C.30): 1e-13;
  * one coarse step of the 2D 48x12 lock exchange at ratio (4,1) with
    all three fields refluxed, implicit refluxing and the VD correction
    (eta_lambda 0.9), lambda and e_lambda seeded with a bump so that the
    VD solve and its gradient in the advecting velocity both act, nu =
    kappa = 1e-2 so that the implicit solve differs from the explicit
    reflux: every field of both levels, the potentials and e_lambda
    within 1e-8 of max|field| in float64, also with each feature off
    (refluxing, implicit refluxing, the VD correction), each of which
    moves the JAX result by more than 100x that (float32, 1e-3: the deck
    of tests/test_torch_amr_rk3_smooth.py, every feature on);
  * the multi-patch parent of tests/test_amr.py:1091 (two level-1 patches,
    each the parent of a level-2 patch, 96x8 at ratios (2,1), (2,1)),
    refluxing all three fields: one coarse step in float64, 1e-8;
  * the port alone, as tests/test_amr.py:365, :398 and :1091 check the JAX
    package: refluxing conserves buoyancy at least as well as not
    (inviscid, 8 coarse steps; the multi-patch parent at K = (2, 2), 4),
    and implicit refluxing agrees with the explicit reflux at small dt
    kappa.

Multigrid runs with the smoothing bottom in float64 (ROADMAP C.7) and dt
is a float64 JAX scalar there (C.10).
"""

import types

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from somar_tpu.amr.flux_register import PatchFluxRegister as JRegister
from somar_tpu.amr.hierarchy import AMRHierarchy as JHierarchy
from somar_tpu.amr.tagging import TagParams as JTags
from somar_tpu.core.grid import Grid as JGrid
from somar_tpu.geometry.geo_source import CartesianMap as JCartesian
from somar_tpu.geometry.level_geometry import build_level_geometry as jgeo
from somar_tpu.physics.navier_stokes import NSParams as JParams
from somar_tpu.physics.navier_stokes import NSState as JState
from somar_tpu.problems.lock_exchange import LockExchange as JLock
from somar_tpu.solvers.multigrid import MGParams as JMG

from somar_tpu_torch import entry
from somar_tpu_torch.amr.flux_register import PatchFluxRegister as TRegister
from somar_tpu_torch.amr.hierarchy import AMRHierarchy
from somar_tpu_torch.amr.tagging import TagParams as TTags
from somar_tpu_torch.core.grid import Grid as TGrid
from somar_tpu_torch.physics.navier_stokes import NSParams as TParams
from somar_tpu_torch.solvers.multigrid import MGParams as TMG
from tests.torch_jax_reference import jax_unoptimized  # noqa: F401 (autouse)

torch.set_num_threads(1)

H = 4   # ADVECT_GROW, the patch halo
#: every field of every level, the potentials and e_lambda
FIELDS = ("vel", "scalars", "lam", "mac_phi", "cc_phi", "pressure",
          "e_lambda")
TOL = {"f64": 1e-8, "f32": 1e-3}
DT = 0.02

#: (parent nx per direction, periodic, ratio, cf_dirs, interior_nx,
#: origin per array axis (fine cells, the extended patch), mapped parent)
REGISTER_CASES = {
    # 2D: the interior in the middle of the domain
    "2d": ((24, 6), (False, False), (4, 1), (0,), (48, 6), (16, 0), False),
    # 2D, ratio 2 in both directions, the parent's Jinv an array
    "2d_mapped": ((24, 8), (False, False), (2, 2), (0,), (20, 16), (0, 10),
                  True),
    # 3D, two CF directions, ratio 1 along y
    "3d_ratio1": ((12, 8, 6), (False, False, False), (2, 1, 1), (0, 1),
                  (8, 4, 6), (0, 1, 6), False),
    # 3D: the patch spans y between its walls (y is not a CF direction)
    # and its lo interface is the domain's lo wall in x (ratio 8 > halo):
    # the coarse cell outside it is clamped into the domain, as the JAX
    # package's dynamic slices clamp
    "3d_walls_lo": ((12, 6, 4), (False, False, False), (8, 1, 1), (0,),
                    (48, 6, 4), (0, 0, 0), True),
    # the same at the hi wall
    "3d_walls_hi": ((12, 6, 4), (False, False, False), (8, 1, 1), (0,),
                    (48, 6, 4), (0, 0, 44), False),
}


def _coupling(grid_cls, nx, periodic, ratio, cf_dirs, interior, dtype):
    ndim = len(nx)
    pg = grid_cls(nx=nx, dx=tuple(1.0 + 0.25 * d for d in range(ndim)),
                  periodic=periodic)
    ext = tuple(interior[d] + (2 * H if d in cf_dirs else 0)
                for d in range(ndim))
    eg = grid_cls(nx=ext, dx=tuple(pg.dx[d] / ratio[d] for d in range(ndim)))
    return types.SimpleNamespace(
        parent_grid=pg, ext_grid=eg, cf_dirs=cf_dirs, interior_nx=interior,
        ratio=ratio, halo=H, params=types.SimpleNamespace(dtype=dtype),
        device=torch.device("cpu"))


@pytest.mark.parametrize("case", sorted(REGISTER_CASES))
def test_flux_register_matches_jax(case):
    """increment_fine (two substeps at weight 1/2), increment_coarse and
    reflux of the port's register against JAX's PatchFluxRegister on
    seeded random fluxes, float64, 1e-13 of max|value|."""
    nx, per, ratio, cf, interior, origin, mapped = REGISTER_CASES[case]
    jax.config.update("jax_enable_x64", True)
    try:
        jc = _coupling(JGrid, nx, per, ratio, cf, interior, jnp.float64)
        tc = _coupling(TGrid, nx, per, ratio, cf, interior, torch.float64)
        jr, tr = JRegister(jc), TRegister(tc)
        rng = np.random.default_rng(sum(map(ord, case)))
        ndim = len(nx)
        pshape, eshape = jc.parent_grid.shape, jc.ext_grid.shape

        def faces(shape, d):
            s = list(shape)
            s[ndim - 1 - d] += 1
            return rng.normal(size=s)

        fine = [[faces(eshape, d) for d in range(ndim)] for _ in range(2)]
        coarse = [faces(pshape, d) for d in range(ndim)]
        cc = rng.normal(size=pshape)
        geo = None
        if mapped:
            geo = rng.uniform(0.5, 2.0, size=pshape)
        org = np.asarray(origin)
        jreg, treg = jr.zeros(), tr.zeros()
        for f in fine:
            jreg = jr.increment_fine(jreg, [jnp.asarray(a) for a in f], 0.5)
            treg = tr.increment_fine(treg, [torch.as_tensor(a) for a in f],
                                     0.5)
        jreg = jr.increment_coarse(jreg, [jnp.asarray(a) for a in coarse],
                                   org)
        treg = tr.increment_coarse(treg,
                                   [torch.as_tensor(a) for a in coarse], org)
        for d in cf:
            for j, t in zip(jreg[d], treg[d]):
                np.testing.assert_allclose(t.numpy(), np.asarray(j),
                                           rtol=0, atol=1e-13
                                           * np.abs(np.asarray(j)).max())
        want = np.asarray(jr.reflux(
            jnp.asarray(cc), jreg, org, 0.37,
            None if geo is None else types.SimpleNamespace(
                Jinv=jnp.asarray(geo))))
        got = tr.reflux(torch.as_tensor(cc), treg, org, 0.37,
                        None if geo is None else types.SimpleNamespace(
                            Jinv=torch.as_tensor(geo))).numpy()
        assert np.abs(want - cc).max() > 1e-3        # the reflux acted
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-13 * np.abs(want).max())
    finally:
        jax.config.update("jax_enable_x64", False)


# -------------------------------------------------------- hierarchy steps
def host(state):
    return {f: np.asarray(getattr(state, f)) for f in entry.STATE_FIELDS}


def pair(prec, nx, nz, params, tag_tol=0.2, seed_bump=True, fronts=False,
         jax_side=True, **hkw):
    """The JAX and the port's hierarchies of the 2D lock exchange (15 x 2,
    nx x nz) with `params` (NSParams keywords, multigrid as a dict) and
    hkw, and their base states: post-initialized, with the two-front
    buoyancy lumps of tests/test_amr.py:1091 where `fronts`, lambda and
    e_lambda seeded with a bump where `seed_bump`.  Returns (JAX
    hierarchy, port's, JAX state, port's); without `jax_side` the JAX
    entries are None and the port post-initializes its own base."""
    f64 = prec == "f64"
    jd, td = (jnp.float64, torch.float64) if f64 else (jnp.float32,
                                                        torch.float32)
    mg = dict(params.pop("mg"))
    if f64:
        mg["bottom_solver"] = "smooth"
    tags = dict(buoyancy_tag_tol=tag_tol, tags_grow=1)
    tl, _ = entry.build_level(nx, nz, device="cpu", dtype=td)
    th = AMRHierarchy(tl.geo, tl.problem,
                      TParams(mg=TMG(**mg), dtype=td, **params),
                      tag_params=TTags(**tags), **hkw)
    jh = None
    if jax_side:
        g = JGrid(nx=(nx, nz), dx=(15 / nx, 2 / nz), x0=(-7.5, 0.0))
        jh = JHierarchy(jgeo(g, JCartesian(), dtype=jd),
                        JLock(pert_amp=0.0),
                        JParams(mg=JMG(**mg), dtype=jd, **params),
                        tag_params=JTags(**tags), **hkw)
        base = host(jh.level0.post_initialize(jh.level0.initial_state()))
    else:
        base = entry.ns_state_to_numpy(
            th.level0.post_initialize(th.level0.initial_state()))
    if fronts:
        x = np.asarray(th.level0.geo.phys_coords_cc()[0])
        b = ((np.abs(x + 4.0) < 0.8) | (np.abs(x - 4.0) < 0.8))
        base["scalars"] = base["scalars"].copy()
        base["scalars"][0] = np.broadcast_to(b, base["lam"].shape)
    if seed_bump:
        xs = np.linspace(-1, 1, nx)[None, :]
        zs = np.linspace(-1, 1, nz)[:, None]
        bump = np.exp(-(xs ** 2 + zs ** 2) / 0.1)
        base["lam"] = 1.0 + 0.004 * bump
        base["e_lambda"] = 0.01 * bump * np.random.default_rng(3).uniform(
            0.5, 1.0, bump.shape)
    base = {f: np.asarray(v, np.float64 if f64 else np.float32)
            for f, v in base.items()}
    js = (JState(**{f: jnp.asarray(v) for f, v in base.items()})
          if jax_side else None)
    ts = entry.ns_state_from_numpy(base, device="cpu", dtype=td)
    return jh, th, js, ts


def step_both(jh, th, js, ts, prec):
    """Placement and one coarse step of both hierarchies.  Returns
    ((JAX base, JAX levels), (port's base, port's levels)) as host
    fields, the levels a list, and the placements ((origins, weights,
    parent_sels) of each)."""
    jd = jnp.float64 if prec == "f64" else jnp.float32
    jgot, tgot = jh.initial_patch_states(js), th.initial_patch_states(ts)
    jf, jo = list(jgot[0]), list(jgot[1])
    tf, to = list(tgot[0]), list(tgot[1])
    jw = list(jgot[2]) if len(jgot) > 2 else None
    tw = list(tgot[2]) if len(tgot) > 2 else None
    ja, jaf = jh.advance(js, jf, jo, jnp.asarray(DT, jd), None, jw,
                         parent_sels=jh.parent_sels)
    ta, taf = th.advance(ts, tf, to, DT, weights=tw,
                         parent_sels=th.parent_sels)
    return (((host(ja), [host(f) for f in jaf]),
             (entry.ns_state_to_numpy(ta),
              [entry.ns_state_to_numpy(f) for f in taf])),
            ((jo, jw, jh.parent_sels), (to, tw, th.parent_sels)))


def max_rel(want, got):
    """max over the levels and FIELDS of max|got - want| / max|want|."""
    (wb, wl), (gb, gl) = want, got
    out = 0.0
    for w, g in zip([wb] + wl, [gb] + gl):
        for f in FIELDS:
            a, b = np.asarray(w[f], np.float64), np.asarray(g[f], np.float64)
            assert a.shape == b.shape, f
            out = max(out, np.abs(a - b).max() / max(np.abs(a).max(),
                                                     1e-30))
    return out


def with_x64(prec, fn, *a):
    jax.config.update("jax_enable_x64", prec == "f64")
    try:
        return fn(*a)
    finally:
        jax.config.update("jax_enable_x64", False)


#: run R: every feature on, and each turned off in turn
R_FEATURES = {"all": {},
              "no_reflux": dict(reflux=(), implicit_reflux=False),
              "explicit": dict(implicit_reflux=False),
              "no_vd": dict(eta_lambda=0.0)}


def _run_r(prec, variant):
    hkw = dict(ratio=(4, 1), reflux=True, implicit_reflux=True,
               eta_lambda=0.9)
    hkw.update(R_FEATURES[variant])
    params = dict(nu=1e-2, kappa=(1e-2,), gravity_method=1,
                  mg=dict(eps=1e-6, imax=15))
    return step_both(*pair(prec, 48, 12, params, **hkw), prec)[0]


@pytest.fixture(scope="module")
def run_r():
    return {v: with_x64("f64", _run_r, "f64", v) for v in R_FEATURES}


@pytest.mark.parametrize("variant", list(R_FEATURES))
def test_reflux_vd_step_matches_jax(run_r, variant):
    want, got = run_r[variant]
    assert max_rel(want, got) <= TOL["f64"]


@pytest.mark.parametrize("variant", ["no_reflux", "explicit", "no_vd"])
def test_each_feature_moves_the_jax_step(run_r, variant):
    """Turning a feature off changes the JAX package's step by more than
    100x the float64 tolerance."""
    all_on, off = run_r["all"][0], run_r[variant][0]
    assert max_rel(all_on, off) > 100 * TOL["f64"]


@pytest.fixture(scope="module")
def multi_parent():
    def run():
        params = dict(nu=0.0, kappa=(0.0,), gravity_method=1,
                      mg=dict(eps=1e-5, imax=10))
        return step_both(*pair("f64", 96, 8, params, tag_tol=0.12,
                               fronts=True, ratios=[(2, 1), (2, 1)],
                               patch_frac=0.2, num_patches=(2, 2),
                               reflux=True), "f64")
    return with_x64("f64", run)


def test_multi_patch_parent_reflux_matches_jax(multi_parent):
    (want, got), ((jo, jw, jps), (to, tw, tps)) = multi_parent
    for a, b in zip(jo, to):
        np.testing.assert_array_equal(b, np.asarray(a))
    assert [int(p) for p in tps[1]] == [int(p) for p in jps[1]] == [0, 1]
    assert [list(w) for w in tw] == [[1.0, 1.0], [1.0, 1.0]]
    assert max_rel(want, got) <= TOL["f64"]


# ---------------------------------------------------- the port alone
def _drift(reflux, **kw):
    """|sum b(end) - sum b(start)| on the base over `steps` coarse steps
    of the inviscid lock exchange (float32, as the JAX tests run)."""
    steps = kw.pop("steps", 8)
    nx, nz = kw.pop("shape", (64, 16))
    fronts = kw.pop("fronts", False)
    params = dict(nu=0.0, kappa=(0.0,), gravity_method=1,
                  mg=dict(eps=1e-6, imax=15))
    _, th, _, ts = pair("f32", nx, nz, params, seed_bump=False,
                        fronts=fronts, tag_tol=kw.pop("tag_tol", 0.2),
                        jax_side=False, reflux=reflux, **kw)
    got = th.initial_patch_states(ts)
    fine, org = list(got[0]), list(got[1])
    w = list(got[2]) if len(got) > 2 else None
    b0 = float(ts.scalars[0].double().sum())
    for _ in range(steps):
        ts, fine = th.advance(ts, fine, org, DT, weights=w,
                              parent_sels=th.parent_sels)
    assert bool(torch.isfinite(ts.scalars[0]).all())
    assert all(bool(torch.isfinite(f.vel).all()) for f in fine)
    return abs(float(ts.scalars[0].double().sum()) - b0)


@pytest.mark.parametrize("case", ["one_patch", "multi_patch_parent"])
def test_refluxing_conserves_buoyancy_better(case):
    kw = dict(ratio=(4, 1)) if case == "one_patch" else dict(
        ratios=[(2, 1), (2, 1)], patch_frac=0.2, num_patches=(2, 2),
        shape=(96, 8), fronts=True, tag_tol=0.12, steps=4)
    off = _drift((), **dict(kw))
    on = _drift(("scalars", "lam", "vel"), **dict(kw))
    assert on <= off + 1e-4, (on, off)


def test_implicit_reflux_matches_explicit_at_small_dt():
    """tests/test_amr.py:398 on the port: with nu = kappa = 1e-4 and dt
    0.01 the implicit correction is a tiny perturbation of the explicit
    one after 5 coarse steps."""
    def run(implicit):
        params = dict(nu=1e-4, kappa=(1e-4,), gravity_method=1,
                      mg=dict(eps=1e-6, imax=15))
        _, th, _, ts = pair("f32", 48, 12, params, seed_bump=False,
                            jax_side=False, ratio=(4, 1),
                            reflux=("scalars", "vel"),
                            implicit_reflux=implicit)
        (fine,), (org,) = th.initial_patch_states(ts)
        for _ in range(5):
            ts, fine = th.advance(ts, fine, org, 0.01)
        assert bool(torch.isfinite(ts.scalars[0]).all())
        return ts.scalars[0].numpy()

    assert np.abs(run(True) - run(False)).max() < 1e-4
