"""The port's multi-patch placement and regrid against the JAX package's,
eagerly, on the CPU:

  * `patch_origins_from_tags` and `tag_coverage` on synthetic tag arrays
    (pure numpy): the same origins and weights for K = 1, 2, 4 in 2D and
    3D, clusters far apart, close together and touching the ends;
  * `subcycle_multipliers` on given dts;
  * a 2D 48x16 hierarchy (ratio (4,1), patch_frac 0.3) placed on one
    buoyancy lump, then regridded (the lump moved; two lumps, which
    doubles K from 1 to 2 within the regrid, the case of
    tests/test_amr.py:556; K pinned at 4, two slots at weight 0; a
    footprint widened by right-sizing with max_auto_patches = 1), the old
    patch data perturbed so that the overlap copy shows: K, weights and
    origins exactly, every field to 1e-12 in float64 and 1e-6 in
    float32;
  * `choose_origins` and the tag coverage on the hierarchy, and the
    placement escalating K 1 -> 2 on the two-front field of
    tests/test_amr.py:504-531.
"""

import warnings

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from somar_tpu.amr.hierarchy import AMRHierarchy as JHierarchy
from somar_tpu.amr.tagging import TagParams as JTags
from somar_tpu.amr.tagging import patch_origins_from_tags as jorigins
from somar_tpu.amr.tagging import tag_coverage as jcoverage
from somar_tpu.core.grid import Grid as JGrid
from somar_tpu.geometry.geo_source import CartesianMap as JCartesian
from somar_tpu.geometry.level_geometry import build_level_geometry as jgeo
from somar_tpu.physics.navier_stokes import NSParams as JParams
from somar_tpu.physics.navier_stokes import NSState as JState
from somar_tpu.problems.lock_exchange import LockExchange as JLock
from somar_tpu.solvers.multigrid import MGParams as JMG

from somar_tpu_torch import entry
from somar_tpu_torch.amr.hierarchy import AMRHierarchy
from somar_tpu_torch.amr.tagging import TagParams as TTags
from somar_tpu_torch.amr.tagging import patch_origins_from_tags as torigins
from somar_tpu_torch.amr.tagging import tag_coverage as tcoverage
from somar_tpu_torch.core.grid import Grid as TGrid
from somar_tpu_torch.physics.navier_stokes import NSParams as TParams
from somar_tpu_torch.solvers.multigrid import MGParams as TMG
from tests.torch_jax_reference import jax_unoptimized  # noqa: F401 (autouse)

torch.set_num_threads(1)

FIELDS = ("vel", "scalars", "lam", "mac_phi", "cc_phi", "pressure",
          "e_lambda")


# ------------------------------------------------------ origins from tags
def _tag_case(name):
    """(tags, grid kwargs, ratio, interior per array axis, halo per array
    axis) of a synthetic case."""
    if name.startswith("2d"):
        nx, nz = 48, 8
        tags = np.zeros((nz, nx), bool)
        grid = dict(nx=(nx, nz), dx=(15 / nx, 2 / nz))
        ratio, interior, halo = (4, 1), (8, 40), (0, 4)
        if name == "2d far apart":
            tags[:, 6:9] = True
            tags[:, 38:41] = True
        elif name == "2d close":
            tags[:, 20:22] = True
            tags[:, 25:27] = True
        elif name == "2d three and an end":
            tags[:, 0:3] = True
            tags[:, 22:24] = True
            tags[:, 44:48] = True
        elif name == "2d random":
            tags = np.random.default_rng(5).uniform(size=(nz, nx)) > 0.93
        return tags, grid, ratio, interior, halo
    nx, ny, nz = 40, 16, 6
    tags = np.zeros((nz, ny, nx), bool)
    grid = dict(nx=(nx, ny, nz), dx=(15 / nx, 2 / ny, 2 / nz),
                periodic=(False, True, False))
    tags[:, 3:9, 4:7] = True
    tags[:, 10:14, 30:34] = True
    return tags, grid, (4, 1, 1), (6, 16, 32), (0, 0, 4)


TAG_CASES = ["2d far apart", "2d close", "2d three and an end", "2d random",
             "3d two lumps"]


@pytest.mark.parametrize("K", [1, 2, 4])
@pytest.mark.parametrize("case", TAG_CASES)
def test_patch_origins_from_tags_match_jax(case, K):
    tags, gkw, ratio, interior, halo = _tag_case(case)
    jg, tg = JGrid(**gkw), TGrid(**gkw)
    for fill, bf in ((0.8, 8), (0.7, 4)):
        want = jorigins(tags, jg, ratio, interior, halo, K,
                        fill_ratio=fill, block_factor=bf)
        got = torigins(tags, tg, ratio, interior, halo, K, fill_ratio=fill,
                       block_factor=bf)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[0].dtype == np.int64 and got[1].dtype == np.float32
        assert jcoverage(tags, want[0], want[1], jg, ratio, interior,
                         halo) == tcoverage(tags, got[0], got[1], tg, ratio,
                                            interior, halo)
    assert torigins(np.zeros_like(tags), tg, ratio, interior, halo,
                    K) is None


DT_CASES = {"fits": (0.04, [0.05, 0.02]), "twice": (0.04, [0.05, 0.005]),
            "four times": (0.08, [0.1, 0.004]),
            "capped at 16": (1.0, [1.0, 1e-5]), "zero dt": (0.04, [0.05, 0.0])}


@pytest.mark.parametrize("case", list(DT_CASES))
def test_subcycle_multipliers_match_jax(pair64, case):
    jh, th = pair64
    dt, dts = DT_CASES[case]
    for tol in (1.1, 1.0):
        assert th.subcycle_multipliers(dt, dts, tol) == \
            jh.subcycle_multipliers(dt, dts, tol)


# ------------------------------------------------------------ hierarchies
NX, NZ = 48, 16


def _lumps(x, centres):
    return sum((np.abs(x - c) < 0.8).astype(np.float64) for c in centres)


def _pair(prec, **kw):
    f64 = prec == "f64"
    jd = jnp.float64 if f64 else jnp.float32
    td = torch.float64 if f64 else torch.float32
    mg = dict(eps=1e-5, imax=12, **({"bottom_solver": "smooth"} if f64
                                    else {}))
    g = JGrid(nx=(NX, NZ), dx=(15 / NX, 2 / NZ), x0=(-7.5, 0.0))
    hkw = dict(ratio=(4, 1), patch_frac=kw.pop("patch_frac", 0.3), **kw)
    jh = JHierarchy(jgeo(g, JCartesian(), dtype=jd), JLock(pert_amp=0.0),
                    JParams(nu=1e-4, kappa=(1e-4,), gravity_method=1,
                            mg=JMG(**mg), dtype=jd),
                    tag_params=JTags(buoyancy_tag_tol=0.12, tags_grow=1),
                    **hkw)
    tl, _ = entry.build_level(NX, NZ, device="cpu", dtype=td)
    th = AMRHierarchy(tl.geo, tl.problem,
                      TParams(nu=1e-4, kappa=(1e-4,), gravity_method=1,
                              mg=TMG(**mg), dtype=td),
                      tag_params=TTags(buoyancy_tag_tol=0.12, tags_grow=1),
                      **hkw)
    return jh, th


def _states(jh, td, centres, seed=0):
    """The same base state for both packages: the post-initialized lock
    exchange with its buoyancy replaced by vertically uniform lumps and
    a small random velocity."""
    js = jh.level0.post_initialize(jh.level0.initial_state())
    x = np.asarray(jh.level0.geo.phys_coords_cc()[0])
    f = {n: np.array(getattr(js, n)) for n in entry.STATE_FIELDS}
    f["scalars"][0] = np.broadcast_to(_lumps(x, centres), f["lam"].shape)
    f["vel"] = f["vel"] + 1e-2 * np.random.default_rng(seed).normal(
        size=f["vel"].shape).astype(f["vel"].dtype)
    js = JState(**{n: jnp.asarray(v) for n, v in f.items()})
    return js, entry.ns_state_from_numpy(f, device="cpu", dtype=td)


def _perturbed(jfine, td, seed):
    """Old patch data that interpolation cannot give: the patches plus
    noise (the same for both packages)."""
    f = {n: np.array(getattr(jfine, n)) for n in entry.STATE_FIELDS}
    rng = np.random.default_rng(seed)
    for n in FIELDS:
        f[n] = (f[n] + 0.1 * rng.normal(size=f[n].shape)).astype(f[n].dtype)
    return (JState(**{n: jnp.asarray(v) for n, v in f.items()}),
            entry.ns_state_from_numpy(f, device="cpu", dtype=td))


def _close(jstate, tstate, tol):
    for n in FIELDS:
        want = np.asarray(getattr(jstate, n))
        got = getattr(tstate, n).numpy()
        assert got.shape == want.shape, (n, got.shape, want.shape)
        scale = max(np.abs(want).max(), 1e-30)
        assert np.abs(got - want).max() <= tol * scale, (n, tol)


def _same_level(jh, th):
    jc, tc = jh.couplings[0], th.couplings[0]
    assert (tc.K, tc.ext_nx, tc.interior_nx) == (jc.K, jc.ext_nx,
                                                  jc.interior_nx)
    np.testing.assert_array_equal(tc.origin_f, np.asarray(jc.origin_f))
    if jc.weights is None:
        assert tc.weights is None
    else:
        np.testing.assert_array_equal(tc.weights, np.asarray(jc.weights))
    assert tc.tag_coverage == jc.tag_coverage


# regrid scenario: (hierarchy kwargs, lump centres at placement, at regrid)
REGRIDS = {
    "moved lump": ({}, [-4.0], [-2.5]),
    "K 1 -> 2 (tests/test_amr.py:556)": ({}, [-4.0], [-4.0, 4.0]),
    "K pinned at 4": (dict(num_patches=4), [-4.0], [-4.0, 4.0]),
    "footprint widened": (dict(max_auto_patches=1), [-4.0],
                          [-4.0, 1.0]),
}


@pytest.fixture(scope="module")
def pair64():
    jax.config.update("jax_enable_x64", True)
    try:
        return _pair("f64")
    finally:
        jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("prec", ["f64", "f32"])
@pytest.mark.parametrize("case", list(REGRIDS))
def test_regrid_matches_jax(case, prec):
    kw, placed, moved = REGRIDS[case]
    td = torch.float64 if prec == "f64" else torch.float32
    tol = 1e-12 if prec == "f64" else 1e-6
    jax.config.update("jax_enable_x64", prec == "f64")
    try:
        jh, th = _pair(prec, **kw)
        js, ts = _states(jh, td, placed)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            jgot = jh.initial_patch_states(js)
            tgot = th.initial_patch_states(ts)
        assert len(jgot) == len(tgot)
        _same_level(jh, th)
        _close(jgot[0][0], tgot[0][0], tol)
        jold, told = _perturbed(jgot[0][0], td, 7)
        js, ts = _states(jh, td, moved, seed=1)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            jgot = jh.regrid(js, (jold,))
            tgot = th.regrid(ts, (told,))
        assert len(jgot) == len(tgot)
        _same_level(jh, th)
        np.testing.assert_array_equal(tgot[1][0], np.asarray(jgot[1][0]))
        if len(jgot) > 2:
            np.testing.assert_array_equal(tgot[2][0],
                                          np.asarray(jgot[2][0]))
        _close(jgot[0][0], tgot[0][0], tol)
        c = th.couplings[0]
        if case.startswith("K 1 -> 2"):
            assert c.K == 2 and c.weights.tolist() == [1.0, 1.0]
            assert c.tag_coverage[0] == 0
        if case == "K pinned at 4":
            assert c.K == 4 and c.weights.tolist() == [1.0, 1.0, 0.0, 0.0]
        if case == "footprint widened":
            assert c.K == 1 and c.interior_nx != (16, 56)
            assert c.tag_coverage[0] == 0
    finally:
        jax.config.update("jax_enable_x64", False)


def test_placement_escalates_on_two_fronts_as_jax():
    """tests/test_amr.py:504-531's field at placement: the default K = 1
    doubles to 2 and both patches are active at the same origins as the
    JAX package's; choose_origins then reports the same coverage."""
    jax.config.update("jax_enable_x64", True)
    try:
        jh, th = _pair("f64")
        js, ts = _states(jh, torch.float64, [-4.0, 4.0])
        jgot = jh.initial_patch_states(js)
        tgot = th.initial_patch_states(ts)
        assert len(tgot) == 3 and th.multi_patch
        _same_level(jh, th)
        assert tgot[2][0].tolist() == [1.0, 1.0]
        _close(jgot[0][0], tgot[0][0], 1e-12)
        jo, jw = jh.couplings[0].choose_origins(js, jh.tag_params)
        to, tw = th.couplings[0].choose_origins(ts, th.tag_params)
        np.testing.assert_array_equal(to, jo)
        np.testing.assert_array_equal(tw, jw)
        assert th.couplings[0].tag_coverage == jh.couplings[0].tag_coverage
    finally:
        jax.config.update("jax_enable_x64", False)
