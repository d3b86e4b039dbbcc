"""Nested refined levels (amr.maxlevel = 2) of the port against the JAX
package's, on the CPU:

  * the three-level hierarchy of tests/test_amr.py:169-194 (2D 64x16, the
    DEM_2D-style ratios (4,1) then (4,2), buoyancy_tag_tol 0.2,
    tags_grow 1): its couplings (footprints, subcycle counts, halos, CF
    directions, donor slabs, the parent's halo); placement with the nest
    buffer at 0 and 2 (tests/test_amr.py:1332); placement and one coarse
    step (4 level-1 substeps, each with 4 level-2 substeps inside, the
    average-downs and the composite sync over three levels) of the eager
    JAX hierarchy (float64, a strongly typed dt) and of the port,
    inviscid (the patches' viscous and diffusive solves are the one-level
    code, held by tests/test_torch_amr_step.py): the port in float64 to
    1e-8 of max|field| and in float32 to 1e-3 (against the float64 JAX
    result, so that one eager JAX step serves both); origins exact; then
    regrid(from_level=1), which keeps level 1 as it is (bitwise in the
    port) and moves level 2 to JAX's origins (tests/test_amr.py:992); and
    the per-level dts and dynamic-subcycling factors over three levels;
  * the two-chain hierarchy of tests/test_amr.py:1014 and :1367 (2D 96x8,
    ratios (2,1) twice, patch_frac 0.2, fronts at x = -4 and +4,
    num_patches = (2, 2)): two level-1 patches, each the parent of a
    level-2 patch (parent_sel {0, 1}); K, origins, weights, parent_sels
    and the global origins through the chain exact, one coarse step in
    float64 to 1e-8; and, in the port alone, the composite solve with
    multi-patch ancestors reproducing the analytic potential
    (tests/test_amr.py:1367).

The eager JAX coarse steps are the whole cost; module-scoped fixtures
share them.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

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
from somar_tpu_torch.amr.composite import AMRCompositeSolver as TSolver
from somar_tpu_torch.amr.composite import CompositeParams as TCP
from somar_tpu_torch.amr.hierarchy import AMRHierarchy
from somar_tpu_torch.amr.tagging import TagParams as TTags
from somar_tpu_torch.physics.navier_stokes import NSParams as TParams
from somar_tpu_torch.solvers.multigrid import MGParams as TMG
from tests.torch_jax_reference import jax_unoptimized  # noqa: F401 (autouse)

torch.set_num_threads(1)

DT = 0.02
FIELDS = ("vel", "scalars", "lam", "mac_phi", "cc_phi", "pressure")
#: step tolerance per precision (a fraction of max|field|)
PRECISIONS = {"f64": 1e-8, "f32": 1e-3}
#: the three-level hierarchy (tests/test_amr.py:169)
NX3, NZ3, RATIOS3 = 64, 16, [(4, 1), (4, 2)]
#: the two-chain hierarchy (tests/test_amr.py:1014)
NX2, NZ2, RATIOS2 = 96, 8, [(2, 1), (2, 1)]
FRONTS = (-4.0, 4.0)


def _host(state):
    return {f: np.asarray(getattr(state, f)) for f in entry.STATE_FIELDS}


def _pair(prec, nx, nz, ratios, tol, **hkw):
    """A JAX hierarchy and the port's on the same inviscid lock exchange
    (multigrid eps 1e-5, imax 12; the smoothing bottom under float64,
    where the JAX BiCGStab fails)."""
    f64 = prec == "f64"
    jd = jnp.float64 if f64 else jnp.float32
    td = torch.float64 if f64 else torch.float32
    mg = dict(eps=1e-5, imax=12, **({"bottom_solver": "smooth"} if f64
                                    else {}))
    g = JGrid(nx=(nx, nz), dx=(15 / nx, 2 / nz), x0=(-7.5, 0.0))
    jh = JHierarchy(jgeo(g, JCartesian(), dtype=jd), JLock(pert_amp=0.0),
                    JParams(nu=0.0, kappa=(0.0,), gravity_method=1,
                            mg=JMG(**mg), dtype=jd), ratios=ratios,
                    tag_params=JTags(buoyancy_tag_tol=tol, tags_grow=1),
                    **hkw)
    tl, _ = entry.build_level(nx, nz, device="cpu", dtype=td)
    th = AMRHierarchy(tl.geo, tl.problem,
                      TParams(nu=0.0, kappa=(0.0,), gravity_method=1,
                              mg=TMG(**mg), dtype=td), ratios=ratios,
                      tag_params=TTags(buoyancy_tag_tol=tol, tags_grow=1),
                      **hkw)
    return jh, th, jd, td


def _base(jh, td, fronts=False):
    """The JAX base state (the two fronts' buoyancy with fronts=True) and
    the port's copy of it."""
    js = jh.level0.post_initialize(jh.level0.initial_state())
    base = _host(js)
    if fronts:
        x = np.asarray(jh.level0.geo.phys_coords_cc()[0])
        b = np.zeros(x.shape, bool)
        for c in FRONTS:
            b |= np.abs(x - c) < 0.8
        base["scalars"] = base["scalars"].copy()
        base["scalars"][0] = np.broadcast_to(b, base["lam"].shape)
        js = JState(**{f: jnp.asarray(v) for f, v in base.items()})
    return js, entry.ns_state_from_numpy(base, device="cpu", dtype=td)


def _levels(fines):
    return [_host(f) for f in fines]


def _port3(td, base):
    """The port's three-level hierarchy in dtype td on the base state's
    host fields: placed and stepped once."""
    tl, _ = entry.build_level(NX3, NZ3, device="cpu", dtype=td)
    mg = dict(eps=1e-5, imax=12, **({"bottom_solver": "smooth"}
                                    if td == torch.float64 else {}))
    th = AMRHierarchy(tl.geo, tl.problem,
                      TParams(nu=0.0, kappa=(0.0,), gravity_method=1,
                              mg=TMG(**mg), dtype=td), ratios=RATIOS3,
                      tag_params=TTags(buoyancy_tag_tol=0.2, tags_grow=1))
    ts = entry.ns_state_from_numpy(base, device="cpu", dtype=td)
    tf, to = th.initial_patch_states(ts)
    placed = _levels(tf)
    ta, taf = th.advance(ts, tf, to, DT)
    return th, list(to), placed, (ta, taf)


@pytest.fixture(scope="module")
def runs3():
    """The JAX three-level hierarchy placed and stepped once in float64,
    then regridded from level 1; the port's in float64 and float32 from
    the same base state (the float32 port held to the float64 JAX
    result)."""
    jax.config.update("jax_enable_x64", True)
    try:
        jh, _, jd, _ = _pair("f64", NX3, NZ3, RATIOS3, 0.2)
        js, _ = _base(jh, torch.float64)
        base = _host(js)
        jf, jo = jh.initial_patch_states(js)
        jplaced = _levels(jf)
        ja, jaf = jh.advance(js, jf, jo, jnp.asarray(DT, jd))
        jstep = [_host(ja)] + _levels(jaf)
        jdts = [float(d) for d in jh.level_dts(ja, jaf)]
        jr, jro = jh.regrid(ja, list(jaf), from_level=1)
        jregrid = ([np.asarray(o) for o in jro], _levels(jr))
    finally:
        jax.config.update("jax_enable_x64", False)
    out = {}
    for prec, td in (("f64", torch.float64), ("f32", torch.float32)):
        th, to, placed, (ta, taf) = _port3(td, base)
        out[prec] = dict(jh=jh, th=th, placed=(jplaced, placed),
                         origins=([np.asarray(o) for o in jo], to),
                         step=(jstep, [entry.ns_state_to_numpy(ta)]
                               + [entry.ns_state_to_numpy(f) for f in taf]))
        if prec == "f64":
            out[prec]["dts"] = (jdts, list(th.level_dts(ta, taf)))
            level1 = taf[0].vel.clone()
            tr, tro = th.regrid(ta, taf, from_level=1)
            out[prec]["regrid"] = dict(
                origins=(jregrid[0], list(tro)),
                states=(jregrid[1], [entry.ns_state_to_numpy(f)
                                     for f in tr]),
                kept=torch.equal(tr[0].vel, level1) and tr[0] is taf[0])
    return out


@pytest.fixture(scope="module")
def chains():
    """The two-chain hierarchies placed and stepped once in float64."""
    jax.config.update("jax_enable_x64", True)
    try:
        jh, th, jd, td = _pair("f64", NX2, NZ2, RATIOS2, 0.12,
                               patch_frac=0.2, num_patches=(2, 2))
        js, ts = _base(jh, td, fronts=True)
        jf, jo, jw = jh.initial_patch_states(js)
        tf, to, tw = th.initial_patch_states(ts)
        placed = dict(
            K=([c.K for c in jh.couplings], [c.K for c in th.couplings]),
            origins=([np.asarray(o) for o in jo], list(to)),
            weights=([np.asarray(w) for w in jw], list(tw)),
            psels=(jh.parent_sels, th.parent_sels),
            globals=([[jh._global_origin(lev, patch=k)
                       for k in range(c.K)]
                      for lev, c in enumerate(jh.couplings)],
                     [[th._global_origin(lev, patch=k)
                       for k in range(c.K)]
                      for lev, c in enumerate(th.couplings)]),
            fill=(_levels(jf), _levels(tf)))
        ja, jaf = jh.advance(js, jf, jo, jnp.asarray(DT, jd), None, jw,
                             parent_sels=jh.parent_sels)
        ta, taf = th.advance(ts, tf, to, DT, weights=tw,
                             parent_sels=th.parent_sels)
        placed["step"] = ([_host(ja)] + _levels(jaf),
                          [_host(ta)] + _levels(taf))
        return placed
    finally:
        jax.config.update("jax_enable_x64", False)


def _close(want, got, tol, where):
    for f in FIELDS:
        scale = max(np.abs(want[f]).max(), 1e-30)
        err = np.abs(got[f] - want[f]).max()
        assert err <= tol * scale, (where, f, err, scale)
    np.testing.assert_allclose(got["time"], want["time"], rtol=1e-6)


# ---------------------------------------------------------------- geometry
@pytest.mark.parametrize("buf", [0, 1, 2])
def test_couplings_match_jax(buf):
    """The couplings of the three-level hierarchy (tests/test_amr.py:183):
    level 2 spans level 1's vertical at ratio 2 and fits inside its valid
    interior with donor margin, as in JAX."""
    jh, th, _, _ = _pair("f32", NX3, NZ3, RATIOS3, 0.2,
                         grid_buffer_size=buf)
    assert th.num_levels == jh.num_levels == 3
    for jc, tc in zip(jh.couplings, th.couplings):
        for attr in ("ext_nx", "interior_nx", "nt", "halo", "cf_dirs",
                     "span_dirs", "donor_shape_c", "parent_halo_axes",
                     "parent_valid_nx", "nest_buffer"):
            assert getattr(tc, attr) == getattr(jc, attr), attr
        assert tuple(tc.ext_grid.shape) == tuple(jc.ext_grid.shape)
        np.testing.assert_allclose(tc.ext_grid.dx, jc.ext_grid.dx)
    c0, c1 = th.couplings
    assert c1.ext_nx[1] == c0.ext_nx[1] * 2
    assert c1.ext_nx[0] <= (c0.ext_nx[0] - 2 * c0.halo) * 4 - 2 * (
        c1.halo + 4)


@pytest.mark.parametrize("buf", [0, 2])
def test_nest_buffer_origins_match_jax(buf):
    """tests/test_amr.py:1332: the level-2 patch keeps (halo + buffer)
    parent cells inside level 1's CF boundary, at JAX's origins."""
    jh, th, _, td = _pair("f32", NX3, NZ3, RATIOS3, 0.2,
                          grid_buffer_size=buf)
    js, ts = _base(jh, td)
    _, jo = jh.initial_patch_states(js)
    _, to = th.initial_patch_states(ts)
    for a, b in zip(jo, to):
        np.testing.assert_array_equal(b, np.asarray(a))
    c0 = th.couplings[0]
    assert to[1][1] >= (c0.halo + buf) * 4
    assert th.couplings[1].nest_buffer == buf


# ------------------------------------------------------- three levels
@pytest.mark.parametrize("prec", list(PRECISIONS))
def test_three_level_placement_matches_jax(runs3, prec):
    r = runs3[prec]
    for a, b in zip(*r["origins"]):
        np.testing.assert_array_equal(b, a)
    assert r["th"].parent_sels is None and r["jh"].parent_sels is None
    assert not r["th"].multi_patch
    for lev, (want, got) in enumerate(zip(*r["placed"])):
        _close(want, got, PRECISIONS[prec], f"level {lev + 1}")
    # the level-2 patch sits inside level 1's valid interior
    c0, c1 = r["th"].couplings
    o1 = r["origins"][1][1]
    assert o1[1] >= (c0.halo + 1) * 4
    assert o1[1] + c1.ext_nx[0] <= (c0.ext_nx[0] - c0.halo - 1) * 4


@pytest.mark.parametrize("level", [0, 1, 2])
@pytest.mark.parametrize("prec", list(PRECISIONS))
def test_three_level_step_matches_jax(runs3, prec, level):
    """One coarse step: the base advance, 4 level-1 substeps with 4
    level-2 substeps inside each, the average-downs and the composite
    sync over three levels."""
    want, got = runs3[prec]["step"]
    _close(want[level], got[level], PRECISIONS[prec], f"level {level}")
    assert np.all(np.isfinite(got[level]["vel"]))


def test_regrid_from_level_1_keeps_level_1(runs3):
    """tests/test_amr.py:992: regrid(from_level=1) re-chooses level 2
    only; level 1 keeps its origin and its data (bitwise in the port)."""
    r = runs3["f64"]
    g = r["regrid"]
    for a, b in zip(*g["origins"]):
        np.testing.assert_array_equal(b, a)
    np.testing.assert_array_equal(g["origins"][1][0], r["origins"][1][0])
    assert g["kept"]
    for lev, (want, got) in enumerate(zip(*g["states"])):
        _close(want, got, PRECISIONS["f64"], f"level {lev + 1}")


def test_level_dts_and_subcycling_match_jax(runs3):
    """level_dts over three levels (one host read in the port) and the
    dynamic-subcycling factors of tests/test_amr.py:955."""
    want, got = runs3["f64"]["dts"]
    assert len(got) == 3
    np.testing.assert_allclose(got, want, rtol=1e-12)
    jh, th = runs3["f64"]["jh"], runs3["f64"]["th"]
    for dt, dts in ((0.02, [0.1, 0.05, 0.05]), (0.02, [0.1, 2e-3, 1.0]),
                    (0.02, [0.1, 1.0, 2e-4]), (0.02, [0.1, 2e-3, 2e-4]),
                    (0.5, want)):
        assert th.subcycle_multipliers(dt, dts) == \
            jh.subcycle_multipliers(dt, dts)
    assert th.subcycle_multipliers(0.02, [0.1, 2e-3, 1.0])[0] == 4
    nt = [c.nt for c in th.couplings]
    ts = [_state(x) for x in runs3["f64"]["step"][1]]
    assert th.compute_dt(ts[0], ts[1:]) == pytest.approx(min(
        want[0], nt[0] * want[1], nt[0] * nt[1] * want[2]), rel=1e-12)


def _state(host):
    return entry.ns_state_from_numpy(host, device="cpu", dtype=torch.float64)


# ----------------------------------------------------------- two chains
def test_two_chain_placement_matches_jax(chains):
    """tests/test_amr.py:1014: two level-1 patches, each the parent of an
    active level-2 patch; K, origins, weights and parent_sels exact."""
    assert chains["K"][1] == chains["K"][0] == [2, 2]
    for a, b in zip(*chains["origins"]):
        np.testing.assert_array_equal(b, a)
    for a, b in zip(*chains["weights"]):
        np.testing.assert_array_equal(b, a)
    jp, tp = chains["psels"]
    assert tp[0] is None and jp[0] is None
    np.testing.assert_array_equal(tp[1], np.asarray(jp[1]))
    w1 = chains["weights"][1][1]
    assert sorted({int(p) for p, w in zip(tp[1], w1) if w > 0}) == [0, 1]
    for lev, (want, got) in enumerate(zip(*chains["fill"])):
        _close(want, got, PRECISIONS["f64"], f"level {lev + 1}")


def test_global_origins_through_the_chain_match_jax(chains):
    jg, tg = chains["globals"]
    for a, b in zip(jg, tg):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(y, x)
    # the two level-2 patches live under different fronts
    assert abs(int(tg[1][0][1]) - int(tg[1][1][1])) > NX2 * 4 // 4


@pytest.mark.parametrize("level", [0, 1, 2])
def test_two_chain_step_matches_jax(chains, level):
    want, got = chains["step"]
    _close(want[level], got[level], PRECISIONS["f64"], f"level {level}")


def test_composite_solve_with_multi_patch_ancestors():
    """tests/test_amr.py:1367 in the port: each level-2 patch's FAS tau
    lands in its own level-1 parent, so the composite solve converges past
    the Schwarz fixed point and reproduces the analytic potential inside
    the level-2 patches."""
    Lx, Lz = 15.0, 2.0
    tl, g = entry.build_level(NX2, NZ2, device="cpu", dtype=torch.float32)
    h = AMRHierarchy(tl.geo, tl.problem,
                     TParams(nu=1e-4, kappa=(1e-4,), gravity_method=1,
                             mg=TMG(eps=1e-6, imax=20)),
                     ratios=RATIOS2, patch_frac=0.2,
                     tag_params=TTags(buoyancy_tag_tol=0.12, tags_grow=1),
                     num_patches=(2, 2))
    s0 = h.level0.post_initialize(h.level0.initial_state())
    x = h.level0.geo.phys_coords_cc()[0]
    x = np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
    b = (np.abs(x + 4.0) < 0.8) | (np.abs(x - 4.0) < 0.8)
    scal = s0.scalars.clone()
    scal[0] = torch.as_tensor(np.broadcast_to(b, g.shape).astype(
        np.float32))
    s0 = dataclasses.replace(s0, scalars=scal)
    fines, origins, weights = h.initial_patch_states(s0)
    psels = h.parent_sels
    c0, c1 = h.couplings
    assert c0.K == 2 and c1.K == 2
    w1 = np.asarray(weights[1])
    assert sorted({int(p) for p, wk in zip(c1.parent_sel, w1)
                   if wk > 0}) == [0, 1]
    kx, kz = np.pi / Lx, np.pi / Lz

    def phi_star(xc, zc):
        return np.cos(kx * (xc - g.x0[0])) * np.cos(kz * (zc - g.x0[1]))

    lam = -(kx * kx + kz * kz)

    def patch_coords(lev, k):
        c = h.couplings[lev]
        gf = h._global_origin(lev, patch=k)
        dxf = c.ext_grid.dx
        zf = g.x0[1] + (gf[0] + np.arange(c.ext_grid.shape[0]) + 0.5) \
            * dxf[1]
        xf = g.x0[0] + (gf[1] + np.arange(c.ext_grid.shape[1]) + 0.5) \
            * dxf[0]
        return np.meshgrid(zf, xf, indexing="ij")

    zc = g.x0[1] + (np.arange(g.shape[0]) + 0.5) * g.dx[1]
    xc = g.x0[0] + (np.arange(g.shape[1]) + 0.5) * g.dx[0]
    Z0, X0 = np.meshgrid(zc, xc, indexing="ij")
    rhss = [torch.as_tensor(lam * phi_star(X0, Z0), dtype=torch.float32)]
    for lev in range(2):
        pats = []
        for k in range(h.couplings[lev].K):
            Zf, Xf = patch_coords(lev, k)
            pats.append(lam * phi_star(Xf, Zf))
        rhss.append(torch.as_tensor(np.stack(pats), dtype=torch.float32))
    phis, (iters, rel) = TSolver(h, TCP(iters=5)).solve(
        rhss, origins, weights=weights, parent_sels=psels)
    assert float(rel) < 2e-3, (iters, float(rel))
    e0 = phi_star(X0, Z0)
    scale = np.abs(e0 - e0.mean()).max()
    p0 = phis[0].numpy()
    assert np.max(np.abs((p0 - p0.mean()) - (e0 - e0.mean()))) \
        < 0.05 * scale
    H = h.halo
    for k in range(2):
        Zf, Xf = patch_coords(1, k)
        e2 = phi_star(Xf, Zf)[:, H:-H]
        p2 = phis[2][k].numpy()[:, H:-H]
        diff = (p2 - p2.mean()) - (e2 - e2.mean())
        assert np.max(np.abs(diff)) < 0.05 * scale, (k, diff)
