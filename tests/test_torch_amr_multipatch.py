"""A refined level of K = 2 patches against the JAX package's, on the CPU:
the two-front field of tests/test_amr.py:504-531 (2D 96x12, ratio (4,1),
patch_frac 0.2, buoyancy_tag_tol 0.12, tags_grow 1, num_patches unset)
placed, which doubles K from 1 to 2 in both packages, then one coarse
step (4 subcycled advances of each patch, weighted average-down, the
composite sync over both patches) of the eager JAX hierarchy and of the
port, and the same step with the dynamic-subcycling factor nt_mults =
(2,) (8 advances of each patch, the halo's time fractions and the cc
ring's scale at nt = 8):

  * inviscid (the per-patch viscous and diffusive solves are the K = 1
    code, held against JAX by tests/test_torch_amr_step.py), in float64:
    every field of both levels to 1e-8 of max|field|; in float32: 1e-3;
  * the composite residual at K = 2 on random potentials and right-hand
    sides, with both patches active and with slot 1 at weight 0: 1e-12
    (float64) and 1e-5 (float32) relative;
  * the composite sums and norms (p = 0, 1, 2) over the base and both
    patches of random fields: the same tolerances.

Two eager JAX steps per precision (~15 s here) are the whole cost; the
module-scoped fixture shares them.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from somar_tpu.amr.composite import AMRCompositeSolver as JSolver
from somar_tpu.amr.composite import CompositeParams as JCP
from somar_tpu.amr.hierarchy import AMRHierarchy as JHierarchy
from somar_tpu.amr.tagging import TagParams as JTags
from somar_tpu.ops import norms as jnorms
from somar_tpu.core.grid import Grid as JGrid
from somar_tpu.geometry.geo_source import CartesianMap as JCartesian
from somar_tpu.geometry.level_geometry import build_level_geometry as jgeo
from somar_tpu.physics.navier_stokes import NSParams as JParams
from somar_tpu.physics.navier_stokes import NSState as JState
from somar_tpu.problems.lock_exchange import LockExchange as JLock
from somar_tpu.solvers.multigrid import MGParams as JMG

from somar_tpu_torch import entry
from somar_tpu_torch.amr.composite import AMRCompositeSolver as TSolver
from somar_tpu_torch.amr.hierarchy import AMRHierarchy
from somar_tpu_torch.amr.tagging import TagParams as TTags
from somar_tpu_torch.ops import norms as tnorms
from somar_tpu_torch.physics.navier_stokes import NSParams as TParams
from somar_tpu_torch.solvers.multigrid import MGParams as TMG
from tests.torch_jax_reference import jax_unoptimized  # noqa: F401 (autouse)

torch.set_num_threads(1)

NX, NZ = 96, 12
DT = 0.02
FIELDS = ("vel", "scalars", "lam", "mac_phi", "cc_phi", "pressure")
#: (step tolerance, residual tolerance) per precision
PRECISIONS = {"f64": (1e-8, 1e-12), "f32": (1e-3, 1e-5)}


def _host(state):
    return {f: np.asarray(getattr(state, f)) for f in entry.STATE_FIELDS}


def _run(prec):
    """Both packages placed on the two-front field and stepped once.
    Returns {stage: (JAX host fields (base, level), port's)} and the two
    hierarchies with the placed base states."""
    f64 = prec == "f64"
    jd = jnp.float64 if f64 else jnp.float32
    td = torch.float64 if f64 else torch.float32
    mg = dict(eps=1e-5, imax=12, **({"bottom_solver": "smooth"} if f64
                                    else {}))
    g = JGrid(nx=(NX, NZ), dx=(15 / NX, 2 / NZ), x0=(-7.5, 0.0))
    hkw = dict(ratio=(4, 1), patch_frac=0.2)
    jh = JHierarchy(jgeo(g, JCartesian(), dtype=jd), JLock(pert_amp=0.0),
                    JParams(nu=0.0, kappa=(0.0,), gravity_method=1,
                            mg=JMG(**mg), dtype=jd),
                    tag_params=JTags(buoyancy_tag_tol=0.12, tags_grow=1),
                    **hkw)
    tl, _ = entry.build_level(NX, NZ, device="cpu", dtype=td)
    th = AMRHierarchy(tl.geo, tl.problem,
                      TParams(nu=0.0, kappa=(0.0,), gravity_method=1,
                              mg=TMG(**mg), dtype=td),
                      tag_params=TTags(buoyancy_tag_tol=0.12, tags_grow=1),
                      **hkw)
    js = jh.level0.post_initialize(jh.level0.initial_state())
    x = np.asarray(jh.level0.geo.phys_coords_cc()[0])
    b = ((np.abs(x + 4.0) < 0.8) | (np.abs(x - 4.0) < 0.8)).astype(
        np.float64)
    base = _host(js)
    base["scalars"] = base["scalars"].copy()
    base["scalars"][0] = np.broadcast_to(b, base["lam"].shape)
    js = JState(**{f: jnp.asarray(v) for f, v in base.items()})
    ts = entry.ns_state_from_numpy(base, device="cpu", dtype=td)
    (jf,), (jo,), (jw,) = jh.initial_patch_states(js)
    (tf,), (to,), (tw,) = th.initial_patch_states(ts)
    out = {"placed": ((base, _host(jf)), (entry.ns_state_to_numpy(ts),
                                          entry.ns_state_to_numpy(tf)))}
    ja, jaf = jh.advance(js, jf, jo, jnp.asarray(DT, jd), None, jw)
    ta, taf = th.advance(ts, tf, to, DT, weights=tw)
    out["step"] = ((_host(ja), _host(jaf)), (entry.ns_state_to_numpy(ta),
                                             entry.ns_state_to_numpy(taf)))
    ja, jaf = jh.advance(js, jf, jo, jnp.asarray(DT, jd), None, jw,
                         nt_mults=(2,))
    ta, taf = th.advance(ts, tf, to, DT, weights=tw, nt_mults=(2,))
    out["step_m2"] = ((_host(ja), _host(jaf)),
                      (entry.ns_state_to_numpy(ta),
                       entry.ns_state_to_numpy(taf)))
    return out, (jh, th, (jo, jw), (to, tw))


@pytest.fixture(scope="module")
def runs():
    out = {}
    for prec in PRECISIONS:
        jax.config.update("jax_enable_x64", prec == "f64")
        try:
            out[prec] = _run(prec)
        finally:
            jax.config.update("jax_enable_x64", False)
    return out


@pytest.mark.parametrize("prec", list(PRECISIONS))
def test_two_fronts_place_two_patches_as_jax(runs, prec):
    _, (jh, th, (jo, jw), (to, tw)) = runs[prec]
    assert jh.couplings[0].K == th.couplings[0].K == 2
    np.testing.assert_array_equal(to, np.asarray(jo))
    np.testing.assert_array_equal(tw, np.asarray(jw))
    assert tw.tolist() == [1.0, 1.0]
    assert th.couplings[0].tag_coverage == jh.couplings[0].tag_coverage


@pytest.mark.parametrize("stage", ["placed", "step", "step_m2"])
@pytest.mark.parametrize("prec", list(PRECISIONS))
def test_k2_coarse_step_matches_jax(runs, prec, stage):
    out, _ = runs[prec]
    if stage == "step_m2":
        # the factor changes the patches' step well beyond the float64
        # tolerance (float32's 1e-3 is above the change itself)
        (_, jm1), (_, jm2) = out["step"][0], out["step_m2"][0]
        diff = np.abs(jm2["scalars"] - jm1["scalars"]).max()
        assert diff > 100 * PRECISIONS["f64"][0] * np.abs(
            jm1["scalars"]).max(), diff
    tol = 1e-13 if stage == "placed" else PRECISIONS[prec][0]
    (jb, jf), (tb, tf) = out[stage]
    for level, want, got in (("base", jb, tb), ("patches", jf, tf)):
        for f in FIELDS:
            assert got[f].shape == want[f].shape, (level, f)
            scale = max(np.abs(want[f]).max(), 1e-30)
            err = np.abs(got[f] - want[f]).max()
            assert err <= tol * scale, (level, f, err, scale)
        np.testing.assert_allclose(got["time"], want["time"], rtol=1e-6)
    assert tf["vel"].shape[0] == 2


@pytest.mark.parametrize("weights", [(1.0, 1.0), (1.0, 0.0)])
@pytest.mark.parametrize("prec", list(PRECISIONS))
def test_k2_composite_residual_matches_jax(runs, prec, weights):
    _, (jh, th, (jo, _), (to, _)) = runs[prec]
    f64 = prec == "f64"
    jax.config.update("jax_enable_x64", f64)
    try:
        dt = np.float64 if f64 else np.float32
        rng = np.random.default_rng(3)
        shape0 = jh.grid0.shape
        shape1 = (2,) + tuple(jh.couplings[0].ext_grid.shape)
        arrs = [rng.normal(size=s).astype(dt)
                for s in (shape0, shape1, shape0, shape1)]
        w = np.asarray(weights, dt)
        want = float(JSolver(jh, JCP()).composite_residual(
            [jnp.asarray(arrs[0]), jnp.asarray(arrs[1])],
            [jnp.asarray(arrs[2]), jnp.asarray(arrs[3])], (jo,),
            weights=(jnp.asarray(w),)))
        t = [torch.as_tensor(a) for a in arrs]
        got = float(TSolver(th).composite_residual(
            [t[0], t[1]], [t[2], t[3]], (to,), (w,)))
        assert abs(got - want) <= PRECISIONS[prec][1] * abs(want), (got,
                                                                    want)
    finally:
        jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("prec", list(PRECISIONS))
def test_k2_composite_norms_match_jax(runs, prec):
    _, (jh, th, (jo, _), (to, _)) = runs[prec]
    f64 = prec == "f64"
    jax.config.update("jax_enable_x64", f64)
    try:
        dt = np.float64 if f64 else np.float32
        rng = np.random.default_rng(4)
        fields = [rng.normal(size=jh.grid0.shape).astype(dt),
                  rng.normal(size=(2,) + tuple(
                      jh.couplings[0].ext_grid.shape)).astype(dt)]
        jf = [jnp.asarray(f) for f in fields]
        tf = [torch.as_tensor(f) for f in fields]
        pairs = [(jnorms.composite_mapped_sum(jh, jf, (jo,)),
                  tnorms.composite_mapped_sum(th, tf, (to,)))]
        pairs += [(jnorms.composite_mapped_norm(jh, jf, (jo,), p),
                   tnorms.composite_mapped_norm(th, tf, (to,), p))
                  for p in (0, 1, 2)]
        for want, got in pairs:
            want, got = float(want), float(got)
            assert abs(got - want) <= PRECISIONS[prec][1] * abs(want), (
                got, want)
    finally:
        jax.config.update("jax_enable_x64", False)
