"""The VD (volume-discrepancy, freestream) correction of the port's AMR
hierarchy on the CPU.  Its composite solve and the gradient the next step
adds to the advecting velocities are held against the JAX package by
tests/test_torch_amr_reflux.py (one coarse step, 1e-8 in float64) and
tests/test_torch_amr_mapped_multipatch.py (two mapped slots); here:

  * tests/test_amr.py:779 on the port: with lambda seeded by a bump, 3
    coarse steps of the 2D 64x16 lock exchange at eta_lambda 0.9 fill
    e_lambda on the base and in the patch interior, and lambda stays
    within 0.016 of 1 on both levels;
  * tests/test_amr.py:821 on the port: the same on the two-front K = 2
    level (96x12, patch_frac 0.2), each slot's interior filled, lambda
    within 0.016 (base) and 0.02 (patches);
  * the flag on every slot level: a mapped hierarchy's slots, rebuilt at
    each placement and regrid, keep use_vd_correction;
  * the "vd" purpose: the base level's multigrid VD solve takes
    NSParams.mg_vd (its iteration cap shows in the solve's info and in
    e_lambda);
  * the plot file's grad_eLambda on a patch level (its CF sides) equals
    the JAX package's, float64, 1e-13.
"""

import numpy as np
import torch
import jax
import jax.numpy as jnp

from somar_tpu.config.context import PlotConfig as JPlot
from somar_tpu.io import checkpoint as jck

from somar_tpu_torch import entry
from somar_tpu_torch.config.context import PlotConfig as TPlot
from somar_tpu_torch.io import checkpoint as tck
from somar_tpu_torch.solvers.multigrid import MGParams
from tests.test_torch_amr_reflux import pair
from tests.torch_jax_reference import jax_unoptimized  # noqa: F401 (autouse)

torch.set_num_threads(1)

DT = 0.02


def _steps(h, s0, n, **kw):
    got = h.initial_patch_states(s0)
    fine, org = list(got[0]), list(got[1])
    w = list(got[2]) if len(got) > 2 else None
    for _ in range(n):
        s0, fine = h.advance(s0, fine, org, DT, weights=w, **kw)
    return s0, fine


def _vd_pair(nx, nz, **hkw):
    params = dict(nu=1e-4, kappa=(1e-4,), gravity_method=1,
                  mg=dict(eps=1e-5, imax=12))
    _, th, _, ts = pair("f32", nx, nz, params, eta_lambda=0.9,
                        jax_side=False, **hkw)
    ts.e_lambda.zero_()
    return th, ts


def test_composite_vd_correction_fills_fine_e_lambda():
    th, ts = _vd_pair(64, 16, ratio=(4, 1))
    assert th.level0.use_vd_correction
    assert th.couplings[0].level.use_vd_correction
    s0, (f,) = _steps(th, ts, 3)
    e0, e1 = s0.e_lambda, f.e_lambda
    H = th.halo
    assert bool((e0 != 0).any()) and bool(torch.isfinite(e0).all())
    assert bool((e1[:, 2 * H:-2 * H] != 0).any())
    assert bool(torch.isfinite(e1).all())
    assert float((s0.lam - 1).abs().max()) < 0.016
    assert float((f.lam - 1).abs().max()) < 0.016
    assert th.last_vd_info[0] == 1


def test_vd_correction_on_multipatch_level():
    th, ts = _vd_pair(96, 12, ratio=(4, 1), patch_frac=0.2, tag_tol=0.12,
                      fronts=True, num_patches=2)
    s0, (f,) = _steps(th, ts, 3)
    assert th.couplings[0].weights.tolist() == [1.0, 1.0]
    H = th.halo
    assert f.e_lambda.shape[0] == 2
    for k in range(2):
        assert bool((f.e_lambda[k][:, 2 * H:-2 * H] != 0).any()), k
    assert bool(torch.isfinite(f.e_lambda).all())
    assert float((s0.lam - 1).abs().max()) < 0.016
    assert float((f.lam - 1).abs().max()) < 0.02


def test_rebuilt_mapped_slots_keep_the_vd_flag():
    """Slots rebuilt by a regrid that moves them (make_level) and by a
    restore (new couplings) carry the flag."""
    import dataclasses
    from somar_tpu_torch.amr.hierarchy import AMRHierarchy
    from somar_tpu_torch.amr.tagging import TagParams
    from somar_tpu_torch.geometry.bathymetric import LedgeMap
    from somar_tpu_torch.geometry.level_geometry import build_level_geometry
    tl, grid = entry.build_level(32, 8, device="cpu", dtype=torch.float64)
    h = AMRHierarchy(build_level_geometry(
        grid, LedgeMap((0.0, 2.0), hl=1.0, hr=2.0, xl=-1.0, xr=1.0),
        device="cpu", dtype=torch.float64), tl.problem, tl.params,
        ratio=(2, 1), eta_lambda=0.9, num_patches=2,
        tag_params=TagParams(buoyancy_tag_tol=0.2, tags_grow=1))
    s0, fine, origin, w = entry.place_amr(h)
    built = h.slots_built
    # the buoyancy rolled 8 cells along x: two fronts, the patches move
    s1 = dataclasses.replace(s0, scalars=torch.roll(s0.scalars, 8, -1))
    fine, origin, w = h.regrid(s1, [fine], dt=DT)
    assert h.slots_built > built
    flags = lambda: [lv.use_vd_correction for c in h.couplings
                     for lv in c.levels]
    assert h.is_mapped and flags() == [True, True]
    h.restore(fine, origin, w)
    assert flags() == [True, True]


def test_vd_solve_takes_mg_vd():
    """The VD pass on a placed 32x8 hierarchy with multigrid pressure
    solves: the base level's VD solve takes mg_vd's iteration cap."""
    def run(mg_vd):
        params = dict(nu=1e-4, kappa=(1e-4,), gravity_method=1,
                      pressure_solver="mg", mg_vd=mg_vd,
                      mg=dict(eps=1e-6, imax=12))
        _, th, _, ts = pair("f32", 32, 8, params, ratio=(4, 1),
                            eta_lambda=0.9, jax_side=False)
        (fine,), (org,) = th.initial_patch_states(ts)
        s0 = th._vd_correction(ts, [fine], th._patch_args([org]), DT)
        return s0.e_lambda, th.level0.projector.last_info["vd"]

    e_cap, info_cap = run(MGParams(eps=1e-6, imax=1))
    e_full, info_full = run(None)
    assert int(info_cap[0]) == 1 < int(info_full[0])
    assert float((e_cap - e_full).abs().max()) > 1e-6


def test_grad_e_lambda_plot_field_on_a_patch_matches_jax():
    jax.config.update("jax_enable_x64", True)
    try:
        params = dict(nu=1e-4, kappa=(1e-4,), gravity_method=1,
                      mg=dict(eps=1e-6, imax=12))
        jh, th, js, ts = pair("f64", 32, 8, params, ratio=(4, 1),
                              eta_lambda=0.9)
        (jf,), _ = jh.initial_patch_states(js)
        (tf,), _ = th.initial_patch_states(ts)
        e = np.random.default_rng(11).normal(size=tuple(tf.lam.shape))
        jf = jf.__class__(**{**{k: getattr(jf, k) for k in
                                entry.STATE_FIELDS},
                             "e_lambda": jnp.asarray(e)})
        tf.e_lambda = torch.as_tensor(e)
        want = jck._plot_fields(jf, jh.couplings[0].level,
                                JPlot(write_grad_e_lambda=True))
        got = tck._plot_fields(tf, th.couplings[0].level,
                               TPlot(write_grad_e_lambda=True))
    finally:
        jax.config.update("jax_enable_x64", False)
    names = [n for n in want if n.startswith("grad_eLambda")]
    assert len(names) == 2
    for n in names:
        w = np.asarray(want[n])
        np.testing.assert_allclose(got[n], w, rtol=0,
                                   atol=1e-13 * np.abs(w).max())
