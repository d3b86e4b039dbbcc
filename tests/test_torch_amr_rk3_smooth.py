"""RK3 patch levels, post-regrid smoothing and a deck with the slice's
features, the port's AMR against the JAX package's on the CPU, eager JAX
and inputs made from a seed:

  * RK3 (update_scheme "rk3") at ratio (2,1) on the 2D 48x12 lock
    exchange, refluxing all three fields (every stage's projections take
    the CF rings, the stages' fluxes combine with weights 1/6, 1/6, 2/3):
    one coarse step in float64 within 1e-8 of max|field|, and the same
    without refluxing, which moves the JAX step by more than 100x that;
    tests/test_amr.py:1221 on the port (5 inviscid coarse steps: b
    bounded, refluxing conserves buoyancy at least as well as not);
  * post-regrid smoothing, float64: (I - mu L) applied to a state on the
    base and on a patch level equals JAX's `_apply_smooth_op` (1e-12),
    and the port's BiCGStab solve of it equals a dense solve of the same
    operator (1e-6 of max|field|, the solve's tolerance); float32 (the
    JAX BiCGStab fails under x64, ROADMAP C.7): a regrid that leaves the
    patch where it is is the identity within 5e-4 (tests/test_amr.py:431)
    and a regrid that moves it (the front shifted 6 cells) equals JAX's
    regrid within 1e-3 of max|field|, smoothing coefficient 100, which
    moves that regrid by more than 100x the tolerance;
  * a deck (tests/test_driver_io.py's AMR_CFG on a 32x8 base, 2 steps,
    a regrid after each) with all three fields refluxed, implicit
    refluxing, the VD correction and post-regrid smoothing through the
    port's RunDriver and the JAX RunDriver run eagerly (jax.disable_jit),
    float32: the same dts, regrid origins and fields of both levels with
    e_lambda within 1e-3 of max|field|; the port resumed from its step-1
    checkpoint equals its run without a break bitwise.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from somar_tpu.config.context import ProblemContext as JContext
from somar_tpu.config.parmparse import ParmParse as JPP
from somar_tpu.driver import RunDriver as JDriver
from somar_tpu.io import checkpoint as jck
from somar_tpu.physics.navier_stokes import NSState as JState

from somar_tpu_torch import entry
from somar_tpu_torch.config.context import ProblemContext as TContext
from somar_tpu_torch.config.parmparse import ParmParse as TPP
from somar_tpu_torch.driver import RunDriver as TDriver
from tests.test_driver_io import AMR_CFG
from tests.test_torch_amr_reflux import (FIELDS, TOL, max_rel, pair,
                                         step_both, with_x64)
from tests.torch_jax_reference import jax_unoptimized  # noqa: F401 (autouse)

torch.set_num_threads(1)

DT = 0.02


# ------------------------------------------------------------------- RK3
def _rk3(reflux):
    params = dict(nu=0.0, kappa=(0.0,), gravity_method=1,
                  update_scheme="rk3", mg=dict(eps=1e-6, imax=12))
    return step_both(*pair("f64", 48, 12, params, ratio=(2, 1),
                           reflux=reflux), "f64")[0]


@pytest.fixture(scope="module")
def rk3_runs():
    return {r: with_x64("f64", _rk3, r) for r in (True, ())}


@pytest.mark.parametrize("reflux", [True, ()], ids=["reflux", "plain"])
def test_rk3_amr_step_matches_jax(rk3_runs, reflux):
    want, got = rk3_runs[reflux]
    assert max_rel(want, got) <= TOL["f64"]


def test_rk3_reflux_moves_the_jax_step(rk3_runs):
    assert max_rel(rk3_runs[True][0], rk3_runs[()][0]) > 100 * TOL["f64"]


def test_rk3_amr_with_refluxing_on_the_port():
    """tests/test_amr.py:1221 on the port."""
    def run(reflux):
        params = dict(nu=0.0, kappa=(0.0,), gravity_method=1,
                      update_scheme="rk3", mg=dict(eps=1e-5, imax=12))
        _, th, _, ts = pair("f32", 48, 12, params, seed_bump=False,
                            jax_side=False, ratio=(2, 1), reflux=reflux)
        (fine,), (org,) = th.initial_patch_states(ts)
        b0 = float(ts.scalars[0].double().sum())
        for _ in range(5):
            ts, fine = th.advance(ts, fine, org, DT)
        b = ts.scalars[0]
        assert bool(torch.isfinite(b).all())
        assert -0.1 < float(b.min()) and float(b.max()) < 1.1
        return abs(float(b.double().sum()) - b0)

    off, on = run(()), run(True)
    assert on <= off + 1e-4, (on, off)


# ------------------------------------------------- post-regrid smoothing
SMOOTH_PARAMS = dict(nu=1e-3, kappa=(1e-3,), gravity_method=1,
                     mg=dict(eps=1e-6, imax=15))
SHIFT = 6


def _smooth_pair(prec, coeff):
    return pair(prec, 48, 12, dict(SMOOTH_PARAMS), seed_bump=False,
                ratio=(4, 1), regrid_smoothing_coeff=coeff)


def _shifted(fields):
    """Host fields with the buoyancy front moved SHIFT cells along +x."""
    out = dict(fields)
    b = fields["scalars"]
    out["scalars"] = np.concatenate(
        [np.repeat(b[..., :1], SHIFT, -1), b[..., :-SHIFT]], -1)
    return out


@pytest.fixture(scope="module")
def smooth_f64():
    def run():
        jh, th, js, ts = _smooth_pair("f64", 4.0)
        (jf,), _ = jh.initial_patch_states(js)
        (tf,), _ = th.initial_patch_states(ts)
        rng = np.random.default_rng(17)
        out = {}
        for name, (jl, tl, jst, tst) in {
                "base": (jh.level0, th.level0, js, ts),
                "patch": (jh.couplings[0].level, th.couplings[0].level,
                          jf, tf)}.items():
            # a random velocity, so that every operator acts
            v = rng.normal(size=tuple(tst.vel.shape))
            jst = dataclasses.replace(jst, vel=jnp.asarray(v))
            tst = dataclasses.replace(tst, vel=torch.as_tensor(v))
            mus = th._smooth_mus(DT)
            assert mus == jh._smooth_mus(DT)
            want = jh._apply_smooth_op(jl, jst, *mus)
            got = th._apply_smooth_op(tl, tst, *mus)
            out[name] = (tl, tst, mus, np.asarray(want.vel),
                         np.asarray(want.scalars), got)
        return out
    return with_x64("f64", run)


@pytest.mark.parametrize("where", ["base", "patch"])
def test_smoothing_operator_matches_jax(smooth_f64, where):
    _, tst, _, wv, ws, got = smooth_f64[where]
    for want, g, x in ((wv, got.vel, tst.vel),
                       (ws, got.scalars, tst.scalars)):
        np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                   atol=1e-12 * np.abs(want).max())
        assert np.abs(want - x.numpy()).max() > 1e-6     # the op acted


def test_smoothing_solve_matches_a_dense_solve(smooth_f64):
    """_solve_smooth_op on the patch level against numpy's dense solve of
    (I - mu L) x = b - A(0), the operator's matrix built column by column
    from the same homogeneous apply."""
    from somar_tpu_torch.amr.hierarchy import AMRHierarchy
    tl, tst, (mu_v, mu_s), *_ = smooth_f64["patch"]
    got = AMRHierarchy._solve_smooth_op(tl, tst, mu_v, mu_s)
    cases = [(tl._visc_ops[m], tst.vel[m], got.vel[m], mu_v)
             for m in range(2)]
    cases.append((tl.diff_solvers[0]._op, tst.scalars[0], got.scalars[0],
                  mu_s[0]))
    for op, rhs, x, mu in cases:
        n = rhs.numel()
        eye = torch.eye(n, dtype=rhs.dtype).reshape((n,) + tuple(rhs.shape))
        A = torch.stack([op.apply(e, 1.0, -mu).reshape(-1) for e in eye], 1)
        b = rhs - op.apply(torch.zeros_like(rhs), 1.0, -mu,
                           homogeneous=False)
        want = np.linalg.solve(A.numpy(), b.reshape(-1).numpy()).reshape(
            tuple(rhs.shape))
        np.testing.assert_allclose(x.numpy(), want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())


@pytest.fixture(scope="module")
def smooth_regrids():
    def run():
        out = {}
        for coeff in (100.0, 0.0):
            jh, th, js, ts = _smooth_pair("f32", coeff)
            (jf,), (jo,) = jh.initial_patch_states(js)
            (tf,), (to,) = th.initial_patch_states(ts)
            if coeff:
                # the placed patch regridded where it is: the identity
                same = th.regrid(ts, tf, dt=DT)
                out["same"] = (to, same, tf)
            moved = _shifted(entry.ns_state_to_numpy(ts))
            jm = JState(**{f: jnp.asarray(v) for f, v in moved.items()})
            tm = entry.ns_state_from_numpy(moved, device="cpu",
                                           dtype=torch.float32)
            jr, jro = jh.regrid(jm, jf, dt=DT)
            tr, tro = th.regrid(tm, tf, dt=DT)
            out[coeff] = ((np.asarray(jro), tro),
                          (np.asarray(jo), to),
                          ({f: np.asarray(getattr(jr, f)) for f in FIELDS},
                           entry.ns_state_to_numpy(tr)))
        return out
    return with_x64("f32", run)


def test_smoothing_regrid_in_place_is_near_identity(smooth_regrids):
    to, (f2, o2), f1 = smooth_regrids["same"]
    np.testing.assert_array_equal(o2, to)
    for f in ("vel", "scalars"):
        assert float((getattr(f2, f) - getattr(f1, f)).abs().max()) < 5e-4


@pytest.mark.parametrize("coeff", [100.0, 0.0], ids=["smoothed", "plain"])
def test_smoothing_regrid_matches_jax(smooth_regrids, coeff):
    (jro, tro), (jo, to), (want, got) = smooth_regrids[coeff]
    np.testing.assert_array_equal(tro, jro)
    assert int(tro[1]) == int(to[1]) + 4 * SHIFT    # the patch moved
    for f in FIELDS:
        w = want[f]
        assert np.abs(got[f] - w).max() <= TOL["f32"] * max(
            np.abs(w).max(), 1e-30), f


def test_smoothing_moves_the_jax_regrid(smooth_regrids):
    on, off = smooth_regrids[100.0][2][0], smooth_regrids[0.0][2][0]
    b_on, b_off = on["scalars"], off["scalars"]
    assert np.abs(b_on - b_off).max() > 100 * TOL["f32"] * np.abs(
        b_off).max()


# ------------------------------------------------------------- the deck
DECK = AMR_CFG.replace("amr.nx = 48 16", "amr.nx = 32 8").replace(
    "amr.nx_offset = -24 0", "amr.nx_offset = -16 0").replace(
    "amr.maxsteps = 4", "amr.maxsteps = 2").replace(
    "amr.regrid_intervals = 2 2", "amr.regrid_intervals = 1 1") + """
amr.advective_momentum_reflux = 1
amr.advective_scalar_reflux = 1
amr.advective_lambda_reflux = 1
amr.implicit_scalar_reflux = 1
amr.implicit_momentum_reflux = 1
projection.applyVDCorrection = 1
projection.etaLambda = 0.9
amr.smooth_after_regrid = 1
amr.postRegrid_smoothing_coeff = 4.0
projection.initial_pressure_iters = 0
plot.plot_interval = -1
plot.checkpoint_interval = 1
"""


def _log(driver, out):
    h = driver.hierarchy
    plain = h.regrid

    def regrid(*a, **kw):
        assert kw.get("dt") is not None
        got = plain(*a, **kw)
        out.append(np.asarray(h.couplings[0].origin_f).tolist())
        return got

    h.regrid = regrid
    times = []
    driver.scheduler.schedule(lambda step, t, s: times.append(float(t)),
                              step_interval=1)
    return times


@pytest.fixture(scope="module")
def deck_runs(tmp_path_factory):
    out = {}
    jdir = tmp_path_factory.mktemp("jax")
    jd = JDriver(JContext.from_parmparse(JPP.from_string(DECK)),
                 out_dir=str(jdir))
    jlog = []
    jt = _log(jd, jlog)
    with jax.disable_jit():
        js, jsteps = jd.run(verbose=False)
    # the JAX driver's refined level, as its final checkpoint holds it
    (jf,) = jck.read_checkpoint(
        str(jdir / "chkpt_final.hdf5"), jd.level,
        fine_grid=[c.ext_grid for c in jd.hierarchy.couplings])[3]
    out["jax"] = (jf, js, jsteps, jt, jlog)
    tdir = tmp_path_factory.mktemp("port")
    td = TDriver(TContext.from_parmparse(TPP.from_string(DECK)),
                 out_dir=str(tdir), device="cpu")
    tlog = []
    tt = _log(td, tlog)
    ts, tsteps = td.run(verbose=False)
    out["port"] = (td, ts, tsteps, tt, tlog, tdir)
    return out


def test_reflux_vd_smoothing_deck_matches_jax_driver(deck_runs):
    jf, js, jsteps, jt, jlog = deck_runs["jax"]
    td, ts, tsteps, tt, tlog, _ = deck_runs["port"]
    h = td.hierarchy
    assert h.reflux_fields == ("vel", "scalars", "lam")
    assert h.implicit_reflux and h.eta_lambda == 0.9
    assert h.regrid_smoothing_coeff == 4.0
    assert jsteps == tsteps == 2
    assert tlog == jlog and len(tlog) == 2
    np.testing.assert_allclose(np.diff([0.0] + tt), np.diff([0.0] + jt),
                               rtol=1e-6)
    want = [{f: np.asarray(getattr(s, f)) for f in FIELDS}
            for s in (js, jf)]
    got = [entry.ns_state_to_numpy(s) for s in (ts, td.fine_state[0])]
    assert max_rel((want[0], want[1:]), (got[0], got[1:])) <= TOL["f32"]
    assert np.abs(got[1]["e_lambda"]).max() > 0.0


def test_reflux_vd_smoothing_deck_resume_is_exact(deck_runs, tmp_path):
    td, ts, _, _, _, tdir = deck_runs["port"]
    (tmp_path / "chkpt_000001.hdf5").write_bytes(
        (tdir / "chkpt_000001.hdf5").read_bytes())
    drv = TDriver(TContext.from_parmparse(TPP.from_string(
        DECK + "amr.restart_file = chkpt_000001.hdf5\n")),
        out_dir=str(tmp_path), device="cpu")
    state, steps = drv.run(verbose=False)
    assert steps == 2
    for a, b in ((state, ts), (drv.fine_state[0], td.fine_state[0])):
        for f in entry.STATE_FIELDS:
            assert torch.equal(getattr(a, f), getattr(b, f)), f
