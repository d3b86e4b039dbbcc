"""Every advection option of the port against the JAX package's plain
path, eagerly (no JAX compile), on the same numpy inputs:

  * `trace_face_states` for PLM (4th-order and van Leer slopes, limited
    and not), CTU(0), the extremum-preserving limiter of PPM and of PLM,
    and central fluxes (PPM and PLM) in 2D (32x16) in f64 and f32, and
    one of each kind in 3D (16x8x8) in f64:
    padded with the pre-Riemann states, and in f64 also padded with the
    fused flux differences (want_div), cropped to valid faces and with
    one direction's Riemann state; with a source term; f64 within 1e-12
    and f32 within 1e-5 of max|output| (f32 runs the first form only, to
    keep the file's time down: JAX dispatches every operation eagerly);
  * the routes: K1 runs only for PPM with upwinding and no high-order
    limiter, K2-K3 whenever the fluxes are upwinded (launch counts of the
    CPU twins stay 0, the dispatch is asserted on the route function);
  * `momentum_flux_divergence(upwind=False)` (central momentum fluxes);
  * the batched tracer (`trace_face_states_batched`,
    `flux_divergence_batched`, `riemann_batched`) against JAX's;
  * `shapiro_filter_1d` and `shapiro_filter` with periodic, Neumann and
    extrapolated BCs.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import somar_tpu.core.bc as jbc
from somar_tpu.core.grid import Grid as JGrid
from somar_tpu.geometry.geo_source import CartesianMap as JCartesian
from somar_tpu.geometry.level_geometry import build_level_geometry as jgeo
from somar_tpu.physics import godunov as jgd
from somar_tpu.problems.lock_exchange import LockExchange as JLock
from somar_tpu.utils import filters as jfl

import somar_tpu_torch.core.bc as tbc
from somar_tpu_torch.core.grid import Grid as TGrid
from somar_tpu_torch.geometry.geo_source import CartesianMap as TCartesian
from somar_tpu_torch.geometry.level_geometry import build_level_geometry
from somar_tpu_torch.physics import godunov as tgd
from somar_tpu_torch.problems.lock_exchange import LockExchange as TLock
from somar_tpu_torch.utils import filters as tfl
from tests.torch_jax_reference import jax_unoptimized  # noqa: F401 (autouse)

torch.set_num_threads(1)

RTOL = {"f32": 1e-5, "f64": 1e-12}
DTYPES = {"f32": (np.float32, torch.float32, jnp.float32),
          "f64": (np.float64, torch.float64, jnp.float64)}
G = tgd.ADVECT_GROW

OPTIONS = {
    "plm": dict(normal_pred_order=1),
    "plm_vanleer": dict(normal_pred_order=1, use_fourth_order_slopes=False),
    "plm_unlimited": dict(normal_pred_order=1, use_limiting=False),
    "ctu0": dict(normal_pred_order=0),
    "ppm_high_order_limiter": dict(use_high_order_limiter=True),
    "plm_high_order_limiter": dict(normal_pred_order=1,
                                   use_high_order_limiter=True),
    "ppm_central": dict(use_upwinding=False),
    "plm_central": dict(normal_pred_order=1, use_upwinding=False),
}


@pytest.fixture
def prec(request):
    """The case's precision, with jax_enable_x64 to match."""
    jax.config.update("jax_enable_x64", request.param == "f64")
    yield request.param
    jax.config.update("jax_enable_x64", False)


def _cases(*rows):
    """pytest params of (rows..., prec) with the prec fixture indirect."""
    return pytest.mark.parametrize(
        "case,prec", [((r[:-1]), r[-1]) for r in rows], indirect=["prec"],
        ids=["-".join(map(str, r)) for r in rows])


def _close(got, want, rtol):
    if isinstance(want, (tuple, list)):
        assert isinstance(got, (tuple, list)) and len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, rtol)
        return
    if want is None:
        assert got is None
        return
    w = np.asarray(want, dtype=np.float64)
    g = got.detach().numpy().astype(np.float64)
    assert g.shape == w.shape, (g.shape, w.shape)
    scale = max(float(np.abs(w).max()), 1e-30)
    err = float(np.abs(g - w).max())
    assert err <= rtol * scale, (err, scale)


def _setup(ndim, prec, seed=0):
    """Both packages' lock-exchange levels, velocity BCs, a scalar, a
    source, padded tracing velocities and padded advecting velocities."""
    npt, tdt, jdt = DTYPES[prec]
    if ndim == 3:
        kw = dict(nx=(16, 8, 8), dx=(15 / 16, 2 / 8, 2 / 8),
                  x0=(-7.5, 0.0, 0.0), periodic=(False, True, False))
    else:
        kw = dict(nx=(32, 16), dx=(15 / 32, 2 / 16), x0=(-7.5, 0.0))
    jg = jgeo(JGrid(**kw), JCartesian(), jdt)
    tg = build_level_geometry(TGrid(**kw), TCartesian(), device="cpu",
                              dtype=tdt)
    jv = JLock().vel_bcs(jg.grid, viscous=False)
    tv = TLock().vel_bcs(tg.grid, viscous=False)
    shape = tg.grid.shape
    rng = np.random.default_rng(seed)
    vel = (0.5 * rng.standard_normal((ndim,) + shape)).astype(npt)
    s = rng.standard_normal(shape).astype(npt)
    src = rng.standard_normal(shape).astype(npt)
    adv = [(0.5 * rng.standard_normal(tg.grid.fc_shape(d))).astype(npt)
           for d in range(ndim)]
    j = dict(geo=jg, vb=jv, s=jnp.asarray(s), src=jnp.asarray(src),
             adv=tuple(jnp.asarray(a) for a in adv),
             u_pad=[jbc.fill_ghosts_cc(jnp.asarray(vel[d]), jg.grid, jv[d],
                                       G) for d in range(ndim)])
    j["adv_pad"] = tuple(jgd.pad_valid_faces(j["adv"][d], jg.grid, d)
                         for d in range(ndim))
    t = dict(geo=tg, vb=tv, s=torch.from_numpy(s), src=torch.from_numpy(src),
             adv=tuple(torch.from_numpy(a) for a in adv),
             u_pad=[tbc.fill_ghosts_cc(torch.from_numpy(vel[d]), tg.grid,
                                       tv[d], G) for d in range(ndim)])
    t["adv_pad"] = tuple(tgd.pad_valid_faces(t["adv"][d], tg.grid, d)
                         for d in range(ndim))
    return j, t


def _trace(mod, x, params, **kw):
    sbcs = x["vb"][0]   # any field's BCs: the x-velocity's
    return mod.trace_face_states(x["s"], None, kw.pop("adv"), x["src"],
                                 0.05, x["geo"], sbcs, params,
                                 u_pad=x["u_pad"], **kw)


#: every option in 2D in f64 and f32; in 3D one of each kind (PLM,
#: CTU(0), the high-order limiter, central fluxes) in f64
CASES = ([(o, 2, p) for o in OPTIONS for p in ("f64", "f32")]
         + [(o, 3, "f64") for o in ("plm", "ctu0", "ppm_high_order_limiter",
                                    "ppm_central")])


@_cases(*CASES)
def test_trace_face_states_options(case, prec):
    option, ndim = case
    j, t = _setup(ndim, prec)
    jp = jgd.AdvectionParams(**OPTIONS[option])
    tp = tgd.AdvectionParams(**OPTIONS[option])
    rtol = RTOL[prec]
    # padded, with the pre-Riemann states
    _close(_trace(tgd, t, tp, adv=t["adv_pad"], padded=True,
                  return_pre_riemann=True),
           _trace(jgd, j, jp, adv=j["adv_pad"], padded=True,
                  return_pre_riemann=True), rtol)
    if prec == "f32":
        return
    # padded, the fused flux differences and their divergence
    got = _trace(tgd, t, tp, adv=t["adv_pad"], padded=True, want_div=True)
    want = _trace(jgd, j, jp, adv=j["adv_pad"], padded=True, want_div=True)
    _close(got, want, rtol)
    _close(tgd.divergence_from_partials(got, t["geo"]),
           jgd.divergence_from_partials(want, j["geo"]), rtol)
    # cropped to the valid faces
    _close(_trace(tgd, t, tp, adv=t["adv"], return_pre_riemann=True),
           _trace(jgd, j, jp, adv=j["adv"], return_pre_riemann=True), rtol)
    # one direction's Riemann state only (JAX's plain path returns all)
    got = _trace(tgd, t, tp, adv=t["adv_pad"], padded=True, rie_dirs=[0])
    want = _trace(jgd, j, jp, adv=j["adv_pad"], padded=True, rie_dirs=[0])
    _close(got[0], want[0], rtol)
    assert all(g is None for g in got[1:])


def test_routes():
    """K1 only for upwinded PPM without the high-order limiter."""
    P = tgd.AdvectionParams
    assert tgd._uses_k1(P())
    assert tgd._uses_k1(P(use_limiting=False))
    for kw in OPTIONS.values():
        assert not tgd._uses_k1(P(**kw))


@_cases((2, "f32"), (2, "f64"), (3, "f64"))
def test_central_momentum_flux_divergence(case, prec):
    ndim, = case
    j, t = _setup(ndim, prec, seed=1)
    jp = jgd.AdvectionParams(use_upwinding=False, use_limiting=False)
    tp = tgd.AdvectionParams(use_upwinding=False, use_limiting=False)
    jpre, tpre = [], []
    for m in range(ndim):
        jpre.append(jgd.trace_face_states(
            j["s"] * (m + 1), None, j["adv_pad"], None, 0.05, j["geo"],
            j["vb"][m], jp, u_pad=j["u_pad"], padded=True,
            return_pre_riemann=True)[1])
        tpre.append(tgd.trace_face_states(
            t["s"] * (m + 1), None, t["adv_pad"], None, 0.05, t["geo"],
            t["vb"][m], tp, u_pad=t["u_pad"], padded=True,
            return_pre_riemann=True)[1])
    rtol = RTOL[prec]
    _close(tgd.momentum_flux_divergence(tpre, t["adv_pad"], t["geo"],
                                        upwind=False),
           jgd.momentum_flux_divergence(jpre, j["adv_pad"], j["geo"],
                                        upwind=False), rtol)
    _close(tgd.riemann_from_states(tpre[0], t["adv_pad"], upwind=False),
           jgd.riemann_from_states(jpre[0], j["adv_pad"], upwind=False),
           rtol)


@_cases(("ppm", 3, "f64"), ("plm", 2, "f64"), ("ppm_central", 2, "f64"),
        ("ppm", 2, "f32"))
def test_batched_tracer(case, prec):
    option, ndim = case
    j, t = _setup(ndim, prec, seed=2)
    kw = {"ppm": {}, "plm": OPTIONS["plm"],
          "ppm_central": OPTIONS["ppm_central"]}[option]
    jp, tp = jgd.AdvectionParams(**kw), tgd.AdvectionParams(**kw)
    fields_np = [np.asarray(j["s"]), 2.0 * np.asarray(j["s"]) ** 2,
                 np.asarray(j["src"])]
    jf = [jnp.asarray(f) for f in fields_np]
    tf = [torch.from_numpy(np.array(f)) for f in fields_np]
    jsrcs = [j["src"], None, 0.5 * j["s"]]
    tsrcs = [t["src"], None, 0.5 * t["s"]]
    rtol = RTOL[prec]
    jfaces, jpre = jgd.trace_face_states_batched(
        jf, jsrcs, j["vb"][:3], j["adv_pad"], 0.05, j["geo"], jp,
        j["u_pad"], return_pre_riemann=True)
    tfaces, tpre = tgd.trace_face_states_batched(
        tf, tsrcs, t["vb"][:3], t["adv_pad"], 0.05, t["geo"], tp,
        t["u_pad"], return_pre_riemann=True)
    _close(tfaces, jfaces, rtol)
    _close(tpre, jpre, rtol)
    _close(tgd.flux_divergence_batched(tfaces, t["adv_pad"], t["geo"]),
           jgd.flux_divergence_batched(jfaces, j["adv_pad"], j["geo"]),
           rtol)
    up = tp.use_upwinding
    _close(tgd.riemann_batched(tpre, t["adv_pad"], upwind=up),
           jgd.riemann_batched(jpre, j["adv_pad"], upwind=up), rtol)
    # without sources or pre-states
    _close(tgd.trace_face_states_batched(tf[:2], None, t["vb"][:2],
                                         t["adv_pad"], 0.05, t["geo"], tp,
                                         t["u_pad"]),
           jgd.trace_face_states_batched(jf[:2], None, j["vb"][:2],
                                         j["adv_pad"], 0.05, j["geo"], jp,
                                         j["u_pad"]), rtol)


@_cases((2, "f32"), (2, "f64"), (3, "f64"))
def test_shapiro_filter(case, prec):
    ndim, = case
    j, t = _setup(ndim, prec, seed=3)
    jg, tg = j["geo"].grid, t["geo"].grid
    rtol = RTOL[prec]
    for bc_j, bc_t in ((jbc.BC.neumann(0.0), tbc.BC.neumann(0.0)),
                       (jbc.BC.extrap(1), tbc.BC.extrap(1))):
        jb = jbc.FieldBCs.from_periodic(jg, bc_j)
        tb = tbc.FieldBCs.from_periodic(tg, bc_t)
        for d in range(ndim):
            _close(tfl.shapiro_filter_1d(t["s"], tg, tb, d, 0.5, passes=2),
                   jfl.shapiro_filter_1d(j["s"], jg, jb, d, 0.5, passes=2),
                   rtol)
        _close(tfl.shapiro_filter(t["s"], tg, tb, passes=2),
               jfl.shapiro_filter(j["s"], jg, jb, passes=2), rtol)
    # s = 1 removes the Nyquist mode exactly along a periodic direction
    if ndim == 3:
        tb = tbc.FieldBCs.from_periodic(tg, tbc.BC.neumann(0.0))
        iy = torch.arange(tg.shape[1], dtype=t["s"].dtype)
        nyq = torch.cos(np.pi * iy).reshape(1, -1, 1).expand(tg.shape)
        out = tfl.shapiro_filter_1d(nyq.contiguous(), tg, tb, 1)
        assert float(out.abs().max()) <= 1e-6
