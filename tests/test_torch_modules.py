"""Module-by-module parity of the PyTorch port against the JAX package.

The same inputs, made from numpy seeds, go through each JAX function and
its port at a 16x8x8 (3D) or 32x16 (2D) grid, in f32 on the CPU.
Tolerance: 1e-5 * max|ref| (f32; only the rounding order differs).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import somar_tpu.core.bc as jbc
import somar_tpu_torch.core.bc as tbc
from somar_tpu.core.grid import Grid as JGrid
from somar_tpu.geometry.geo_source import CartesianMap as JCartesian
from somar_tpu.geometry.level_geometry import build_level_geometry as jgeo
from somar_tpu.ops import stencil as jst
from somar_tpu.physics import godunov as jgd
from somar_tpu.problems.base import SpongeSpec as JSponge
from somar_tpu.problems.base import sponge_ramp as jsponge_ramp
from somar_tpu.problems.lock_exchange import LockExchange as JLock
from somar_tpu.problems.taylor_green import TaylorGreen as JTG
from somar_tpu.projection.projector import LevelProjector as JProjector
from somar_tpu.solvers.fft_poisson import FFTPoissonSolver as JFFT
from somar_tpu.solvers.parabolic import BatchedSpectralHeat as JBatched
from somar_tpu.solvers.parabolic import make_heat_solver as jheat
from somar_tpu.solvers.poisson_op import PoissonOp as JOp

from somar_tpu_torch.core.grid import Grid as TGrid
from somar_tpu_torch.geometry.geo_source import CartesianMap as TCartesian
from somar_tpu_torch.geometry.level_geometry import build_level_geometry as tgeo
from somar_tpu_torch.ops import stencil as tst
from somar_tpu_torch.physics import godunov as tgd
from somar_tpu_torch.problems.base import SpongeSpec as TSponge
from somar_tpu_torch.problems.base import sponge_ramp as tsponge_ramp
from somar_tpu_torch.problems.lock_exchange import LockExchange as TLock
from somar_tpu_torch.problems.taylor_green import TaylorGreen as TTG
from somar_tpu_torch.projection.projector import LevelProjector as TProjector
from somar_tpu_torch.solvers.fft_poisson import FFTPoissonSolver as TFFT
from somar_tpu_torch.solvers.parabolic import BatchedSpectralHeat as TBatched
from somar_tpu_torch.solvers.parabolic import make_heat_solver as theat
from somar_tpu_torch.solvers.poisson_op import PoissonOp as TOp
from tests.torch_jax_reference import jax_unoptimized  # noqa: F401 (autouse)

torch.set_num_threads(1)

RTOL = 1e-5


def _close(got, want, rtol=RTOL):
    """|got - want| <= rtol * max|want| over every array of a (nested)
    result."""
    if isinstance(want, (tuple, list)):
        assert isinstance(got, (tuple, list)) and len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, rtol)
        return
    w = np.asarray(want)
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert g.shape == w.shape, (g.shape, w.shape)
    scale = max(float(np.abs(w).max()), 1e-30)
    err = float(np.abs(g - w).max())
    assert err <= rtol * scale, (err, scale)


def _rand(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _pair(arr):
    return jnp.asarray(arr), torch.from_numpy(np.array(arr))


def _grids(ndim, periodic=None):
    if ndim == 3:
        kw = dict(nx=(16, 8, 8), dx=(15 / 16, 2 / 8, 2 / 8),
                  x0=(-7.5, 0.0, 0.0),
                  periodic=periodic or (False, True, False))
    else:
        kw = dict(nx=(32, 16), dx=(15 / 32, 2 / 16), x0=(-7.5, 0.0),
                  periodic=periodic or (False, False))
    return JGrid(**kw), TGrid(**kw)


def _geos(ndim, periodic=None):
    jg, tg = _grids(ndim, periodic)
    return (jgeo(jg, JCartesian()),
            tgeo(tg, TCartesian(), device="cpu"))


def _bc(kind, value=0.0, order=1):
    """The same BC in both packages."""
    return (jbc.BC(jbc.BCType[kind], value=value, order=order),
            tbc.BC(tbc.BCType[kind], value=value, order=order))


def _fbcs(lo, hi):
    """FieldBCs pairs from per-direction lists of _bc pairs."""
    return (jbc.FieldBCs(lo=tuple(b[0] for b in lo),
                         hi=tuple(b[0] for b in hi)),
            tbc.FieldBCs(lo=tuple(b[1] for b in lo),
                         hi=tuple(b[1] for b in hi)))


BC_KINDS = {
    "periodic": ("PERIODIC", 0.0, 1),
    "dirichlet": ("DIRICHLET", 0.3, 1),
    "neumann": ("NEUMANN", -0.2, 1),
    "extrap0": ("EXTRAP", 0.0, 0),
    "extrap1": ("EXTRAP", 0.0, 1),
    "extrap2": ("EXTRAP", 0.0, 2),
    "cf": ("CF", 0.5, 1),
}


# --------------------------------------------------------------------------
# core/bc.py
# --------------------------------------------------------------------------
@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("kind", list(BC_KINDS))
def test_fill_ghosts_cc(kind, ndim):
    jg, tg = _grids(ndim)
    b = _bc(*BC_KINDS[kind])
    jb, tb = _fbcs([b] * ndim, [b] * ndim)
    ngrow = 4 if ndim == 3 else (1, 3)
    j, t = _pair(_rand(1, jg.shape))
    _close(tbc.fill_ghosts_cc(t, tg, tb, ngrow),
           jbc.fill_ghosts_cc(j, jg, jb, ngrow))


def test_fill_ghosts_cc_mixed_sides():
    """Different types per side and direction; corner ghosts follow the
    x, y, z fill order."""
    jg, tg = _grids(3)
    lo = [_bc("DIRICHLET", 0.1), _bc("PERIODIC"), _bc("NEUMANN", 0.2)]
    hi = [_bc("EXTRAP", order=2), _bc("PERIODIC"), _bc("EXTRAP", order=1)]
    jb, tb = _fbcs(lo, hi)
    j, t = _pair(_rand(2, jg.shape))
    _close(tbc.fill_ghosts_cc(t, tg, tb, (2, 4, 3)),
           jbc.fill_ghosts_cc(j, jg, jb, (2, 4, 3)))


def test_apply_fc_bc():
    jg, tg = _grids(2)
    jb, tb = _fbcs([_bc("DIRICHLET", 0.25), _bc("NEUMANN")],
                   [_bc("EXTRAP"), _bc("DIRICHLET", -1.0)])
    for d in range(2):
        j, t = _pair(_rand(3 + d, jg.fc_shape(d)))
        got = tbc.apply_fc_bc(t, d, tg, tb)
        _close(got, jbc.apply_fc_bc(j, d, jg, jb))
    np.testing.assert_array_equal(t.numpy(), _rand(4, jg.fc_shape(1)))


# --------------------------------------------------------------------------
# ops/stencil.py, solvers/poisson_op.py
# --------------------------------------------------------------------------
def _mixed_bcs(ndim):
    if ndim == 3:
        return _fbcs([_bc("NEUMANN"), _bc("PERIODIC"), _bc("DIRICHLET", 0.1)],
                     [_bc("NEUMANN"), _bc("PERIODIC"), _bc("DIRICHLET")])
    return _fbcs([_bc("DIRICHLET"), _bc("NEUMANN", 0.3)],
                 [_bc("EXTRAP"), _bc("NEUMANN")])


@pytest.mark.parametrize("ndim", [2, 3])
def test_mac_gradient_and_divergence(ndim):
    jgeo_, tgeo_ = _geos(ndim)
    jb, tb = _mixed_bcs(ndim)
    j, t = _pair(_rand(5, jgeo_.grid.shape))
    jgrad = jst.mac_gradient(j, jgeo_, jb)
    tgrad = tst.mac_gradient(t, tgeo_, tb)
    _close(tgrad, jgrad)
    _close(tst.mac_divergence(tgrad, tgeo_), jst.mac_divergence(jgrad, jgeo_))
    for d in range(ndim):
        _close(tst.cc_to_fc(t, d, tgeo_.grid, tb),
               jst.cc_to_fc(j, d, jgeo_.grid, jb))


@pytest.mark.parametrize("ndim", [2, 3])
def test_poisson_op_apply_and_diag(ndim):
    jgeo_, tgeo_ = _geos(ndim)
    jb, tb = _mixed_bcs(ndim)
    jop, top = JOp(jgeo_, jb), TOp(tgeo_, tb)
    j, t = _pair(_rand(6, jgeo_.grid.shape))
    for hom in (True, False):
        _close(top.apply(t, 0.5, -2.0, homogeneous=hom),
               jop.apply(j, 0.5, -2.0, homogeneous=hom))
    _close(top.residual(t, 2 * t), jop.residual(j, 2 * j))
    _close(top.diag(1.0, -0.5), jop.diag(1.0, -0.5))
    _close(top.compat_project(t), jop.compat_project(j))
    assert top.bcs_singular() == jop.bcs_singular()


# --------------------------------------------------------------------------
# solvers/fft_poisson.py
# --------------------------------------------------------------------------
FFT_BCS = {
    "periodic": (("PERIODIC",) * 3, ("PERIODIC",) * 3, (True, True, True)),
    "neumann": (("NEUMANN",) * 3, ("NEUMANN",) * 3, (False,) * 3),
    "dirichlet": (("DIRICHLET",) * 3, ("DIRICHLET",) * 3, (False,) * 3),
    "mixed": (("NEUMANN", "PERIODIC", "DIRICHLET"),
              ("DIRICHLET", "PERIODIC", "CF"), (False, True, False)),
}


@pytest.mark.parametrize("alpha,beta", [(0.0, 1.0), (1.0, -0.05)])
@pytest.mark.parametrize("case", list(FFT_BCS))
def test_fft_poisson_solve(case, alpha, beta):
    lo, hi, periodic = FFT_BCS[case]
    jgeo_, tgeo_ = _geos(3, periodic)
    jb, tb = _fbcs([_bc(k) for k in lo], [_bc(k) for k in hi])
    assert JFFT.supports(jgeo_, jb) and TFFT.supports(tgeo_, tb)
    jf, tf = JFFT(jgeo_, jb), TFFT(tgeo_, tb)
    assert tf.singular == jf.singular
    j, t = _pair(_rand(7, jgeo_.grid.shape))
    _close(tf.solve(t, alpha, beta), jf.solve(j, alpha, beta))


# --------------------------------------------------------------------------
# solvers/parabolic.py
# --------------------------------------------------------------------------
def _vel_bcs(viscous):
    jg, tg = _grids(3)
    return JLock().vel_bcs(jg, viscous), TLock().vel_bcs(tg, viscous)


@pytest.mark.parametrize("scheme", [0, 1, 2])
def test_heat_solver_update(scheme):
    jgeo_, tgeo_ = _geos(3)
    jv, tv = _vel_bcs(True)
    js = jheat(scheme, jgeo_, jv[0], 0.05)
    ts = theat(scheme, tgeo_, tv[0], 0.05)
    s, src = _pair(_rand(8, jgeo_.grid.shape)), _pair(_rand(9, jgeo_.grid.shape))
    got, _ = ts.update(s[1], src[1], 0.1)
    want, _ = js.update(s[0], src[0], 0.1)
    _close(got, want)


@pytest.mark.parametrize("scheme", [0, 1, 2])
def test_batched_spectral_heat_update(scheme):
    jgeo_, tgeo_ = _geos(3)
    jv, tv = _vel_bcs(True)
    jsolvers = [jheat(scheme, jgeo_, b, 0.05) for b in jv]
    tsolvers = [theat(scheme, tgeo_, b, 0.05) for b in tv]
    assert JBatched.supports(jsolvers)
    shape = (3,) + jgeo_.grid.shape
    f, src = _pair(_rand(10, shape)), _pair(_rand(11, shape))
    _close(TBatched(tsolvers).update(f[1], src[1], 0.1),
           JBatched(jsolvers).update(f[0], src[0], 0.1))


# --------------------------------------------------------------------------
# projection/projector.py
# --------------------------------------------------------------------------
def test_project_mac():
    jgeo_, tgeo_ = _geos(3)
    jp, tp = JProjector(jgeo_), TProjector(tgeo_)
    assert tp.method == jp.method == "fft"
    fl = [_pair(_rand(12 + d, jgeo_.grid.fc_shape(d))) for d in range(3)]
    jout, jphi, _ = jp.project_mac(tuple(f[0] for f in fl))
    tout, tphi, _ = tp.project_mac(tuple(f[1] for f in fl))
    _close(tout, jout)
    _close(tphi, jphi)


def test_project_cc():
    jgeo_, tgeo_ = _geos(3)
    jp, tp = JProjector(jgeo_), TProjector(tgeo_)
    jv, tv = _vel_bcs(False)
    j, t = _pair(_rand(15, (3,) + jgeo_.grid.shape))
    jvel, jphi, _ = jp.project_cc(j, jv)
    tvel, tphi, _ = tp.project_cc(t, tv)
    _close(tvel, jvel)
    _close(tphi, jphi)
    _close(tp.cc_grad_cart(tphi), jp.cc_grad_cart(jphi))


# --------------------------------------------------------------------------
# physics/godunov.py (padded path)
# --------------------------------------------------------------------------
def _trace_inputs(seed):
    """A 3D lock-exchange level's BCs with random cell fields, tracing
    velocities and projected-looking advecting velocities."""
    jgeo_, tgeo_ = _geos(3)
    jg, tg = jgeo_.grid, tgeo_.grid
    jv, tv = _vel_bcs(False)
    G = jgd.ADVECT_GROW
    rng = np.random.default_rng(seed)
    vel = (0.5 * rng.standard_normal((3,) + jg.shape)).astype(np.float32)
    s = rng.standard_normal(jg.shape).astype(np.float32)
    src = rng.standard_normal(jg.shape).astype(np.float32)
    adv = [(0.5 * rng.standard_normal(jg.fc_shape(d))).astype(np.float32)
           for d in range(3)]
    j = dict(geo=jgeo_, vel_bcs=jv, s=jnp.asarray(s), src=jnp.asarray(src),
             u_pad=[jbc.fill_ghosts_cc(jnp.asarray(vel[d]), jg, jv[d], G)
                    for d in range(3)],
             adv_pad=tuple(jgd.pad_valid_faces(jnp.asarray(adv[d]), jg, d)
                           for d in range(3)))
    t = dict(geo=tgeo_, vel_bcs=tv, s=torch.from_numpy(s),
             src=torch.from_numpy(src),
             u_pad=[tbc.fill_ghosts_cc(torch.from_numpy(vel[d]), tg, tv[d], G)
                    for d in range(3)],
             adv_pad=tuple(tgd.pad_valid_faces(torch.from_numpy(adv[d]), tg, d)
                           for d in range(3)))
    return j, t


def test_pad_valid_faces_and_crops():
    j, t = _trace_inputs(20)
    jg, tg = j["geo"].grid, t["geo"].grid
    for d in range(3):
        _close(t["adv_pad"][d], j["adv_pad"][d])
        _close(tgd._crop_faces(t["adv_pad"][d], tg, d, 4),
               jgd._crop_faces(j["adv_pad"][d], jg, d, 4))
    _close(tgd._crop_cells(t["u_pad"][0], tg, 4),
           jgd._crop_cells(j["u_pad"][0], jg, 4))


def test_trace_face_states_want_div():
    """The scalar path: limited PPM, source term, fused flux differences,
    then the divergence."""
    j, t = _trace_inputs(21)
    jp = jgd.AdvectionParams(use_limiting=True)
    tp = tgd.AdvectionParams(use_limiting=True)
    jsb = jbc.FieldBCs.from_periodic(j["geo"].grid, jbc.BC.extrap(1))
    tsb = tbc.FieldBCs.from_periodic(t["geo"].grid, tbc.BC.extrap(1))
    want = jgd.trace_face_states(
        j["s"], None, j["adv_pad"], j["src"], 0.02, j["geo"], jsb, jp,
        vel_bcs=j["vel_bcs"], u_pad=j["u_pad"], padded=True, want_div=True)
    got = tgd.trace_face_states(
        t["s"], None, t["adv_pad"], t["src"], 0.02, t["geo"], tsb, tp,
        vel_bcs=t["vel_bcs"], u_pad=t["u_pad"], padded=True, want_div=True)
    _close(got, want)
    _close(tgd.divergence_from_partials(got, t["geo"]),
           jgd.divergence_from_partials(want, j["geo"]))


@pytest.mark.parametrize("m", [0, 1, 2])
def test_trace_face_states_pre_riemann(m):
    """The velocity path: unlimited PPM, Riemann output for direction m
    only, pre-Riemann states for every direction."""
    j, t = _trace_inputs(22 + m)
    jp = jgd.AdvectionParams(use_limiting=False)
    tp = tgd.AdvectionParams(use_limiting=False)
    prov_j = tuple(jst.face_avg(j["u_pad"][d], j["geo"].grid.axis(d))
                   for d in range(3))
    prov_t = tuple(tst.face_avg(t["u_pad"][d], t["geo"].grid.axis(d))
                   for d in range(3))
    jf, jpre = jgd.trace_face_states(
        j["s"], None, prov_j, j["src"], 0.02, j["geo"], j["vel_bcs"][m], jp,
        vel_bcs=j["vel_bcs"], u_pad=j["u_pad"], return_pre_riemann=True,
        padded=True, rie_dirs=[m])
    tf, tpre = tgd.trace_face_states(
        t["s"], None, prov_t, t["src"], 0.02, t["geo"], t["vel_bcs"][m], tp,
        vel_bcs=t["vel_bcs"], u_pad=t["u_pad"], return_pre_riemann=True,
        padded=True, rie_dirs=[m])
    assert all(tf[d] is None for d in range(3) if d != m)
    _close(tf[m], jf[m])
    _close(tpre, jpre)


def test_momentum_flux_divergence():
    j, t = _trace_inputs(30)
    shape = j["adv_pad"][0].shape
    pre = [[tuple(_pair(_rand(100 + 10 * f + 2 * d + k, shape))
                  for k in range(2)) for d in range(3)] for f in range(3)]
    want = jgd.momentum_flux_divergence(
        [[(p[0][0], p[1][0]) for p in field] for field in pre],
        j["adv_pad"], j["geo"])
    got = tgd.momentum_flux_divergence(
        [[(p[0][1], p[1][1]) for p in field] for field in pre],
        t["adv_pad"], t["geo"])
    _close(got, want)


def test_flux_divergence_padded():
    j, t = _trace_inputs(31)
    shape = j["adv_pad"][0].shape
    faces = [_pair(_rand(200 + d, shape)) for d in range(3)]
    _close(tgd.flux_divergence([f[1] for f in faces], t["adv_pad"], t["geo"],
                               padded=True),
           jgd.flux_divergence([f[0] for f in faces], j["adv_pad"], j["geo"],
                               padded=True))


def test_unported_advection_options_raise():
    """The PLM, central-flux and high-order-limiter options are ported:
    they trace as the JAX package's plain path does
    (tests/test_torch_advection_options.py holds every option)."""
    j, t = _trace_inputs(32)
    tsb = tbc.FieldBCs.from_periodic(t["geo"].grid, tbc.BC.extrap(1))
    jsb = jbc.FieldBCs.from_periodic(j["geo"].grid, jbc.BC.extrap(1))
    for kw in (dict(normal_pred_order=1), dict(use_upwinding=False),
               dict(use_high_order_limiter=True)):
        _close(tgd.trace_face_states(t["s"], None, t["adv_pad"], None, 0.02,
                                     t["geo"], tsb, tgd.AdvectionParams(**kw),
                                     u_pad=t["u_pad"], padded=True),
               jgd.trace_face_states(j["s"], None, j["adv_pad"], None, 0.02,
                                     j["geo"], jsb, jgd.AdvectionParams(**kw),
                                     u_pad=j["u_pad"], padded=True))


# --------------------------------------------------------------------------
# problems
# --------------------------------------------------------------------------
@pytest.mark.parametrize("ndim", [2, 3])
def test_lock_exchange_and_taylor_green_ics(ndim):
    jgeo_, tgeo_ = _geos(ndim)
    jl, tl = JLock(pert_amp=0.05), TLock(pert_amp=0.05)
    _close(tl.scalar_ic(tgeo_), jl.scalar_ic(jgeo_), rtol=1e-6)
    jt, tt = JTG(lengths=(15.0, 2.0)), TTG(lengths=(15.0, 2.0))
    _close(tt.vel_ic(tgeo_), jt.vel_ic(jgeo_), rtol=1e-6)
    _close(tt.pressure_soln(tgeo_, 0.3), jt.pressure_soln(jgeo_, 0.3),
           rtol=1e-6)
    jg, tg = jgeo_.grid, tgeo_.grid
    spec = dict(width_lo=(0.1,) + (0.0,) * (ndim - 1),
                width_hi=(0.2,) + (0.0,) * (ndim - 2) + (0.1,))
    np.testing.assert_array_equal(tsponge_ramp(tg, TSponge(**spec)),
                                  jsponge_ramp(jg, JSponge(**spec)))
    for jb, tb in zip(jl.vel_bcs(jg, True) + (jl.scalar_bcs(jg),),
                      tl.vel_bcs(tg, True) + (tl.scalar_bcs(tg),)):
        assert [(b.type.value, b.value) for b in jb.lo + jb.hi] == \
            [(b.type.value, b.value) for b in tb.lo + tb.hi]


@pytest.mark.parametrize("limiting", [True, False])
@pytest.mark.parametrize("ax", [0, 1, 2])
def test_normal_predict_fullpad(ax, limiting):
    """The PPM normal predictor on full padded arrays (junk edges too)."""
    shape = (24, 16, 40)
    s, u = _pair(_rand(40 + ax, shape)), _pair(0.5 * _rand(50 + ax, shape))
    jp = jgd.AdvectionParams(use_limiting=limiting)
    tp = tgd.AdvectionParams(use_limiting=limiting)
    _close(tgd._normal_predict_fullpad(s[1], u[1], ax, 4, 0.1, 0.03, tp),
           jgd._normal_predict_fullpad(s[0], u[0], ax, 4, 0.1, 0.03, jp))
