"""The probed-stencil kernels K7-K8 and their set-up: the port's
ops/stencil_gsrb_kernels.py against the JAX package's
ops/stencil_gsrb_pallas.py on the same inputs.

Cases: the five mapped levels of tests/test_stencil_gsrb_pallas.py
(stretched, ledge and twisted metrics; Neumann, Dirichlet, periodic, CF and
extrapolation BCs; 2D and 3D) plus a periodic extent of 3 and one of 4.

  * build_stencil_plan probes the same offsets as the JAX package and the
    same weights, row sums and smoother diagonals within 1e-6 of their
    max (f32): both probe their own operator;
  * with the JAX plan's weights carried across (entry.stencil_plan_from_
    numpy), the plain twins of K7 (iters 1 and 3) and K8 equal the Pallas
    kernels (interpret=True) within 1e-6 of max|ref| in f32 and 1e-12 in
    f64, with and without the delta overrides of implicit gravity;
  * the CUDA kernels against their twins (marked `cuda`, skipped without a
    card).  On a GPU host without JAX:

    python -m pytest tests/test_torch_stencil_kernels.py -m cuda --noconftest
"""

import itertools

import numpy as np
import pytest
import torch

from somar_tpu_torch import entry
from somar_tpu_torch.core import bc as tbc
from somar_tpu_torch.core.grid import Grid
from somar_tpu_torch.geometry import bathymetric as tbath
from somar_tpu_torch.geometry import geo_source as tsrc
from somar_tpu_torch.geometry.level_geometry import build_level_geometry
from somar_tpu_torch.ops import stencil_gsrb_kernels as sgk
from somar_tpu_torch.solvers.poisson_op import PoissonOp

try:    # the JAX reference; a GPU host may have no JAX (the cuda test runs)
    import jax
    import jax.numpy as jnp
    from somar_tpu.core import bc as jbc
    from somar_tpu.core.grid import Grid as JGrid
    from somar_tpu.geometry import bathymetric as jbath
    from somar_tpu.geometry import geo_source as jsrc
    from somar_tpu.geometry.level_geometry import build_level_geometry as jgeo
    from somar_tpu.ops import stencil_gsrb_pallas as sp
    from somar_tpu.solvers.poisson_op import PoissonOp as JOp
except ImportError:
    jax = None

torch.set_num_threads(1)

TOL = {"f32": 1e-6, "f64": 1e-12}
ALPHA, BETA = 0.4, 1.7


def _stretch_fns(nd):
    s = 3.0
    return [lambda x: x] * (nd - 1) + [
        lambda z: (np.exp(s * z) - 1.0) / (np.exp(s) - 1.0)]


# map builders: (grid keywords, geometry source) from the module holding
# Grid's and the maps' classes (the port's or the JAX package's)
def _stretched(nx, periodic, maps):
    return (dict(nx=nx, dx=tuple(1.0 / n for n in nx), periodic=periodic),
            maps.StretchedCartesianMap(tuple(_stretch_fns(len(nx)))))


def _ledge(nx, periodic, maps):
    return (dict(nx=nx, dx=tuple(2.0 / n for n in nx),
                 x0=(-1.0,) * (len(nx) - 1) + (0.0,), periodic=periodic),
            maps.LedgeMap((0.0, 1.0), hl=0.5, hr=1.0, xl=-0.5, xr=0.5))


def _twisted(nx, periodic, maps):
    return (dict(nx=nx, dx=tuple(1.0 / n for n in nx), periodic=periodic),
            maps.TwistedMap((0.07,) * len(nx), (1.0,) * len(nx)))


# (label, map builder, nx, periodic, lo BCs, hi BCs): N Neumann, D
# Dirichlet, P periodic, C coarse-fine, E extrapolation of order 0
CASES = [
    ("stretched-2d", _stretched, (24, 32), (True, False), "PN", "PD"),
    ("ledge-2d", _ledge, (32, 24), (False, False), "NN", "NN"),
    ("twisted-2d", _twisted, (24, 16), (True, False), "PC", "PE"),
    ("stretched-3d", _stretched, (16, 12, 16), (True, True, False),
     "PPN", "PPN"),
    ("ledge-3d", _ledge, (12, 8, 12), (False, True, False), "NPN", "DPN"),
    ("twisted-periodic3", _twisted, (3, 16), (True, False), "PN", "PD"),
    ("ledge-periodic4", _ledge, (16, 4, 12), (False, True, False),
     "NPN", "NPN"),
]
IDS = [c[0] for c in CASES]
#: the cases also compared in float64
F64_CASES = ("ledge-2d", "ledge-3d", "twisted-periodic3")
PRECS = [(c, "f32") for c in CASES] + [(c, "f64") for c in CASES
                                        if c[0] in F64_CASES]


class _Maps:
    """The map classes of one package under one namespace."""

    def __init__(self, src, bath):
        self.StretchedCartesianMap = src.StretchedCartesianMap
        self.TwistedMap = src.TwistedMap
        self.LedgeMap = bath.LedgeMap


TMAPS = _Maps(tsrc, tbath)


def _bcs(mod, letters):
    mk = {"N": mod.neumann, "D": mod.dirichlet, "P": mod.periodic,
          "C": mod.cf, "E": lambda: mod.extrap(0)}
    return tuple(mk[c]() for c in letters)


def _port_op(case, dtype=torch.float32, device="cpu"):
    _, make, nx, periodic, lo, hi = case
    kw, src = make(nx, periodic, TMAPS)
    geo = build_level_geometry(Grid(**kw), src, device=device, dtype=dtype)
    return PoissonOp(geo, tbc.FieldBCs(lo=_bcs(tbc.BC, lo),
                                       hi=_bcs(tbc.BC, hi)))


def _jax_plan(jop):
    """sp.build_stencil_plan(jop) with the probed operator jitted: the
    same probe, offsets and weights, without eager dispatch of every
    probe's operator (its validation passes on every case here, which
    test_stencil_gsrb_pallas.py asserts)."""
    grid = jop.grid
    per = [grid.periodic[grid.dir_of_axis(a)] for a in range(grid.ndim)]
    lam = jax.jit(lambda x: jop.apply(x, 0.0, 1.0, homogeneous=True))
    offsets, Wn, R = sp.probe_stencil(lam, grid.shape, per)
    plan = sp.StencilPlan(offsets, Wn, R, jop.diag(0.0, 1.0), grid.shape,
                          per)
    assert plan.ok
    return plan


def _build(case, prec):
    """(JAX op, JAX plan, port op, phi, rhs as numpy) of one case."""
    _, make, nx, periodic, lo, hi = case
    kw, src = make(nx, periodic, _Maps(jsrc, jbath))
    jd = jnp.float64 if prec == "f64" else jnp.float32
    jop = JOp(jgeo(JGrid(**kw), src, dtype=jd),
              jbc.FieldBCs(lo=_bcs(jbc.BC, lo), hi=_bcs(jbc.BC, hi)))
    jplan = _jax_plan(jop)
    top = _port_op(case, torch.float64 if prec == "f64" else torch.float32)
    rng = np.random.RandomState(3)
    npd = np.float64 if prec == "f64" else np.float32
    phi = rng.randn(*top.grid.shape).astype(npd)
    rhs = rng.randn(*top.grid.shape).astype(npd)
    return jop, jplan, top, phi, rhs


def _carry(jplan):
    return entry.stencil_plan_from_numpy(
        jplan.offsets, np.asarray(jplan.Wn), np.asarray(jplan.R),
        np.asarray(jplan.D), jplan.shape, jplan.periodic, device="cpu")


def _x64(prec):
    jax.config.update("jax_enable_x64", prec == "f64")


@pytest.fixture(scope="module")
def built():
    """Every case in f32 and the F64_CASES in f64, built once."""
    if jax is None:
        pytest.skip("the JAX reference is not installed")
    monkey = pytest.MonkeyPatch()
    monkey.setenv("SOMAR_FUSED_GSRB", "0")
    out = {}
    try:
        for case, prec in PRECS:
            _x64(prec)
            out[case[0], prec] = _build(case, prec)
    finally:
        _x64("f32")
        monkey.undo()
    return out


def _close(got, want, tol, what):
    want = np.asarray(want)
    scale = np.abs(want).max() + 1e-30
    err = np.abs(np.asarray(got) - want).max()
    assert err <= tol * scale, (what, err, scale)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plan_matches_jax(built, case):
    jop, jplan, top, _, _ = built[case[0], "f32"]
    plan = top._stencil_plan
    assert jplan is not None and plan is not None
    assert top._fused_plan is None
    assert plan.offsets == tuple(jplan.offsets)
    assert plan.periodic == tuple(jplan.periodic)
    for name in ("Wn", "R", "D"):
        _close(getattr(plan, name).numpy(),
               np.broadcast_to(np.asarray(getattr(jplan, name)),
                               getattr(plan, name).shape), 1e-6, name)


@pytest.mark.parametrize("case,prec", PRECS,
                         ids=[f"{c[0]}-{p}" for c, p in PRECS])
def test_twins_match_pallas(built, case, prec):
    _x64(prec)
    try:
        _, jplan, _, phi, rhs = built[case[0], prec]
        plan = _carry(jplan)
        tphi, trhs = torch.from_numpy(phi), torch.from_numpy(rhs)
        for iters in (1, 3):
            want = sp.gsrb_sweeps(jplan, jnp.asarray(phi), jnp.asarray(rhs),
                                  ALPHA, BETA, iters, interpret=True)
            got = sgk.stencil_gsrb_sweeps(plan, tphi, trhs, ALPHA, BETA,
                                          iters)
            _close(got.numpy(), want, TOL[prec], f"K7 iters={iters}")
        want = sp.helm_residual(jplan, jnp.asarray(phi), jnp.asarray(rhs),
                                ALPHA, BETA, interpret=True)
        got = sgk.stencil_helm_residual(plan, tphi, trhs, ALPHA, BETA)
        _close(got.numpy(), want, TOL[prec], "K8")
    finally:
        _x64("f32")


def _delta(grid_shape_fc, nd, npd):
    rng = np.random.RandomState(7)
    diag = [(-0.1 * rng.rand(*fs)).astype(npd) for fs in grid_shape_fc]
    full = [(0.05 * rng.randn(nd, *fs)).astype(npd) for fs in grid_shape_fc]
    return diag, full


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_delta_weights_and_overrides_match_jax(built, case):
    """Implicit gravity's delta weights: the port's delta_stencil_weights
    against the JAX package's (1e-6 of max, f32), and the twins with the
    overrides against the Pallas kernels; None where the plan does not
    span the full 3^nd - 1 neighbourhood (diagonal metrics)."""
    jop, jplan, top, phi, rhs = built[case[0], "f32"]
    grid = top.grid
    diag, full = _delta([grid.fc_shape(d) for d in range(grid.ndim)],
                        grid.ndim, np.float32)
    jd = (tuple(jnp.asarray(a) for a in diag),
          tuple(jnp.asarray(a) for a in full))
    td = (tuple(torch.from_numpy(a) for a in diag),
          tuple(torch.from_numpy(a) for a in full))
    want = jax.jit(lambda d: sp.delta_stencil_weights(jplan, jop, d))(jd)
    got = top.delta_kernel_overrides(td)
    if want is None:
        assert jplan.K != 3 ** grid.ndim - 1
        assert got is None
        return
    dWn, dR = want
    Wn, R, w0 = got
    _close(Wn.numpy(), np.asarray(jplan.Wn + dWn), 1e-6, "Wn + dWn")
    _close(R.numpy(), np.asarray(jplan.R + dR), 1e-6, "R + dR")
    jw0 = np.asarray(jop.diag(0.0, 1.0, jd))
    _close(w0.numpy(), np.broadcast_to(jw0, w0.shape), 1e-6, "w0")
    # the twins on the JAX package's combined weights
    plan = _carry(jplan)
    jWn, jR = jplan.Wn + dWn, jplan.R + dR
    ov = dict(Wn=torch.from_numpy(np.array(jWn)),
              R=torch.from_numpy(np.array(jR)))
    tphi, trhs = torch.from_numpy(phi), torch.from_numpy(rhs)
    ref = sp.helm_residual(jplan, jnp.asarray(phi), jnp.asarray(rhs), ALPHA,
                           BETA, interpret=True, Wn=jWn, R=jR)
    _close(sgk.stencil_helm_residual(plan, tphi, trhs, ALPHA, BETA,
                                     **ov).numpy(), ref, TOL["f32"], "K8")
    ref = sp.gsrb_sweeps(jplan, jnp.asarray(phi), jnp.asarray(rhs), ALPHA,
                         BETA, 2, interpret=True, Wn=jWn, R=jR, w0=jw0)
    got = sgk.stencil_gsrb_sweeps(
        plan, tphi, trhs, ALPHA, BETA, 2,
        w0=torch.from_numpy(np.array(np.broadcast_to(jw0, phi.shape))), **ov)
    _close(got.numpy(), ref, TOL["f32"], "K7")


def test_unrepresentable_and_uncoloured_levels_have_no_plan():
    """No plan, as in the JAX package: an extent below 3 (no colouring),
    a periodic extent divisible by neither 3 nor 4, and order-2
    extrapolation (a stencil reaching offset 2 fails validation)."""
    assert sgk.moduli((2, 20), (False, False)) is None
    assert sgk.moduli((5, 12), (True, False)) is None
    assert sgk.moduli((8, 9), (True, True)) == (4, 3)
    kw, src = _stretched((24, 32), (True, False), TMAPS)
    geo = build_level_geometry(Grid(**kw), src, device="cpu")
    BC = tbc.BC
    for lo, ok in (((BC.periodic(), BC.extrap(1)), True),
                   ((BC.periodic(), BC.extrap(2)), False)):
        op = PoissonOp(geo, tbc.FieldBCs(lo=lo, hi=(BC.periodic(),
                                                    BC.dirichlet())))
        assert (op._stencil_plan is not None) == ok


def test_wrappers_dispatch_on_device_and_count_nothing_on_cpu():
    op = _port_op(("ledge", _ledge, (12, 9), (False, False), "NN", "NN"))
    plan = op._stencil_plan
    sgk.reset_launch_counts()
    phi = torch.randn(op.grid.shape,
                      generator=torch.Generator().manual_seed(1))
    out = sgk.stencil_gsrb_sweeps(plan, phi, phi, 0.0, 1.0, 2)
    assert out is not phi and out.shape == phi.shape
    assert sgk.launch_counts() == {"stencil_gsrb_sweeps": 0,
                                   "stencil_helm_residual": 0}
    with pytest.raises(ValueError):
        sgk.stencil_helm_residual(plan, phi[:-1], phi[:-1], 0.0, 1.0)
    # the plan's operator equals the ghost-fill operator it was probed from
    want = op.apply(phi, 0.0, 1.0)
    got = sgk.apply_reference(plan, phi)
    assert float((got - want).abs().max()) <= 2e-6 * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_kernels_match_twins_on_the_card(case):
    """K7/K8 on the card against their twins on the same card tensors, with
    and without overrides (bitwise with -fmad=false; limit 1e-6)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    op = _port_op(case, device="cuda")
    plan, grid = op._stencil_plan, op.grid
    gen = torch.Generator(device="cuda").manual_seed(11)
    phi, rhs = (torch.randn(grid.shape, generator=gen, device="cuda")
                for _ in range(2))
    ovs = [{}]
    diag, full = _delta([grid.fc_shape(d) for d in range(grid.ndim)],
                        grid.ndim, np.float32)
    got = op.delta_kernel_overrides(
        (tuple(torch.from_numpy(a).cuda() for a in diag),
         tuple(torch.from_numpy(a).cuda() for a in full)))
    if got is not None:
        ovs.append(dict(zip(("Wn", "R", "w0"), got)))
    for ov, iters in itertools.product(ovs, (1, 3)):
        a = sgk.stencil_gsrb_sweeps(plan, phi, rhs, ALPHA, BETA, iters, **ov)
        b = sgk.stencil_gsrb_sweeps_plain(plan, phi, rhs, ALPHA, BETA, iters,
                                          **ov)
        assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())
        ov2 = {k: v for k, v in ov.items() if k != "w0"}
        a = sgk.stencil_helm_residual(plan, phi, rhs, ALPHA, BETA, **ov2)
        b = sgk.stencil_helm_residual_plain(plan, phi, rhs, ALPHA, BETA,
                                            **ov2)
        assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())
