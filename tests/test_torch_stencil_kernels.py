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
  * K7's variant chooser on the multigrid levels of the 640x512
    BeamGeneration level (no JAX);
  * the CUDA kernels against their twins (marked `cuda`, skipped without a
    card): K7 bitwise in each variant, on these levels and on synthetic
    plans of awkward shapes (periodic extents 2, 3 and 5, extents that are
    not multiples of a tile, 3D with K = 18 and 26).  On a GPU host without
    JAX:

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
from somar_tpu_torch.ops import rb_sweeps
from somar_tpu_torch.ops import stencil_gsrb_kernels as sgk
from somar_tpu_torch.solvers.multigrid import semicoarsening_schedule
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


#: the multigrid levels of main path 3 with a stencil plan (the three
#: coarsest, (2,20), (2,10), (2,5), have none: an extent of 2 has no
#: colouring)
PATH3_PLAN_LEVELS = [(512, 640), (256, 640), (128, 640), (64, 640),
                     (32, 320), (16, 160), (8, 80), (4, 40)]


def test_path3_levels_are_the_schedule():
    grid = Grid(nx=(640, 512), dx=(entry.BEAM_LENGTH / 640,
                                   entry.BEAM_DEPTH / 512))
    shapes = [grid.shape]
    for ratio in semicoarsening_schedule(grid):
        grid = grid.coarsen(ratio)
        shapes.append(grid.shape)
    assert shapes == PATH3_PLAN_LEVELS + [(2, 20), (2, 10), (2, 5)]
    assert [sgk.moduli(s, (False, False)) is not None for s in shapes] \
        == [True] * 8 + [False] * 3


@pytest.mark.parametrize("f64", [False, True], ids=["f32", "f64"])
@pytest.mark.parametrize("shape", PATH3_PLAN_LEVELS, ids=str)
def test_variant_chooser_on_path3_levels(shape, f64):
    """One launch per smoothing call up to (32,320) (80 KB of shared
    memory in f32, 160 KB in f64), one per sweep from (64,640) up."""
    item = 8 if f64 else 4
    var, tz = rb_sweeps.choose_variant(shape, item, 8)
    whole = shape[0] * shape[1] <= 32 * 320
    assert (var, tz) == ((rb_sweeps.WHOLE, 0) if whole
                         else (rb_sweeps.TILED, 1))
    assert rb_sweeps.tiled_smem_bytes(2, item) <= rb_sweeps.SMEM_PER_BLOCK
    assert rb_sweeps.launches_per_call(var, 4) == (1 if whole else 4)


def _synthetic_plan(shape, periodic, K, device, dtype, seed):
    """A StencilPlan with random weights on the first K offsets of the 3^nd
    box (corners last): the kernels take any weights, so awkward shapes
    that no mapped level has can be held against the twin."""
    nd = len(shape)
    offs = [o for o in itertools.product((-1, 0, 1), repeat=nd) if any(o)]
    offs.sort(key=lambda o: sum(map(abs, o)) == nd)
    gen = torch.Generator(device=device).manual_seed(seed)
    kw = dict(generator=gen, device=device, dtype=dtype)
    Wn = torch.rand((K,) + tuple(shape), **kw)
    R = 0.1 * torch.randn(shape, **kw)
    D = -Wn.sum(0) - 1.0
    return sgk.StencilPlan(offs[:K], Wn, R, D, shape, periodic)


#: (shape, periodic, K): periodic extents 2, 3 and 5, extents that are not
#: multiples of a tile (2D 32x32; 3D 16x64 with chunks along axis 0)
SYNTHETIC = [((2, 5), (True, True), 8), ((3, 7), (True, False), 8),
             ((5, 33), (True, True), 4), ((37, 70), (False, True), 8),
             ((64, 96), (False, False), 8),
             ((2, 3, 5), (True, True, True), 26),
             ((5, 17, 70), (True, False, True), 18),
             ((18, 33, 65), (False, True, False), 18),
             ((7, 20, 130), (True, True, True), 26)]


def _k7_variants(shape, dtype):
    item = torch.empty((), dtype=dtype).element_size()
    fits = 2 * np.prod(shape) * item <= rb_sweeps.SMEM_PER_BLOCK
    return [None, rb_sweeps.TILED] + ([rb_sweeps.WHOLE] if fits else [])


def _k7_bitwise(plan, phi, rhs, ovs):
    for ov, iters in itertools.product(ovs, (1, 3)):
        want = sgk.stencil_gsrb_sweeps_plain(plan, phi, rhs, ALPHA, BETA,
                                             iters, **ov)
        for variant in _k7_variants(plan.shape, phi.dtype):
            got = sgk.stencil_gsrb_sweeps(plan, phi, rhs, ALPHA, BETA, iters,
                                          variant=variant, **ov)
            assert float((got - want).abs().max()) == 0.0, \
                (plan.shape, iters, variant, sorted(ov))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("shape,periodic,K", SYNTHETIC,
                         ids=[str(c[0]) for c in SYNTHETIC])
def test_k7_variants_on_awkward_shapes(shape, periodic, K, dtype):
    """Both K7 variants bitwise equal to the twin, with the plan's weights
    and with overrides, on shapes whose halos wrap onto themselves."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    plan = _synthetic_plan(shape, periodic, K, "cuda", dtype, 3)
    other = _synthetic_plan(shape, periodic, K, "cuda", dtype, 4)
    gen = torch.Generator(device="cuda").manual_seed(12)
    phi, rhs = (torch.randn(shape, generator=gen, device="cuda", dtype=dtype)
                for _ in range(2))
    _k7_bitwise(plan, phi, rhs,
                [{}, dict(Wn=other.Wn, R=other.R, w0=other.D)])
    sgk.reset_launch_counts()
    sgk.stencil_gsrb_sweeps(plan, phi, rhs, ALPHA, BETA, 4,
                            variant=rb_sweeps.TILED)
    assert sgk.launch_counts()["stencil_gsrb_sweeps"] == 4


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_kernels_match_twins_on_the_card(case):
    """K7/K8 on the card against their twins on the same card tensors, with
    and without overrides: K7 bitwise in each variant (-fmad=false), K8
    within 1e-6."""
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
    _k7_bitwise(plan, phi, rhs, ovs)
    for ov in ovs:
        ov2 = {k: v for k, v in ov.items() if k != "w0"}
        a = sgk.stencil_helm_residual(plan, phi, rhs, ALPHA, BETA, **ov2)
        b = sgk.stencil_helm_residual_plain(plan, phi, rhs, ALPHA, BETA,
                                            **ov2)
        assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())
