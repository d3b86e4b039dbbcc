"""The port's GSRB kernels K5-K6 against the JAX package.

On the CPU each wrapper runs its plain PyTorch twin.  The twins are held
  * against the Pallas kernels run with interpret=True: 1e-5 of max|result|
    in f32 (a few f32 roundings per cell and sweep; ~1e-6 is usual), 1e-12
    in f64;
  * against the jnp ghost-fill path (PoissonOp.relax_gsrb / residual) at
    rtol 1e-4, atol 1e-5 in f32, as tests/test_gsrb_pallas.py holds the
    Pallas kernels, and 1e-11 in f64;
  * on shapes the TPU gate refused and the port accepts (a periodic
    vertical axis in 3D; periodic extents 2 and 3, where a cell's wrap
    neighbour has the cell's own colour) against the jnp path alone.
The variant chooser of K5 (one launch per smoothing call on levels whose
ping-pong pair fits one block's shared memory, one per sweep above) is
checked on the multigrid levels of the lock exchange without JAX.
The CUDA kernels are held against the twins on the card by the tests marked
`cuda`, which skip without one: bitwise, K5 in each variant.  On a GPU
host without JAX they run with

    python -m pytest tests/test_torch_gsrb_kernels.py -m cuda --noconftest
"""

import contextlib
import types

import numpy as np
import pytest
import torch

from somar_tpu_torch.core import bc as tbc
from somar_tpu_torch.core.grid import Grid as TGrid
from somar_tpu_torch.geometry.geo_source import CartesianMap as TCartesian
from somar_tpu_torch.geometry.level_geometry import build_level_geometry as tgeo
from somar_tpu_torch.ops import gsrb_kernels as gk
from somar_tpu_torch.ops import rb_sweeps
from somar_tpu_torch.solvers.multigrid import semicoarsening_schedule
from somar_tpu_torch.solvers.poisson_op import PoissonOp as TOp

try:    # the JAX reference; a GPU host may have no JAX (the cuda tests run)
    import jax
    import jax.numpy as jnp
    from somar_tpu.core import bc as jbc
    from somar_tpu.core.grid import Grid as JGrid
    from somar_tpu.geometry.geo_source import CartesianMap as JCartesian
    from somar_tpu.geometry.level_geometry import build_level_geometry as jgeo
    from somar_tpu.ops import gsrb_pallas as gp
    from somar_tpu.solvers.poisson_op import PoissonOp as JOp
except ImportError:
    jax = None

torch.set_num_threads(1)

N, P, D, C, E0, E1 = (("NEUMANN", 1), ("PERIODIC", 1), ("DIRICHLET", 1),
                      ("CF", 1), ("EXTRAP", 0), ("EXTRAP", 1))

#: (nx, periodic, lo BCs, hi BCs): the CASES of tests/test_gsrb_pallas.py
CASES = {
    "3d-neumann-periodic": ((16, 12, 32), (False, True, False),
                            (N, P, N), (N, P, N)),
    "3d-mixed": ((16, 12, 32), (False, False, False), (D, C, N), (N, C, E0)),
    "2d-periodic-dirichlet": ((24, 32), (True, False), (P, D), (P, N)),
}
#: shapes the TPU kernels' gate refused
EXTRA = {
    "3d-periodic-vertical": ((8, 6, 10), (False, False, True),
                             (N, D, P), (D, N, P)),
    "3d-periodic-extent-2": ((6, 2, 4), (False, True, False),
                             (N, P, D), (N, P, N)),
    "3d-periodic-extent-3": ((3, 5, 4), (True, False, False),
                             (P, N, D), (P, N, N)),
    "2d-periodic-2-and-3": ((2, 3), (True, True), (P, P), (P, P)),
    "3d-2x2x2": ((2, 2, 2), (False, True, False), (N, P, N), (N, P, N)),
}
COEFS = [(0.7, 1.3), (0.0, 1.0)]


@contextlib.contextmanager
def _x64(on):
    jax.config.update("jax_enable_x64", bool(on))
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


@pytest.fixture
def needs_jax():
    if jax is None:
        pytest.skip("needs the JAX package (jax) for the reference")


def _bcs(mod, lo, hi):
    mk = lambda kind, order: mod.BC(mod.BCType[kind], order=order)
    return mod.FieldBCs(lo=tuple(mk(*b) for b in lo),
                        hi=tuple(mk(*b) for b in hi))


def _tsetup(case, dtype=torch.float32, device="cpu"):
    nx, periodic, lo, hi = case
    grid = TGrid(nx=nx, dx=tuple(0.3 + 0.2 * d for d in range(len(nx))),
                 periodic=periodic)
    geo = tgeo(grid, TCartesian(), device=device, dtype=dtype)
    return grid, geo, _bcs(tbc, lo, hi)


def _jsetup(case, f64):
    nx, periodic, lo, hi = case
    grid = JGrid(nx=nx, dx=tuple(0.3 + 0.2 * d for d in range(len(nx))),
                 periodic=periodic)
    geo = jgeo(grid, JCartesian(),
               dtype=jnp.float64 if f64 else jnp.float32)
    return grid, geo, _bcs(jbc, lo, hi)


def _fields(shape, f64):
    rng = np.random.RandomState(7)
    dt = np.float64 if f64 else np.float32
    return rng.randn(*shape).astype(dt), rng.randn(*shape).astype(dt)


def _close_to_pallas(got, want, f64):
    tol = 1e-12 if f64 else 1e-5
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def _close_to_jnp(got, want, f64):
    if f64:
        np.testing.assert_allclose(got, want, rtol=1e-11, atol=1e-11)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


#: f64 once per case: every JAX call here compiles, which is what this
#: file's time goes to
SWEEP_RUNS = [(c, *COEFS[0], False) for c in CASES] \
    + [("3d-mixed", *COEFS[1], False)] \
    + [(c, *COEFS[0], True) for c in CASES]


@pytest.mark.parametrize("case,alpha,beta,f64", SWEEP_RUNS)
def test_gsrb_twin_matches_pallas_and_jnp(needs_jax, case, alpha, beta, f64):
    tgrid, tg, tb = _tsetup(CASES[case],
                            torch.float64 if f64 else torch.float32)
    phi, rhs = _fields(tgrid.shape, f64)
    tplan = gk.make_plan(tgrid, tb, tg)
    assert tplan is not None
    with _x64(f64):
        jgrid, jg, jb = _jsetup(CASES[case], f64)
        jplan = gp.make_plan(jgrid, jb, jg)
        jop = JOp(jg, jb)
        for iters in (1, 3):
            got = gk.gsrb_sweeps(tplan, torch.from_numpy(phi),
                                 torch.from_numpy(rhs), alpha, beta,
                                 iters).numpy()
            assert got.dtype == phi.dtype
            pal = gp.gsrb_sweeps(jplan, jnp.asarray(phi), jnp.asarray(rhs),
                                 alpha, beta, iters, interpret=True)
            _close_to_pallas(got, np.asarray(pal), f64)
            ref = jop.relax_gsrb(jnp.asarray(phi), jnp.asarray(rhs), alpha,
                                 beta, iters)
            _close_to_jnp(got, np.asarray(ref), f64)


@pytest.mark.parametrize("f64", [False, True], ids=["f32", "f64"])
@pytest.mark.parametrize("alpha,beta", COEFS)
@pytest.mark.parametrize("case", list(CASES))
def test_residual_twin_matches_pallas_and_jnp(needs_jax, case, alpha, beta,
                                              f64):
    tgrid, tg, tb = _tsetup(CASES[case],
                            torch.float64 if f64 else torch.float32)
    phi, rhs = _fields(tgrid.shape, f64)
    tplan = gk.make_plan(tgrid, tb, tg)
    got = gk.helm_residual(tplan, torch.from_numpy(phi),
                           torch.from_numpy(rhs), alpha, beta).numpy()
    with _x64(f64):
        jgrid, jg, jb = _jsetup(CASES[case], f64)
        pal = gp.helm_residual(gp.make_plan(jgrid, jb, jg), jnp.asarray(phi),
                               jnp.asarray(rhs), alpha, beta, interpret=True)
        _close_to_pallas(got, np.asarray(pal), f64)
        ref = JOp(jg, jb).residual(jnp.asarray(phi), jnp.asarray(rhs), alpha,
                                   beta, homogeneous=True)
        _close_to_jnp(got, np.asarray(ref), f64)


@pytest.mark.parametrize("case,f64", [(c, False) for c in EXTRA]
                         + [("3d-periodic-extent-3", True)])
def test_shapes_beyond_the_tpu_gate_match_jnp(needs_jax, case, f64):
    """Through PoissonOp, which holds the plan: the port's relax_gsrb and
    residual on shapes the TPU kernels refused."""
    tgrid, tg, tb = _tsetup(EXTRA[case],
                            torch.float64 if f64 else torch.float32)
    top = TOp(tg, tb)
    assert top._fused_plan is not None
    phi, rhs = _fields(tgrid.shape, f64)
    tp, tr = torch.from_numpy(phi), torch.from_numpy(rhs)
    with _x64(f64):
        _, jg, jb = _jsetup(EXTRA[case], f64)
        jop = JOp(jg, jb)
        jp, jr = jnp.asarray(phi), jnp.asarray(rhs)
        (alpha, beta), (a2, b2) = COEFS
        _close_to_jnp(top.relax_gsrb(tp, tr, alpha, beta, 2).numpy(),
                      np.asarray(jop.relax_gsrb(jp, jr, alpha, beta, 2)),
                      f64)
        _close_to_jnp(top.residual(tp, tr, a2, b2).numpy(),
                      np.asarray(jop.residual(jp, jr, a2, b2)), f64)


GATE = {
    "extrap-1": ((8, 8), (False, False), (E1, E1), (E1, E1), False),
    "extrap-0": ((8, 8), (False, False), (E0, E0), (E0, E0), True),
    "neumann-3d": ((8, 8, 8), (False,) * 3, (N, N, N), (N, N, N), True),
    "dirichlet-cf": ((8, 8), (False, False), (D, C), (C, D), True),
    "periodic-one-side": ((8, 8), (True, False), (P, N), (N, N), False),
    "periodic-bc-on-wall": ((8, 8), (False, False), (P, N), (P, N), False),
}


@pytest.mark.parametrize("name", list(GATE))
def test_bc_gate_matches_jax(needs_jax, name):
    nx, periodic, lo, hi, want = GATE[name]
    dx = (0.1,) * len(nx)
    tplan = gk.make_plan(TGrid(nx=nx, dx=dx, periodic=periodic),
                         _bcs(tbc, lo, hi))
    jplan = gp.make_plan(JGrid(nx=nx, dx=dx, periodic=periodic),
                         _bcs(jbc, lo, hi))
    assert (tplan is not None) == want == (jplan is not None)


def test_gate_refuses_1d_and_mapped_metrics():
    grid1 = TGrid(nx=(8,), dx=(0.1,))
    assert gk.make_plan(grid1, _bcs(tbc, (N,), (N,))) is None
    grid = TGrid(nx=(8, 8), dx=(0.1, 0.1))
    bcs = _bcs(tbc, (N, N), (N, N))
    mapped = types.SimpleNamespace(is_uniform=False)
    assert gk.make_plan(grid, bcs, mapped) is None
    assert gk.make_plan(grid, bcs, types.SimpleNamespace(is_uniform=True))


def test_level_without_plan_takes_the_ghost_fill_path():
    """EXTRAP order 1 has no plan: relax_gsrb and residual are computed
    from ghost fills, and agree with the operator's own apply."""
    grid, geo, bcs = _tsetup(((8, 6), (False, False), (E1, N), (E1, N)))
    op = TOp(geo, bcs)
    assert op._fused_plan is None
    phi, rhs = (torch.from_numpy(a) for a in _fields(grid.shape, False))
    res = op.residual(phi, rhs, 0.7, 1.3)
    torch.testing.assert_close(res, rhs - op.apply(phi, 0.7, 1.3))
    out = op.relax_gsrb(phi, rhs, 0.7, 1.3, 2)
    assert out.shape == phi.shape and torch.isfinite(out).all()
    assert float(op.norm(op.residual(out, rhs, 0.7, 1.3))) \
        < float(op.norm(res))


def test_sweeps_leave_phi_alone_and_zero_iters_copies():
    grid, geo, bcs = _tsetup(CASES["2d-periodic-dirichlet"])
    plan = gk.make_plan(grid, bcs, geo)
    phi, rhs = (torch.from_numpy(a) for a in _fields(grid.shape, False))
    keep = phi.clone()
    out = gk.gsrb_sweeps(plan, phi, rhs, 1.0, -0.1, 2)
    assert torch.equal(phi, keep) and out is not phi
    zero = gk.gsrb_sweeps(plan, phi, rhs, 1.0, -0.1, 0)
    assert torch.equal(zero, phi) and zero is not phi


def test_wrappers_refuse_wrong_shapes_and_devices():
    grid, geo, bcs = _tsetup(CASES["2d-periodic-dirichlet"])
    plan = gk.make_plan(grid, bcs, geo)
    phi = torch.zeros(grid.shape)
    with pytest.raises(ValueError):
        gk.helm_residual(plan, phi[:-1], phi[:-1], 0.0, 1.0)
    with pytest.raises(ValueError):
        gk.gsrb_sweeps(plan, phi, phi.double(), 0.0, 1.0, 1)
    meta = torch.zeros(grid.shape, device="meta")
    with pytest.raises(ValueError):     # never sent to the twin
        gk.gsrb_sweeps(plan, meta, meta, 0.0, 1.0, 1)


def test_launch_counts_count_only_kernel_launches():
    gk.reset_launch_counts()
    grid, geo, bcs = _tsetup(CASES["2d-periodic-dirichlet"])
    plan = gk.make_plan(grid, bcs, geo)
    phi = torch.zeros(grid.shape)
    gk.gsrb_sweeps(plan, phi, phi, 0.0, 1.0, 2)   # CPU: the twin, no launch
    gk.helm_residual(plan, phi, phi, 0.0, 1.0)
    assert gk.launch_counts() == {"gsrb_sweeps": 0, "helm_residual": 0}


# --------------------------------------------------------------------------
# K5's launch shape per level (no JAX)
# --------------------------------------------------------------------------
def _mg_levels(nx, dx, periodic):
    grid = TGrid(nx=nx, dx=dx, periodic=periodic)
    shapes = [grid.shape]
    for ratio in semicoarsening_schedule(grid):
        grid = grid.coarsen(ratio)
        shapes.append(grid.shape)
    return shapes


#: the multigrid levels of main path 2 (the 512x128x128 lock exchange)
PATH2_LEVELS = [(128, 128, 512), (64, 64, 256), (32, 32, 128), (16, 16, 64),
                (8, 8, 32), (4, 4, 16), (2, 2, 8), (2, 2, 4), (2, 2, 2)]
#: their shapes with the pressure BCs, for the card (array axes reversed);
#: the finest two are left to chip_smoke.py
MG_LEVELS = {f"path2-{s}": (s[::-1], (False, True, False), (N, P, N),
                            (N, P, N)) for s in PATH2_LEVELS[2:]}
#: for the card: a periodic extent of 5 and extents that are not multiples
#: of a tile (2D 32x32; 3D 16x64 with chunks along axis 0)
AWKWARD = {
    "periodic-5-ragged": ((19, 5, 70), (True, True, False), (P, P, D),
                          (P, P, N)),
    "ragged-3d": ((65, 33, 18), (False, False, False), (D, C, N),
                  (N, C, E0)),
    "2d-ragged": ((70, 37), (True, False), (P, D), (P, N)),
    "2d-periodic-5": ((5, 33), (True, True), (P, P), (P, P)),
}


def test_path2_levels_are_the_schedule():
    assert _mg_levels((512, 128, 128), (15 / 512, 2 / 128, 2 / 128),
                      (False, True, False)) == PATH2_LEVELS


@pytest.mark.parametrize("f64", [False, True], ids=["f32", "f64"])
@pytest.mark.parametrize("shape", PATH2_LEVELS, ids=str)
def test_variant_chooser_on_path2_levels(shape, f64):
    """One launch per smoothing call up to (16,16,64) in f32, where the
    ping-pong pair takes 128 KB of shared memory; one per sweep above, and
    at (16,16,64) in f64 (256 KB)."""
    item = 8 if f64 else 4
    var, tz = rb_sweeps.choose_variant(shape, item)
    cells = int(np.prod(shape))
    want_whole = cells <= 16 * 16 * 64 and not (f64 and cells == 16384)
    assert var == (rb_sweeps.WHOLE if want_whole else rb_sweeps.TILED)
    if var == rb_sweeps.WHOLE:
        assert 2 * cells * item <= rb_sweeps.WHOLE_BYTES and tz == 0
    else:
        assert 1 <= tz <= shape[0]
        assert rb_sweeps.tiled_smem_bytes(3, item) \
            <= rb_sweeps.SMEM_PER_BLOCK
    for iters in (1, 2, 4):
        assert rb_sweeps.launches_per_call(var, iters) == \
            (1 if want_whole else iters)


def test_forced_variants_and_chooser_limits():
    assert rb_sweeps.check_forced("tiled", (2, 2, 2), 4) == ("tiled", 2)
    assert rb_sweeps.check_forced("whole", (16, 16, 64), 4) == ("whole", 0)
    for shape, item in (((16, 16, 64), 8), ((32, 32, 128), 4)):
        with pytest.raises(ValueError):     # above one block's 227 KB
            rb_sweeps.check_forced("whole", shape, item)
    with pytest.raises(ValueError):
        rb_sweeps.check_forced("half", (2, 2, 2), 4)
    with pytest.raises(ValueError):
        rb_sweeps.choose_variant((8,), 4)
    # a smaller shared memory moves a level to the tiled variant
    assert rb_sweeps.choose_variant((16, 16, 64), 4, smem_per_block=65536) \
        == ("tiled", 4)
    assert rb_sweeps.launches_per_call("whole", 0) == 0


# --------------------------------------------------------------------------
# on the card: the CUDA kernels against their twins on the same tensors
# --------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _variants(shape, dtype):
    """The K5 variants that fit the level: the plan's own choice, then each
    one forced."""
    item = torch.empty((), dtype=dtype).element_size()
    forced = [v for v in (rb_sweeps.WHOLE, rb_sweeps.TILED)
              if v == rb_sweeps.TILED
              or 2 * np.prod(shape) * item <= rb_sweeps.SMEM_PER_BLOCK]
    return [None] + forced


def _cuda_compare(case, dtype, device):
    grid, geo, bcs = _tsetup(case, dtype, device)
    plan = gk.make_plan(grid, bcs, geo)
    gen = torch.Generator(device=device).manual_seed(5)
    phi, rhs = (torch.randn(grid.shape, generator=gen, device=device,
                            dtype=dtype) for _ in range(2))
    for alpha, beta in COEFS + [(1.0, -1e-3)]:
        for iters in (1, 3):
            want = gk.gsrb_sweeps_plain(plan, phi, rhs, alpha, beta, iters)
            for variant in _variants(grid.shape, dtype):
                got = gk.gsrb_sweeps(plan, phi, rhs, alpha, beta, iters,
                                     variant=variant)
                assert got.device.type == "cuda" and got.dtype == dtype
                assert float((got - want).abs().max()) == 0.0, \
                    (case, iters, variant)
        _residual_bitwise(plan, phi, rhs, alpha, beta, case)


def _residual_bitwise(plan, phi, rhs, alpha, beta, case):
    got = gk.helm_residual(plan, phi, rhs, alpha, beta)
    want = gk.helm_residual_plain(plan, phi, rhs, alpha, beta)
    assert got.device.type == "cuda" and got.dtype == phi.dtype
    assert float((got - want).abs().max()) == 0.0, (case, alpha, beta)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_kernels_match_twins(cuda_device, dtype):
    """Full arrays: K5 bitwise equal to its twin in each variant and K6
    bitwise equal to its twin (the kernels are built with -fmad=false and
    round as the twins do)."""
    for case in list(CASES.values()) + list(EXTRA.values()) \
            + list(MG_LEVELS.values()) + list(AWKWARD.values()):
        _cuda_compare(case, dtype, cuda_device)


#: K6 on the edges of its design (tiles of 8 x 32 columns in 3D and 128 in
#: 2D, marching chunks of planes along the first active axis: one plane a
#: block on small levels, 4 with a short last chunk on (67, 65, 161)):
#: levels with interior blocks beside periodic seams, periodic extents 2,
#: 3 and 5 on every axis, every boundary factor (Dirichlet 2, Neumann 0,
#: coarse-fine 1, extrapolation 0) on every face, extents that are not
#: multiples of a tile or a chunk, and levels where every block touches a
#: boundary
K6_EDGES = {
    "interior-and-seams": ((70, 21, 20), (False, True, False), (D, P, N),
                           (E0, P, C)),
    "periodic-2-3-5": ((5, 3, 2), (True, True, True), (P, P, P), (P, P, P)),
    "periodic-3-5-2": ((3, 5, 2), (True, True, True), (P, P, P), (P, P, P)),
    "periodic-2-5-3": ((2, 5, 3), (True, True, True), (P, P, P), (P, P, P)),
    "factors-dnc-ced": ((37, 35, 19), (False, False, False), (D, N, C),
                        (C, E0, D)),
    "factors-ecd-ndn": ((67, 13, 11), (False, False, False), (E0, C, D),
                        (N, D, N)),
    "periodic-march-axis": ((66, 20, 21), (False, False, True), (D, C, P),
                            (N, E0, P)),
    "multi-plane-chunks": ((161, 65, 67), (False, True, False), (D, P, N),
                           (N, P, C)),
    "all-edge-blocks": ((16, 4, 4), (False, True, False), (N, P, N),
                        (N, P, N)),
    "all-edge-8": ((8, 8, 8), (False, False, False), (D, D, N), (N, C, D)),
    "2d-interior-and-seams": ((300, 45), (True, False), (P, D), (P, N)),
    "2d-periodic-5-2": ((5, 2), (True, True), (P, P), (P, P)),
    "2d-periodic-3-130": ((3, 130), (True, True), (P, P), (P, P)),
    "2d-factors": ((131, 7), (False, False), (C, E0), (D, N)),
    "2d-all-edge": ((100, 3), (False, True), (D, P), (N, P)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k6_edges_match_twin_bitwise(cuda_device, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(23)
    for name, case in K6_EDGES.items():
        grid, geo, bcs = _tsetup(case, dtype, cuda_device)
        plan = gk.make_plan(grid, bcs, geo)
        assert plan is not None, name
        phi, rhs = (torch.randn(grid.shape, generator=gen,
                                device=cuda_device, dtype=dtype)
                    for _ in range(2))
        for alpha, beta in COEFS + [(1.0, -1e-3)]:
            _residual_bitwise(plan, phi, rhs, alpha, beta, name)


@pytest.mark.cuda
def test_cuda_launch_counts(cuda_device):
    grid, geo, bcs = _tsetup(CASES["3d-mixed"], device=cuda_device)
    plan = gk.make_plan(grid, bcs, geo)
    phi = torch.zeros(grid.shape, device=cuda_device)
    gk.reset_launch_counts()
    gk.gsrb_sweeps(plan, phi, phi, 0.0, 1.0, 3)       # whole: one launch
    gk.gsrb_sweeps(plan, phi, phi, 0.0, 1.0, 3, variant="tiled")
    gk.helm_residual(plan, phi, phi, 0.0, 1.0)
    assert gk.launch_counts() == {"gsrb_sweeps": 4, "helm_residual": 1}
    assert gk.helm_residual.launches_by_shape == {tuple(grid.shape): 1}
