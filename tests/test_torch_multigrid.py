"""The port's multigrid stack against the JAX package's, on the CPU, from
the same seeded numpy inputs: the tridiagonal solve, the semicoarsening
schedule, the transfer operators, the Jacobi and line smoothers, a fixed
number of V-cycles, and full solves.

The JAX package's BiCGStab cannot run under jax_enable_x64 (its restart
branch returns float64 scalars where the other branch returns float32, and
lax.cond refuses the pair), so the float64 comparisons take the smoothing
bottom solver and the BiCGStab bottom is compared in float32.
"""

import contextlib

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from somar_tpu.core import bc as jbc
from somar_tpu.core.grid import Grid as JGrid
from somar_tpu.geometry.geo_source import CartesianMap as JCartesian
from somar_tpu.geometry.level_geometry import build_level_geometry as jgeo
from somar_tpu.solvers import multigrid as jmg
from somar_tpu.solvers import tridiag as jtri
from somar_tpu.solvers.poisson_op import PoissonOp as JOp

from somar_tpu_torch.core import bc as tbc
from somar_tpu_torch.core.grid import Grid as TGrid
from somar_tpu_torch.geometry.geo_source import CartesianMap as TCartesian
from somar_tpu_torch.geometry.level_geometry import build_level_geometry as tgeo
from somar_tpu_torch.solvers import multigrid as tmg
from somar_tpu_torch.solvers import tridiag as ttri
from somar_tpu_torch.solvers.poisson_op import PoissonOp as TOp

torch.set_num_threads(1)

#: the 16x8x8 lock-exchange grid and a 2D grid with unequal spacings
GRID3 = dict(nx=(16, 8, 8), dx=(15 / 16, 2 / 8, 2 / 8),
             periodic=(False, True, False))
GRID2 = dict(nx=(16, 16), dx=(1 / 16, 1.5 / 16), periodic=(False, False))


@contextlib.contextmanager
def _x64(on):
    jax.config.update("jax_enable_x64", bool(on))
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _dtypes(f64):
    return ((np.float64, jnp.float64, torch.float64) if f64
            else (np.float32, jnp.float32, torch.float32))


def _setup(gridkw, bc_kind, f64, values=(0.0, 0.0)):
    """(JAX geo, JAX bcs, port geo, port bcs): periodic where the grid is,
    `bc_kind` elsewhere with `values` on the (lo, hi) sides."""
    _, jdt, tdt = _dtypes(f64)
    jg, tg = JGrid(**gridkw), TGrid(**gridkw)

    def bcs(mod, grid):
        lo = tuple(mod.BC.periodic() if p else
                   mod.BC(mod.BCType[bc_kind], value=values[0])
                   for p in grid.periodic)
        hi = tuple(mod.BC.periodic() if p else
                   mod.BC(mod.BCType[bc_kind], value=values[1])
                   for p in grid.periodic)
        return mod.FieldBCs(lo=lo, hi=hi)

    return (jgeo(jg, JCartesian(), dtype=jdt), bcs(jbc, jg),
            tgeo(tg, TCartesian(), device="cpu", dtype=tdt), bcs(tbc, tg))


def _rand(shape, f64, seed=3, n=1):
    rng = np.random.default_rng(seed)
    out = [rng.standard_normal(shape).astype(_dtypes(f64)[0])
           for _ in range(n)]
    return out[0] if n == 1 else out


# --------------------------------------------------------------------------
# tridiagonal solve, schedule, transfers
# --------------------------------------------------------------------------
def test_thomas_solve_matches_jax():
    rng = np.random.default_rng(0)
    shape = (12, 5, 7)
    a, c, d = (rng.standard_normal(shape).astype(np.float32)
               for _ in range(3))
    b = (4.0 + rng.random(shape)).astype(np.float32)   # diagonally dominant
    want = np.asarray(jtri.thomas_solve(*map(jnp.asarray, (a, b, c, d))))
    got = ttri.thomas_solve(*map(torch.from_numpy, (a, b, c, d))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_vertical_poisson_nn_matches_jax():
    rng = np.random.default_rng(1)
    shape = (10, 6)
    rhs = rng.standard_normal(shape).astype(np.float32)
    lo, hi = (1.0 + rng.random(shape).astype(np.float32) for _ in range(2))
    want = np.asarray(jtri.vertical_poisson_nn(
        jnp.asarray(rhs), jnp.asarray(lo), jnp.asarray(hi), 0.1))
    got = ttri.vertical_poisson_nn(
        *map(torch.from_numpy, (rhs, lo, hi)), 0.1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("gridkw", [
    dict(nx=(512, 128, 128), dx=(15 / 512, 2 / 128, 2 / 128)),
    dict(nx=(64, 16, 32), dx=(15 / 64, 2 / 16, 2 / 32)),
    dict(nx=(640, 24), dx=(0.01, 0.5)),
    dict(nx=(96, 6), dx=(0.1, 0.1)),
], ids=["512x128x128", "64x16x32", "anisotropic-2d", "odd-coarse-2d"])
def test_semicoarsening_schedule_matches_jax(gridkw):
    want = jmg.semicoarsening_schedule(JGrid(**gridkw))
    got = tmg.semicoarsening_schedule(TGrid(**gridkw))
    assert got == want and len(got) > 0
    assert tmg.semicoarsening_schedule(TGrid(**gridkw), 2) == want[:2]


TRANSFERS = {
    "3d-periodic-y": (dict(nx=(8, 4, 6), dx=(1.0, 1.0, 1.0),
                           periodic=(False, True, False)), (2, 2, 2)),
    "3d-semi": (dict(nx=(8, 4, 6), dx=(1.0, 1.0, 1.0),
                     periodic=(False, True, False)), (2, 1, 2)),
    "2d-walls": (dict(nx=(12, 6), dx=(1.0, 1.0)), (2, 2)),
    "2d-coarse-n2": (dict(nx=(4, 4), dx=(1.0, 1.0),
                          periodic=(True, False)), (2, 2)),
    "2d-coarse-n1": (dict(nx=(2, 8), dx=(1.0, 1.0)), (2, 2)),
}


@pytest.mark.parametrize("name", list(TRANSFERS))
def test_restrict_and_prolong_match_jax(name):
    gridkw, ratio = TRANSFERS[name]
    jg, tg = JGrid(**gridkw), TGrid(**gridkw)
    fine = _rand(tg.shape, False, seed=5)
    want = np.asarray(jmg.restrict_fullweight(jnp.asarray(fine), jg, ratio))
    got = tmg.restrict_fullweight(torch.from_numpy(fine), tg, ratio)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    coarse = jnp.asarray(want)
    np.testing.assert_allclose(
        tmg.prolong_const(got, tg, ratio).numpy(),
        np.asarray(jmg.prolong_const(coarse, jg, ratio)), rtol=0, atol=0)
    np.testing.assert_allclose(
        tmg.prolong_linear_mg(got, tg, ratio, tg.periodic).numpy(),
        np.asarray(jmg.prolong_linear_mg(coarse, jg, ratio, jg.periodic)),
        rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------------------
# smoothers without a kernel
# --------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["jacobi", "line"])
def test_relax_modes_match_jax(mode):
    jg, jb, tg, tb = _setup(GRID3, "NEUMANN", False)
    phi, rhs = _rand(tg.grid.shape, False, n=2)
    want = JOp(jg, jb).relax(jnp.asarray(phi), jnp.asarray(rhs), 1.0, -0.3,
                             2, mode)
    got = TOp(tg, tb).relax(torch.from_numpy(phi), torch.from_numpy(rhs),
                            1.0, -0.3, 2, mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


def test_relax_rejects_unknown_mode_and_none_is_identity():
    _, _, tg, tb = _setup(GRID2, "NEUMANN", False)
    op = TOp(tg, tb)
    phi = torch.zeros(tg.grid.shape)
    assert op.relax(phi, phi, 0.0, 1.0, 3, "none") is phi
    with pytest.raises(ValueError):
        op.relax(phi, phi, 0.0, 1.0, 1, "sor")


def test_norm_accumulates_in_float32():
    r = torch.from_numpy(_rand((6, 5), True))
    got = TOp.norm(r)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got),
                               np.sqrt(np.mean(r.numpy() ** 2)), rtol=1e-6)
    assert float(TOp.norm(r, 0)) == float(r.abs().max())


def test_level_modes_and_depth_match_jax():
    jg, jb, tg, tb = _setup(GRID2, "NEUMANN", False)
    jm, tm = jmg.LevelMultigrid(jg, jb), tmg.LevelMultigrid(tg, tb)
    assert tm.modes == jm.modes and tm.depth == jm.depth
    assert [o.grid.nx for o in tm.ops] == [o.grid.nx for o in jm.ops]
    # dz << dx: the vertical coupling dominates and 'auto' takes the line
    # smoother until semicoarsening has evened the spacings out
    _, _, tg, tb = _setup(dict(nx=(16, 16), dx=(0.5, 0.05)), "NEUMANN",
                          False)
    tm = tmg.LevelMultigrid(tg, tb)
    assert tm.modes[0] == "line" and tm.modes[3] == "gsrb"
    assert tmg.LevelMultigrid(
        tg, tb, tmg.MGParams(relax_mode="jacobi")).modes[0] == "jacobi"


# --------------------------------------------------------------------------
# V-cycles and solves
# --------------------------------------------------------------------------
def _solve_both(gridkw, bc_kind, f64, params, values=(0.0, 0.0), phi0=False,
                **solve_kw):
    """The same solve in both packages: (JAX phi, JAX info, port phi, port
    info, port op, folded port rhs norm reference pieces)."""
    with _x64(f64):
        jg, jb, tg, tb = _setup(gridkw, bc_kind, f64, values)
        rhs, guess = _rand(tg.grid.shape, f64, n=2)
        _, jdt, tdt = _dtypes(f64)
        jsolver = jmg.LevelMultigrid(jg, jb, jmg.MGParams(**params), jdt)
        jphi, jinfo = jsolver.solve(
            jnp.asarray(rhs), phi0=jnp.asarray(guess) if phi0 else None,
            **solve_kw)
        jphi = np.asarray(jphi)
        jinfo = (int(jinfo[0]), float(jinfo[1]))
    tsolver = tmg.LevelMultigrid(tg, tb, tmg.MGParams(**params), tdt)
    tphi, tinfo = tsolver.solve(
        torch.from_numpy(rhs),
        phi0=torch.from_numpy(guess) if phi0 else None, **solve_kw)
    return jphi, jinfo, tphi.numpy(), tinfo, tsolver, rhs


FIXED = dict(imin=2, imax=2, eps=0.0)


@pytest.mark.parametrize("f64,bottom", [(True, "smooth"),
                                        (False, "bicgstab")])
def test_fixed_vcycles_match_jax(f64, bottom):
    """Two V-cycles of the singular Neumann/periodic Poisson problem from a
    random guess: 1e-10 of max|phi| in f64, 1e-4 in f32 (the smoothers'
    roundings differ between the two packages and two V-cycles carry them
    through every level)."""
    jphi, jinfo, tphi, tinfo, _, _ = _solve_both(
        GRID3, "NEUMANN", f64, dict(FIXED, bottom_solver=bottom), phi0=True)
    assert tinfo[0] == jinfo[0] == 2
    tol = 1e-10 if f64 else 1e-4
    assert np.abs(tphi - jphi).max() <= tol * np.abs(jphi).max()
    np.testing.assert_allclose(tinfo[1], jinfo[1], rtol=1e-3)


def test_wcycle_and_const_prolongation_match_jax():
    jphi, jinfo, tphi, tinfo, _, _ = _solve_both(
        GRID2, "NEUMANN", True,
        dict(FIXED, bottom_solver="smooth", num_mg=2, prolong_order=0,
             relax_mode="jacobi"))
    assert tinfo[0] == jinfo[0] == 2
    assert np.abs(tphi - jphi).max() <= 1e-10 * np.abs(jphi).max()


def test_singular_poisson_solve_matches_jax_f64():
    """Equal V-cycle counts and phi to 1e-8 of max|phi| in f64."""
    jphi, jinfo, tphi, tinfo, _, _ = _solve_both(
        GRID3, "NEUMANN", True, dict(eps=1e-9, bottom_solver="smooth"))
    assert tinfo[0] == jinfo[0] and 2 < tinfo[0] < 20
    assert tinfo[1] <= 1e-9
    assert np.abs(tphi - jphi).max() <= 1e-8 * np.abs(jphi).max()
    assert abs(tphi.mean()) <= 1e-12 * np.abs(tphi).max()


def test_dirichlet_helmholtz_solve_matches_jax_f64():
    """Inhomogeneous Dirichlet values folded into the rhs
    (homogeneous=False), warm start, non-singular."""
    jphi, jinfo, tphi, tinfo, _, _ = _solve_both(
        GRID2, "DIRICHLET", True, dict(eps=1e-9, bottom_solver="smooth"),
        values=(0.3, -0.2), phi0=True, alpha=1.0, beta=-0.05,
        homogeneous=False, singular=False)
    assert tinfo[0] == jinfo[0] and tinfo[1] <= 1e-9
    assert np.abs(tphi - jphi).max() <= 1e-8 * np.abs(jphi).max()


@pytest.mark.parametrize("problem", ["poisson", "helmholtz"])
def test_solves_converge_like_jax_f32(problem):
    """Default parameters (BiCGStab bottom) in f32.  Both packages reach
    eps*||rhs|| and agree on phi to 1e-3 of max|phi|; the V-cycle counts
    may differ by one where a residual lands on the threshold, because the
    two packages sum the norm in different orders."""
    if problem == "poisson":
        args = (GRID3, "NEUMANN", False, dict(eps=1e-5, imax=12))
        kw = {}
    else:
        args = (GRID2, "DIRICHLET", False, dict(eps=1e-5, imax=12))
        kw = dict(values=(0.3, -0.2), alpha=1.0, beta=-0.05,
                  homogeneous=False, singular=False)
    jphi, jinfo, tphi, tinfo, solver, rhs = _solve_both(*args, **kw)
    assert jinfo[1] <= 1e-5 and tinfo[1] <= 1e-5
    assert abs(tinfo[0] - jinfo[0]) <= 1
    assert np.abs(tphi - jphi).max() <= 1e-3 * np.abs(jphi).max()
    # the port's own residual of what it returned, against ||rhs||
    op = solver.ops[0]
    alpha, beta = kw.get("alpha", 0.0), kw.get("beta", 1.0)
    r = torch.from_numpy(rhs)
    if problem == "poisson":
        r = op.compat_project(r)
    res = r - op.apply(torch.from_numpy(tphi), alpha, beta,
                       homogeneous=problem == "poisson")
    assert float(op.norm(res)) <= 1.5e-5 * float(op.norm(r))


def test_warm_start_below_target_runs_no_cycle():
    """||rhs|| is the convergence reference: a converged guess returns at
    once, with zero V-cycles, whatever imin says."""
    _, _, tg, tb = _setup(GRID3, "NEUMANN", False)
    solver = tmg.LevelMultigrid(tg, tb, tmg.MGParams(eps=1e-5, imax=12))
    rhs = torch.from_numpy(_rand(tg.grid.shape, False))
    phi, (its, rel) = solver.solve(rhs)
    again, (its2, rel2) = solver.solve(rhs, phi0=phi)
    assert its >= 2 and its2 == 0 and rel2 <= 1e-5
    assert again is phi or torch.equal(again, phi)


def test_bottom_params_match_jax():
    kw = dict(bottom_eps=1e-7, bottom_imax=33, bottom_hang=1e-6,
              bottom_small=1e-20, bottom_reps=1e-10, bottom_num_restarts=2,
              bottom_norm_type=0)
    jp = jmg.MGParams(**kw).bottom_params()
    tp = tmg.MGParams(**kw).bottom_params()
    for f in ("eps", "imax", "hang", "small", "num_restarts", "stall_iters",
              "reps", "norm_type"):
        assert getattr(tp, f) == getattr(jp, f), f
