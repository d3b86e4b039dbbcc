"""The users of the port's multigrid stack against the JAX package's, on the
CPU, from the same seeded numpy inputs: BiCGStab, the projector with
method "mg" and "bicgstab", and the Crank-Nicolson / TGA updates through multigrid where the BC values leave no spectral path.

The JAX package's BiCGStab cannot run under jax_enable_x64 (see
tests/test_torch_multigrid.py), so it is compared in float32; in float64
the port's BiCGStab is held to a dense solve of the same operator.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from somar_tpu.core import bc as jbc
from somar_tpu.core.grid import Grid as JGrid
from somar_tpu.geometry.geo_source import CartesianMap as JCartesian
from somar_tpu.geometry.level_geometry import build_level_geometry as jgeo
from somar_tpu.projection.projector import LevelProjector as JProjector
from somar_tpu.solvers import bicgstab as jbi
from somar_tpu.solvers.multigrid import MGParams as JMG
from somar_tpu.solvers.parabolic import make_heat_solver as jheat
from somar_tpu.solvers.poisson_op import PoissonOp as JOp

from somar_tpu_torch.core import bc as tbc
from somar_tpu_torch.core.grid import Grid as TGrid
from somar_tpu_torch.geometry.geo_source import CartesianMap as TCartesian
from somar_tpu_torch.geometry.level_geometry import build_level_geometry as tgeo
from somar_tpu_torch.ops.stencil import mac_divergence
from somar_tpu_torch.projection.projector import LevelProjector as TProjector
from somar_tpu_torch.solvers import bicgstab as tbi
from somar_tpu_torch.solvers.host_reads import read_scalars
from somar_tpu_torch.solvers.multigrid import MGParams as TMG
from somar_tpu_torch.solvers.parabolic import make_heat_solver as theat
from somar_tpu_torch.solvers.poisson_op import PoissonOp as TOp
from tests.torch_jax_reference import jax_unoptimized  # noqa: F401 (autouse)

torch.set_num_threads(1)

GRID3 = dict(nx=(16, 8, 8), dx=(15 / 16, 2 / 8, 2 / 8),
             periodic=(False, True, False))
GRID2 = dict(nx=(16, 16), dx=(1 / 16, 1.5 / 16), periodic=(False, False))


def _bcs(mod, grid, kind, values=(0.0, 0.0)):
    side = lambda v: tuple(
        mod.BC.periodic() if p else mod.BC(mod.BCType[kind], value=v)
        for p in grid.periodic)
    return mod.FieldBCs(lo=side(values[0]), hi=side(values[1]))


def _setup(gridkw, kind, values=(0.0, 0.0), dtype=torch.float32):
    jg, tg = JGrid(**gridkw), TGrid(**gridkw)
    return (jgeo(jg, JCartesian()), _bcs(jbc, jg, kind, values),
            tgeo(tg, TCartesian(), device="cpu", dtype=dtype),
            _bcs(tbc, tg, kind, values))


def _rand(shape, seed=11, n=1, dtype=np.float32):
    rng = np.random.default_rng(seed)
    out = [rng.standard_normal(shape).astype(dtype) for _ in range(n)]
    return out[0] if n == 1 else out


# --------------------------------------------------------------------------
# BiCGStab
# --------------------------------------------------------------------------
@pytest.mark.parametrize("kind,precond", [("DIRICHLET", False),
                                          ("DIRICHLET", True),
                                          ("NEUMANN", True)])
def test_bicgstab_matches_jax_f32(kind, precond):
    """Same iteration in both packages; both stop at eps = 1e-6 of the
    initial residual, and the solutions agree to 1e-4 of max|x| (f32
    Krylov recurrences amplify the two packages' different summation
    orders)."""
    jg, jb, tg, tb = _setup(GRID2, kind)
    jop, top = JOp(jg, jb), TOp(tg, tb)
    singular = kind == "NEUMANN"
    rhs = _rand(tg.grid.shape)
    if singular:
        rhs = rhs - rhs.mean()
    jM = tM = None
    if precond:
        jM = lambda v: jop.relax(jnp.zeros_like(v), v, 0.0, 1.0, 2, "gsrb")
        tM = lambda v: top.relax(torch.zeros_like(v), v, 0.0, 1.0, 2, "gsrb")
    jx, (jit, jrel) = jbi.bicgstab(jop.apply, jnp.asarray(rhs), M=jM,
                                   remove_mean=singular)
    tx, (tit, trel) = tbi.bicgstab(top.apply, torch.from_numpy(rhs), M=tM,
                                   remove_mean=singular)
    assert isinstance(tit, int) and isinstance(trel, float)
    assert trel <= 1e-6 and float(jrel) <= 1e-6
    # unpreconditioned, the count itself wanders by a few with the rounding
    assert abs(tit - int(jit)) <= max(2, 0.15 * int(jit))
    scale = np.abs(np.asarray(jx)).max()
    assert np.abs(tx.numpy() - np.asarray(jx)).max() <= 1e-4 * scale


def test_bicgstab_f64_matches_dense_solve():
    _, _, tg, tb = _setup(GRID2, "DIRICHLET", dtype=torch.float64)
    op = TOp(tg, tb)
    shape = tg.grid.shape
    n = int(np.prod(shape))
    eye = torch.eye(n, dtype=torch.float64).reshape((n,) + shape)
    mat = torch.stack([op.apply(e, 0.3, -1.0).reshape(-1) for e in eye],
                      dim=1).numpy()
    rhs = _rand(shape, dtype=np.float64)
    want = np.linalg.solve(mat, rhs.reshape(-1)).reshape(shape)
    before = read_scalars.count
    x, (its, rel) = tbi.bicgstab(
        lambda v: op.apply(v, 0.3, -1.0), torch.from_numpy(rhs),
        params=tbi.BiCGStabParams(eps=1e-10, imax=200))
    assert x.dtype == torch.float64 and rel <= 1e-10
    assert np.abs(x.numpy() - want).max() <= 1e-8 * np.abs(want).max()
    # one read before the loop and one per iteration (more only on restart)
    assert its + 1 <= read_scalars.count - before <= its + 1 + 6


def test_bicgstab_stops_at_imax_and_on_zero_rhs():
    _, _, tg, tb = _setup(GRID2, "DIRICHLET")
    op = TOp(tg, tb)
    rhs = torch.from_numpy(_rand(tg.grid.shape))
    _, (its, rel) = tbi.bicgstab(op.apply, rhs,
                                 params=tbi.BiCGStabParams(imax=3))
    assert its == 3 and rel > 1e-6
    x, (its, _) = tbi.bicgstab(op.apply, torch.zeros_like(rhs))
    assert its == 0 and float(x.abs().max()) == 0.0


# --------------------------------------------------------------------------
# projector
# --------------------------------------------------------------------------
def _fluxes(grid, seed=21):
    """Random MAC fluxes with no flow through the walls (so that their
    divergence lies in the range of the Neumann operator)."""
    rng = np.random.default_rng(seed)
    out = []
    for d in range(grid.ndim):
        f = rng.standard_normal(grid.fc_shape(d)).astype(np.float32)
        ax = grid.axis(d)
        if grid.periodic[d]:    # one value per periodic face pair
            np.moveaxis(f, ax, 0)[-1] = np.moveaxis(f, ax, 0)[0]
        else:
            np.moveaxis(f, ax, 0)[[0, -1]] = 0.0
        out.append(f)
    return out


@pytest.mark.parametrize("method", ["mg", "bicgstab"])
def test_project_mac_matches_jax(method):
    """The projected fluxes are discretely divergence-free to the solver's
    tolerance in both packages, and agree to 1e-3 of max|flux| (the
    solvers stop at a tolerance, so the two potentials differ by about
    eps)."""
    jg, _, tg, _ = _setup(GRID3, "NEUMANN")
    # bottom_*: BiCGStab as the pressure solver takes its knobs from there;
    # unpreconditioned, it needs a few hundred iterations on this grid
    mgp = dict(eps=1e-6, imax=15, bottom_eps=1e-7, bottom_imax=600)
    jp = JProjector(jg, JMG(**mgp), method=method)
    tp = TProjector(tg, TMG(**mgp), method=method)
    assert tp.method == method and tp.singular
    fl = _fluxes(tg.grid)
    jout, jphi, jinfo = jp.project_mac(tuple(map(jnp.asarray, fl)))
    tout, tphi, tinfo = tp.project_mac(tuple(map(torch.from_numpy, fl)))
    div0 = float(mac_divergence(tuple(map(torch.from_numpy, fl)),
                                tg).abs().max())
    tdiv = float(mac_divergence(tout, tg).abs().max())
    jdiv = float(mac_divergence(
        tuple(torch.tensor(np.asarray(f)) for f in jout), tg).abs().max())
    assert tdiv <= 1e-4 * div0 and jdiv <= 1e-4 * div0
    assert isinstance(tinfo[0], int) and tinfo[0] > 1
    for t, j in zip(tout, jout):
        assert np.abs(t.numpy() - np.asarray(j)).max() \
            <= 1e-3 * np.abs(np.asarray(j)).max()
    scale = np.abs(np.asarray(jphi)).max()
    assert np.abs(tphi.numpy() - np.asarray(jphi)).max() <= 1e-3 * scale
    # the warm start: the converged potential needs no further cycle
    if method == "mg":
        _, _, again = tp.project_mac(tuple(map(torch.from_numpy, fl)),
                                     phi0=tphi)
        assert again[0] == 0


def test_project_cc_mg_matches_jax_and_purpose_params():
    jg, _, tg, _ = _setup(GRID3, "NEUMANN")
    loose, tight = dict(eps=1e-2, imax=15), dict(eps=1e-6, imax=15)
    jp = JProjector(jg, JMG(**loose), method="mg",
                    mg_params_by_purpose={"cc": JMG(**tight)})
    tp = TProjector(tg, TMG(**loose), method="mg",
                    mg_params_by_purpose={"cc": TMG(**tight)})
    vel = np.stack(_rand(tg.grid.shape, seed=4, n=3))
    noslip = lambda mod, g: tuple(_bcs(mod, g, "DIRICHLET")
                                  for _ in range(3))
    jv, jphi, jinfo = jp.project_cc(jnp.asarray(vel), noslip(jbc, jg.grid))
    tv, tphi, tinfo = tp.project_cc(torch.from_numpy(vel),
                                    noslip(tbc, tg.grid))
    assert tinfo[1] <= 1e-6 and float(jinfo[1]) <= 1e-6
    assert tp._mg_for("cc") is not tp._mg_for("mac")
    assert tp._mg_for("mac").params.eps == 1e-2
    assert np.abs(tv.numpy() - np.asarray(jv)).max() \
        <= 1e-3 * np.abs(np.asarray(jv)).max()


def test_projector_auto_takes_mg_without_a_spectral_path(monkeypatch):
    from somar_tpu_torch.projection import projector as mod
    _, _, tg, _ = _setup(GRID2, "NEUMANN")
    assert TProjector(tg).method == "fft"
    monkeypatch.setattr(mod.FFTPoissonSolver, "supports",
                        staticmethod(lambda geo, bcs: False))
    assert TProjector(tg).method == "mg"
    # "auto" never picks the leptic solver; asked for, it is built
    assert TProjector(tg, method="leptic").method == "leptic"
    with pytest.raises(ValueError):
        TProjector(tg, method="sor")


# --------------------------------------------------------------------------
# heat solvers off the spectral path
# --------------------------------------------------------------------------
@pytest.mark.parametrize("scheme", [1, 2], ids=["CN", "TGA"])
def test_heat_update_through_mg_matches_jax(scheme):
    """Inhomogeneous Dirichlet values have no spectral path: the update is
    one (CN) or two (TGA) multigrid Helmholtz solves.  1e-4 of max|s|
    in f32: both stop at eps = 1e-6 of ||rhs||."""
    jg, jb, tg, tb = _setup(GRID2, "DIRICHLET", values=(0.3, -0.2))
    js, ts = jheat(scheme, jg, jb, 0.05), theat(scheme, tg, tb, 0.05)
    assert ts._fft is None and js._fft is None
    s, src = _rand(tg.grid.shape, seed=8, n=2)
    want, jinfo = js.update(jnp.asarray(s), jnp.asarray(src), 0.1)
    got, tinfo = ts.update(torch.from_numpy(s), torch.from_numpy(src), 0.1)
    assert tinfo[0] >= 1 and tinfo[1] <= 1e-6
    scale = np.abs(np.asarray(want)).max()
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-4 * scale
    want2, _ = js.update(jnp.asarray(s), None, 0.1)
    got2, _ = ts.update(torch.from_numpy(s), None, 0.1)
    assert np.abs(got2.numpy() - np.asarray(want2)).max() <= 1e-4 * scale


def test_backward_euler_through_mg_solves_its_equation():
    """Without JAX: (I - dt kappa L) s_new = s + dt src with the
    inhomogeneous Dirichlet operator, to the solver's tolerance."""
    _, _, tg, tb = _setup(GRID2, "DIRICHLET", values=(0.3, -0.2))
    solver = theat(0, tg, tb, 0.05)
    assert solver._fft is None
    s, src = (torch.from_numpy(a)
              for a in _rand(tg.grid.shape, seed=8, n=2))
    new, (its, rel) = solver.update(s, src, 0.1)
    rhs = s + 0.1 * src
    res = rhs - TOp(tg, tb).apply(new, 1.0, -0.1 * 0.05, homogeneous=False)
    assert its >= 1 and rel <= 1e-6
    assert float(res.abs().max()) <= 1e-4 * float(rhs.abs().max())
