"""The multigrid line smoother's tridiagonal solve, parallel cyclic
reduction (`solvers/tridiag.pcr_factor` / `pcr_apply`), against the JAX
package's Thomas solve on seeded diagonally dominant systems of 1 to 128
planes (float32 at 1e-5, float64 at 1e-12 of max|x|), and the vertical
line relaxation built on it against the JAX package's in float64
(1e-12): a Poisson and a Helmholtz relaxation on a stretched 2D level and
a Poisson one on a 3D level, whose factorization the second call of the
same coefficients reuses."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from somar_tpu.core import bc as jbc
from somar_tpu.core.grid import Grid as JGrid
from somar_tpu.geometry.geo_source import StretchedCartesianMap as JStretch
from somar_tpu.geometry.level_geometry import build_level_geometry as jgeo
from somar_tpu.solvers import tridiag as jtri
from somar_tpu.solvers.poisson_op import PoissonOp as JOp

from somar_tpu_torch.core import bc as tbc
from somar_tpu_torch.core.grid import Grid as TGrid
from somar_tpu_torch.geometry.geo_source import StretchedCartesianMap
from somar_tpu_torch.geometry.level_geometry import build_level_geometry
from somar_tpu_torch.solvers import tridiag as ttri
from somar_tpu_torch.solvers.poisson_op import PoissonOp as TOp
from tests.torch_jax_reference import jax_unoptimized  # noqa: F401 (autouse)

torch.set_num_threads(1)

TOL = {np.float32: 1e-5, np.float64: 1e-12}


def _system(n, dtype, seed):
    rng = np.random.default_rng(seed)
    shape = (n, 5, 7)
    a, c, d = (rng.standard_normal(shape) for _ in range(3))
    sign = np.where(rng.random(shape) > 0.5, 1.0, -1.0)
    b = sign * (np.abs(a) + np.abs(c) + 0.1 + rng.random(shape))
    return [x.astype(dtype) for x in (a, b, c, d)]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n", [1, 2, 3, 7, 16, 31, 128])
def test_pcr_matches_jax_thomas(n, dtype):
    a, b, c, d = _system(n, dtype, n)
    jax.config.update("jax_enable_x64", dtype == np.float64)
    try:
        want = np.asarray(jtri.thomas_solve(*map(jnp.asarray, (a, b, c, d))))
    finally:
        jax.config.update("jax_enable_x64", False)
    t = [torch.from_numpy(x) for x in (a, b, c, d)]
    got = ttri.pcr_apply(ttri.pcr_factor(*t[:3]), t[3]).numpy()
    assert got.dtype == dtype
    assert np.abs(got - want).max() <= TOL[dtype] * np.abs(want).max()


def _stretch(ndim):
    f = lambda x: x + 0.2 * np.sin(x)
    g = lambda z: z + 0.05 * np.sin(2.0 * z)
    return [f] * (ndim - 1) + [g]


LEVELS = {"2d": ((32, 16), 2), "3d": ((8, 6, 16), 3)}


@pytest.mark.parametrize("level, coefs", [("2d", (0.0, 1.0)),
                                          ("2d", (1.0, -0.3)),
                                          ("3d", (0.0, 1.0))],
                         ids=["2d-poisson", "2d-helmholtz", "3d-poisson"])
def test_line_relaxation_matches_jax(level, coefs):
    nx, ndim = LEVELS[level]
    kw = dict(nx=nx, dx=tuple(1.0 / n for n in nx))
    rng = np.random.default_rng(11)
    phi, rhs = (rng.standard_normal(tuple(reversed(nx))) for _ in range(2))
    lo = ["DIRICHLET"] + ["NEUMANN"] * (ndim - 1)
    hi = ["NEUMANN"] * ndim
    jb = jbc.FieldBCs(lo=tuple(jbc.BC(getattr(jbc.BCType, t)) for t in lo),
                      hi=tuple(jbc.BC(getattr(jbc.BCType, t)) for t in hi))
    tb = tbc.FieldBCs(lo=tuple(tbc.BC(getattr(tbc.BCType, t)) for t in lo),
                      hi=tuple(tbc.BC(getattr(tbc.BCType, t)) for t in hi))
    alpha, beta = coefs
    jax.config.update("jax_enable_x64", True)
    try:
        jop = JOp(jgeo(JGrid(**kw), JStretch(_stretch(ndim)),
                       dtype=jnp.float64), jb)
        want = np.asarray(jop.relax(jnp.asarray(phi), jnp.asarray(rhs),
                                    alpha, beta, 2, "line"))
    finally:
        jax.config.update("jax_enable_x64", False)
    top = TOp(build_level_geometry(TGrid(**kw),
                                   StretchedCartesianMap(_stretch(ndim)),
                                   device="cpu", dtype=torch.float64), tb)
    for _ in range(2):      # the second call reuses the factorization
        got = top.relax(torch.from_numpy(phi), torch.from_numpy(rhs),
                        alpha, beta, 2, "line").numpy()
        assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    assert top._line_factor[0] == (alpha, beta)
