"""The multigrid-forced step as a whole: the port's NSLevel.advance with
pressure_solver="mg" against the JAX package's from the same state.

  * 3D lock exchange 16x8x8 with MGParams(eps=1e-5, imax=12), after 1 and
    3 steps: max|diff| <= 1e-3 max|field| in f32.  Looser than the spectral
    step's 1e-4 because multigrid stops at a tolerance: the two packages'
    potentials may differ by up to eps * ||rhs|| each solve.  In f64
    <= 1e-8, with the smoothing bottom solver (the JAX package's BiCGStab
    cannot run under jax_enable_x64, see tests/test_torch_multigrid.py);
  * without JAX: the port's MG step against the port's spectral step (both
    solve the same Poisson problems), f64 with eps = 1e-8, 1e-6 after 3
    steps;
  * the per-component viscous solvers that replace the batched spectral one
    where a velocity component has no spectral path.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from somar_tpu.core.grid import Grid as JGrid
from somar_tpu.geometry.geo_source import CartesianMap as JCartesian
from somar_tpu.geometry.level_geometry import build_level_geometry as jgeo
from somar_tpu.physics.navier_stokes import NSLevel as JLevel
from somar_tpu.physics.navier_stokes import NSParams as JParams
from somar_tpu.problems.lock_exchange import LockExchange as JLock
from somar_tpu.solvers.multigrid import MGParams as JMG

from somar_tpu_torch import entry
from somar_tpu_torch.solvers.host_reads import read_scalars
from somar_tpu_torch.solvers.multigrid import MGParams as TMG

torch.set_num_threads(1)

FIELDS = ("vel", "scalars", "lam", "pressure")
NSTEPS = 3
DT = 0.02
TOL = {"f32": 1e-3, "f64": 1e-8}
MG = {"f32": dict(eps=1e-5, imax=12),
      "f64": dict(eps=1e-5, imax=12, bottom_solver="smooth")}


def _np_state(state):
    return {f: np.asarray(getattr(state, f)) for f in entry.STATE_FIELDS}


def _trajectories(prec):
    """States after each of NSTEPS steps, JAX and port, from the JAX
    package's post-initialized state."""
    jdtype = jnp.float64 if prec == "f64" else jnp.float32
    tdtype = torch.float64 if prec == "f64" else torch.float32
    jax.config.update("jax_enable_x64", prec == "f64")
    try:
        grid = JGrid(nx=(16, 8, 8), dx=(15 / 16, 2 / 8, 2 / 8),
                     x0=(-7.5, 0.0, 0.0), periodic=(False, True, False))
        params = JParams(nu=1e-4, kappa=(1e-4,), gravity_method=1, cfl=0.9,
                         pressure_solver="mg", mg=JMG(**MG[prec]),
                         dtype=jdtype)
        jl = JLevel(jgeo(grid, JCartesian(), dtype=jdtype), JLock(), params)
        js = jl.post_initialize(jl.initial_state())
        tl, _ = entry.build_level(nx=16, nz=8, ny=8, device="cpu",
                                  dtype=tdtype, pressure_solver="mg",
                                  mg=TMG(**MG[prec]))
        assert tl.projector.method == "mg"
        ts = entry.ns_state_from_numpy(_np_state(js), device="cpu",
                                       dtype=tdtype)
        step = jax.jit(lambda s, d: jl.advance(s, d))
        out = []
        for _ in range(NSTEPS):
            js = step(js, jnp.asarray(DT, jdtype))
            ts = tl.advance(ts, DT)
            out.append((_np_state(js), entry.ns_state_to_numpy(ts)))
        return out
    finally:
        jax.config.update("jax_enable_x64", False)


@pytest.fixture(scope="module")
def trajectories():
    return {prec: _trajectories(prec) for prec in ("f32", "f64")}


@pytest.mark.parametrize("after", [1, NSTEPS])
@pytest.mark.parametrize("prec", ["f32", "f64"])
def test_mg_lock_exchange_step_matches_jax(trajectories, prec, after):
    want, got = trajectories[prec][after - 1]
    assert got["vel"].dtype == (np.float64 if prec == "f64" else np.float32)
    # the projection potentials themselves are only good to the solver's
    # tolerance; in f64 with fixed smoothing they follow to roundoff
    for f in FIELDS + (("mac_phi", "cc_phi") if prec == "f64" else ()):
        scale = np.abs(want[f]).max()
        err = np.abs(got[f] - want[f]).max()
        assert err <= TOL[prec] * scale, (prec, after, f, err, scale)
    np.testing.assert_allclose(got["time"], want["time"], rtol=1e-6)


def test_mg_step_matches_spectral_step_f64():
    """No JAX involved: multigrid at eps = 1e-8 and the direct spectral
    solve answer the same Poisson problems."""
    kw = dict(nx=16, nz=8, ny=8, device="cpu", dtype=torch.float64)
    spectral, _ = entry.build_level(**kw)
    mg, _ = entry.build_level(pressure_solver="mg",
                              mg=TMG(eps=1e-8, imax=30), **kw)
    s0 = spectral.post_initialize(spectral.initial_state())
    sa = sb = s0
    for _ in range(NSTEPS):
        sa = spectral.advance(sa, DT)
        sb = mg.advance(sb, DT)
    for f in FIELDS:
        a, b = getattr(sa, f), getattr(sb, f)
        assert float((a - b).abs().max()) <= 1e-6 * float(a.abs().max()), f
    assert float(mg.max_divergence(sb)) < 10 * float(
        spectral.max_divergence(sa)) + 1e-9


def test_entry_run_mg_counts_host_reads():
    """One step of the MG level: finite fields, and the
    solvers' reads (one per V-cycle and per BiCGStab iteration) on top of
    compute_dt's one per step."""
    level, _ = entry.build_level(nx=16, nz=8, ny=8, device="cpu",
                                 pressure_solver="mg",
                                 mg=TMG(eps=1e-5, imax=12))
    state = level.post_initialize(level.initial_state())
    before = read_scalars.count
    state = level.advance(state, DT)
    solver_reads = read_scalars.count - before
    level.compute_dt(state)
    assert read_scalars.count - before == solver_reads + 1
    assert solver_reads >= 2 * 2     # two solves, each at least two reads
    for f in FIELDS:
        assert torch.isfinite(getattr(state, f)).all(), f


def test_bicgstab_pressure_solver_steps():
    level, _ = entry.build_level(nx=16, nz=8, ny=8, device="cpu",
                                 pressure_solver="bicgstab",
                                 mg=TMG(bottom_imax=400))
    ref, _ = entry.build_level(nx=16, nz=8, ny=8, device="cpu")
    s0 = ref.post_initialize(ref.initial_state())
    a, b = ref.advance(s0, DT), level.advance(s0, DT)
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert float((x - y).abs().max()) <= 1e-3 * float(x.abs().max()), f


def test_viscous_solves_without_spectral_path_go_per_component():
    """Where a velocity component's viscous BCs have no spectral path the
    per-component heat solvers (multigrid) replace the batched spectral
    solve: same step to 1e-4 of max|field| (the Helmholtz solves stop at
    eps = 1e-6 of ||rhs||)."""
    kw = dict(nx=16, nz=8, ny=8, device="cpu")
    ref, _ = entry.build_level(**kw)
    lvl, _ = entry.build_level(**kw)
    assert lvl._visc_batched is not None
    for hs in lvl.visc_solvers:
        hs._fft = None
    lvl._visc_batched = None
    s0 = ref.post_initialize(ref.initial_state())
    a, b = ref.advance(s0, DT), lvl.advance(s0, DT)
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert float((x - y).abs().max()) <= 1e-4 * float(x.abs().max()), f
