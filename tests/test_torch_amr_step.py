"""The two-level AMR step as a whole in float64: the port's AMRHierarchy
against the JAX package's from the same state.

  * the 2D lock exchange 32x8 at ratio (4,1) and the 3D 16x8x8 at ratio
    (4,1,1), each base velocity perturbed by a seeded random field so
    that the composite initial projection has work to do;
  * the patch origin, interior and ext, and the initial patch state,
    equal to JAX's (1e-13);
  * after `init_project` (one composite projection) and after each of 2
    coarse steps, with the sync projection on and off, every field of
    both levels within 1e-8 of max|field| (float64; 1e-3 in float32,
    tests/test_torch_amr_step_f32.py).  Multigrid solves use the
    smoothing bottom (ROADMAP C.7) and dt is strongly typed (C.10); the
    JAX side is K = 1.

One JAX compile per case: the JAX package's `AMRHierarchy.advance` is its
base advance plus `_advance_recursive` (the subcycled patch and the
average-down) plus `_sync_project` (hierarchy.py:1176-1226); the two
halves are jitted apart, so the sync-off run is the first half alone.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from somar_tpu.amr.hierarchy import AMRHierarchy as JHierarchy
from somar_tpu.amr.tagging import TagParams as JTags
from somar_tpu.core.grid import Grid as JGrid
from somar_tpu.geometry.geo_source import CartesianMap as JCartesian
from somar_tpu.geometry.level_geometry import build_level_geometry as jgeo
from somar_tpu.physics.navier_stokes import NSParams as JParams
from somar_tpu.problems.lock_exchange import LockExchange as JLock
from somar_tpu.solvers.multigrid import MGParams as JMG

from somar_tpu_torch import entry
from somar_tpu_torch.solvers.multigrid import MGParams as TMG
from tests.torch_jax_reference import jax_unoptimized  # noqa: F401 (autouse)

torch.set_num_threads(1)

NSTEPS = 2
DT = 0.02
FIELDS = ("vel", "scalars", "lam", "mac_phi", "cc_phi", "pressure")
CASES = {2: ((32, None, 8), (4, 1)), 3: ((16, 8, 8), (4, 1, 1))}
PERTURB = 0.01


def _np(state):
    return {f: np.asarray(getattr(state, f)) for f in entry.STATE_FIELDS}


def _jax_hierarchy(ndim, jdtype, mg):
    (nx, ny, nz), ratio = CASES[ndim]
    if ndim == 2:
        grid = JGrid(nx=(nx, nz), dx=(15 / nx, 2 / nz), x0=(-7.5, 0.0))
        prob = JLock(pert_amp=0.0)
    else:
        grid = JGrid(nx=(nx, ny, nz), dx=(15 / nx, 2 / ny, 2 / nz),
                     x0=(-7.5, 0.0, 0.0), periodic=(False, True, False))
        prob = JLock()
    params = JParams(nu=1e-4, kappa=(1e-4,), gravity_method=1, cfl=0.9,
                     mg=JMG(**mg), dtype=jdtype)
    return JHierarchy(jgeo(grid, JCartesian(), dtype=jdtype), prob, params,
                      ratio=ratio,
                      tag_params=JTags(buoyancy_tag_tol=0.2, tags_grow=1))


def run_pair(ndim, prec):
    """Both packages through placement, init_project and NSTEPS coarse
    steps with the sync projection on and off.  Returns {stage: (JAX
    (base, patch) host fields, port's)} and the placements."""
    f64 = prec == "f64"
    jdtype = jnp.float64 if f64 else jnp.float32
    tdtype = torch.float64 if f64 else torch.float32
    mg = dict(bottom_solver="smooth") if f64 else {}
    jax.config.update("jax_enable_x64", f64)
    try:
        jh = _jax_hierarchy(ndim, jdtype, mg)
        (nx, ny, nz), ratio = CASES[ndim]
        th = entry.build_amr_hierarchy(nx, ny, nz, ratio, device="cpu",
                                       dtype=tdtype, mg=TMG(**mg))
        c = jh.couplings[0]
        assert c.K == 1 and not jh.multi_patch
        js0 = jh.level0.post_initialize(jh.level0.initial_state())
        base = _np(js0)
        rng = np.random.default_rng(1234 + ndim)
        base["vel"] = (base["vel"] + PERTURB * rng.normal(
            size=base["vel"].shape)).astype(base["vel"].dtype)
        js0 = type(js0)(**{f: jnp.asarray(v) for f, v in base.items()})
        ts0 = entry.ns_state_from_numpy(base, device="cpu", dtype=tdtype)
        (jf,), (jo,) = jh.initial_patch_states(js0)
        (tf,), (to,) = th.initial_patch_states(ts0)
        out = {"placed": ((base, _np(jf)), (entry.ns_state_to_numpy(ts0),
                                            entry.ns_state_to_numpy(tf)))}
        placement = {"jax": (np.asarray(jo), c.interior_nx, c.ext_nx),
                     "port": (to, th.couplings[0].interior_nx,
                              th.couplings[0].ext_nx)}
        js0, (jf,) = jh.init_project(js0, (jf,), (jo,))
        ts0, (tf,) = th.init_project(ts0, tf, to)
        out["init_project"] = ((_np(js0), _np(jf)),
                               (entry.ns_state_to_numpy(ts0),
                                entry.ns_state_to_numpy(tf)))

        def first_half(s0, sf, o, dt):
            fs = [sf]
            s1 = jh.level0.advance(s0, dt)
            s1 = jh._advance_recursive(0, s0, s1, fs, [o], dt, None,
                                       parent_level=jh.level0)
            return s1, fs[0]

        def sync(s0, sf, o):
            fs = [sf]
            return jh._sync_project(s0, fs, [o]), fs[0]

        jadv, jsync = jax.jit(first_half), jax.jit(sync)
        dt = jnp.asarray(DT, jdtype)
        for on in (True, False):
            th.do_sync_projection = on
            a0, af, b0, bf = js0, jf, ts0, tf
            for i in range(NSTEPS):
                a0, af = jadv(a0, af, jo, dt)
                if on:
                    a0, af = jsync(a0, af, jo)
                b0, bf = th.advance(b0, bf, to, DT)
                out[f"sync {'on' if on else 'off'} step {i + 1}"] = (
                    (_np(a0), _np(af)), (entry.ns_state_to_numpy(b0),
                                         entry.ns_state_to_numpy(bf)))
        return out, placement
    finally:
        jax.config.update("jax_enable_x64", False)


def check_stage(stage, tol):
    (jb, jf), (tb, tf) = stage
    for level, want, got in (("base", jb, tb), ("patch", jf, tf)):
        for f in FIELDS:
            scale = np.abs(want[f]).max()
            err = np.abs(got[f] - want[f]).max()
            assert err <= tol * max(scale, 1e-30), (level, f, err, scale)
        np.testing.assert_allclose(got["time"], want["time"], rtol=1e-6)


STAGES = ["placed", "init_project"] + [
    f"sync {s} step {i}" for s in ("on", "off") for i in range(1, NSTEPS + 1)]


@pytest.fixture(scope="module")
def runs():
    return {ndim: run_pair(ndim, "f64") for ndim in CASES}


@pytest.mark.parametrize("ndim", list(CASES))
def test_placement_matches_jax(runs, ndim):
    _, placement = runs[ndim]
    jo, jint, jext = placement["jax"]
    to, tint, text = placement["port"]
    np.testing.assert_array_equal(to, jo)
    assert (tint, text) == (jint, jext)


@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("ndim", list(CASES))
def test_amr_step_matches_jax_f64(runs, ndim, stage):
    out, _ = runs[ndim]
    check_stage(out[stage], 1e-13 if stage == "placed" else 1e-8)


@pytest.mark.parametrize("ndim", list(CASES))
def test_sync_projection_changes_the_patch(runs, ndim):
    """The sync projection corrects the patch velocity directly."""
    out, _ = runs[ndim]
    on = out[f"sync on step {NSTEPS}"][1][1]["vel"]
    off = out[f"sync off step {NSTEPS}"][1][1]["vel"]
    assert np.abs(on - off).max() > 1e-6 * np.abs(on).max()
