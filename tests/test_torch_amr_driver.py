"""AMR decks through the port's RunDriver, its checkpoints and plot files,
against the JAX package's, on the CPU:

  * tests/test_driver_io.py's AMR_CFG deck (2D 48x16, ratio (4,1),
    regrids every 2 steps) with amr.fixed_dt unset and amr.max_dt = 0.05
    (so the first dt is init_dt_multiplier x 0.05 and the next come from
    level_dts, ROADMAP C.10), checkpoints and plot files every 2 steps,
    through JAX's RunDriver (the one jitted JAX hierarchy of these tests)
    and the port's for 4 steps: the same step count, dt sequence (1e-6),
    dynamic-subcycling factors, origins in every checkpoint, files, and
    fields of both levels within 1e-3 of max|field| (float32 multigrid
    stops at a tolerance);
  * checkpoints both ways: each package reads the other's files of that
    run, and of a K = 2 hierarchy (the two lumps of tests/test_amr.py:
    504-531 on that grid, float64), with every array bitwise equal and
    the same origins, weights and parent selections;
  * the Chombo plot files of both runs and of the K = 2 hierarchy: the
    same fine-level boxes (one per active patch interior) and data within
    1e-3 of max|component| (the runs' float32 multigrid), the K = 2
    checkpoints' Chombo views with the same boxes, offsets and data;
  * the port's exact resume: the two-lump deck (K doubled from 1 to 2 at
    placement, regrids every 2 steps) restarted from its step-2
    checkpoint equals the run without a break bitwise, K, footprint,
    origins and weights included;
  * dynamic subcycling through the port's RunDriver: chip_smoke's
    R0_SUBCYCLED deck takes the factor 2 on its first coarse step and 1
    after, and counts the refined level's cell updates with it (the step
    itself at nt_mults = (2,) is held against JAX by
    tests/test_torch_amr_multipatch.py).
"""

import h5py
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from somar_tpu.amr.hierarchy import AMRHierarchy as JHierarchy
from somar_tpu.amr.tagging import TagParams as JTags
from somar_tpu.config.context import ProblemContext as JContext
from somar_tpu.config.parmparse import ParmParse as JPP
from somar_tpu.core.grid import Grid as JGrid
from somar_tpu.driver import RunDriver as JDriver
from somar_tpu.geometry.geo_source import CartesianMap as JCartesian
from somar_tpu.geometry.level_geometry import build_level_geometry as jgeo
from somar_tpu.io import checkpoint as jck
from somar_tpu.physics.navier_stokes import NSParams as JParams
from somar_tpu.physics.navier_stokes import NSState as JState
from somar_tpu.problems.lock_exchange import LockExchange as JLock
from somar_tpu.solvers.multigrid import MGParams as JMG

from somar_tpu_torch import entry
from somar_tpu_torch.config.context import ProblemContext as TContext
from somar_tpu_torch.config.parmparse import ParmParse as TPP
from somar_tpu_torch.driver import RunDriver as TDriver
from somar_tpu_torch.io import checkpoint as tck
from tests.test_driver_io import AMR_CFG
from tests.torch_jax_reference import jax_unoptimized  # noqa: F401 (autouse)

torch.set_num_threads(1)

DECK = AMR_CFG + """
amr.fixed_dt = -1
amr.max_dt = 0.05
plot.plot_interval = 2
plot.checkpoint_interval = 2
"""
FIELDS = ("vel", "scalars", "lam", "pressure")


def _times(driver):
    times = []
    driver.scheduler.schedule(lambda step, t, s: times.append(float(t)),
                              step_interval=1)
    return times


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both RunDrivers on DECK: (JAX driver, its times, its dir), (port
    driver, its times, its dir), (JAX state, port state)."""
    jdir = tmp_path_factory.mktemp("jax")
    tdir = tmp_path_factory.mktemp("port")
    jd = JDriver(JContext.from_parmparse(JPP.from_string(DECK)),
                 out_dir=str(jdir))
    jt = _times(jd)
    js, jsteps = jd.run(verbose=False)
    td = TDriver(TContext.from_parmparse(TPP.from_string(DECK)),
                 out_dir=str(tdir), device="cpu")
    tt = _times(td)
    ts, tsteps = td.run(verbose=False)
    assert jsteps == tsteps == 4
    return (jd, jt, jdir), (td, tt, tdir), (js, ts)


def _np(state):
    return {f: np.asarray(getattr(state, f)) for f in entry.STATE_FIELDS}


def _fields_close(want, got, tol):
    for f in FIELDS:
        w, g = np.asarray(want[f]), np.asarray(got[f])
        assert g.shape == w.shape, f
        assert np.abs(g - w).max() <= tol * max(np.abs(w).max(), 1e-30), f


def test_amr_deck_matches_jax_driver(runs):
    (jd, jt, jdir), (td, tt, tdir), (js, ts) = runs
    np.testing.assert_allclose(np.diff([0.0] + tt), np.diff([0.0] + jt),
                               rtol=1e-6)
    assert td.nt_mults == [(1,)] * 4
    assert [r["step"] for r in td.regrids] == [2, 4]
    _fields_close(_np(js), entry.ns_state_to_numpy(ts), 1e-3)
    assert sorted(p.name for p in tdir.iterdir()) == sorted(
        p.name for p in jdir.iterdir())
    jg = [c.ext_grid for c in jd.hierarchy.couplings]
    tg = [c.ext_grid for c in td.hierarchy.couplings]
    for name in ("chkpt_000002.hdf5", "chkpt_000004.hdf5",
                 "chkpt_final.hdf5"):
        want = jck.read_checkpoint(str(jdir / name), jd.level, fine_grid=jg)
        got = tck.read_checkpoint(str(tdir / name), td.level, fine_grid=tg)
        assert got[1] == want[1]
        np.testing.assert_allclose(got[2], want[2], rtol=1e-6)
        np.testing.assert_array_equal(got[4][0], np.asarray(want[4][0]))
        assert got[5] == want[5] == (None,)
        _fields_close(_np(want[0]), entry.ns_state_to_numpy(got[0]), 1e-3)
        _fields_close(_np(want[3][0]), entry.ns_state_to_numpy(got[3][0]),
                      1e-3)


@pytest.mark.parametrize("way", ["port reads jax", "jax reads port"])
def test_amr_checkpoints_cross_between_packages(runs, way):
    (jd, _, jdir), (td, _, tdir), _ = runs
    jg = [c.ext_grid for c in jd.hierarchy.couplings]
    tg = [c.ext_grid for c in td.hierarchy.couplings]
    path = str((jdir if way == "port reads jax" else tdir)
               / "chkpt_000004.hdf5")
    want = jck.read_checkpoint(path, jd.level, fine_grid=jg)
    got = tck.read_checkpoint(path, td.level, fine_grid=tg)
    assert got[1:3] == want[1:3]
    for a, b in ((want[0], got[0]), (want[3][0], got[3][0])):
        for f in entry.STATE_FIELDS:
            np.testing.assert_array_equal(getattr(b, f).numpy(),
                                          np.asarray(getattr(a, f)), f)
    np.testing.assert_array_equal(got[4][0], np.asarray(want[4][0]))


def _boxes(path):
    with h5py.File(path, "r") as f:
        return {k: (f[k]["boxes"][...], f[k]["data:datatype=0"][...])
                for k in f if k.startswith("level_")}


def _same_plots(a, b):
    pa, pb = _boxes(a), _boxes(b)
    assert sorted(pa) == sorted(pb) == ["level_0", "level_1"]
    for k in pa:
        np.testing.assert_array_equal(pa[k][0], pb[k][0])
        scale = max(np.abs(pa[k][1]).max(), 1e-30)
        assert pb[k][1].shape == pa[k][1].shape
        assert np.abs(pb[k][1] - pa[k][1]).max() <= 1e-3 * scale


def test_amr_plotfile_boxes_match_jax(runs):
    (_, _, jdir), (_, _, tdir), _ = runs
    _same_plots(jdir / "plot_000004.2d.hdf5", tdir / "plot_000004.2d.hdf5")


# ------------------------------------------------------- a K = 2 hierarchy
NX, NZ = 48, 16


@pytest.fixture(scope="module")
def k2(tmp_path_factory):
    """A JAX and a port hierarchy placed on two lumps (K doubled to 2), in
    float64, each written as a checkpoint and a plot file."""
    out = tmp_path_factory.mktemp("k2")
    jax.config.update("jax_enable_x64", True)
    try:
        mg = dict(eps=1e-5, imax=12, bottom_solver="smooth")
        g = JGrid(nx=(NX, NZ), dx=(15 / NX, 2 / NZ), x0=(-7.5, 0.0))
        jh = JHierarchy(jgeo(g, JCartesian(), dtype=jnp.float64),
                        JLock(pert_amp=0.0),
                        JParams(nu=1e-4, kappa=(1e-4,), mg=JMG(**mg),
                                dtype=jnp.float64),
                        ratio=(4, 1), patch_frac=0.3,
                        tag_params=JTags(buoyancy_tag_tol=0.12,
                                         tags_grow=1))
        th = entry.build_amr_hierarchy(
            NX, None, NZ, (4, 1), device="cpu", dtype=torch.float64,
            patch_frac=0.3, tag_params=entry.TagParams(
                buoyancy_tag_tol=0.12, tags_grow=1))
        js = jh.level0.post_initialize(jh.level0.initial_state())
        x = np.asarray(jh.level0.geo.phys_coords_cc()[0])
        f = _np(js)
        f["scalars"] = f["scalars"].copy()
        f["scalars"][0] = ((np.abs(x + 4.0) < 0.8)
                           | (np.abs(x - 4.0) < 0.8)).astype(np.float64)
        js = JState(**{n: jnp.asarray(v) for n, v in f.items()})
        ts = entry.ns_state_from_numpy(f, device="cpu", dtype=torch.float64)
        (jf,), (jo,), (jw,) = jh.initial_patch_states(js)
        (tf,), (to,), (tw,) = th.initial_patch_states(ts)
        jc = jh.couplings[0]
        jck.write_checkpoint(
            str(out / "jax.hdf5"), js, jh.level0, 3, 0.02, fine_state=[jf],
            fine_grid=[jc.ext_grid], origin=[np.asarray(jo)],
            weights=[np.asarray(jc.weights)],
            parent_sels=[np.asarray(jc.parent_sel)], old_state=js,
            old_fine=[jf], hierarchy=jh)
        tc = th.couplings[0]
        tck.write_checkpoint(
            str(out / "port.hdf5"), ts, th.level0, 3, 0.02, fine_state=[tf],
            fine_grid=[tc.ext_grid], origin=[to], weights=[tc.weights],
            parent_sels=[tc.parent_sel], old_state=ts, old_fine=[tf],
            hierarchy=th)
        jck.write_chombo_plotfile(str(out / "jax.2d.hdf5"), js, jh.level0,
                                  3, hierarchy=jh, fine_states=[jf],
                                  dt=0.02)
        tck.write_chombo_plotfile(str(out / "port.2d.hdf5"), ts, th.level0,
                                  3, hierarchy=th, fine_states=[tf],
                                  dt=0.02)
        yield jh, th, out
    finally:
        jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("path", ["jax.hdf5", "port.hdf5"])
def test_k2_checkpoints_cross_between_packages(k2, path):
    jh, th, out = k2
    assert th.couplings[0].K == jh.couplings[0].K == 2
    want = jck.read_checkpoint(str(out / path), jh.level0,
                               fine_grid=[jh.couplings[0].ext_grid])
    got = tck.read_checkpoint(str(out / path), th.level0,
                              fine_grid=[th.couplings[0].ext_grid])
    assert got[1:3] == want[1:3] == (3, 0.02)
    for a, b in ((want[0], got[0]), (want[3][0], got[3][0])):
        for f in entry.STATE_FIELDS:
            np.testing.assert_array_equal(getattr(b, f).numpy(),
                                          np.asarray(getattr(a, f)), f)
    for i in (4, 5, 6):
        np.testing.assert_array_equal(got[i][0], np.asarray(want[i][0]))
    assert got[5][0].tolist() == [1.0, 1.0]


def test_k2_checkpoint_views_and_plot_boxes_match_jax(k2):
    _, _, out = k2
    with h5py.File(out / "jax.hdf5", "r") as a, \
            h5py.File(out / "port.hdf5", "r") as b:
        for k in ("level_0", "level_1"):
            np.testing.assert_array_equal(b[k]["boxes"][...],
                                          a[k]["boxes"][...])
            for name in ("new_velocity:datatype=0",
                         "new_scalar_component_0:datatype=0",
                         "ccPressure:offsets=0"):
                np.testing.assert_array_equal(b[k][name][...],
                                              a[k][name][...])
            assert sorted(b[k].attrs) == sorted(a[k].attrs)
    _same_plots(out / "jax.2d.hdf5", out / "port.2d.hdf5")


# -------------------------------------------------------- the port's resume
TWO_LUMPS = """
amr.nx = 48 16
amr.length = 15.0 2.0
amr.nx_offset = -24 0
ibc.problem = 1
amr.viscosity = 0.0001
amr.scal_diffusion_coeffs = 0.0001
amr.maxlevel = 1
amr.refratio_lev0 = 4 1
amr.regrid_intervals = 2
amr.buoyancy_tag_tol = 0.12
amr.tags_grow = 1
amr.max_grid_size = 56
amr.max_dt = 0.05
amr.final = 10.0
plot.checkpoint_interval = 2
amr.verbosity = 0
"""


def two_lump_driver(out_dir, *extra):
    """The port's RunDriver on TWO_LUMPS with its initial buoyancy
    replaced by two vertically uniform lumps at x = -4 and 4."""
    ctx = TContext.from_parmparse(TPP.from_string(
        TWO_LUMPS + "\n".join(extra) + "\n"))
    drv = TDriver(ctx, out_dir=str(out_dir), device="cpu")
    lvl = drv.level
    plain = lvl.initial_state

    def two_lumps():
        s = plain()
        x = np.asarray(lvl.geo.phys_coords_cc()[0])
        b = (np.abs(x + 4.0) < 0.8) | (np.abs(x - 4.0) < 0.8)
        scal = s.scalars.clone()
        scal[0] = torch.as_tensor(b, dtype=scal.dtype).expand_as(scal[0])
        return type(s)(**{**{f: getattr(s, f) for f in entry.STATE_FIELDS},
                          "scalars": scal})

    lvl.initial_state = two_lumps
    return drv


def test_amr_resume_equals_uninterrupted_run(tmp_path):
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    full = two_lump_driver(tmp_path / "a")
    s_full, _ = full.run(max_steps=4, verbose=False)
    assert full.hierarchy.couplings[0].K == 2
    two_lump_driver(tmp_path / "b").run(max_steps=2, verbose=False)
    resumed = two_lump_driver(tmp_path / "b",
                              "amr.restart_file = chkpt_000002.hdf5")
    s_res, steps = resumed.run(max_steps=4, verbose=False)
    assert steps == 4
    a, b = full.hierarchy.couplings[0], resumed.hierarchy.couplings[0]
    assert (a.K, a.ext_nx) == (b.K, b.ext_nx)
    np.testing.assert_array_equal(a.origin_f, b.origin_f)
    np.testing.assert_array_equal(a.weights, b.weights)
    assert resumed.dts == full.dts[2:]
    for x, y in ((s_full, s_res), (full.fine_state[0],
                                   resumed.fine_state[0])):
        for f in entry.STATE_FIELDS:
            assert torch.equal(getattr(x, f), getattr(y, f)), f


def test_amr_deck_subcycles_its_first_step(tmp_path):
    import chip_smoke
    ctx = TContext.from_parmparse(TPP.from_string(chip_smoke.R0_SUBCYCLED))
    drv = TDriver(ctx, out_dir=str(tmp_path), device="cpu")
    state, steps = drv.run(max_steps=2, verbose=False)
    assert steps == 2 and drv.nt_mults == [(2,), (1,)]
    c = drv.hierarchy.couplings[0]
    substeps = c.nt * 2 + c.nt * 1
    assert drv.cell_updates == (2 * drv.grid.ncells
                                + substeps * c.K * int(np.prod(c.ext_nx)))
    np.testing.assert_allclose(float(state.time), sum(drv.dts), rtol=1e-6)
    for s in (state, drv.fine_state[0]):
        assert all(bool(torch.isfinite(getattr(s, f)).all())
                   for f in entry.STATE_FIELDS)
