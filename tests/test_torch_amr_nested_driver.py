"""A nested AMR deck (amr.maxlevel = 2) through the port's RunDriver, its
checkpoints and plot files, against the JAX package's, on the CPU:

  * DECK3: tests/test_driver_io.py's AMR_CFG (2D 48x16, the lock
    exchange, amr.max_dt 0.05 so that level_dts set each dt, ROADMAP
    C.10) with a second refined level, ratios (2,1) then (2,1), and
    amr.regrid_intervals = 4 2 (step 2 regrids from level 1, step 4 from
    the base), through JAX's RunDriver (one jitted JAX hierarchy, shared
    by the module's tests) and the port's for 4 steps in float32 (C.7):
    the same dts (1e-6), dynamic-subcycling factors, regrid log (step,
    from_level, per level K and origins), parent selections and fields of
    every level within 1e-3 of max|field|;
  * its checkpoints both ways: each package reads the other's, every
    array bitwise equal, with the same origins, weights and parent
    selections on both refined levels;
  * its Chombo plot files: the same boxes on all three levels and data
    within 1e-3 of max|component|;
  * the port's exact resume of DECK3 from its step-2 checkpoint: equal to
    the run without a break bitwise, every level's K, footprint and
    origins included.
"""

import shutil

import h5py
import numpy as np
import pytest
import torch

from somar_tpu.config.context import ProblemContext as JContext
from somar_tpu.config.parmparse import ParmParse as JPP
from somar_tpu.driver import RunDriver as JDriver
from somar_tpu.io import checkpoint as jck

from somar_tpu_torch import entry
from somar_tpu_torch.config.context import ProblemContext as TContext
from somar_tpu_torch.config.parmparse import ParmParse as TPP
from somar_tpu_torch.driver import RunDriver as TDriver
from somar_tpu_torch.io import checkpoint as tck
from tests.test_driver_io import AMR_CFG
from tests.torch_jax_reference import jax_unoptimized  # noqa: F401 (autouse)

torch.set_num_threads(1)

DECK3 = AMR_CFG.replace("amr.maxlevel = 1", "amr.maxlevel = 2").replace(
    "amr.refratio_lev0 = 4 1", "amr.refratio_lev0 = 2 1\n"
    "amr.refratio_lev1 = 2 1").replace(
    "amr.regrid_intervals = 2 2", "amr.regrid_intervals = 4 2") + """
amr.fixed_dt = -1
amr.max_dt = 0.05
plot.plot_interval = 2
plot.checkpoint_interval = 2
"""
FIELDS = ("vel", "scalars", "lam", "pressure")


def _record(driver, h, log):
    """Log every regrid of hierarchy h: (step, from_level, per level (K,
    origins)); the step is the number of scheduler calls so far."""
    plain = h.regrid
    steps = []
    driver.scheduler.schedule(lambda *_: steps.append(1), step_interval=1)

    def regrid(*a, from_level=0, **kw):
        got = plain(*a, from_level=from_level, **kw)
        log.append((len(steps) + 1, from_level, [
            (c.K, np.asarray(c.origin_f).tolist()) for c in h.couplings]))
        return got

    h.regrid = regrid


def _times(driver):
    times = []
    driver.scheduler.schedule(lambda step, t, s: times.append(float(t)),
                              step_interval=1)
    return times


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both RunDrivers on DECK3: per package (driver, times, dir, regrid
    log, subcycling factors, final state)."""
    out = {}
    for name in ("jax", "port"):
        d = tmp_path_factory.mktemp(name)
        if name == "jax":
            drv = JDriver(JContext.from_parmparse(JPP.from_string(DECK3)),
                          out_dir=str(d))
            mults = []
            plain = drv.hierarchy.subcycle_multipliers
            drv.hierarchy.subcycle_multipliers = \
                lambda *a, **k: mults.append(plain(*a, **k)) or mults[-1]
        else:
            drv = TDriver(TContext.from_parmparse(TPP.from_string(DECK3)),
                          out_dir=str(d), device="cpu")
            mults = drv.nt_mults
        log = []
        _record(drv, drv.hierarchy, log)
        times = _times(drv)
        state, steps = drv.run(verbose=False)
        assert steps == 4
        out[name] = dict(drv=drv, times=times, dir=d, log=log, mults=mults,
                         state=state)
    return out


def _np(state):
    return {f: np.asarray(getattr(state, f)) for f in entry.STATE_FIELDS}


def _fields_close(want, got, tol):
    for f in FIELDS:
        w, g = np.asarray(want[f]), np.asarray(got[f])
        assert g.shape == w.shape, f
        assert np.abs(g - w).max() <= tol * max(np.abs(w).max(), 1e-30), f


def _grids(drv):
    return [c.ext_grid for c in drv.hierarchy.couplings]


def test_nested_deck_matches_jax_driver(runs):
    j, t = runs["jax"], runs["port"]
    jh, th = j["drv"].hierarchy, t["drv"].hierarchy
    assert th.num_levels == jh.num_levels == 3
    np.testing.assert_allclose(np.diff([0.0] + t["times"]),
                               np.diff([0.0] + j["times"]), rtol=1e-6)
    assert t["mults"] == j["mults"] and len(t["mults"]) == 4
    assert t["log"] == j["log"]
    assert [(s, f) for s, f, _ in t["log"]] == [(2, 1), (4, 0)]
    assert [r["from_level"] for r in t["drv"].regrids] == [1, 0]
    psj, pst = jh.parent_sels, th.parent_sels
    assert (psj is None) == (pst is None)
    for lev, (jc, tc) in enumerate(zip(jh.couplings, th.couplings)):
        assert (tc.K, tc.ext_nx) == (jc.K, jc.ext_nx), lev
        np.testing.assert_array_equal(tc.origin_f, np.asarray(jc.origin_f))
    _fields_close(_np(j["state"]), entry.ns_state_to_numpy(t["state"]),
                  1e-3)
    jfine = jck.read_checkpoint(str(j["dir"] / "chkpt_final.hdf5"),
                                j["drv"].level, fine_grid=_grids(j["drv"]))[3]
    for a, b in zip(jfine, t["drv"].fine_state):
        _fields_close(_np(a), entry.ns_state_to_numpy(b), 1e-3)


@pytest.mark.parametrize("way", ["port reads jax", "jax reads port"])
def test_nested_checkpoints_cross_between_packages(runs, way):
    j, t = runs["jax"], runs["port"]
    path = str((j["dir"] if way == "port reads jax" else t["dir"])
               / "chkpt_000004.hdf5")
    want = jck.read_checkpoint(path, j["drv"].level,
                               fine_grid=_grids(j["drv"]))
    got = tck.read_checkpoint(path, t["drv"].level,
                              fine_grid=_grids(t["drv"]))
    assert got[1:3] == want[1:3]
    assert len(got[3]) == len(want[3]) == 2
    for a, b in zip((want[0],) + tuple(want[3]), (got[0],) + tuple(got[3])):
        for f in entry.STATE_FIELDS:
            np.testing.assert_array_equal(getattr(b, f).numpy(),
                                          np.asarray(getattr(a, f)), f)
    for i in (4, 5, 6):
        for a, b in zip(want[i], got[i]):
            assert (a is None) == (b is None), i
            if a is not None:
                np.testing.assert_array_equal(b, np.asarray(a))


def _boxes(path):
    with h5py.File(path, "r") as f:
        return {k: (f[k]["boxes"][...], f[k]["data:datatype=0"][...])
                for k in f if k.startswith("level_")}


def test_nested_plotfile_boxes_match_jax(runs):
    pa = _boxes(runs["jax"]["dir"] / "plot_000004.2d.hdf5")
    pb = _boxes(runs["port"]["dir"] / "plot_000004.2d.hdf5")
    assert sorted(pa) == sorted(pb) == ["level_0", "level_1", "level_2"]
    for k in pa:
        np.testing.assert_array_equal(pb[k][0], pa[k][0])
        scale = max(np.abs(pa[k][1]).max(), 1e-30)
        assert pb[k][1].shape == pa[k][1].shape
        assert np.abs(pb[k][1] - pa[k][1]).max() <= 1e-3 * scale
    with h5py.File(runs["jax"]["dir"] / "chkpt_000004.hdf5", "r") as a, \
            h5py.File(runs["port"]["dir"] / "chkpt_000004.hdf5", "r") as b:
        for k in ("level_0", "level_1", "level_2"):
            np.testing.assert_array_equal(b[k]["boxes"][...],
                                          a[k]["boxes"][...])
            for attr in ("ref_ratio", "prob_domain"):
                assert b[k].attrs[attr] == a[k].attrs[attr], (k, attr)
            np.testing.assert_allclose(b[k].attrs["dt"], a[k].attrs["dt"],
                                       rtol=1e-6)


def test_nested_resume_equals_uninterrupted_run(runs, tmp_path):
    t = runs["port"]
    full = t["drv"]
    shutil.copy(t["dir"] / "chkpt_000002.hdf5", tmp_path)
    ctx = TContext.from_parmparse(TPP.from_string(
        DECK3 + "amr.restart_file = chkpt_000002.hdf5\n"))
    resumed = TDriver(ctx, out_dir=str(tmp_path), device="cpu")
    s_res, steps = resumed.run(max_steps=4, verbose=False)
    assert steps == 4
    assert resumed.dts == full.dts[2:]
    for a, b in zip(full.hierarchy.couplings, resumed.hierarchy.couplings):
        assert (a.K, a.ext_nx) == (b.K, b.ext_nx)
        np.testing.assert_array_equal(a.origin_f, b.origin_f)
    for x, y in zip((t["state"],) + tuple(full.fine_state),
                    (s_res,) + tuple(resumed.fine_state)):
        for f in entry.STATE_FIELDS:
            assert torch.equal(getattr(x, f), getattr(y, f)), f
