"""Mapped AMR decks (a terrain-following base) through the port's
RunDriver against the JAX package's, on the CPU:

  * LEDGE_DECK: tests/test_driver_io.py's AMR_CFG (2D 48x16, the lock
    exchange, ratio (4,1), regrids every 2 steps, amr.max_dt 0.05 so that
    level_dts set each dt, ROADMAP C.10) on the Ledge map with the
    LockExchange_Ledge2D stand-ins (geometry.coordMap = 5, ledgeMapHl 1,
    Hr 0, Xl -1, Xr 1: a 1-deep shelf dropping to the 2-deep basin),
    plot.writeGeometry on, inviscid, without the hierarchy-wide pressure
    initialization, with two multigrid levels below each level and line
    relaxation named (C.27), through JAX's RunDriver (the module's one
    jitted JAX run) and the port's for 4 steps in float32 (C.7): the same
    dts (1e-6), subcycling factors, regrid log (step, K, origins) and
    fields of both levels within 1e-3 of max|field|;
  * the port's exact resume of LEDGE_DECK from its step-2 checkpoint:
    equal to the run without a break bitwise (the slots' metrics rebuilt
    from the restored origins);
  * the port's plot file: the refined patch's box carries its own
    displacement and J, equal to the map evaluated on the patch
    interior (1e-6);
  * entry.amr_hierarchy_from_context builds, places and steps a mapped
    hierarchy on coordMaps 1 (Twisted), 2 (BeamGenerator) and 5 (Ledge).

The nested mapped deck (amr.maxlevel = 2) is
tests/test_torch_amr_mapped_nested.py's.  The JAX package runs with the
port's two C.28 rules (`tests/test_torch_amr_mapped.jax_c28`).
"""

import h5py
import numpy as np
import pytest
import torch

from somar_tpu.config.context import ProblemContext as JContext
from somar_tpu.config.parmparse import ParmParse as JPP
from somar_tpu.driver import RunDriver as JDriver

from somar_tpu_torch import entry
from somar_tpu_torch.config.context import ProblemContext as TContext
from somar_tpu_torch.config.parmparse import ParmParse as TPP
from somar_tpu_torch.core.grid import Grid
from somar_tpu_torch.driver import RunDriver as TDriver
from somar_tpu_torch.geometry.level_geometry import build_level_geometry
from tests.test_driver_io import AMR_CFG
from tests.test_torch_amr_mapped import jax_c28  # noqa: F401 (autouse)
from tests.torch_jax_reference import jax_unoptimized  # noqa: F401 (autouse)

torch.set_num_threads(1)

LEDGE = """
geometry.coordMap = 5
geometry.ledgeMapHl = 1
geometry.ledgeMapHr = 0
geometry.ledgeMapXl = -1
geometry.ledgeMapXr = 1
"""
#: inviscid, no hierarchy-wide pressure initialization and two multigrid
#: levels below each level, so that the JAX RunDriver compiles one small
#: hierarchy step (one that takes minutes to compile otherwise);
#: vertical line relaxation named, since the jitted JAX step picks a
#: mapped patch's smoother from its computational dx, not its metric
#: (ROADMAP C.27)
LEDGE_DECK = AMR_CFG.replace("amr.viscosity = 0.0001",
                             "amr.viscosity = 0.0").replace(
    "amr.scal_diffusion_coeffs = 0.0001",
    "amr.scal_diffusion_coeffs = 0.0") + LEDGE + """
amr.fixed_dt = -1
amr.max_dt = 0.05
projection.initial_pressure_iters = 0
AMRMG.relax_mode = 3
AMRMG.maxDepth = 2
plot.plot_interval = 2
plot.checkpoint_interval = 2
plot.writeGeometry = 1
"""
FIELDS = ("vel", "scalars", "lam", "pressure")


def _np(state):
    return {f: np.asarray(getattr(state, f)) for f in entry.STATE_FIELDS}


def _record(driver, log):
    """Log every regrid: (step, per level (K, origins)); the step is the
    number of scheduler calls so far, plus one."""
    h = driver.hierarchy
    plain = h.regrid
    steps = []
    driver.scheduler.schedule(lambda *_: steps.append(1), step_interval=1)

    def regrid(*a, **kw):
        got = plain(*a, **kw)
        log.append((len(steps) + 1, [(c.K, np.asarray(c.origin_f).tolist())
                                     for c in h.couplings]))
        return got

    h.regrid = regrid


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = {}
    for name in ("jax", "port"):
        d = tmp_path_factory.mktemp(name)
        if name == "jax":
            drv = JDriver(JContext.from_parmparse(JPP.from_string(
                LEDGE_DECK)), out_dir=str(d))
            mults = []
            plain = drv.hierarchy.subcycle_multipliers
            drv.hierarchy.subcycle_multipliers = \
                lambda *a, **k: mults.append(plain(*a, **k)) or mults[-1]
        else:
            drv = TDriver(TContext.from_parmparse(TPP.from_string(
                LEDGE_DECK)), out_dir=str(d), device="cpu")
            mults = drv.nt_mults
        log, times = [], []
        _record(drv, log)
        drv.scheduler.schedule(lambda step, t, s: times.append(float(t)),
                               step_interval=1)
        state, steps = drv.run(verbose=False)
        assert steps == 4
        out[name] = dict(drv=drv, times=times, dir=d, log=log, mults=mults,
                         state=state)
    return out


def _close(want, got, tol):
    for f in FIELDS:
        w, g = np.asarray(want[f]), np.asarray(got[f])
        assert g.shape == w.shape, f
        err = np.abs(g - w).max()
        assert err <= tol * max(np.abs(w).max(), 1e-30), (f, err)


def test_ledge_deck_matches_jax_driver(runs):
    j, t = runs["jax"], runs["port"]
    jh, th = j["drv"].hierarchy, t["drv"].hierarchy
    assert th.is_mapped and th.couplings[0].is_mapped
    np.testing.assert_allclose(np.diff([0.0] + t["times"]),
                               np.diff([0.0] + j["times"]), rtol=1e-6)
    assert t["mults"] == j["mults"] and len(t["mults"]) == 4
    assert t["log"] == j["log"] and [s for s, _ in t["log"]] == [2, 4]
    for jc, tc in zip(jh.couplings, th.couplings):
        assert (tc.K, tc.ext_nx) == (jc.K, jc.ext_nx)
    _close(_np(j["state"]), entry.ns_state_to_numpy(t["state"]), 1e-3)
    tf = t["drv"].fine_state
    # the refined level's state through the JAX checkpoint reader
    from somar_tpu.io import checkpoint as jck
    grids = [c.ext_grid for c in jh.couplings]
    want = jck.read_checkpoint(str(j["dir"] / "chkpt_final.hdf5"),
                               j["drv"].level, fine_grid=grids)[3]
    _close(_np(want[0]), entry.ns_state_to_numpy(tf[0]), 1e-3)
    # every slot was built at each placement and regrid
    assert th.slots_built >= 1 and th.refresh_seconds > 0.0
    assert all("refresh_seconds" in r for r in t["drv"].regrids)


def test_ledge_deck_resume_is_exact(runs, tmp_path):
    t = runs["port"]
    src = t["dir"] / "chkpt_000002.hdf5"
    (tmp_path / "chkpt_000002.hdf5").write_bytes(src.read_bytes())
    drv = TDriver(TContext.from_parmparse(TPP.from_string(
        LEDGE_DECK + "amr.restart_file = chkpt_000002.hdf5\n")),
        out_dir=str(tmp_path), device="cpu")
    state, steps = drv.run(verbose=False)
    assert steps == 4
    h, h0 = drv.hierarchy, t["drv"].hierarchy
    for c, c0 in zip(h.couplings, h0.couplings):
        assert (c.K, c.ext_nx) == (c0.K, c0.ext_nx)
        np.testing.assert_array_equal(c.origin_f, c0.origin_f)
        assert torch.equal(c.level.geo.J, c0.level.geo.J)
    for a, b in zip((state,) + tuple(drv.fine_state),
                    (t["state"],) + tuple(t["drv"].fine_state)):
        for f in entry.STATE_FIELDS:
            assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_plot_file_carries_each_patch_metric(runs):
    t = runs["port"]
    h = t["drv"].hierarchy
    c = h.couplings[0]
    with h5py.File(t["dir"] / "plot_000004.2d.hdf5", "r") as f:
        names = [f.attrs[f"component_{i}"].decode()
                 for i in range(int(f.attrs["num_components"]))]
        boxes = f["level_1"]["boxes"][...]
        data = f["level_1"]["data:datatype=0"][...]
    assert {"displacement_0", "displacement_1", "J"} <= set(names)
    assert len(boxes) == 1
    lo = np.array([boxes[0][0], boxes[0][1]])
    hi = np.array([boxes[0][2], boxes[0][3]])
    n = hi - lo + 1
    comps = data.reshape(len(names), n[1], n[0])
    # the map on the patch interior: cells lo..hi of the level's global
    # index space
    g0 = h.grid0
    dx = c.ext_grid.dx
    win = Grid(nx=tuple(int(v) for v in n), dx=dx,
               x0=tuple(g0.x0[d] + lo[d] * dx[d] for d in range(2)))
    lg = build_level_geometry(win, h.level0.geo.geo, device="cpu",
                              dtype=torch.float64)
    disp = lg.displacement_cc()
    J = lg.J.expand(win.shape).numpy()
    for name, want in (("displacement_0", disp[0]),
                       ("displacement_1", disp[1]), ("J", J)):
        got = comps[names.index(name)]
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-6 * np.abs(want).max(),
                                   err_msg=name)
    assert np.abs(disp[1]).max() > 0.1       # a terrain-following patch


DECK_MAPS = {
    1: "geometry.coordMap = 1\n",
    2: "geometry.coordMap = 2\ngeometry.beamGenMapAlpha = 15\n",
    5: LEDGE,
}


@pytest.mark.parametrize("coord_map", sorted(DECK_MAPS))
def test_entry_builds_mapped_hierarchies(coord_map):
    deck = AMR_CFG.replace("amr.nx = 48 16", "amr.nx = 32 8").replace(
        "amr.nx_offset = -24 0", "amr.nx_offset = -16 0") \
        + DECK_MAPS[coord_map]
    ctx = TContext.from_parmparse(TPP.from_string(deck))
    assert ctx.coord_map == coord_map
    h = entry.amr_hierarchy_from_context(ctx, device="cpu")
    assert h.is_mapped and h.couplings[0].is_mapped
    s0, fine, origin = entry.place_amr(h)
    c = h.couplings[0]
    assert c.level.geo.J.shape == tuple(c.ext_grid.shape)
    assert type(c.level.geo.geo).__name__ == "RawGeoSource"
    s1, f1 = h.advance(s0, fine, origin, 0.01)
    assert bool(torch.isfinite(f1.vel).all()) \
        and bool(torch.isfinite(s1.vel).all())
