"""A nested mapped AMR deck (amr.maxlevel = 2 on the Ledge map) through the
port's RunDriver against the JAX package's, on the CPU: LEDGE_DECK of
tests/test_torch_amr_mapped_driver.py (inviscid, 2D 48x16) with two
refined levels at ratios (2,1) and (2,1) and amr.regrid_intervals = 4 2
(step 2 regrids from level 1, step 4 from the base), so that every level
places and moves slots on its own metric, without the coarse step's sync
projection, through JAX's RunDriver (the module's one jitted JAX run) and
the port's for 4 steps in float32 (C.7):

  * the same dts (1e-6), subcycling factors and regrid log (step,
    from_level, per level K and origins), and every level's fields within
    1e-3 of max|field|;
  * each level-2 slot's metric is the map's at its global position
    (1e-6): the level-2 origin is relative to its level-1 parent, so the
    global position runs through the chain of parents.

The JAX package runs with the port's two C.28 rules
(`tests/test_torch_amr_mapped.jax_c28`).
"""

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
from somar_tpu_torch.core.grid import Grid
from somar_tpu_torch.driver import RunDriver as TDriver
from somar_tpu_torch.geometry.level_geometry import build_level_geometry
from tests.test_torch_amr_mapped import jax_c28  # noqa: F401 (autouse)
from tests.test_torch_amr_mapped_driver import LEDGE_DECK, _close, _np

torch.set_num_threads(1)

#: without the sync projection in the coarse step, which halves the JAX
#: step's compile (the composite initial projection stays; the
#: nested mapped sync is held card against CPU by chip_smoke M0 and the
#: mapped sync against JAX by tests/test_torch_amr_mapped*.py)
NESTED_DECK = LEDGE_DECK.replace("amr.maxlevel = 1", "amr.maxlevel = 2") \
    .replace("amr.refratio_lev0 = 4 1",
             "amr.refratio_lev0 = 2 1\namr.refratio_lev1 = 2 1") \
    .replace("amr.regrid_intervals = 2 2", "amr.regrid_intervals = 4 2") \
    + "projection.doSyncProjection = 0\n"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = {}
    for name in ("jax", "port"):
        d = tmp_path_factory.mktemp(name)
        if name == "jax":
            drv = JDriver(JContext.from_parmparse(JPP.from_string(
                NESTED_DECK)), out_dir=str(d))
            mults = []
            plain = drv.hierarchy.subcycle_multipliers
            drv.hierarchy.subcycle_multipliers = \
                lambda *a, **k: mults.append(plain(*a, **k)) or mults[-1]
        else:
            drv = TDriver(TContext.from_parmparse(TPP.from_string(
                NESTED_DECK)), out_dir=str(d), device="cpu")
            mults = drv.nt_mults
        h = drv.hierarchy
        log, times, steps = [], [], []
        plain_regrid = h.regrid

        def regrid(*a, from_level=0, _h=h, _p=plain_regrid, _log=log,
                   _steps=steps, **kw):
            got = _p(*a, from_level=from_level, **kw)
            _log.append((len(_steps) + 1, from_level, [
                (c.K, np.asarray(c.origin_f).tolist())
                for c in _h.couplings]))
            return got

        h.regrid = regrid
        drv.scheduler.schedule(lambda *_a, _s=steps: _s.append(1),
                               step_interval=1)
        drv.scheduler.schedule(lambda step, t, s, _t=times:
                               _t.append(float(t)), step_interval=1)
        state, nsteps = drv.run(verbose=False)
        assert nsteps == 4
        out[name] = dict(drv=drv, times=times, dir=d, log=log, mults=mults,
                         state=state)
    return out


def test_nested_ledge_deck_matches_jax_driver(runs):
    j, t = runs["jax"], runs["port"]
    jh, th = j["drv"].hierarchy, t["drv"].hierarchy
    assert th.num_levels == jh.num_levels == 3
    assert all(c.is_mapped for c in th.couplings)
    np.testing.assert_allclose(np.diff([0.0] + t["times"]),
                               np.diff([0.0] + j["times"]), rtol=1e-6)
    assert t["mults"] == j["mults"] and len(t["mults"]) == 4
    assert t["log"] == j["log"]
    assert [(s, f) for s, f, _ in t["log"]] == [(2, 1), (4, 0)]
    for jc, tc in zip(jh.couplings, th.couplings):
        assert (tc.K, tc.ext_nx) == (jc.K, jc.ext_nx)
    _close(_np(j["state"]), entry.ns_state_to_numpy(t["state"]), 1e-3)
    grids = [c.ext_grid for c in jh.couplings]
    jfine = jck.read_checkpoint(str(j["dir"] / "chkpt_final.hdf5"),
                                j["drv"].level, fine_grid=grids)[3]
    for want, got in zip(jfine, t["drv"].fine_state):
        _close(_np(want), entry.ns_state_to_numpy(got), 1e-3)


def test_level2_slot_metric_is_the_map_at_its_global_position(runs):
    th = runs["port"]["drv"].hierarchy
    c1, c2 = th.couplings
    g2 = th._global_origin(1)
    g1 = th._global_origin(0)
    r = np.array([c2._axis_ratio(ax) for ax in range(2)])
    np.testing.assert_array_equal(
        g2, g1 * r + np.asarray(c2.origin_f))
    dx = c2.ext_grid.dx
    win = Grid(nx=c2.ext_nx, dx=dx, periodic=c2.ext_grid.periodic,
               x0=tuple(th.grid0.x0[d] + g2[th.grid0.axis(d)] * dx[d]
                        for d in range(2)))
    lg = build_level_geometry(win, th.level0.geo.geo, device="cpu",
                              dtype=torch.float32)
    got = c2.level.geo
    np.testing.assert_allclose(got.J.numpy(),
                               lg.J.expand(win.shape).numpy(), rtol=1e-6)
    for d in range(2):
        np.testing.assert_allclose(got.Jgup_full[d].numpy(),
                                   lg.Jgup_full[d].numpy(), rtol=0,
                                   atol=1e-6 * float(
                                       lg.Jgup_full[d].abs().max()))
