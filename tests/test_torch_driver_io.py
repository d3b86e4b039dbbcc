"""The port's checkpoints, plot files, RunDriver and command line against
the JAX package's:

  * checkpoints both ways: a file that JAX writes from an eager
    post-initialized state is read by the port with every array bitwise
    equal and the same step and dt, and the reverse; the two packages'
    files of one state hold the same groups, datasets and attributes;
  * the Chombo plot files (and the one-group dumps of write_plotfile) of
    both packages on one state: the same component names and boxes, data
    within 1e-6 of max|component|
    (Taylor-Green with the stream function, vorticity, divergence and
    lambda; BeamGeneration with the displacement, J, Ri and the buoyancy
    deviation);
  * the port's RunDriver on tests/test_driver_io.py's deck (Taylor-Green
    32x32, 3 steps at a fixed dt) against JAX's RunDriver within 1e-4 of
    max|field| (the one jitted JAX step of these tests);
  * the halt file, pout.0, the scheduler, the final checkpoint, and a
    restart that equals the uninterrupted run bitwise on the CPU;
  * `python -m somar_tpu_torch --device cpu` on a 2D lock-exchange deck:
    "finished 3 steps", and plot and checkpoint files that JAX's
    read_checkpoint reads back to the port's arrays.
"""

import contextlib
import io

import h5py
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from somar_tpu.config.context import ProblemContext as JContext
from somar_tpu.config.parmparse import ParmParse as JPP
from somar_tpu.driver import RunDriver as JDriver
from somar_tpu.geometry.level_geometry import build_level_geometry as jgeo
from somar_tpu.io import checkpoint as jck
from somar_tpu.physics.navier_stokes import NSLevel as JLevel
from somar_tpu.physics.navier_stokes import NSState as JState

from somar_tpu_torch import entry
from somar_tpu_torch.__main__ import main as cli_main
from somar_tpu_torch.config.context import ProblemContext as TContext
from somar_tpu_torch.config.parmparse import ParmParse as TPP
from somar_tpu_torch.driver import RunDriver as TDriver
from somar_tpu_torch.io import checkpoint as tck
from tests.test_driver_io import AMR_CFG, CFG
from tests.test_torch_rk3 import DECKS
from tests.torch_jax_reference import jax_unoptimized  # noqa: F401 (autouse)

torch.set_num_threads(1)

LOCK_2D = """
amr.nx = 32 16
amr.length = 15.0 2.0
amr.nx_offset = -16 0
ibc.problem = 1
amr.viscosity = 1e-4
amr.scal_diffusion_coeffs = 1e-4
amr.max_dt = 0.05
amr.final = 100.0
amr.maxsteps = 10
plot.plot_interval = 2
plot.checkpoint_interval = 2
amr.verbosity = 2
"""
PLOT_FLAGS = """
plot.writeVorticity = 1
plot.writeDivergence = 1
plot.writeLambda = 1
plot.writeGeometry = 1
plot.writeRi = 1
plot.writeScalarsMinusBackground = 1
plot.writeLevelIDs = 1
plot.writeGradELambda = 1
"""


def _levels(deck):
    """(JAX level, port level, port context) of a deck, f32."""
    jctx = JContext.from_parmparse(JPP.from_string(deck))
    tctx = TContext.from_parmparse(TPP.from_string(deck))
    jl = JLevel(jgeo(jctx.base_grid(), jctx.new_geo_source(),
                     dtype=jctx.ns.dtype), jctx.new_problem(), jctx.ns)
    tdrv = TDriver(tctx, device="cpu")
    return jl, tdrv.level, tctx


def _np(state):
    return {f: np.asarray(getattr(state, f)) if not isinstance(
        getattr(state, f), torch.Tensor) else getattr(state, f).numpy()
        for f in entry.STATE_FIELDS}


def _same_state(jl, seed, project=True):
    """A JAX initial state (post-initialized when `project`) with a
    perturbed buoyancy and eLambda, and the same state in the port."""
    js = jl.initial_state()
    fields = _np(jl.post_initialize(js) if project else js)
    rng = np.random.default_rng(seed)
    fields["scalars"] = (fields["scalars"] + 0.01 * rng.standard_normal(
        fields["scalars"].shape)).astype(np.float32)
    fields["e_lambda"] = (0.1 * rng.standard_normal(
        fields["e_lambda"].shape)).astype(np.float32)
    js = JState(**{k: jnp.asarray(v) for k, v in fields.items()})
    return js, entry.ns_state_from_numpy(fields, device="cpu")


def _walk(path):
    """{name: (kind, attrs, data)} of every group and dataset in a file."""
    out = {}

    def visit(name, obj):
        data = obj[...] if isinstance(obj, h5py.Dataset) else None
        out[name] = (type(obj).__name__, dict(obj.attrs), data)

    with h5py.File(path, "r") as f:
        out["/"] = ("Group", dict(f.attrs), None)
        f.visititems(visit)
    return out


def _same_value(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and (
        a.tobytes() == b.tobytes())


@pytest.fixture(scope="module")
def tg():
    jl, tl, _ = _levels(CFG)
    js, ts = _same_state(jl, seed=11)
    return jl, tl, js, ts


def test_jax_checkpoint_read_by_port(tmp_path, tg):
    jl, tl, js, _ = tg
    path = str(tmp_path / "jax.hdf5")
    old = jl.initial_state()
    jck.write_checkpoint(path, js, jl, 7, 0.002, old_state=old, cfl=0.8)
    ts, step, dt = tck.read_checkpoint(path, tl)
    assert (step, dt) == (7, float(np.float64(0.002)))
    want, got = _np(js), entry.ns_state_to_numpy(ts)
    for f in entry.STATE_FIELDS:
        assert got[f].dtype == want[f].dtype, f
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)


def test_port_checkpoint_read_by_jax(tmp_path, tg):
    jl, tl, _, ts = tg
    path = str(tmp_path / "port.hdf5")
    tck.write_checkpoint(path, ts, tl, 9, 0.0025,
                         old_state=tl.initial_state(), cfl=0.8)
    js, step, dt = jck.read_checkpoint(path, jl)
    assert (step, dt) == (9, 0.0025)
    want, got = entry.ns_state_to_numpy(ts), _np(js)
    for f in entry.STATE_FIELDS:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)


def test_checkpoint_files_have_the_same_layout(tmp_path, tg):
    jl, tl, js, ts = tg
    a, b = str(tmp_path / "jax.hdf5"), str(tmp_path / "port.hdf5")
    old = jl.initial_state()
    jck.write_checkpoint(a, js, jl, 3, 0.002, extra={"k": 1},
                         old_state=old, cfl=0.8)
    tck.write_checkpoint(b, ts, tl, 3, 0.002, extra={"k": 1},
                         old_state=entry.ns_state_from_numpy(
                             _np(old), device="cpu"), cfl=0.8)
    want, got = _walk(a), _walk(b)
    assert sorted(got) == sorted(want)
    for name, (kind, attrs, data) in want.items():
        gkind, gattrs, gdata = got[name]
        assert gkind == kind, name
        assert sorted(gattrs) == sorted(attrs), name
        for k, v in attrs.items():
            assert _same_value(gattrs[k], v), (name, k, gattrs[k], v)
        if data is not None:
            assert _same_value(gdata, data), name


def _plot_components(path):
    with h5py.File(path, "r") as f:
        n = int(f.attrs["num_components"])
        names = [f.attrs[f"component_{i}"].decode() for i in range(n)]
        g = f["level_0"]
        return (names, np.asarray(g["boxes"]),
                np.asarray(g["data:datatype=0"]).reshape(n, -1),
                {k: g.attrs[k] for k in g.attrs})


@pytest.mark.parametrize("name", ["taylor_green", "beam"])
def test_chombo_plotfile_matches_jax(tmp_path, tg, name):
    if name == "taylor_green":
        jl, tl, js, ts = tg
        flags = PLOT_FLAGS + "plot.writeStreamFunction = 1\n"
        deck = CFG
    else:
        deck = DECKS["beam"]
        jl, tl, _ = _levels(deck)
        js, ts = _same_state(jl, seed=13, project=False)
        flags = PLOT_FLAGS + "plot.writeDisplacement = 1\n"
    jplot = JContext.from_parmparse(JPP.from_string(deck + flags)).plot
    tplot = TContext.from_parmparse(TPP.from_string(deck + flags)).plot
    a, b = str(tmp_path / "jax.2d.hdf5"), str(tmp_path / "port.2d.hdf5")
    jck.write_chombo_plotfile(a, js, jl, 4, jplot, dt=0.01)
    tck.write_chombo_plotfile(b, ts, tl, 4, tplot, dt=0.01)
    wn, wb, wd, wattrs = _plot_components(a)
    gn, gb, gd, gattrs = _plot_components(b)
    assert gn == wn and len(wn) >= 10
    assert _same_value(gb, wb)
    for k, v in wattrs.items():
        assert _same_value(gattrs[k], v), k
    for i, comp in enumerate(wn):
        scale = max(np.abs(wd[i]).max(), 1e-30)
        err = np.abs(gd[i] - wd[i]).max()
        assert err <= 1e-6 * scale, (comp, err, scale)


def test_run_driver_matches_jax(tmp_path):
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    tdir.mkdir()
    jctx = JContext.from_parmparse(JPP.from_string(CFG))
    jstate, jsteps = JDriver(jctx, out_dir=str(jdir)).run(verbose=False)
    tctx = TContext.from_parmparse(TPP.from_string(CFG))
    tstate, tsteps = TDriver(tctx, out_dir=str(tdir), device="cpu").run(
        verbose=False)
    assert tsteps == jsteps == 3
    want, got = _np(jstate), entry.ns_state_to_numpy(tstate)
    for f in ("vel", "scalars", "lam", "pressure"):
        scale = np.abs(want[f]).max()
        assert np.abs(got[f] - want[f]).max() <= 1e-4 * scale, f
    np.testing.assert_allclose(got["time"], want["time"], rtol=1e-6)
    assert sorted(p.name for p in tdir.iterdir()) == sorted(
        p.name for p in jdir.iterdir())


def _port_driver(deck, out_dir, *extra):
    ctx = TContext.from_parmparse(TPP.from_string(deck + "\n".join(extra)))
    return TDriver(ctx, out_dir=str(out_dir), device="cpu")


def test_halt_pout_scheduler_and_final_checkpoint(tmp_path):
    drv = _port_driver(CFG, tmp_path)
    fired = []
    drv.scheduler.schedule(lambda step, t, s: fired.append(step),
                           step_interval=1)
    state, steps = drv.run(max_steps=2, verbose=False)
    assert steps == 2 and fired == [1, 2]
    log = (tmp_path / "pout.0").read_text()
    assert "step      1" in log and "total cell updates" in log
    final, step, _ = tck.read_checkpoint(str(tmp_path / "chkpt_final.hdf5"),
                                         drv.level)
    assert step == 2
    for f in entry.STATE_FIELDS:
        assert torch.equal(getattr(final, f), getattr(state, f)), f
    (tmp_path / "halt").write_text("")
    _, steps = _port_driver(CFG, tmp_path).run(max_steps=50, verbose=False)
    assert steps == 0


def test_restart_equals_uninterrupted_run(tmp_path):
    """A run restarted from its step-2 checkpoint reaches step 4 with the
    state of the run that was not interrupted, bitwise (the CFL dt rule,
    not a fixed dt)."""
    deck = LOCK_2D.replace("amr.verbosity = 2", "amr.verbosity = 0")
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    full, _ = _port_driver(deck, tmp_path / "a").run(max_steps=4,
                                                     verbose=False)
    first = _port_driver(deck, tmp_path / "b")
    first.run(max_steps=2, verbose=False)
    resumed, steps = _port_driver(
        deck, tmp_path / "b", "amr.restart_file = chkpt_000002.hdf5").run(
            max_steps=4, verbose=False)
    assert steps == 4
    for f in entry.STATE_FIELDS:
        assert torch.equal(getattr(resumed, f), getattr(full, f)), f


def test_amr_is_refused():
    """RunDriver at amr.maxlevel = 1 builds a two-level hierarchy (on the
    GPU unless told otherwise) and its checkpoints carry the refined level
    (slice 10 ported them); at amr.maxlevel = 2 it builds the nested
    hierarchy and its checkpoints carry both refined levels (slice 11a);
    a refluxing deck builds a refluxing hierarchy (slice 11c)."""
    deck = AMR_CFG
    ctx = TContext.from_parmparse(TPP.from_string(deck))
    drv = TDriver(ctx, device="cpu")
    assert drv.hierarchy is not None and drv.level is drv.hierarchy.level0
    if not torch.cuda.is_available():
        # the default device is the GPU: without one the driver raises
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TDriver(ctx)
    ctx2 = TContext.from_parmparse(TPP.from_string(
        deck + "amr.maxlevel = 2\namr.refratio_lev1 = 2 1\n"))
    drv2 = TDriver(ctx2, device="cpu")
    assert drv2.hierarchy.num_levels == 3
    ctx3 = TContext.from_parmparse(TPP.from_string(
        deck + "amr.advective_momentum_reflux = 1\n"))
    drv3 = TDriver(ctx3, device="cpu")
    assert drv3.hierarchy.reflux_fields == ("vel",)
    assert drv3.hierarchy.couplings[0].flux_register is not None
    h = drv.hierarchy
    s0, fine, origin = entry.place_amr(h)
    c = h.couplings[0]
    tree = tck.checkpoint_tree(s0, h.level0, 0, 0.1, fine_state=[fine],
                               fine_grid=[c.ext_grid], origin=[origin],
                               hierarchy=h)
    assert tree["attrs"]["num_levels"] == 2
    np.testing.assert_array_equal(
        tree["level_1"]["attrs"]["patch_origin"], origin)
    got = tck.state_from_tree(tree, h.level0, fine_grid=c.ext_grid)
    assert torch.equal(got[3].vel, fine.vel)
    h2 = drv2.hierarchy
    s2 = h2.level0.post_initialize(h2.level0.initial_state())
    fines2, origins2 = h2.initial_patch_states(s2)[:2]
    tree2 = tck.checkpoint_tree(
        s2, h2.level0, 0, 0.1, fine_state=fines2,
        fine_grid=[c2.ext_grid for c2 in h2.couplings], origin=origins2,
        hierarchy=h2)
    assert tree2["attrs"]["num_levels"] == 3
    got2 = tck.state_from_tree(tree2, h2.level0,
                               fine_grid=[c2.ext_grid for c2 in h2.couplings])
    for a, b in zip(got2[3], fines2):
        assert torch.equal(a.vel, b.vel)


def test_cli_runs_a_2d_deck(tmp_path, monkeypatch):
    deck = tmp_path / "inputs.lock2d"
    deck.write_text(LOCK_2D)
    monkeypatch.chdir(tmp_path)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli_main(["somar_tpu_torch", "--device", "cpu", str(deck),
                       "amr.maxsteps=3"])
    assert rc == 0
    text = out.getvalue()
    assert "finished 3 steps" in text and "max|div|" in text
    for name in ("plot_000002.2d.hdf5", "chkpt_000002.hdf5",
                 "chkpt_final.hdf5", "pout.0"):
        assert (tmp_path / name).exists(), name
    jctx = JContext.from_parmparse(JPP.from_string(LOCK_2D))
    jl = JLevel(jgeo(jctx.base_grid(), jctx.new_geo_source(),
                     dtype=jctx.ns.dtype), jctx.new_problem(), jctx.ns)
    _, tl, _ = _levels(LOCK_2D)
    for name, step in (("chkpt_000002.hdf5", 2), ("chkpt_final.hdf5", 3)):
        js, jstep, jdt = jck.read_checkpoint(str(tmp_path / name), jl)
        ts, tstep, tdt = tck.read_checkpoint(str(tmp_path / name), tl)
        assert jstep == tstep == step and jdt == tdt
        want, got = _np(js), entry.ns_state_to_numpy(ts)
        for f in entry.STATE_FIELDS:
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)
        assert np.isfinite(want["vel"]).all()


def test_simple_plotfile_matches_jax(tmp_path, tg):
    """write_plotfile, the one-group dump: the same datasets and
    attributes as JAX's, data within 1e-6 of max|field|."""
    jl, tl, js, ts = tg
    deck = CFG + PLOT_FLAGS + "plot.writeStreamFunction = 1\n"
    jplot = JContext.from_parmparse(JPP.from_string(deck)).plot
    tplot = TContext.from_parmparse(TPP.from_string(deck)).plot
    a, b = str(tmp_path / "jax.hdf5"), str(tmp_path / "port.hdf5")
    jck.write_plotfile(a, js, jl, 5, jplot)
    tck.write_plotfile(b, ts, tl, 5, tplot)
    want, got = _walk(a), _walk(b)
    assert sorted(got) == sorted(want)
    for name, (kind, attrs, data) in want.items():
        assert sorted(got[name][1]) == sorted(attrs), name
        if data is None:
            continue
        scale = max(np.abs(data).max(), 1e-30)
        assert np.abs(got[name][2] - data).max() <= 1e-6 * scale, name
