"""The new branches of the single-level physics on the card against the
CPU, at the sizes of chip_smoke.py's small gates (`cuda`-marked: they
skip without an NVIDIA GPU).  No JAX is imported, so on a GPU host they
run with

    python -m pytest tests/test_torch_card_physics.py -m cuda --noconftest

  * every advection option's `trace_face_states` (and the central
    momentum fluxes): the card's kernels and plain torch against the
    CPU's twins, f32, within 1e-5 of max|output|;
  * a callable BC bound at a 0-d device time stays on the device, and an
    array profile moved by `FieldBCs.on_device` fills ghosts there;
  * 3 steps of the 128x64 ramped vortex street, the 64x16x32 HorizConv
    deck and the 32x32x8 leptic lock exchange: card against CPU within
    1e-3 (the solves stop at a tolerance); the 128x128 PLM slotted disk
    within 1e-4;
  * one leptic solve on the 32x32x8 box: gauge-free 1e-3;
  * the batched tracer (three fields, 3D, PPM and PLM): the card's
    kernels against the CPU's twins within 1e-5 of max|output|;
  * the two-level AMR hierarchy of chip_smoke.py's A0 (3D 32x16x16 at
    ratio (4,1,1), 2D 48x16 at (4,1)) placed, projected and stepped 3
    times: card against CPU within 1e-3 of max|field| on both levels
    (the potentials mac_phi and cc_phi with their means removed), the
    same origin;
  * K5 and K6 on every multigrid level of a patch's pressure hierarchy
    (CF sides, boundary factor 1) against their twins, bitwise.
"""

import numpy as np
import pytest
import torch

from somar_tpu_torch import entry
from somar_tpu_torch.config.context import ProblemContext
from somar_tpu_torch.config.parmparse import ParmParse
from somar_tpu_torch.core.bc import BC, FieldBCs, fill_ghosts_cc
from somar_tpu_torch.core.grid import Grid
from somar_tpu_torch.driver import RunDriver
from somar_tpu_torch.geometry.geo_source import CartesianMap
from somar_tpu_torch.geometry.level_geometry import build_level_geometry
from somar_tpu_torch.physics import godunov as gd
from somar_tpu_torch.problems import HorizConv, VortexStreet
from somar_tpu_torch.ops import gsrb_kernels as gk
from somar_tpu_torch.solvers.leptic import LepticParams, LevelLepticSolver
from somar_tpu_torch.solvers.multigrid import LevelMultigrid, MGParams

torch.set_num_threads(1)

FIELDS = ("vel", "scalars", "lam", "pressure")
OPTIONS = [dict(), dict(normal_pred_order=1), dict(normal_pred_order=0),
           dict(use_high_order_limiter=True),
           dict(normal_pred_order=1, use_upwinding=False)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _rel(got, want):
    got = got.cpu().double()
    want = want.cpu().double()
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-30)


def _flat(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if x is None:
        return []
    return [t for v in x for t in _flat(v)]


@pytest.mark.cuda
@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("opts", OPTIONS, ids=["ppm", "plm", "ctu0", "hol",
                                               "plm_central"])
def test_trace_options_on_the_card(cuda_device, opts, ndim):
    nx = (32, 16, 16) if ndim == 3 else (64, 32)
    grid = Grid(nx=nx, dx=tuple(1.0 / n for n in nx))
    G = gd.ADVECT_GROW
    out = {}
    for dev in ("cpu", cuda_device):
        geo = build_level_geometry(grid, CartesianMap(), device=dev)
        bcs = FieldBCs.from_periodic(grid, BC.extrap(1))
        t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
        r = np.random.default_rng(0)
        s = t(r.standard_normal(grid.shape))
        src = t(r.standard_normal(grid.shape))
        u_pad = [fill_ghosts_cc(t(0.5 * r.standard_normal(grid.shape)), grid,
                                bcs, G) for _ in range(ndim)]
        adv = tuple(gd.pad_valid_faces(
            t(0.5 * r.standard_normal(grid.fc_shape(d))), grid, d)
            for d in range(ndim))
        p = gd.AdvectionParams(**opts)
        faces, pre = gd.trace_face_states(s, None, adv, src, 0.02, geo, bcs,
                                          p, u_pad=u_pad, padded=True,
                                          return_pre_riemann=True)
        div = gd.trace_face_states(s, None, adv, src, 0.02, geo, bcs, p,
                                   u_pad=u_pad, padded=True, want_div=True)
        mom = gd.momentum_flux_divergence([pre], adv, geo,
                                          upwind=p.use_upwinding)
        out[str(dev)] = _flat((faces, pre, div, mom))
    for g, w in zip(out[str(cuda_device)], out["cpu"]):
        assert g.device.type == "cuda"
        assert _rel(g, w) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("opts", OPTIONS[:2], ids=["ppm", "plm"])
def test_batched_tracer_on_the_card(cuda_device, opts):
    grid = Grid(nx=(32, 16, 16), dx=(1 / 32, 1 / 16, 1 / 16))
    G = gd.ADVECT_GROW
    out = {}
    for dev in ("cpu", cuda_device):
        geo = build_level_geometry(grid, CartesianMap(), device=dev)
        bcs = FieldBCs.from_periodic(grid, BC.extrap(1))
        t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
        r = np.random.default_rng(1)
        fields = [t(r.standard_normal(grid.shape)) for _ in range(3)]
        u_pad = [fill_ghosts_cc(t(0.5 * r.standard_normal(grid.shape)), grid,
                                bcs, G) for _ in range(3)]
        adv = tuple(gd.pad_valid_faces(
            t(0.5 * r.standard_normal(grid.fc_shape(d))), grid, d)
            for d in range(3))
        faces, pre = gd.trace_face_states_batched(
            fields, [None, fields[0], None], [bcs] * 3, adv, 0.02, geo,
            gd.AdvectionParams(**opts), u_pad, return_pre_riemann=True)
        out[str(dev)] = _flat((faces, pre, gd.flux_divergence_batched(
            faces, adv, geo)))
    for g, w in zip(out[str(cuda_device)], out["cpu"]):
        assert g.device.type == "cuda"
        assert _rel(g, w) <= 1e-5


@pytest.mark.cuda
def test_bound_values_stay_on_the_card(cuda_device):
    grid = Grid(nx=(32, 16), dx=(0.125, 0.125), periodic=(False, True))
    bcs = VortexStreet(ramp_time=0.5).vel_bcs(grid, True)[0]
    t = torch.tensor(0.2, device=cuda_device)
    v = bcs.at_time(t).lo[0].value
    assert isinstance(v, torch.Tensor) and v.device.type == "cuda"
    top = HorizConv().scalar_bcs(Grid(nx=(32, 8), dx=(0.5, 0.25)))
    on = top.on_device(cuda_device, torch.float32)
    field = torch.randn((8, 32), device=cuda_device)
    got = fill_ghosts_cc(field, Grid(nx=(32, 8), dx=(0.5, 0.25)), on, 4)
    want = fill_ghosts_cc(field.cpu(), Grid(nx=(32, 8), dx=(0.5, 0.25)),
                          top, 4)
    assert _rel(got, want) <= 1e-6


def _deck_states(deck, device):
    ctx = ProblemContext.from_parmparse(ParmParse.from_string(deck))
    return [RunDriver(ctx, out_dir=".", device=dev).run(verbose=False)[0]
            for dev in ("cpu", device)]


HORIZ_DECK = """
amr.nx = 64 16 32
amr.length = 15 2 2
amr.nx_offset = -32 0 0
amr.isPeriodic = 0 1 0
ibc.problem = 6
amr.viscosity = 1e-4
amr.scal_diffusion_coeffs = 1e-4
amr.fixed_dt = 0.01
amr.maxsteps = 3
plot.plot_interval = -1
plot.checkpoint_interval = -1
amr.verbosity = 0
"""
DISK_DECK = """
amr.nx = 128 128
amr.length = 1 1
amr.isPeriodic = 1 1
ibc.problem = 0
projection.isIncompressible = 0
amr.gravityMethod = 0
advection.normalPredOrderVel = 1
advection.normalPredOrderScal = 1
amr.fixed_dt = 0.002
amr.maxsteps = 3
plot.plot_interval = -1
plot.checkpoint_interval = -1
amr.verbosity = 0
"""
LEPTIC_DECK = """
amr.nx = 32 32 8
amr.length = 64 64 1
amr.nx_offset = -16 0 0
ibc.problem = 1
amr.viscosity = 1e-4
amr.scal_diffusion_coeffs = 1e-4
projection.solver = 2
amr.fixed_dt = 0.02
amr.maxsteps = 2
plot.plot_interval = -1
plot.checkpoint_interval = -1
amr.verbosity = 0
"""


@pytest.mark.cuda
@pytest.mark.parametrize("deck,rtol", [(HORIZ_DECK, 1e-3), (DISK_DECK, 1e-4),
                                       (LEPTIC_DECK, 1e-3)],
                         ids=["horiz_conv", "plm_disk", "leptic_lock"])
def test_decks_on_the_card(cuda_device, deck, rtol, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    try:
        import h5py  # noqa: F401
    except ImportError:
        # a GPU host without h5py: the driver's final checkpoint is not
        # stored (the comparison reads the returned states only)
        from somar_tpu_torch.io import checkpoint
        monkeypatch.setattr(checkpoint, "write_tree", lambda path, tree: None)
    cpu, card = _deck_states(deck, cuda_device)
    for f in FIELDS:
        assert _rel(getattr(card, f), getattr(cpu, f)) <= rtol, f


@pytest.mark.cuda
def test_ramped_vortex_street_on_the_card(cuda_device):
    states = {}
    for dev in ("cpu", cuda_device):
        level, _ = entry.build_vortex_level(128, 64, ramp_time=1.0,
                                            device=dev)
        s = level.post_initialize(level.initial_state())
        for _ in range(3):
            s = level.advance(s, 0.01)
        states[str(dev)] = s
    for f in FIELDS:
        assert _rel(getattr(states[str(cuda_device)], f),
                    getattr(states["cpu"], f)) <= 1e-3, f


@pytest.mark.cuda
def test_leptic_solve_on_the_card(cuda_device):
    grid = Grid(nx=(32, 32, 8), dx=(2.0, 2.0, 0.125))
    bcs = FieldBCs.from_periodic(grid, BC.neumann(0.0))
    rhs = torch.randn(grid.shape, generator=torch.Generator().manual_seed(0))
    rhs = rhs - rhs.mean()
    phis = {}
    for dev in ("cpu", cuda_device):
        geo = build_level_geometry(grid, CartesianMap(), device=dev)
        phi, (_, relres, _) = LevelLepticSolver(
            geo, bcs, LepticParams()).solve_with_fallback(rhs.to(dev))
        assert relres < 1e-3
        phis[str(dev)] = phi - phi.mean()
    assert _rel(phis[str(cuda_device)], phis["cpu"]) <= 1e-3


AMR_A0 = {"3d": ((32, 16, 16), (4, 1, 1)), "2d": ((48, None, 16), (4, 1))}


def _amr_run(device, shape, ratio):
    h = entry.build_amr_hierarchy(*shape, ratio, device=device,
                                  mg=MGParams(eps=1e-5, imax=12))
    s0, fine, origin = entry.place_amr(h)
    s0, fine = entry.run_amr(h, s0, fine, origin, 0.02, 3)
    return s0, fine, origin


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(AMR_A0))
def test_amr_hierarchy_on_the_card(cuda_device, case):
    shape, ratio = AMR_A0[case]
    card = _amr_run(cuda_device, shape, ratio)
    cpu = _amr_run("cpu", shape, ratio)
    assert list(card[2]) == list(cpu[2])
    for a, b in zip(card[:2], cpu[:2]):
        for f in FIELDS:
            assert _rel(getattr(a, f), getattr(b, f)) <= 1e-3, f
        for f in ("mac_phi", "cc_phi"):   # pure Neumann: gauge-free
            x, y = getattr(a, f), getattr(b, f)
            assert _rel(x - x.mean(), y - y.mean()) <= 1e-3, f


@pytest.mark.cuda
def test_k5_on_a_cf_level_on_the_card(cuda_device):
    h = entry.build_amr_hierarchy(32, 16, 16, (4, 1, 1), device=cuda_device)
    lvl = h.couplings[0].level
    mg = LevelMultigrid(lvl.geo, lvl.projector.phi_bcs, MGParams())
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    for op in mg.ops:
        plan = op._fused_plan
        assert plan is not None and 1.0 in plan.flo + plan.fhi
        phi, rhs = (torch.randn(plan.shape, generator=gen,
                                device=cuda_device) for _ in range(2))
        for alpha, beta in ((0.0, 1.0), (1.0, -1e-6)):
            want = gk.gsrb_sweeps_plain(plan, phi, rhs, alpha, beta, 4)
            got = gk.gsrb_sweeps(plan, phi, rhs, alpha, beta, 4)
            assert float((got - want).abs().max()) == 0.0
            got = gk.helm_residual(plan, phi, rhs, alpha, beta)
            want = gk.helm_residual_plain(plan, phi, rhs, alpha, beta)
            assert float((got - want).abs().max()) == 0.0
