#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its result on its own line; any failure exits
non-zero:
  1. device: nvidia-smi name and power limit, torch and CUDA versions
     (no CUDA device: exit 2, nothing else runs);
  2. build: compile the CTU kernels K1-K4, the GSRB kernels K5-K6 and the
     probed-stencil kernels K7-K8 with nvcc for sm_90a, the three libraries
     side by side;
  3. kernel parity: each kernel against its plain PyTorch twin on the same
     card tensors, full arrays: K2-K4 and K8 within 1e-6 max|input|, K1,
     K6 and the smoothers K5 and K7 bitwise (max abs diff 0.0), K5 and K7
     in each of their variants (the plan's choice, then "whole" where the
     level fits one block's shared memory and "tiled", each forced).  K1
     at the padded shapes of main paths 1 and 3, (136, 136, 520) and
     (520, 648), and at (136, 520), every axis, limited and not, f32 and
     f64; K2-K4 at (136, 136, 520) f32, every stencil axis and mode;
     K5-K6 at (128, 128, 512) with the pressure BCs and with mixed
     BCs, in 2D, on periodic extents 2 and 3, and on every multigrid level
     of main path 2 in f32 and f64; K7-K8 on the seven mapped levels of
     tests/test_torch_stencil_kernels.py (2D and 3D, periodic extents 3
     and 4) and on the eight multigrid levels of main path 3 that have a
     stencil plan, in f32 and f64, with and without the implicit-gravity
     delta overrides; then the K5/K7 launches of one 4-sweep relax call on
     every level of paths 2 and 3 (1 where the level takes the whole-level
     variant, 4 where it takes the tiled one);
  4. kernel timing: median time of one call of each kernel and of its twin
     (CUDA events) and the kernel's own device time (torch.profiler), K1
     per stencil axis at (136, 136, 520) and (520, 648), K2-K4 averaged
     over the stencil axes, K5 per sweep (one tiled launch) at (128, 128,
     512), K6 per call on every multigrid level of main path 2, f32; K7
     per sweep and K8 per call at the
     BeamGeneration level (512, 640), K = 8, and at a twisted 3D level
     (128, 256, 256), K = 18 (the most a mapped operator probes in 3D),
     f32; beside each the least time the card could take for the same
     bytes and operations;
  5. solve and step parity: one multigrid solve at 64x16x32 on the card
     against the CPU from the same rhs (phi within 1e-4 max|phi|); the
     64x16x32 lock exchange stepped 5 times at a fixed dt on the card and on
     the CPU from one state, max|diff| / max|field| <= 1e-4 with spectral
     and <= 1e-3 with multigrid pressure solves;
  6. main path 1: the 512x128x128 lock exchange with spectral solves through
     entry.run (20 steps, CFL 0.9), checked for finite fields, buoyancy
     within (-0.1, 1.1), no energy growth beyond 2e-4 E0 and launches of
     K1-K4; then 3 timed samples of 10 steps;
  7. main path 2: the same level with multigrid-forced pressure solves
     (MGParams(eps=1e-5, imax=12)) through entry.run (10 steps), the same
     checks plus launches of every kernel K1-K6, the V-cycle counts and
     residuals of the first and the last step; then 3 timed samples of 5
     steps with the kernel launches per step, K6's by multigrid level, and
     K6's launches x device time and launches x (device time - bound)
     summed over the levels;
  8. the mapped step on the card against the CPU: one implicit-gravity
     multigrid solve (phi within 1e-4 max|phi|) and 5 steps of the 40x32
     BeamGeneration level (max|diff| / max|field| <= 1e-3);
  9. main path 3: the 640x512 BeamGeneration level (entry.build_beam_level:
     terrain-following metric, implicit gravity, multigrid everywhere)
     through entry.run (20 steps), checked for finite fields, max|u| <=
     10 U0, solves that reduce their residual, and launches of K1, K3, K4,
     K7 and K8; V-cycles and residuals of every projection; then 3 timed
     samples of 3 steps.
The line before the last is a JSON object describing each kernel; the last
line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

SHAPE3 = (136, 136, 520)      # 512x128x128 plus ADVECT_GROW ghosts
SHAPE2 = (136, 520)           # 512x128 (x, z) plus ghosts
BEAM_PAD = (520, 648)         # main path 3's 640x512 level plus ghosts
PARITY_RTOL = 1e-6
STEP_RTOL = 1e-4
MG_STEP_RTOL = 1e-3           # multigrid stops at a tolerance
MG_SOLVE_RTOL = 1e-4
GSRB_SHAPE = (128, 128, 512)  # the finest multigrid level of 512x128x128
ENERGY_GROWTH = 2e-4          # tests/test_lock_exchange.py:127
#: the lock exchange's buoyancy bound of tests/test_lock_exchange.py:56;
#: the PPM step itself over- and undershoots [0, 1] by a few percent
B_BOUNDS = (-0.1, 1.1)
#: kernel -> (source, TPU kernel it replaces, arrays moved per call at the
#: timed configuration, flops per cell counted from the source)
CTU_SOURCE = "somar_tpu_torch/csrc/ctu_kernels.cu"
GSRB_SOURCE = "somar_tpu_torch/csrc/gsrb_kernels.cu"
STENCIL_SOURCE = "somar_tpu_torch/csrc/stencil_gsrb_kernels.cu"
KERNELS = {
    # K1 reads s, u and writes lo, hi, corr; one PPM evaluation a cell
    # (~58 flops with the limiter) and one Riemann state and correction a
    # face (~9)
    "ppm_predict": (CTU_SOURCE, "somar_tpu/ops/pallas_kernels.py:252",
                    5, 70),
    # K2 with two corrections: reads lo1, hi1, u, 2 corr; writes 2
    "ctu_corr3": (CTU_SOURCE, "somar_tpu/ops/pallas_kernels.py:315", 7, 40),
    # K3 want_div: reads lo1, hi1, adv, 2 corr, src; writes 1
    "ctu_final": (CTU_SOURCE, "somar_tpu/ops/pallas_kernels.py:398", 7, 30),
    # K4 with three fields: reads adv and 3 (lo, hi) pairs; writes 3
    "riemann_fluxdiv": (CTU_SOURCE, "somar_tpu/ops/pallas_kernels.py:468",
                        10, 30),
    # K5, one sweep: reads phi and rhs, writes phi; two half sweeps of a
    # 3-axis stencil, a diagonal and a division on half the cells each
    "gsrb_sweeps": (GSRB_SOURCE, "somar_tpu/ops/gsrb_pallas.py:368", 3, 50),
    # K6: reads phi and rhs, writes the residual; 5 flops an axis and 4
    "helm_residual": (GSRB_SOURCE, "somar_tpu/ops/gsrb_pallas.py:387", 3,
                      20),
    # K7, one sweep at K weight planes: reads phi, rhs, Wn, R, w0, writes
    # phi; 3K + 10 flops a cell (see STENCIL_ARRAYS)
    "stencil_gsrb_sweeps": (STENCIL_SOURCE,
                            "somar_tpu/ops/stencil_gsrb_pallas.py:497",
                            None, None),
    # K8: reads phi, rhs, Wn, R, writes the residual; 3K + 5 flops a cell
    "stencil_helm_residual": (STENCIL_SOURCE,
                              "somar_tpu/ops/stencil_gsrb_pallas.py:524",
                              None, None),
}
#: K7/K8 arrays moved and flops per cell as functions of K
STENCIL_ARRAYS = {"stencil_gsrb_sweeps": (lambda K: K + 5,
                                          lambda K: 3 * K + 10),
                  "stencil_helm_residual": (lambda K: K + 4,
                                            lambda K: 3 * K + 5)}
#: the CUDA kernel names of the smoothers' two variants (neither K5's nor
#: K7's is a substring of the other's)
K5_NAMES = ("uniform_gsrb_whole_kernel", "uniform_gsrb_tiled_kernel")
K7_NAMES = ("stencil_gsrb_whole_kernel", "stencil_gsrb_tiled_kernel")
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (data sheet)
F32_FLOPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores


class PhaseError(RuntimeError):
    pass


def say(msg):
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------
# phase 3/4: kernels against their plain twins
# --------------------------------------------------------------------------
def kernel_cases(torch, ck, device, shape3, shape2):
    """(kernel name, label, inputs, kernel call, twin call) per case."""
    gen = torch.Generator(device=device).manual_seed(1234)

    def rnd(shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=device, dtype=dtype)

    cases = []
    for shape in (shape3, shape2, BEAM_PAD):
        for dtype in (torch.float32, torch.float64):
            for ax in range(len(shape)):
                s, u = rnd(shape, dtype), 0.5 * rnd(shape, dtype)
                for lim in (True, False):
                    args = (s, u, 0.3, ax, lim, 0.1)
                    cases.append((
                        "ppm_predict", f"{len(shape)}d {shape} ax{ax} "
                        f"lim={lim} f{8 * s.element_size()}", (s, u),
                        lambda a=args: ck.ppm_predict(*a),
                        lambda a=args: ck.ppm_predict_plain(*a)))
    for shape in (shape3, shape2):
        nd = len(shape)
        for ax in range(nd):
            if nd == 3:
                ins = [rnd(shape) for _ in range(5)]
                args = (ins[0], ins[1], ins[2], ins[3:], 0.25, ax)
                cases.append(("ctu_corr3", f"3d ax{ax} ncorr=2", ins,
                              lambda a=args: ck.ctu_corr3(*a),
                              lambda a=args: ck.ctu_corr3_plain(*a)))
                pairs = [(rnd(shape), rnd(shape)) for _ in range(3)]
                adv = rnd(shape)
                args = (pairs, adv, ax)
                cases.append(("riemann_fluxdiv", f"3d ax{ax} nf=3",
                              [adv] + [x for p in pairs for x in p],
                              lambda a=args: ck.riemann_fluxdiv(*a),
                              lambda a=args: ck.riemann_fluxdiv_plain(*a)))
            lo1, hi1, adv, src = (rnd(shape) for _ in range(4))
            c3 = [rnd(shape) for _ in range(2 if nd == 3 else 1)]
            modes = ((("div", dict(want_div=True)),
                      ("rie+pre", dict(want_rie=True, want_pre=True)),
                      ("pre", dict(want_rie=False, want_pre=True)))
                     if nd == 3 else (("div", dict(want_div=True)),))
            for mode, flags in modes:
                args = (lo1, hi1, adv, c3, src, 0.05, ax)
                cases.append(("ctu_final", f"{nd}d ax{ax} {mode}",
                              [lo1, hi1, adv, src] + c3,
                              lambda a=args, f=flags: ck.ctu_final(*a, **f),
                              lambda a=args, f=flags: ck.ctu_final_plain(
                                  *a, **f)))
    return cases


def kernel_parity(torch, ck, device, shape3=SHAPE3, shape2=SHAPE2):
    """Returns {kernel: max abs err over its cases}; raises where K1
    differs from its twin in any bit or K2-K4 by more than PARITY_RTOL *
    max|input|."""
    worst = {}
    for name, label, ins, kern, plain in kernel_cases(torch, ck, device,
                                                      shape3, shape2):
        got, want = kern(), plain()
        if device != "cpu":
            torch.cuda.synchronize()
        scale = max(float(t.abs().max()) for t in ins)
        limit = 0.0 if name == "ppm_predict" else PARITY_RTOL * scale
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        ok = err <= limit and len(got) == len(want)
        say(f"parity {name:16s} {label:18s} max_abs_err={err:.3e} "
            f"limit={limit:.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise PhaseError(f"{name} {label}: kernel and twin disagree")
        worst[name] = max(worst.get(name, 0.0), err)
    return worst


def median_ms(torch, fn, reps=50):
    """Median time of one call of fn over `reps` calls after 0.2 s of
    back-to-back calls (CUDA events)."""
    from somar_tpu_torch.kernel_bench import warm
    warm(torch, fn)
    samples = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        samples.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in samples)


def kernel_timing(torch, ck, device):
    """{kernel: (ms, plain_ms, device_ms)}: median per-launch times and the
    kernels' own device time of K2-K4, averaged over the 3D stencil axes
    (K1: k1_timing)."""
    per = {}
    for name, label, _, kern, plain in kernel_cases(torch, ck, device,
                                                    SHAPE3, SHAPE2):
        if name == "ppm_predict" or not label.startswith("3d") \
                or (name == "ctu_final" and "div" not in label):
            continue      # the scalar-path variant of K3: want_div
        times = [median_ms(torch, kern), median_ms(torch, plain),
                 device_ms(torch, kern, (f"{name}_kernel",))]
        say(f"timing {name:16s} {label:18s} kernel={times[0]:.4f} ms "
            f"plain={times[1]:.4f} ms kernel device time={times[2]:.4f} ms")
        per.setdefault(name, []).append(times)
    return {name: tuple(statistics.mean(t[i] for t in v) for i in range(3))
            for name, v in per.items()}


def k1_timing(torch, ck, device):
    """{(shape, ax): (ms, plain_ms, device_ms)} of K1 (limited, f32) along
    every axis of main path 1's padded array and of main path 3's."""
    gen = torch.Generator(device=device).manual_seed(77)
    out = {}
    for shape in (SHAPE3, BEAM_PAD):
        for ax in range(len(shape)):
            s, u = (torch.randn(shape, generator=gen, device=device)
                    for _ in range(2))
            args = (s, u, 0.3, ax, True, 0.1)
            out[shape, ax] = (
                median_ms(torch, lambda: ck.ppm_predict(*args)),
                median_ms(torch, lambda: ck.ppm_predict_plain(*args)),
                device_ms(torch, lambda: ck.ppm_predict(*args),
                          ("ppm_predict_",)))
            route, chunk = ck.ppm_launch_shape(shape, ax)
            bound, by = bound_ms("ppm_predict", s.numel())
            say(f"timing ppm_predict      {str(shape):16s} ax{ax} "
                f"{route}/{chunk:<4d} kernel={out[shape, ax][0]:.4f} ms "
                f"plain={out[shape, ax][1]:.4f} ms kernel device time="
                f"{out[shape, ax][2]:.4f} ms bound={bound:.4f} ms ({by})")
    return out


# --------------------------------------------------------------------------
# phase 3/4 for the GSRB kernels K5-K6
# --------------------------------------------------------------------------
def gsrb_plan(gk, nx, periodic, lo, hi):
    """FusedPlan of a grid with the lock exchange's spacings per cell count
    and the named BCs per logical direction."""
    from somar_tpu_torch.core.bc import BC, BCType, FieldBCs
    from somar_tpu_torch.core.grid import Grid
    mk = {"N": BC.neumann(), "D": BC.dirichlet(), "P": BC.periodic(),
          "C": BC(BCType.CF), "E": BC.extrap(0)}
    length = (15.0, 2.0, 2.0) if len(nx) == 3 else (15.0, 2.0)
    grid = Grid(nx=nx, dx=tuple(L / n for L, n in zip(length, nx)),
                periodic=periodic)
    plan = gk.make_plan(grid, FieldBCs(lo=tuple(mk[c] for c in lo),
                                       hi=tuple(mk[c] for c in hi)))
    if plan is None:
        raise PhaseError(f"no GSRB plan for {nx} {lo}/{hi}")
    return plan


#: label -> (nx, periodic, lo BCs, hi BCs, dtype name); array shapes are nx
#: reversed.  First the finest level of main path 2 with the pressure BCs.
GSRB_CASES = {
    "pressure 128,128,512": ((512, 128, 128), (False, True, False),
                             "NPN", "NPN", "float32"),
    "mixed 128,128,512": ((512, 128, 128), (False, False, False),
                          "DCN", "NCE", "float32"),
    "2d 128,512": ((512, 128), (True, False), "PD", "PN", "float32"),
    "coarse 2,2,8": ((8, 2, 2), (False, True, False), "NPN", "NPN",
                     "float32"),
    "coarse 2,2,2": ((2, 2, 2), (False, True, False), "NPN", "NPN",
                     "float32"),
    "walls 3,5,7": ((7, 5, 3), (False, False, False), "NDN", "DNN",
                    "float32"),
    "periodic 2 and 3": ((6, 3, 2), (False, True, True), "NPP", "DPP",
                         "float32"),
    "pressure f64 64,64,256": ((256, 64, 64), (False, True, False),
                               "NPN", "NPN", "float64"),
}
GSRB_COEFS = ((0.0, 1.0), (1.0, -1e-6))     # Poisson, viscous Helmholtz


#: the multigrid levels of main path 2 (array shapes), each with the
#: pressure BCs in f32 and f64
PATH2_LEVELS = [(128, 128, 512), (64, 64, 256), (32, 32, 128), (16, 16, 64),
                (8, 8, 32), (4, 4, 16), (2, 2, 8), (2, 2, 4), (2, 2, 2)]
for _shape in PATH2_LEVELS:
    for _dt in ("float32", "float64"):
        GSRB_CASES[f"path2 {_shape} f{_dt[5:]}"] = (
            _shape[::-1], (False, True, False), "NPN", "NPN", _dt)


def smoother_variants(rb, shape, itemsize):
    """The variants to hold against the twin: the plan's own choice, then
    each one forced where it fits."""
    fits = 2 * math.prod(shape) * itemsize <= rb.SMEM_PER_BLOCK
    return [None, rb.TILED] + ([rb.WHOLE] if fits else [])


def smoother_check(name, label, got, want, line):
    """Bitwise: the smoothers round as their twins do."""
    err = float((got - want).abs().max())
    ok = err == 0.0 and got.shape == want.shape \
        and bool(got.isfinite().all())
    say(f"{line} max_abs_err={err:.3e} limit=0 (bitwise) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise PhaseError(f"{name} {label}: kernel and twin disagree")
    return err


def gsrb_parity(torch, gk, device):
    """Returns {kernel: max abs err over its cases}; raises where K5 or K6
    differs from its twin in any bit."""
    from somar_tpu_torch.ops import rb_sweeps as rb
    worst = {"gsrb_sweeps": 0.0, "helm_residual": 0.0}
    gen = torch.Generator(device=device).manual_seed(4321)
    for label, (nx, per, lo, hi, dtname) in GSRB_CASES.items():
        plan = gsrb_plan(gk, nx, per, lo, hi)
        dtype = getattr(torch, dtname)
        phi, rhs = (torch.randn(plan.shape, generator=gen, device=device,
                                dtype=dtype) for _ in range(2))
        for alpha, beta in GSRB_COEFS:
            for it in (1, 4):
                want = gk.gsrb_sweeps_plain(plan, phi, rhs, alpha, beta, it)
                for var in smoother_variants(rb, plan.shape,
                                             phi.element_size()):
                    got = gk.gsrb_sweeps(plan, phi, rhs, alpha, beta, it,
                                         variant=var)
                    torch.cuda.synchronize()
                    worst["gsrb_sweeps"] = max(
                        worst["gsrb_sweeps"], smoother_check(
                            "gsrb_sweeps", label, got, want,
                            f"parity gsrb_sweeps      {label:22s} a={alpha} "
                            f"b={beta} iters={it} variant={var or 'plan'}"))
            got = gk.helm_residual(plan, phi, rhs, alpha, beta)
            want = gk.helm_residual_plain(plan, phi, rhs, alpha, beta)
            torch.cuda.synchronize()
            worst["helm_residual"] = max(
                worst["helm_residual"], smoother_check(
                    "helm_residual", label, got, want,
                    f"parity helm_residual    {label:22s} a={alpha} "
                    f"b={beta}"))
    return worst


def relax_launches(torch, ops, mod, name, label):
    """K5/K7 launches of one 4-sweep relax call on each multigrid level:
    {shape: launches}; raises unless a level with a plan makes 1 launch
    (whole-level variant) or 4 (tiled), as rb_sweeps chooses."""
    from somar_tpu_torch.ops import rb_sweeps as rb
    out = {}
    for op in ops:
        plan = op._fused_plan if name == "gsrb_sweeps" else op._stencil_plan
        phi = torch.zeros(op.grid.shape, device=op.geo.device,
                          dtype=op.geo.dtype)
        rhs = torch.ones_like(phi)
        mod.reset_launch_counts()
        op.relax_gsrb(phi, rhs, 0.0, 1.0, 4)
        torch.cuda.synchronize()
        n = mod.launch_counts()[name]
        want = 0
        if plan is not None:
            var, _ = rb.choose_variant(plan.shape, phi.element_size())
            want = rb.launches_per_call(var, 4)
        out[str(tuple(op.grid.shape))] = n
        if n != want:
            raise PhaseError(f"{label} level {op.grid.shape}: {n} {name} "
                             f"launches for a 4-sweep relax, not {want}")
    say(f"{label}: {name} launches per 4-sweep relax call by level "
        f"{json.dumps(out)}")
    return out


def path2_relax_launches(torch, gk, device, mg):
    """K5 launches of a 4-sweep relax call on each multigrid level of main
    path 2, as LevelMultigrid builds them on the card."""
    from somar_tpu_torch.core.grid import Grid
    from somar_tpu_torch.geometry.geo_source import CartesianMap
    from somar_tpu_torch.geometry.level_geometry import build_level_geometry
    from somar_tpu_torch.projection.projector import pressure_bcs
    from somar_tpu_torch.solvers.multigrid import LevelMultigrid
    grid = Grid(nx=(512, 128, 128), dx=(15.0 / 512, 2.0 / 128, 2.0 / 128),
                periodic=(False, True, False))
    geo = build_level_geometry(grid, CartesianMap(), device=device)
    levels = LevelMultigrid(geo, pressure_bcs(grid), mg)
    shapes = [tuple(op.grid.shape) for op in levels.ops]
    if shapes != PATH2_LEVELS:
        raise PhaseError(f"path 2 multigrid levels {shapes}")
    return relax_launches(torch, levels.ops, gk, "gsrb_sweeps",
                          "main path 2")


def gsrb_timing(torch, gk, device):
    """{"gsrb_sweeps": (ms, plain_ms, device_ms)}: K5 per sweep (iters=1:
    one tiled launch) at GSRB_SHAPE f32 with the pressure BCs (K6:
    k6_level_timing)."""
    nx, per, lo, hi, _ = GSRB_CASES["pressure 128,128,512"]
    plan = gsrb_plan(gk, nx, per, lo, hi)
    gen = torch.Generator(device=device).manual_seed(99)
    phi, rhs = (torch.randn(plan.shape, generator=gen, device=device)
                for _ in range(2))
    times = (median_ms(torch, lambda: gk.gsrb_sweeps(plan, phi, rhs, 0.0,
                                                     1.0, 1)),
             median_ms(torch, lambda: gk.gsrb_sweeps_plain(plan, phi, rhs,
                                                           0.0, 1.0, 1)),
             device_ms(torch, lambda: gk.gsrb_sweeps(plan, phi, rhs, 0.0,
                                                     1.0, 1), K5_NAMES))
    say(f"timing gsrb_sweeps      {'pressure 128,128,512':22s} "
        f"kernel={times[0]:.4f} ms plain={times[1]:.4f} ms "
        f"kernel device time={times[2]:.4f} ms")
    return {"gsrb_sweeps": times}


def k6_level_timing(torch, gk, device):
    """{level shape: (ms, plain_ms, device_ms)} of K6 (f32, pressure BCs)
    on every multigrid level of main path 2."""
    gen = torch.Generator(device=device).manual_seed(98)
    out = {}
    for shape in PATH2_LEVELS:
        plan = gsrb_plan(gk, shape[::-1], (False, True, False), "NPN", "NPN")
        phi, rhs = (torch.randn(shape, generator=gen, device=device)
                    for _ in range(2))
        out[shape] = (
            median_ms(torch, lambda: gk.helm_residual(plan, phi, rhs, 0.0,
                                                      1.0)),
            median_ms(torch, lambda: gk.helm_residual_plain(plan, phi, rhs,
                                                            0.0, 1.0)),
            device_ms(torch, lambda: gk.helm_residual(plan, phi, rhs, 0.0,
                                                      1.0),
                      ("helm_residual_kernel",)))
        bound, by = bound_ms("helm_residual", phi.numel())
        say(f"timing helm_residual    {str(shape):16s} "
            f"kernel={out[shape][0]:.4f} ms plain={out[shape][1]:.4f} ms "
            f"kernel device time={out[shape][2]:.4f} ms "
            f"bound={bound:.4f} ms ({by})")
    return out


def bound_ms(name, ncells, itemsize=4, K=None):
    """(least ms the card could take, what bounds it): the larger of the
    bytes the function must move over the memory rate and its operations
    over the float32 rate, for `ncells` cells per array (K7-K8: with K
    weight planes)."""
    _, _, arrays, flops = KERNELS[name]
    if name in STENCIL_ARRAYS:
        arrays, flops = (f(K) for f in STENCIL_ARRAYS[name])
    t_bytes = arrays * ncells * itemsize / HBM_BYTES_PER_S
    t_ops = flops * ncells / F32_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


# --------------------------------------------------------------------------
# phase 5: the step on the card against the step on the CPU
# --------------------------------------------------------------------------
def solve_parity(torch, device, mg_params, nx=64, ny=16, nz=32):
    """One multigrid solve of the singular pressure Poisson problem on the
    card against the CPU, from the same rhs."""
    from somar_tpu_torch.core.grid import Grid
    from somar_tpu_torch.geometry.geo_source import CartesianMap
    from somar_tpu_torch.geometry.level_geometry import build_level_geometry
    from somar_tpu_torch.projection.projector import pressure_bcs
    from somar_tpu_torch.solvers.multigrid import LevelMultigrid
    grid = Grid(nx=(nx, ny, nz), dx=(15.0 / nx, 2.0 / ny, 2.0 / nz),
                periodic=(False, True, False))
    rhs = torch.randn(grid.shape, generator=torch.Generator().manual_seed(7))
    out = {}
    for dev in ("cpu", device):
        geo = build_level_geometry(grid, CartesianMap(), device=dev)
        mg = LevelMultigrid(geo, pressure_bcs(grid), mg_params)
        phi, info = mg.solve(rhs.to(dev))
        out[dev] = (phi.cpu(), info)
    (p_cpu, i_cpu), (p_dev, i_dev) = out["cpu"], out[device]
    err = float((p_cpu - p_dev).abs().max()) / float(p_cpu.abs().max())
    say(f"solve parity {nx}x{ny}x{nz}: phi={err:.3e} limit={MG_SOLVE_RTOL} "
        f"V-cycles cpu={i_cpu[0]} card={i_dev[0]} relres cpu={i_cpu[1]:.3e} "
        f"card={i_dev[1]:.3e}")
    if not (err <= MG_SOLVE_RTOL and i_dev[1] <= mg_params.eps
            and i_cpu[1] <= mg_params.eps):
        raise PhaseError("card and CPU multigrid solves disagree")


def step_parity(torch, entry, device, nx=64, ny=16, nz=32, nsteps=5,
                dt=0.01, rtol=STEP_RTOL, **level_kw):
    cpu_level, _ = entry.build_level(nx=nx, nz=nz, ny=ny, device="cpu",
                                     **level_kw)
    dev_level, _ = entry.build_level(nx=nx, nz=nz, ny=ny, device=device,
                                     **level_kw)
    s_cpu = cpu_level.post_initialize(cpu_level.initial_state())
    s_dev = entry.ns_state_from_numpy(entry.ns_state_to_numpy(s_cpu),
                                      device=device)
    for _ in range(nsteps):
        s_cpu = cpu_level.advance(s_cpu, dt)
        s_dev = dev_level.advance(s_dev, dt)
    a, b = entry.ns_state_to_numpy(s_cpu), entry.ns_state_to_numpy(s_dev)
    errs = {}
    for f in ("vel", "scalars", "pressure"):
        scale = float(abs(a[f]).max())
        errs[f] = float(abs(a[f] - b[f]).max()) / scale
    say(f"step parity {nx}x{ny}x{nz} {nsteps} steps dt={dt} "
        f"pressure={dev_level.projector.method}: "
        + " ".join(f"{f}={e:.3e}" for f, e in errs.items())
        + f" limit={rtol}")
    if not all(e <= rtol for e in errs.values()):
        raise PhaseError("card and CPU steps disagree")
    return errs


# --------------------------------------------------------------------------
# phases 6 and 7: the main paths at full width
# --------------------------------------------------------------------------
def main_path(torch, entry, counters, device, smi="", label="spectral",
              nx=512, ny=128, nz=128, nsteps=20, samples=3, sample_steps=10,
              **level_kw):
    """Drive one main path through entry.run and check it; `counters` are
    the kernel modules whose launch counts are set to 0 just before the run
    and read just after (every counted kernel must have been launched).
    Returns (launches of the run, launches per timed step, ms/step, {kernel:
    {level shape: launches per timed step}} of the kernels that count by
    level)."""
    from somar_tpu_torch.solvers.host_reads import read_scalars
    level, grid = entry.build_level(nx=nx, nz=nz, ny=ny, device=device,
                                    **level_kw)
    state = level.initial_state()
    energies, infos = [], []

    def on_step(i, s, dt):
        energies.append(float(level.total_energy(s)))
        infos.append(dict(level.projector.last_info))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mod in counters:
        mod.reset_launch_counts()
    t0 = time.perf_counter()
    state = entry.run(level, state, nsteps, on_step=on_step)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {}
    for mod in counters:
        launches.update(mod.launch_counts())

    b = state.scalars[0]
    finite = all(bool(torch.isfinite(getattr(state, f)).all())
                 for f in ("vel", "scalars", "lam", "pressure"))
    bmin, bmax = float(b.min()), float(b.max())
    e0 = energies[0]
    emax = max(energies)
    say(f"main path {label} {grid.nx} {nsteps} steps in {run_s:.2f} s "
        f"(with set-up): t={float(state.time):.4f} b in [{bmin:.6f}, "
        f"{bmax:.6f}] E0={e0:.6f} Emax={emax:.6f} finite={finite} "
        f"launches={json.dumps(launches)}")
    for which, info in (("first", infos[1]), ("last", infos[-1])):
        say(f"main path {label} {which} step solves: " + " ".join(
            f"{purpose}: iterations={it} relres={rr:.3e}"
            for purpose, (it, rr) in sorted(info.items())))
    if not finite:
        raise PhaseError("non-finite state")
    if not (B_BOUNDS[0] < bmin and bmax < B_BOUNDS[1]):
        raise PhaseError(f"buoyancy out of {B_BOUNDS}")
    if emax > e0 * (1.0 + ENERGY_GROWTH):
        raise PhaseError("total energy grew")
    if not all(n > 0 for n in launches.values()):
        raise PhaseError(f"a kernel was never launched on the {label} path")

    # timed samples: dt varies by 1e-6 relative on every call, one
    # synchronize per sample
    dt = level.compute_dt(state)
    k = 0
    times = []
    reads0 = read_scalars.count
    for mod in counters:
        mod.reset_launch_counts()
    for _ in range(samples):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(sample_steps):
            k += 1
            state = level.advance(state, dt * (1.0 + 1e-6 * k))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) / sample_steps)
    reads = (read_scalars.count - reads0) / (samples * sample_steps)
    per_step = {}
    for mod in counters:
        per_step.update({n: c / (samples * sample_steps)
                         for n, c in mod.launch_counts().items()})
    by_level = {k.__name__: {sh: c / (samples * sample_steps)
                             for sh, c in k.launches_by_shape.items()}
                for mod in counters for k in mod.KERNELS
                if hasattr(k, "launches_by_shape")}
    diag = {}
    state = level.advance(state, dt, diag=diag)
    if not bool(torch.isfinite(state.vel).all()):
        raise PhaseError("non-finite state after the timed steps")
    for name, per_level in by_level.items():
        say(f"main path {label}: {name} launches per step by level "
            + json.dumps({str(sh): v for sh, v in per_level.items()}))
    ms = 1e3 * statistics.median(times)
    peak = torch.cuda.max_memory_allocated()
    say(f"main path {label} timing {grid.nx}: ms/step={ms:.3f} samples="
        + ",".join(f"{1e3 * t:.3f}" for t in times)
        + f" cell-updates/s={grid.ncells / (ms * 1e-3):.4e}"
        f" peak_mem_bytes={peak} solver_host_reads/step={reads:.1f}"
        f" launches/step={json.dumps(per_step)}"
        f" max|div| of the projected advecting velocity="
        f"{float(diag['max_mac_div']):.3e} on {smi}")
    return launches, per_step, ms, by_level


# --------------------------------------------------------------------------
# phase 3/4 for the probed-stencil kernels K7-K8
# --------------------------------------------------------------------------
def _stretch(z):
    import numpy as np
    return (np.exp(3.0 * z) - 1.0) / (np.exp(3.0) - 1.0)


def stencil_level(nx, periodic, kind, device, dtype, bcs):
    """PoissonOp of a mapped level: kind "stretched" (vertical exponential
    stretching), "ledge" (shelf break), "twisted" (sinusoidal tangle) or
    "beam" (the BeamGeneration ridge at its stand-in size); bcs per logical
    direction as letters (N Neumann, D Dirichlet, P periodic, C coarse-fine,
    E extrapolation of order 0) for lo then hi."""
    import numpy as np
    import torch
    from somar_tpu_torch.core.bc import BC, FieldBCs
    from somar_tpu_torch.core.grid import Grid
    from somar_tpu_torch.geometry import bathymetric, geo_source
    from somar_tpu_torch.geometry.level_geometry import build_level_geometry
    from somar_tpu_torch.solvers.poisson_op import PoissonOp
    nd = len(nx)
    kw = dict(nx=nx, dx=tuple(1.0 / n for n in nx), periodic=periodic)
    if kind == "stretched":
        src = geo_source.StretchedCartesianMap(
            (lambda x: x,) * (nd - 1) + (_stretch,))
    elif kind == "ledge":
        kw.update(dx=tuple(2.0 / n for n in nx),
                  x0=(-1.0,) * (nd - 1) + (0.0,))
        src = bathymetric.LedgeMap((0.0, 1.0), hl=0.5, hr=1.0, xl=-0.5,
                                   xr=0.5)
    elif kind == "twisted":
        src = geo_source.TwistedMap((0.07,) * nd, (1.0,) * nd)
    else:
        from somar_tpu_torch import entry
        Lx, H = entry.BEAM_LENGTH, entry.BEAM_DEPTH
        kw.update(dx=(Lx / nx[0], H / nx[1]), x0=(-Lx / 2, 0.0))
        src = bathymetric.BeamGeneratorMap(
            (0.0, H), full_depth=H,
            angle=float(np.deg2rad(entry.BEAM_ALPHA_DEG)), lx=Lx)
    mk = {"N": BC.neumann, "D": BC.dirichlet, "P": BC.periodic, "C": BC.cf,
          "E": lambda: BC.extrap(0)}
    lo, hi = bcs
    geo = build_level_geometry(Grid(**kw), src, device=device,
                               dtype=getattr(torch, dtype))
    op = PoissonOp(geo, FieldBCs(lo=tuple(mk[c]() for c in lo),
                                 hi=tuple(mk[c]() for c in hi)))
    if op._stencil_plan is None:
        raise PhaseError(f"no stencil plan for {kind} {nx}")
    return op


#: label -> (nx, periodic, map kind, (lo, hi) BCs, dtype name): the cases of
#: tests/test_torch_stencil_kernels.py, the finest BeamGeneration level
#: with the pressure BCs, and once in f64
STENCIL_CASES = {
    "stretched-2d": ((24, 32), (True, False), "stretched", ("PN", "PD"),
                     "float32"),
    "ledge-2d": ((32, 24), (False, False), "ledge", ("NN", "NN"), "float32"),
    "twisted-2d": ((24, 16), (True, False), "twisted", ("PC", "PE"),
                   "float32"),
    "stretched-3d": ((16, 12, 16), (True, True, False), "stretched",
                     ("PPN", "PPN"), "float32"),
    "ledge-3d": ((12, 8, 12), (False, True, False), "ledge",
                 ("NPN", "DPN"), "float32"),
    "twisted-periodic3": ((3, 16), (True, False), "twisted", ("PN", "PD"),
                          "float32"),
    "ledge-periodic4": ((16, 4, 12), (False, True, False), "ledge",
                        ("NPN", "NPN"), "float32"),
    "beam 512,640": ((640, 512), (False, False), "beam", ("NN", "NN"),
                     "float32"),
    "ledge-2d f64": ((32, 24), (False, False), "ledge", ("NN", "NN"),
                     "float64"),
}
STENCIL_TIMING = {"beam 512,640": STENCIL_CASES["beam 512,640"],
                  "twisted-3d 128,256,256": (
                      (256, 256, 128), (True, True, False), "twisted",
                      ("PPN", "PPD"), "float32")}


def _delta_overrides(torch, op, gen):
    """The op's K7-K8 operands with a random altered-metric delta folded
    in (None where the plan does not span all 3^nd - 1 offsets)."""
    grid = op.grid
    kw = dict(generator=gen, device=op.geo.device, dtype=op.geo.dtype)
    diag = tuple(-0.1 * torch.rand(grid.fc_shape(d), **kw)
                 for d in range(grid.ndim))
    full = tuple(0.05 * torch.randn((grid.ndim,) + grid.fc_shape(d), **kw)
                 for d in range(grid.ndim))
    return op.delta_kernel_overrides((diag, full))


def stencil_parity_case(torch, sgk, label, plan, phi, rhs, variants, worst):
    """K7 in each variant bitwise, K8 within PARITY_RTOL * max|input|, with
    the plan's weights and with each set of overrides in `variants`."""
    from somar_tpu_torch.ops import rb_sweeps as rb
    limit = PARITY_RTOL * max(float(phi.abs().max()), float(rhs.abs().max()))
    for what, ov in variants:
        for it in (1, 3):
            want = sgk.stencil_gsrb_sweeps_plain(plan, phi, rhs, 0.4, 1.7, it,
                                                 **ov)
            for var in smoother_variants(rb, plan.shape, phi.element_size()):
                got = sgk.stencil_gsrb_sweeps(plan, phi, rhs, 0.4, 1.7, it,
                                              variant=var, **ov)
                torch.cuda.synchronize()
                worst["stencil_gsrb_sweeps"] = max(
                    worst["stencil_gsrb_sweeps"], smoother_check(
                        "stencil_gsrb_sweeps", label, got, want,
                        f"parity stencil_gsrb_sweeps {label:24s} "
                        f"K={plan.K:2d} {what:5s} iters={it} "
                        f"variant={var or 'plan'}"))
        res_ov = {k: v for k, v in ov.items() if k != "w0"}
        a = sgk.stencil_helm_residual(plan, phi, rhs, 0.4, 1.7, **res_ov)
        b = sgk.stencil_helm_residual_plain(plan, phi, rhs, 0.4, 1.7,
                                            **res_ov)
        torch.cuda.synchronize()
        err = float((a - b).abs().max())
        ok = err <= limit and a.shape == b.shape \
            and bool(torch.isfinite(a).all())
        say(f"parity stencil_helm_residual {label:24s} K={plan.K:2d} "
            f"{what:5s} max_abs_err={err:.3e} limit={limit:.3e} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise PhaseError(f"stencil_helm_residual {label}: kernel and "
                             "twin disagree")
        worst["stencil_helm_residual"] = max(worst["stencil_helm_residual"],
                                             err)


def stencil_parity(torch, sgk, device):
    """Returns {kernel: max abs err over its cases}; raises where K7
    differs from its twin in any bit or K8 by more than PARITY_RTOL *
    max|input|."""
    worst = {"stencil_gsrb_sweeps": 0.0, "stencil_helm_residual": 0.0}
    gen = torch.Generator(device=device).manual_seed(2718)
    for label, (nx, per, kind, bcs, dtname) in STENCIL_CASES.items():
        op = stencil_level(nx, per, kind, device, dtname, bcs)
        plan = op._stencil_plan
        phi, rhs = (torch.randn(plan.shape, generator=gen, device=device,
                                dtype=plan.Wn.dtype) for _ in range(2))
        variants = [("plain", {})]
        got = _delta_overrides(torch, op, gen)
        if got is not None:
            variants.append(("delta", dict(zip(("Wn", "R", "w0"), got))))
        stencil_parity_case(torch, sgk, label, plan, phi, rhs, variants,
                            worst)
    return worst


#: the multigrid levels of main path 3 with a stencil plan
PATH3_PLAN_LEVELS = [(512, 640), (256, 640), (128, 640), (64, 640),
                     (32, 320), (16, 160), (8, 80), (4, 40)]


def path3_levels(torch, entry, sgk, device, worst):
    """K7-K8 on the plan levels of the 640x512 BeamGeneration level as
    entry.build_beam_level builds them, in f32 and f64 (the plan's weights
    in f64), with and without the delta overrides of one implicit-gravity
    solve; then K5/K7 launches of a 4-sweep relax call by level."""
    level, _ = entry.build_beam_level(640, 512, device=device)
    ops = level.projector.mg.ops
    shapes = [tuple(op.grid.shape) for op in ops]
    if shapes[:8] != PATH3_PLAN_LEVELS or any(
            op._stencil_plan is None for op in ops[:8]):
        raise PhaseError(f"path 3 multigrid levels {shapes}")
    deltas = level._altered_metric.jgup_delta_list(
        level.params.gravity_theta * 20.0)
    gen = torch.Generator(device=device).manual_seed(314)
    for op, jd in zip(ops[:8], deltas):
        plan = op._stencil_plan
        sets = [("plain", dict(Wn=plan.Wn, R=plan.R, w0=plan.D))]
        got = op.delta_kernel_overrides(jd)
        if got is None:
            raise PhaseError(f"no delta overrides on {plan.shape}")
        sets.append(("delta", dict(zip(("Wn", "R", "w0"), got))))
        for dtype in (torch.float32, torch.float64):
            phi, rhs = (torch.randn(plan.shape, generator=gen, device=device,
                                    dtype=dtype) for _ in range(2))
            variants = [(what, {k: v.to(dtype) for k, v in ov.items()})
                        for what, ov in sets]
            stencil_parity_case(
                torch, sgk, f"path3 {plan.shape} {str(dtype)[-7:]}", plan,
                phi, rhs, variants, worst)
    return relax_launches(torch, ops, sgk, "stencil_gsrb_sweeps",
                          "main path 3")


def device_ms(torch, fn, kernels, calls=20):
    """Device time per call of fn spent in CUDA kernels whose name contains
    one of `kernels` (torch.profiler): the kernel's own time, without the
    host's launch gaps that a CUDA-event pair around one call includes.
    The median of 5 windows of `calls` calls, each after 50 ms of
    back-to-back calls (the card at its clocks under load)."""
    from somar_tpu_torch.kernel_bench import device_ms as dev
    return dev(torch, fn, kernels, calls)


def stencil_timing(torch, sgk, device):
    """{label: (ncells, K, {kernel: (ms, plain_ms, device_ms)})}: K7 per
    sweep (iters=1: one tiled launch), K8 per call, f32, with the plan's
    own weights; ms and plain_ms from CUDA events around one call,
    device_ms the kernels' own time (profiler)."""
    out = {}
    gen = torch.Generator(device=device).manual_seed(31)
    for label, (nx, per, kind, bcs, dtname) in STENCIL_TIMING.items():
        op = stencil_level(nx, per, kind, device, dtname, bcs)
        plan = op._stencil_plan
        phi, rhs = (torch.randn(plan.shape, generator=gen, device=device)
                    for _ in range(2))
        times = {}
        for name, cu_name, kern, plain in (
                ("stencil_gsrb_sweeps", K7_NAMES,
                 lambda: sgk.stencil_gsrb_sweeps(plan, phi, rhs, 0.0, 1.0, 1),
                 lambda: sgk.stencil_gsrb_sweeps_plain(plan, phi, rhs, 0.0,
                                                       1.0, 1)),
                ("stencil_helm_residual", ("stencil_helm_residual_kernel",),
                 lambda: sgk.stencil_helm_residual(plan, phi, rhs, 0.0, 1.0),
                 lambda: sgk.stencil_helm_residual_plain(plan, phi, rhs, 0.0,
                                                         1.0))):
            times[name] = (median_ms(torch, kern), median_ms(torch, plain),
                           device_ms(torch, kern, cu_name))
            ncells = phi.numel()
            bound, by = bound_ms(name, ncells, K=plan.K)
            say(f"timing {name:21s} {label:22s} K={plan.K} "
                f"kernel={times[name][0]:.4f} ms "
                f"plain={times[name][1]:.4f} ms "
                f"kernel device time={times[name][2]:.4f} ms "
                f"bound={bound:.4f} ms ({by})")
        out[label] = (phi.numel(), plan.K, times)
        del op, plan, phi, rhs
        torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# phase 8: the mapped step on the card against the CPU
# --------------------------------------------------------------------------
BEAM_TEST_SIZE = (40, 32)


def ig_solve_parity(torch, entry, device):
    """One multigrid solve with the altered metric of implicit gravity on
    the small BeamGeneration level, card against CPU from the same rhs."""
    out = {}
    rhs = torch.randn(BEAM_TEST_SIZE[::-1],
                      generator=torch.Generator().manual_seed(17))
    for dev in ("cpu", device):
        level, _ = entry.build_beam_level(*BEAM_TEST_SIZE, device=dev)
        mg = level.projector.mg
        deltas = level._altered_metric.jgup_delta_list(0.6 * 80.0)
        phi, info = mg.solve(rhs.to(dev), singular=True, jgup_deltas=deltas)
        out[dev] = (phi.cpu(), info)
    (p_cpu, i_cpu), (p_dev, i_dev) = out["cpu"], out[device]
    err = float((p_cpu - p_dev).abs().max()) / float(p_cpu.abs().max())
    say(f"IG solve parity {BEAM_TEST_SIZE}: phi={err:.3e} "
        f"limit={MG_SOLVE_RTOL} V-cycles cpu={i_cpu[0]} card={i_dev[0]} "
        f"relres cpu={i_cpu[1]:.3e} card={i_dev[1]:.3e}")
    if not err <= MG_SOLVE_RTOL:
        raise PhaseError("card and CPU implicit-gravity solves disagree")


def beam_step_parity(torch, entry, device, nsteps=5):
    cpu_level, _ = entry.build_beam_level(*BEAM_TEST_SIZE, device="cpu")
    dev_level, _ = entry.build_beam_level(*BEAM_TEST_SIZE, device=device)
    s_cpu = cpu_level.post_initialize(cpu_level.initial_state())
    s_dev = entry.ns_state_from_numpy(entry.ns_state_to_numpy(s_cpu),
                                      device=device)
    for _ in range(nsteps):
        dt = cpu_level.compute_dt(s_cpu)
        s_cpu = cpu_level.advance(s_cpu, dt)
        s_dev = dev_level.advance(s_dev, dt)
    a, b = entry.ns_state_to_numpy(s_cpu), entry.ns_state_to_numpy(s_dev)
    errs = {f: float(abs(a[f] - b[f]).max()) / float(abs(a[f]).max())
            for f in ("vel", "scalars", "pressure")}
    say(f"beam step parity {BEAM_TEST_SIZE} {nsteps} steps: "
        + " ".join(f"{f}={e:.3e}" for f, e in errs.items())
        + f" limit={MG_STEP_RTOL}")
    if not all(e <= MG_STEP_RTOL for e in errs.values()):
        raise PhaseError("card and CPU BeamGeneration steps disagree")


# --------------------------------------------------------------------------
# phase 9: main path 3, the BeamGeneration level at 640x512
# --------------------------------------------------------------------------
#: a solve whose final relative residual stays above this did not work: in
#: f32 the solves stop by their stall rule at 1e-6..1e-4 of ||rhs||
SOLVE_FAIL_RELRES = 1e-3


def beam_path(torch, entry, counters, device, smi="", nx=640, nz=512,
              nsteps=20, samples=3, sample_steps=3):
    """Drive the BeamGeneration level through entry.run and check it.
    Returns (launches of the run, launches per timed step, ms/step)."""
    from somar_tpu_torch.solvers.host_reads import read_scalars
    t0 = time.perf_counter()
    level, grid = entry.build_beam_level(nx, nz, device=device)
    torch.cuda.synchronize()
    say(f"main path beam {grid.nx}: level built in "
        f"{time.perf_counter() - t0:.2f} s; MG levels "
        f"{[op.grid.shape for op in level.projector.mg.ops]} stencil plans "
        f"{[op._stencil_plan.K if op._stencil_plan else None for op in level.projector.mg.ops]}")
    eps = level.params.mg.eps
    u0 = entry.BEAM_TIDAL_U0
    rows = []

    def on_step(i, s, dt):
        rows.append((i, dt, dict(level.projector.last_info)))

    torch.cuda.reset_peak_memory_stats()
    for mod in counters:
        mod.reset_launch_counts()
    t0 = time.perf_counter()
    state = entry.run(level, level.initial_state(), nsteps, on_step=on_step)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {}
    for mod in counters:
        launches.update(mod.launch_counts())
    worst = 0.0
    for i, dt, info in rows:
        say(f"main path beam step {i:3d} dt={dt:.4f} " + " ".join(
            f"{purpose}: V-cycles={it} relres={rr:.3e}"
            for purpose, (it, rr) in sorted(info.items())))
        worst = max([worst] + [rr for _, rr in info.values()])
    finite = all(bool(torch.isfinite(getattr(state, f)).all())
                 for f in ("vel", "scalars", "lam", "pressure"))
    umax = float(state.vel.abs().max())
    say(f"main path beam {grid.nx} {nsteps} steps in {run_s:.2f} s (with "
        f"set-up): t={float(state.time):.3f} s max|u|={umax:.4e} "
        f"(limit {10 * u0}) worst relres={worst:.3e} (eps {eps}) "
        f"finite={finite} launches={json.dumps(launches)}")
    if not finite:
        raise PhaseError("non-finite BeamGeneration state")
    if not umax <= 10 * u0:
        raise PhaseError("max|u| above 10 U0")
    if worst > SOLVE_FAIL_RELRES:
        raise PhaseError("a projection did not reduce its residual")
    path = ("ppm_predict", "ctu_final", "riemann_fluxdiv",
            "stencil_gsrb_sweeps", "stencil_helm_residual")
    if not all(launches[k] > 0 for k in path):
        raise PhaseError("a kernel of the BeamGeneration path was never "
                         "launched")

    dt = level.compute_dt(state)
    times = []
    reads0 = read_scalars.count
    for mod in counters:
        mod.reset_launch_counts()
    k = 0
    for _ in range(samples):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(sample_steps):
            k += 1
            state = level.advance(state, dt * (1.0 + 1e-6 * k))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) / sample_steps)
    per_step = {}
    for mod in counters:
        per_step.update({n: c / (samples * sample_steps)
                         for n, c in mod.launch_counts().items()})
    reads = (read_scalars.count - reads0) / (samples * sample_steps)
    div = float(level.max_divergence(state))
    if not bool(torch.isfinite(state.vel).all()):
        raise PhaseError("non-finite state after the timed steps")
    ms = 1e3 * statistics.median(times)
    peak = torch.cuda.max_memory_allocated()
    say(f"main path beam timing {grid.nx}: ms/step={ms:.3f} samples="
        + ",".join(f"{1e3 * t:.3f}" for t in times)
        + f" cell-updates/s={grid.ncells / (ms * 1e-3):.4e}"
        f" peak_mem_bytes={peak} solver_host_reads/step={reads:.1f}"
        f" K7 launches/step={per_step['stencil_gsrb_sweeps']:.1f}"
        f" K8 launches/step={per_step['stencil_helm_residual']:.1f}"
        f" max|div| after the CC projection={div:.3e} on {smi}")
    return launches, per_step, ms



def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test runs only "
              "on a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from somar_tpu_torch import cuda_build, entry
    from somar_tpu_torch.ops import ctu_kernels as ck
    from somar_tpu_torch.ops import gsrb_kernels as gk
    from somar_tpu_torch.ops import stencil_gsrb_kernels as sgk
    from somar_tpu_torch.solvers.multigrid import MGParams

    device = "cuda"
    smi = nvidia_smi_line()
    say(f"device: {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)} x"
        f"{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    cuda_build.build_libraries(dict([ck.LIBRARY, gk.LIBRARY, sgk.LIBRARY]))
    ck.load()
    gk.load()
    sgk.load()
    say(f"build: {time.perf_counter() - t0:.2f} s")
    for name in (ck.LIBRARY[0], gk.LIBRARY[0], sgk.LIBRARY[0]):
        for line in cuda_build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                say(f"  ptxas {name}: {line.strip()}")

    mg = MGParams(eps=1e-5, imax=12)
    errs = kernel_parity(torch, ck, device)
    errs.update(gsrb_parity(torch, gk, device))
    errs.update(stencil_parity(torch, sgk, device))
    relax = {"main path 2": path2_relax_launches(torch, gk, device, mg),
             "main path 3": path3_levels(torch, entry, sgk, device, errs)}
    timing = kernel_timing(torch, ck, device)
    k1_times = k1_timing(torch, ck, device)
    timing["ppm_predict"] = tuple(statistics.mean(
        k1_times[SHAPE3, ax][i] for ax in range(3)) for i in range(3))
    timing.update(gsrb_timing(torch, gk, device))
    k6_times = k6_level_timing(torch, gk, device)
    timing["helm_residual"] = k6_times[GSRB_SHAPE]
    st_timing = stencil_timing(torch, sgk, device)
    solve_parity(torch, device, mg)
    step_parity(torch, entry, device)
    step_parity(torch, entry, device, rtol=MG_STEP_RTOL,
                pressure_solver="mg", mg=mg)
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        raise PhaseError("TF32 is on: the levels' spectral solvers switch "
                         "it off")
    launches, _, _, _ = main_path(torch, entry, (ck,), device, smi)
    launches_mg, per_step_mg, _, by_level_mg = main_path(
        torch, entry, (ck, gk), device, smi, label="multigrid", nsteps=10,
        sample_steps=5, pressure_solver="mg", mg=mg)
    ig_solve_parity(torch, entry, device)
    beam_step_parity(torch, entry, device)
    launches_beam, per_step_beam, _ = beam_path(torch, entry, (ck, gk, sgk),
                                                device, smi)

    k6_levels = {}
    for shape, (ms, plain, dev) in k6_times.items():
        bound = bound_ms("helm_residual", math.prod(shape))[0]
        k6_levels[str(shape)] = dict(
            launches_per_step=by_level_mg["helm_residual"].get(shape, 0.0),
            ms=ms, plain_ms=plain, device_ms=dev, bound_ms=bound)
    dev = sum(v["launches_per_step"] * v["device_ms"]
              for v in k6_levels.values())
    gap = sum(v["launches_per_step"] * (v["device_ms"] - v["bound_ms"])
              for v in k6_levels.values())
    say(f"main path 2: K6 per step, sum over levels of launches x device "
        f"time = {dev:.4f} ms, of launches x (device time - bound) = "
        f"{gap:.4f} ms")
    k1_axes = {}
    for (shape, ax), (ms, plain, dev) in k1_times.items():
        route, chunk = ck.ppm_launch_shape(shape, ax)
        k1_axes[f"{shape} ax{ax}"] = dict(
            route=route, chunk=chunk, ms=ms, plain_ms=plain, device_ms=dev,
            bound_ms=bound_ms("ppm_predict", math.prod(shape))[0])

    kernels = []
    beam_cells, beam_K, beam_times = st_timing["beam 512,640"]
    cells_3d, K_3d, times_3d = st_timing["twisted-3d 128,256,256"]
    for name, (source, replaces, _, _) in KERNELS.items():
        entry_ = {"name": name, "route": "cuda", "source": source,
                  "replaces": replaces}
        if source == STENCIL_SOURCE:
            # timed at main path 3's finest level (512, 640), K = 8
            bound, by = bound_ms(name, beam_cells, K=beam_K)
            entry_.update(launches=launches_beam[name],
                          ms=beam_times[name][0],
                          plain_ms=beam_times[name][1],
                          device_ms=beam_times[name][2],
                          K=beam_K, K_3d=K_3d, ms_3d=times_3d[name][0],
                          plain_ms_3d=times_3d[name][1],
                          device_ms_3d=times_3d[name][2],
                          bound_ms_3d=bound_ms(name, cells_3d, K=K_3d)[0])
        else:
            ncells = (SHAPE3[0] * SHAPE3[1] * SHAPE3[2]
                      if source == CTU_SOURCE
                      else GSRB_SHAPE[0] * GSRB_SHAPE[1] * GSRB_SHAPE[2])
            bound, by = bound_ms(name, ncells)
            entry_.update(launches=launches.get(name, launches_mg[name]),
                          ms=timing[name][0], plain_ms=timing[name][1],
                          device_ms=timing[name][2])
        entry_.update(
            launches_multigrid_path=launches_mg.get(name, 0),
            launches_per_multigrid_step=per_step_mg.get(name, 0.0),
            launches_beam_path=launches_beam.get(name, 0),
            launches_per_beam_step=per_step_beam.get(name, 0.0),
            max_abs_err=errs[name], bound_ms=bound, bound_by=by,
            # no single PyTorch call computes any of these functions
            library_ms=None)
        if name == "ppm_predict":
            entry_["by_axis"] = k1_axes
        if name == "helm_residual":
            entry_["by_level"] = k6_levels
        kernels.append(entry_)
    say(f"smoother launches per 4-sweep relax call by level: "
        f"{json.dumps(relax)}")
    say(f"card: {smi}")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
