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
     samples of 3 steps;
 10. D1: main path 1 as an input deck (D1_DECK) through ProblemContext
     and RunDriver: its NSParams, grid, problem and map equal to
     entry.build_level(512, 128, 128)'s; 20 steps with plot and checkpoint
     files every 10, the state equal to main path 1's after its 20 steps
     (max|diff| <= 1e-6 max|field|, expected 0.0); then a second RunDriver
     resumed from chkpt_000010.hdf5 to step 20, equal to the first; the
     driver's ms/step beside path 1's, host reads per step, cell-updates/s,
     the seconds of one checkpoint and one plot file, peak memory, the
     launches of K1-K4.  Without h5py on the host the files' trees are
     kept in memory by path (MemoryFiles; printed);
 11. D2: the same deck with amr.updateScheme = 2 (RK3), 5 steps: finite
     fields, the buoyancy and energy bounds, the last MAC projection's
     max|div|, 3 timed steps with launches per step (K1-K3, no K4); the
     deck at 64x16x32 and a fixed dt on the card against the CPU (1e-4
     of max|field|);
 12. D3: main path 3 as an input deck (D3_DECK), 3 steps through
     RunDriver, its setup and metric equal to entry.build_beam_level(640,
     512)'s and its state to main path 3's after 3 steps (1e-6);
 13. the command line, `python -m somar_tpu_torch <deck> amr.maxsteps=2`,
     in a subprocess on a 128x32 lock exchange: exit 0 and "finished 2
     steps";
 14. D4: HorizConv (ibc.problem = 6) at 512x128x128 through RunDriver
     (5 steps, then 3 timed): its top buoyancy profile, an array-valued
     Dirichlet value, in the multigrid diffusive solve (K5-K6 beside
     K1-K4); buoyancy within (-0.1, 1.1), the MAC divergence gate; first
     the deck at 64x16x32 on the card against the CPU (1e-3);
 15. D5: the vortex street of entry.build_vortex_level at 1024x512 with
     its inflow ramped over 1.0 time units (a callable BC bound every
     step), multigrid projections and viscous solves, through entry.run
     (5 steps, then 3 timed): finite, max|u| <= 10, every projection's
     relres below 1e-3; host reads a step with the ramp equal to those
     with ramp_time = 0 (every solve held to 4 V-cycles); 128x64 on the
     card against the CPU (1e-3);
 16. D6: the slotted disk (ibc.problem = 0, no projection, no gravity) at
     2048x2048 once with each advection option (PPM, PLM, CTU(0), the
     high-order limiter, central fluxes), 3 steps and 3 timed: the disk
     within (-0.15, 1.15) (not for central fluxes, which are not
     monotone), each option's kernels as physics/godunov.py routes them
     and no other CTU kernel; 128x128 on the card against the CPU (1e-4);
 17. D7: InternalWave, SolitaryWave and DJL (KdV eta) at 1024x256, 3
     steps and 2 timed: total buoyancy within its initial range +- 10%,
     the MAC divergence gate; 128x32 on the card against the CPU (1e-4);
 18. L1: LevelLepticSolver against LevelMultigrid on the 512x512x32 box
     of the leptic regime (H = 1, dx_h = 2, Neumann walls): orders,
     status, relres below 1e-3 for both, the gauge-free difference of the
     solutions (5e-2), ms, host reads and launches per solve; K7/K8 on
     the flattened (512, 512) level against their twins and timed; a
     32x32x8 solve on the card against the CPU (1e-3);
 19. L2: a flat 3D lock exchange with projection.solver = 2 on the L1
     box through RunDriver (3 steps): the MAC divergence gate after every
     advance, each leptic projection's relres below 1e-3, K1-K4 and
     K6-K8 launched; the deck at 32x32x8 on the card against the CPU
     (1e-3).
 20. A0: the two-level AMR hierarchy (entry.build_amr_hierarchy: the lock
     exchange as base level, one subcycled patch) at 3D 32x16x16 ratio
     (4,1,1) and 2D 48x16 ratio (4,1): placed, projected and stepped 3
     coarse steps on the card and on the CPU, every field of both levels
     within 1e-3 of max|field| (the potentials mac_phi and cc_phi with
     their means removed) and the same origin, the card's launches
     printed, the sync solve's relres below 3e-2 after every step; again
     with the sync projection off: the composite divergence that the sync
     acts on (uncovered base cells with the averaged patch flux on the
     CF faces, and the patch) and the patch's own lower with it, and
     tests/test_amr.py:736-778's measure within 1.5x; then three faults
     of the sync solve (one composite pass; no FAS tau; no lagged
     elliptic reflux), each of which must cross the 3e-2 relres limit;
 21. A1: the JAX bench's AMR cell at its recorded shapes (base 64x96x64,
     ratio (4,1,1), patch ext (128, 96, 64) asserted, nt 4, 1 sync
     iteration of 2 composite passes; path 1's physics, the tag and
     multigrid parameters as named stand-ins): placement, 2 warm-up and
     10 timed coarse steps at dt 0.01; after every step finite fields,
     buoyancy within (-0.1, 1.1) on both levels, the coarse cells under
     the patch equal to the restricted patch (1e-6 of max|b|), the sync
     solve's relres below 3e-2; ms per coarse step, cell-updates/s,
     launches and host reads per coarse step, peak memory, the composite
     buoyancy mass and its drift; then K1-K4 at both levels' padded
     shapes (K1 bitwise), K5-K6 on every multigrid level of both levels'
     pressure hierarchies (the patch's CF sides) and K7-K8 on the stencil
     levels of their diffusive solves against their twins;
 22. A2: the same at base 128x128x128 (the north star's effective
     512x128x128), 1 warm-up and 5 timed coarse steps.
 23. R0: AMR decks through RunDriver on the card and on the CPU: R0_DECK
     (tests/test_driver_io.py's AMR_CFG, 2D 48x16, regrids every 2 steps,
     amr.fixed_dt unset so level_dts and the dynamic-subcycling factors
     set each dt), R0_SUBCYCLED (R0_DECK viscous on square cells, whose
     first coarse step takes the dynamic-subcycling factor 2) and
     R0_TWO_FRONTS (tests/test_amr.py:504-531's two fronts, 96x12, whose
     placement doubles K from 1 to 2), 6 coarse steps each: the same K,
     origins and weights at placement and after every regrid, the same
     subcycling factors, every field of both levels within 1e-3 (the
     potentials gauge-free), and on the card the run resumed from its
     step-3 checkpoint equal to the uninterrupted one (1e-6; K, footprint
     and origins restored); K = 2 active on the card in R0_TWO_FRONTS,
     the factor 2 on R0_SUBCYCLED's first step, and on the card every
     kernel of the 2D AMR path launched;
 24. R1: main path 1 as an AMR deck (R1_DECK: base 128^3, ratio (4,1,1),
     regrids every 5 steps, CFL-limited dt, files every 10, 20 coarse
     steps) through RunDriver: ms per coarse step (plain and regrid steps
     apart), seconds per regrid, K, origins and tag coverage at placement
     and after each regrid, launches and host reads per coarse step,
     file seconds, peak memory; gates after every coarse step: finite,
     b in (-0.1, 1.1), the base cells under each active patch equal to
     its restricted interior (1e-6 of max|b|), the sync relres below
     3e-2; no tagged cell dropped at placement or after any regrid; then
     K1-K4 at the padded shapes of every level the run reached and K5-K8
     on their solver hierarchies against their twins;
 25. R2: R1's base with the two fronts extruded in y (R2_DECK,
     amr.max_grid_size 120), 6 coarse steps: two active 3D patches at
     placement and after the regrid, the same prints and gates and twins;
 26. the command line on R0_DECK in a subprocess: exit 0 and "finished 2
     steps";
 27. N0: three-level decks (amr.maxlevel = 2) through RunDriver on the
     card and on the CPU: N0_DECK (R0_DECK with a second refined level at
     ratio (4,2), both levels regridded every 2 steps) and N0_TWO_CHAINS
     (R0_TWO_FRONTS at ratios (2,1) twice, amr.max_patches = 2 2: two
     level-1 patches, each the parent of a level-2 patch), 6 coarse steps
     each: the same K, origins, weights and parent selections on every
     level at placement and after every regrid, the same subcycling
     factors, every field of every level within 1e-3 (the potentials
     gauge-free), the step gates on every level, and on the card the run
     resumed from its step-3 checkpoint equal to the uninterrupted one
     (1e-6); both chains active at every regrid of N0_TWO_CHAINS, and every
     kernel of the 2D AMR path launched;
 28. N1: R1's deck at three levels (N1_DECK: a second refined level at
     ratio (4,1,2), 16 level-2 substeps per coarse step, regrids of both
     levels every 5 steps, 6 coarse steps, files at step 5), the
     level-2 footprint reckoned by patch_footprint first and the built one
     printed: R1's prints and gates at both interfaces, and per level K,
     ext, origins, parent selections and tag coverage at placement and
     after each regrid;
 29. N2: K1-K4 at the padded shapes of the level-2 patches N1 reached and
     K5-K8 on their solver hierarchies against their twins;
 30. M0: mapped decks (each patch slot on the map's metric at its own
     position) through RunDriver on the card and, in a worker process at
     the same time, on the CPU: M0_LEDGE (tests/test_amr.py:236-249's
     Ledge hierarchy, 48x16, ratio (2,2)), M0_NESTED (the same at
     amr.maxlevel = 2, ratios (4,1) and (4,2)) and M0_TWO_FRONTS (the
     TwistedMap two fronts at K = 2), 6 coarse steps each (M0_NESTED
     4): R0's gates
     (the average-down weighted by each slot's J), each slot's J range,
     and the two fronts' slots on metrics of their own;
 31. M1: a 2D lock exchange on the Ledge map (M1_DECK: D1's physics, base
     1024x128, ratio (4,1), the patch footprint reckoned first, regrids
     every 5 steps, 5 coarse steps, files at step 5): R1's prints and
     gates, per regrid the seconds spent rebuilding slots, and every
     kernel of the mapped path launched (mapped_path);
 32. M2: R1's deck on the Ledge map extruded in y (M2_DECK, 2 coarse
     steps): the same;
 33. M3: K1-K4 at M1's and M2's padded patch shapes, K7/K8 on every
     slot's own projection and diffusive hierarchies (M1, M2, and the two
     slots of M0_TWO_FRONTS) against their twins;
 34. F0: slice 11c's features on small decks (F0_DECKS: R0_DECK with the
     three fields refluxed and the VD correction, the same with implicit
     refluxing, N0_TWO_CHAINS and M0_TWO_FRONTS refluxing, R0_DECK with
     RK3 and refluxing, R0_DECK with post-regrid smoothing), card
     against CPU as M0 (e_lambda held too), resume, e_lambda filled and
     lambda near 1 under the VD correction, implicit against explicit
     refluxing, and the conservation gate of tests/test_amr.py:365 on an
     inviscid R0_DECK with and without refluxing;
 35. F1: R1's deck at CFL 0.3 with velocity and buoyancy refluxed,
     implicit refluxing, the VD correction and smoothing (F1_DECK, 10
     coarse steps) and with none of them (F1_OFF): R1's prints and
     gates, the composite buoyancy mass drift and max|lambda - 1| of
     each; then F1_ALL, R1's deck as it stands with every feature on,
     lambda refluxing too, a run of a fault of the reference (ROADMAP
     C.31) held to finiteness, its drift, b and tag coverage printed;
 36. F2: F1's deck with RK3 and all three fields refluxed (F2_DECK, 5
     coarse steps): R1's prints and gates, and no K4 launched.
The line before the last is a JSON object describing each kernel, with
launches_r0 / launches_r1 / launches_r2 / launches_n0 / launches_n1 /
launches_m0 / launches_m1 / launches_m2 / launches_f0 / launches_f1 /
launches_f1_off / launches_f1_all / launches_f2 and the per-coarse-step
counts of R1, R2, N1, M1, M2, F1, F1_OFF, F1_ALL and F2; the last line
is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
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
def kernel_cases(torch, ck, device, shapes, ppm_only=()):
    """(kernel name, label, inputs, kernel call, twin call) per case: K1-K4
    at each padded shape of `shapes` (K2 and K4 in 3D only), K1 also at
    each of `ppm_only`."""
    gen = torch.Generator(device=device).manual_seed(1234)

    def rnd(shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=device, dtype=dtype)

    cases = []
    for shape in tuple(shapes) + tuple(ppm_only):
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
    for shape in shapes:
        nd = len(shape)
        for ax in range(nd):
            if nd == 3:
                ins = [rnd(shape) for _ in range(5)]
                args = (ins[0], ins[1], ins[2], ins[3:], 0.25, ax)
                cases.append(("ctu_corr3", f"3d {shape} ax{ax} ncorr=2", ins,
                              lambda a=args: ck.ctu_corr3(*a),
                              lambda a=args: ck.ctu_corr3_plain(*a)))
                pairs = [(rnd(shape), rnd(shape)) for _ in range(3)]
                adv = rnd(shape)
                args = (pairs, adv, ax)
                cases.append(("riemann_fluxdiv", f"3d {shape} ax{ax} nf=3",
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
                cases.append(("ctu_final", f"{nd}d {shape} ax{ax} {mode}",
                              [lo1, hi1, adv, src] + c3,
                              lambda a=args, f=flags: ck.ctu_final(*a, **f),
                              lambda a=args, f=flags: ck.ctu_final_plain(
                                  *a, **f)))
    return cases


def kernel_parity(torch, ck, device, shapes=(SHAPE3, SHAPE2),
                  ppm_only=(BEAM_PAD,)):
    """Returns {kernel: max abs err over its cases}; raises where K1
    differs from its twin in any bit or K2-K4 by more than PARITY_RTOL *
    max|input|."""
    worst = {}
    for name, label, ins, kern, plain in kernel_cases(torch, ck, device,
                                                      shapes, ppm_only):
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
                                                    (SHAPE3, SHAPE2)):
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
    level, (the level, the state at the end of the run))."""
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
    run_state = state
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
    return launches, per_step, ms, by_level, (level, run_state)


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
        out[label] = plan_timing(torch, sgk, op._stencil_plan, label, gen)
        del op
        torch.cuda.empty_cache()
    return out


def plan_timing(torch, sgk, plan, label, gen):
    """(ncells, K, {kernel: (ms, plain_ms, device_ms)}) of K7 per sweep
    (iters=1) and K8 per call on a probed plan's own weights, each line
    printed with its bound."""
    device = plan.Wn.device
    phi, rhs = (torch.randn(plan.shape, generator=gen, device=device,
                            dtype=plan.Wn.dtype) for _ in range(2))
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
        bound, by = bound_ms(name, phi.numel(), K=plan.K)
        say(f"timing {name:21s} {label:22s} K={plan.K} "
            f"kernel={times[name][0]:.4f} ms "
            f"plain={times[name][1]:.4f} ms "
            f"kernel device time={times[name][2]:.4f} ms "
            f"bound={bound:.4f} ms ({by})")
    return phi.numel(), plan.K, times


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
    Returns (launches of the run, launches per timed step, ms/step, (the
    level, the state after D3_STEPS steps of the run))."""
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
    rows, early = [], []

    def on_step(i, s, dt):
        rows.append((i, dt, dict(level.projector.last_info)))
        if i == D3_STEPS - 1:
            early.append(s)

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
    return launches, per_step, ms, (level, early[0])


# --------------------------------------------------------------------------
# phases 10-13: input decks through ProblemContext, RunDriver and the CLI
# --------------------------------------------------------------------------
#: D1, the lock exchange of main path 1 as an input deck: every key that
#: makes the context's NSParams equal entry.build_level(512, 128, 128)'s
#: (the context's multigrid defaults, imin 5 and 2 smoothings, and its
#: single initial projection and pressure iterations differ from the
#: port's MGParams and entry.run)
D1_DECK = """
amr.nx = 512 128 128
amr.length = 15 2 2
amr.nx_offset = -256 0 0
amr.isPeriodic = 0 1 0
ibc.problem = 1
amr.gravityMethod = 1
amr.cfl = 0.9
amr.viscosity = 1e-4
amr.scal_diffusion_coeffs = 1e-4
advection.useLimitingVel = 0
advection.useLimitingScal = 1
projection.initial_projection_iters = 2
projection.initial_pressure_iters = 2
AMRMG.imin = 2
AMRMG.num_smooth_down = 4
AMRMG.num_smooth_up = 4
AMRMG.num_smooth_bottom = 4
amr.maxsteps = 20
amr.final = 1e9
plot.plot_interval = 10
plot.checkpoint_interval = 10
amr.verbosity = 0
"""
#: D2, the same deck with the RK3 scheme, and its card-against-CPU size
D2_DECK = D1_DECK + """
amr.updateScheme = 2
amr.maxsteps = 5
plot.plot_interval = -1
plot.checkpoint_interval = -1
"""
#: at 64x16x32 the deck's first dt (a tenth of the viscous limit) is 0.59,
#: far past the stable RK3 step of a grid that coarse, so the card and the
#: CPU take a fixed dt there, as the PPM step parity does
D2_SMALL = "amr.nx = 64 16 32\namr.nx_offset = -32 0 0\namr.fixed_dt = 0.01\n"
D2_TIMED_STEPS = 3
#: D3, the BeamGeneration level of main path 3 as an input deck, with the
#: entry.BEAM_* stand-ins as keys (the problem fixes N^2 = 1.493e-5)
D3_STEPS = 3
D3_DECK = """
amr.nx = 640 512
amr.length = 38400 3000
amr.nx_offset = -320 0
geometry.coordMap = 2
geometry.beamGenMapAlpha = 15
ibc.problem = 2
ibc.useBackgroundScalar = 1
ibc.bgScalarProfile = 1
ibc.tidalU0 = 0.01
ibc.tidalOmega = 1e-3
amr.viscosity = 1e-4
amr.scal_diffusion_coeffs = 1e-4
amr.gravityMethod = 2
amr.gravityTheta = 0.6
amr.limitDtViaInternalWaveSpeed = 1
AMRMG.eps = 1e-6
AMRMG.imax = 20
AMRMG.relax_mode = 1
AMRMG.imin = 2
AMRMG.num_smooth_down = 4
AMRMG.num_smooth_up = 4
AMRMG.num_smooth_bottom = 4
projection.initial_projection_iters = 2
projection.initial_pressure_iters = 2
amr.maxsteps = 3
amr.final = 1e30
amr.verbosity = 0
"""
#: the command line's deck: a small 2D lock exchange
CLI_DECK = """
amr.nx = 128 32
amr.length = 15 2
amr.nx_offset = -64 0
ibc.problem = 1
amr.viscosity = 1e-4
amr.scal_diffusion_coeffs = 1e-4
amr.max_dt = 0.05
amr.final = 100
plot.plot_interval = 1
plot.checkpoint_interval = 1
"""
#: the state equality of a deck's run and entry.run's: max|diff| within
#: this fraction of max|field| (expected 0.0: the same code on one card)
DRIVER_RTOL = 1e-6
D2_CPU_RTOL = 1e-4
#: the fields held to D2_CPU_RTOL, as in the PPM step parity; the
#: projection potentials are increments, small against their roundoff
D2_CPU_FIELDS = ("vel", "scalars", "lam", "pressure")
#: the last MAC projection's max|div| against max_d max|u_d| / dx_d
MAC_DIV_RTOL = 1e-5
STATE_DIFF_FIELDS = ("vel", "scalars", "lam", "mac_phi", "cc_phi",
                     "pressure", "e_lambda", "time")


class MemoryFiles:
    """The h5py layer of io/checkpoint.py kept in memory, for a host
    without h5py: write_tree / read_tree hold each file's tree by path.
    Every device computation and kernel launch is the same; only the file
    bytes are not written."""

    def __init__(self):
        self.trees = {}

    def write_tree(self, path, tree):
        self.trees[os.path.abspath(path)] = tree

    def read_tree(self, path):
        return self.trees[os.path.abspath(path)]


#: the command line run with MemoryFiles in place of h5py
CLI_SHIM = """import runpy, sys
from somar_tpu_torch.io import checkpoint
trees = {}
checkpoint.write_tree = trees.__setitem__
checkpoint.read_tree = trees.__getitem__
runpy.run_module("somar_tpu_torch", run_name="__main__", alter_sys=True)
"""


def file_layer():
    """None where h5py imports (the decks write real files into temporary
    directories), else MemoryFiles installed in io/checkpoint.py."""
    try:
        import h5py  # noqa: F401
        say("files: h5py is installed; the decks write HDF5 files")
        return None
    except ImportError:
        from somar_tpu_torch.io import checkpoint
        mem = MemoryFiles()
        checkpoint.write_tree = mem.write_tree
        checkpoint.read_tree = mem.read_tree
        say("files: h5py is not installed on this host, so chip_smoke keeps "
            "each checkpoint and plot file's tree in memory by path "
            "(io/checkpoint.write_tree / read_tree); every device "
            "computation and kernel launch is the same")
        return mem


def resolved_params(p):
    """NSParams with every per-solver multigrid block that is None (and so
    falls back to p.mg) replaced by p.mg."""
    return dataclasses.replace(p, **{
        f: getattr(p, f) or p.mg
        for f in ("mg_mac", "mg_cc", "mg_sync", "mg_vd", "mg_viscous",
                  "mg_diffusive")})


def context(deck):
    from somar_tpu_torch.config.context import ProblemContext
    from somar_tpu_torch.config.parmparse import ParmParse
    return ProblemContext.from_parmparse(ParmParse.from_string(deck))


def same_setup(ctx, level, label):
    """Raise unless the context builds the level's run: NSParams field by
    field, the grid, the problem and the coordinate map."""
    def fields(obj):
        return {k: (fields(v) if hasattr(v, "__dict__") else v)
                for k, v in vars(obj).items()}
    checks = {
        "NSParams": resolved_params(ctx.ns) == resolved_params(level.params),
        "grid": ctx.base_grid() == level.grid,
        "problem": (type(ctx.new_problem()) is type(level.problem)
                    and fields(ctx.new_problem()) == fields(level.problem)),
        "map": (type(ctx.new_geo_source()) is type(level.geo.geo)
                and vars(ctx.new_geo_source()) == vars(level.geo.geo)),
    }
    say(f"{label} deck against the entry level: "
        + " ".join(f"{k}={'equal' if v else 'DIFFERENT'}"
                   for k, v in checks.items()))
    if not all(checks.values()):
        raise PhaseError(f"{label}: the deck does not build the entry level")


def field_diffs(a, b, fields=STATE_DIFF_FIELDS):
    """{field: max|a - b| / max|b|} of two NSStates."""
    rel = {}
    for f in fields:
        x, y = getattr(a, f), getattr(b, f).to(getattr(a, f).device)
        rel[f] = float((x - y).abs().max()) / max(float(y.abs().max()),
                                                  1e-30)
    return rel


def state_diff(a, b, fields=STATE_DIFF_FIELDS):
    """(max over fields of max|a - b| / max|b|, its field)."""
    rel = field_diffs(a, b, fields)
    field = max(rel, key=rel.get)
    return rel[field], field


def reset_counts(counters):
    for mod in counters:
        mod.reset_launch_counts()


def read_counts(counters):
    out = {}
    for mod in counters:
        out.update(mod.launch_counts())
    return out


def check_launched(launches, path, label):
    if not all(launches[k] > 0 for k in path):
        raise PhaseError(f"{label}: a kernel of the path was never launched "
                         f"{json.dumps(launches)}")


def driver_run(torch, ctx, out_dir, device, counters):
    """Run a deck through RunDriver with the counts set to 0 just before;
    returns (driver, state, steps, launches, host reads per step between
    step ends, seconds)."""
    from somar_tpu_torch.driver import RunDriver
    from somar_tpu_torch.solvers.host_reads import read_scalars
    from somar_tpu_torch.utils.timers import timer
    timer.reset()
    drv = RunDriver(ctx, out_dir=out_dir, device=device)
    marks = []
    drv.scheduler.schedule(lambda *_: marks.append(read_scalars.count),
                           step_interval=1)
    torch.cuda.synchronize()
    reset_counts(counters)
    t0 = time.perf_counter()
    state, steps = drv.run(verbose=False)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    reads = ((marks[-1] - marks[0]) / (len(marks) - 1) if len(marks) > 1
             else float("nan"))
    return drv, state, steps, read_counts(counters), reads, seconds


def io_seconds(name):
    from somar_tpu_torch.utils.timers import timer
    node = timer.root.children.get(name)
    return (node.total / node.calls, node.calls) if node else (None, 0)


def driver_lock(torch, counters, device, smi, path1, ms_path1, files):
    """D1: the lock exchange deck through RunDriver (20 steps, plot and
    checkpoint files every 10), held to main path 1's state; then resumed
    from its step-10 checkpoint and held to its own state."""
    level1, want = path1
    ctx = context(D1_DECK)
    same_setup(ctx, level1, "D1")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_d1_") as out:
        torch.cuda.reset_peak_memory_stats()
        drv, state, steps, launches, reads, secs = driver_run(
            torch, ctx, out, device, counters)
        peak = torch.cuda.max_memory_allocated()
        ckpt_s, ckpts = io_seconds("write_checkpoint")
        plot_s, plots = io_seconds("write_plotfile")
        err, field = state_diff(state, want)
        ms = 1e3 * statistics.median(drv.step_seconds)
        say(f"D1 RunDriver {ctx.base_grid().nx} {steps} steps in {secs:.2f} "
            f"s (with set-up and files): state against main path 1 "
            f"max|diff|/max|field|={err:.3e} ({field}) limit {DRIVER_RTOL}; "
            f"ms/step={ms:.3f} (advance + time and dt reads; main path 1 "
            f"through entry.run {ms_path1:.3f}) host reads/step={reads:.1f} "
            f"cell-updates/s={drv.cell_updates / drv.elapsed:.4e} (the "
            f"driver's report, files included) checkpoint write "
            f"{ckpt_s:.3f} s x{ckpts} plot file write {plot_s:.3f} s "
            f"x{plots} peak_mem_bytes={peak} launches={json.dumps(launches)}"
            f" on {smi}")
        if not err <= DRIVER_RTOL:
            raise PhaseError("D1: the deck's run differs from entry.run's")
        if steps != 20:
            raise PhaseError(f"D1 ran {steps} steps")
        check_launched(launches, ("ppm_predict", "ctu_corr3", "ctu_final",
                                  "riemann_fluxdiv"), "D1")
        resumed = context(D1_DECK + "amr.restart_file = chkpt_000010.hdf5\n")
        drv2, state2, steps2, _, _, _ = driver_run(torch, resumed, out,
                                                   device, counters)
        err2, field2 = state_diff(state2, state)
        say(f"D1 resumed from chkpt_000010.hdf5 to step {steps2}: against "
            f"the uninterrupted run max|diff|/max|field|={err2:.3e} "
            f"({field2}) limit {DRIVER_RTOL}")
        if not (steps2 == 20 and err2 <= DRIVER_RTOL):
            raise PhaseError("D1: the resumed run differs")
    if files is not None:
        files.trees.clear()
    return launches


def driver_rk3(torch, counters, device, smi):
    """D2: the lock exchange deck with the RK3 scheme through RunDriver (5
    steps), its gates, timed steps with launches per step, and the same
    deck at 64x16x32 on the card against the CPU."""
    from somar_tpu_torch.driver import RunDriver
    from somar_tpu_torch.solvers.host_reads import read_scalars
    ctx = context(D2_DECK)
    if ctx.ns.update_scheme != "rk3":
        raise PhaseError("D2: amr.updateScheme = 2 did not select RK3")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_d2_") as out:
        drv, state, steps, launches, _, secs = driver_run(
            torch, ctx, out, device, counters)
    level = drv.level
    b = state.scalars[0]
    finite = all(bool(torch.isfinite(getattr(state, f)).all())
                 for f in ("vel", "scalars", "lam", "pressure"))
    bmin, bmax = float(b.min()), float(b.max())
    dt = level.compute_dt(state)
    e0 = float(level.total_energy(state))
    reset_counts(counters)
    reads0 = read_scalars.count
    times, energies = [], []
    diag = {}
    for k in range(D2_TIMED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = level.advance(state, dt * (1.0 + 1e-6 * (k + 1)),
                              diag=diag if k == D2_TIMED_STEPS - 1 else None)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        energies.append(float(level.total_energy(state)))
    per_step = {n: c / D2_TIMED_STEPS
                for n, c in read_counts(counters).items()}
    solver_reads = (read_scalars.count - reads0) / D2_TIMED_STEPS
    scale = max(float(state.vel[d].abs().max()) / level.grid.dx[d]
                for d in range(level.grid.ndim))
    mac_div = float(diag["max_mac_div"])
    ms = 1e3 * statistics.median(times)
    say(f"D2 RunDriver RK3 {ctx.base_grid().nx} {steps} steps in {secs:.2f} "
        f"s (with set-up): b in [{bmin:.6f}, {bmax:.6f}] finite={finite} "
        f"launches={json.dumps(launches)}; then {D2_TIMED_STEPS} timed "
        f"steps: ms/step={ms:.3f} samples="
        + ",".join(f"{1e3 * t:.3f}" for t in times)
        + f" E={e0:.6f}->{max(energies):.6f} max|div| after the last MAC "
        f"projection={mac_div:.3e} (limit {MAC_DIV_RTOL} x {scale:.3e}) "
        f"solver host reads/step={solver_reads:.1f} launches/step="
        f"{json.dumps(per_step)} on {smi}")
    if not finite:
        raise PhaseError("D2: non-finite state")
    if not (B_BOUNDS[0] < bmin and bmax < B_BOUNDS[1]):
        raise PhaseError(f"D2: buoyancy out of {B_BOUNDS}")
    if max(energies) > e0 * (1.0 + ENERGY_GROWTH):
        raise PhaseError("D2: total energy grew")
    if not mac_div <= MAC_DIV_RTOL * scale:
        raise PhaseError("D2: the MAC projection left a divergence")
    check_launched(launches, ("ppm_predict", "ctu_corr3", "ctu_final"), "D2")
    if launches["riemann_fluxdiv"] != 0:
        raise PhaseError("D2: RK3 launched K4")

    small = context(D2_DECK + D2_SMALL)
    got = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_d2s_") as out:
        for dev in ("cpu", device):
            got[dev], n = RunDriver(small, out_dir=out, device=dev).run(
                verbose=False)
    rel = field_diffs(got[device], got["cpu"])
    err = max(rel[f] for f in D2_CPU_FIELDS)
    say(f"D2 RK3 card against CPU {small.base_grid().nx} {n} steps: "
        f"max|diff|/max|field| " + " ".join(
            f"{f}={e:.3e}" for f, e in rel.items())
        + f"; limit {D2_CPU_RTOL} on {', '.join(D2_CPU_FIELDS)}")
    if not err <= D2_CPU_RTOL:
        raise PhaseError("D2: the card's RK3 run differs from the CPU's")
    return {"launches": launches, "per_step": per_step}


def driver_beam(torch, counters, device, smi, path3, files):
    """D3: the BeamGeneration deck through RunDriver (3 steps), held to
    main path 3's state after as many steps."""
    level3, want = path3
    ctx = context(D3_DECK)
    same_setup(ctx, level3, "D3")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_d3_") as out:
        torch.cuda.reset_peak_memory_stats()
        drv, state, steps, launches, reads, secs = driver_run(
            torch, ctx, out, device, counters)
        peak = torch.cuda.max_memory_allocated()
    geo_same = all(torch.equal(getattr(drv.level.geo, f),
                               getattr(level3.geo, f))
                   for f in ("J", "Jinv", "e_cc", "einv_cc", "gdn_cc"))
    err, field = state_diff(state, want)
    ms = 1e3 * statistics.median(drv.step_seconds)
    say(f"D3 RunDriver beam {ctx.base_grid().nx} {steps} steps in "
        f"{secs:.2f} s (with set-up): metric equal to the entry level's="
        f"{geo_same}; state against main path 3 after {D3_STEPS} steps "
        f"max|diff|/max|field|={err:.3e} ({field}) limit {DRIVER_RTOL}; "
        f"ms/step={ms:.3f} host reads/step={reads:.1f} peak_mem_bytes="
        f"{peak} launches={json.dumps(launches)} on {smi}")
    if not (geo_same and steps == D3_STEPS and err <= DRIVER_RTOL):
        raise PhaseError("D3: the deck's run differs from entry.run's")
    check_launched(launches, ("ppm_predict", "ctu_final", "riemann_fluxdiv",
                              "stencil_gsrb_sweeps",
                              "stencil_helm_residual"), "D3")
    if files is not None:
        files.trees.clear()
    return launches


def cli_phase(device, files, options=(), deck=CLI_DECK, label="2D deck"):
    """The command line in a subprocess on the card: a small 2D deck, two
    steps (`options` go before the deck)."""
    text = deck
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as out:
        deck = os.path.join(out, "inputs.lock2d")
        with open(deck, "w") as f:
            f.write(text)
        args = list(options) + [deck, "amr.maxsteps=2"]
        cmd = ([sys.executable, "-m", "somar_tpu_torch"] if files is None
               else [sys.executable, "-c", CLI_SHIM]) + args
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (ROOT, env.get("PYTHONPATH")) if p)
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=out, env=env, capture_output=True,
                              text=True, timeout=600)
        secs = time.perf_counter() - t0
    tail = proc.stdout.strip().splitlines()[-1:] or [""]
    say(f"CLI ({label}) python -m somar_tpu_torch {' '.join(args)} on "
        f"{device}"
        f"{'' if files is None else ' (files kept in memory)'}: exit "
        f"{proc.returncode} in {secs:.1f} s, last line {tail[0]!r}")
    if proc.returncode != 0 or "finished 2 steps" not in proc.stdout:
        say(proc.stderr[-3000:])
        raise PhaseError("the command line did not finish its deck")


# --------------------------------------------------------------------------
# phases 14-19: the rest of the single-level physics and the leptic solver
# --------------------------------------------------------------------------
#: D4, horizontal convection at main path 1's widths: the top buoyancy
#: profile (an array-valued Dirichlet value) enters the diffusive solve,
#: which takes multigrid; the pressure and viscous solves stay spectral
D4_DECK = """
amr.nx = 512 128 128
amr.length = 15 2 2
amr.nx_offset = -256 0 0
amr.isPeriodic = 0 1 0
ibc.problem = 6
amr.cfl = 0.9
amr.viscosity = 1e-4
amr.scal_diffusion_coeffs = 1e-4
amr.maxsteps = 5
amr.final = 1e9
plot.plot_interval = -1
plot.checkpoint_interval = -1
amr.verbosity = 0
"""
D4_SMALL = ("amr.nx = 64 16 32\namr.nx_offset = -32 0 0\n"
            "amr.fixed_dt = 0.01\namr.maxsteps = 3\n")
#: D5, the vortex street of entry.build_vortex_level: its full size, the
#: ramp, and the card-against-CPU size
D5_SIZE = (1024, 512)
D5_SMALL = (128, 64)
D5_RAMP = 1.0
D5_STEPS = 5
#: D6, Zalesak's slotted disk without projections or gravity (pure
#: advection), each advection option set for the velocity and the scalars
D6_DECK = """
amr.nx = 2048 2048
amr.length = 1 1
amr.isPeriodic = 1 1
ibc.problem = 0
projection.isIncompressible = 0
amr.gravityMethod = 0
amr.maxsteps = 3
amr.final = 1e9
plot.plot_interval = -1
plot.checkpoint_interval = -1
amr.verbosity = 0
"""
D6_SMALL = "amr.nx = 128 128\namr.fixed_dt = 0.002\n"
D6_OPTIONS = {
    "ppm": "",
    "plm": "advection.normalPredOrderVel = 1\n"
           "advection.normalPredOrderScal = 1\n",
    "ctu0": "advection.normalPredOrderVel = 0\n"
            "advection.normalPredOrderScal = 0\n",
    "high_order_limiter": "advection.useHighOrderLimiterVel = 1\n"
                          "advection.useHighOrderLimiterScal = 1\n"
                          "advection.useLimitingVel = 1\n",
    "central": "advection.useUpwindingVel = 0\n"
               "advection.useUpwindingScal = 0\n",
}
#: the kernels each option's route launches (physics/godunov.py)
D6_ROUTES = {"ppm": ("ppm_predict", "ctu_final", "riemann_fluxdiv"),
             "plm": ("ctu_final", "riemann_fluxdiv"),
             "ctu0": ("ctu_final", "riemann_fluxdiv"),
             "high_order_limiter": ("ctu_final", "riemann_fluxdiv"),
             "central": ()}
#: tests/test_reference_configs.py:33-34
DISK_BOUNDS = (-0.15, 1.15)
#: D7, the background-stratified problems on a 2D 8 x 1 box; at rest the
#: first dt comes from the internal-wave speed limit
D7_DECK = """
amr.nx = 1024 256
amr.length = 8 1
amr.nx_offset = -512 -256
ibc.problem = {problem}
ibc.useBackgroundScalar = 1
ibc.bgScalarProfile = {profile}
amr.gravityMethod = 1
amr.limitDtViaInternalWaveSpeed = 1
amr.maxsteps = 3
amr.final = 1e9
plot.plot_interval = -1
plot.checkpoint_interval = -1
amr.verbosity = 0
"""
D7_SMALL = "amr.nx = 128 32\namr.nx_offset = -64 -16\namr.fixed_dt = 0.01\n"
D7_PROBLEMS = {"InternalWave": (3, 1), "SolitaryWave": (7, 3), "DJL": (8, 3)}
#: L1/L2, the leptic solver's design regime (tools/bench_leptic.py:43-53):
#: H = 1, horizontal cells dx_h = 2H (eps_leptic = 0.25), Neumann walls
L1_SIZE = (512, 512, 32)
L1_SMALL = (32, 32, 8)
L1_EPS = 1e-6
L1_ORDERS = 20
#: the gauge-free difference of the leptic and the multigrid solution
#: of a random rhs (the JAX package's own bound, tests/test_leptic.py:72)
L1_DIFF = 5e-2
L2_DECK = """
amr.nx = {nx} {ny} {nz}
amr.length = {lx} {ly} 1
amr.nx_offset = {off} 0 0
amr.isPeriodic = 0 0 0
ibc.problem = 1
amr.gravityMethod = 1
amr.cfl = 0.9
amr.viscosity = 1e-4
amr.scal_diffusion_coeffs = 1e-4
projection.solver = 2
amr.maxsteps = 3
amr.final = 1e9
plot.plot_interval = -1
plot.checkpoint_interval = -1
amr.verbosity = 0
"""
CARD_CPU_RTOL = {"spectral": 1e-4, "multigrid": 1e-3}
STATE_FIELDS = ("vel", "scalars", "lam", "pressure")


def l2_deck(nx, ny, nz, extra=""):
    return L2_DECK.format(nx=nx, ny=ny, nz=nz, lx=2 * nx, ly=2 * ny,
                          off=-nx // 2) + extra


def timed_steps(torch, level, state, counters, nsteps):
    """nsteps advances at the next compute_dt (varied by 1e-6 relative a
    step), the counts set to 0 just before; returns (state, seconds per
    step, launches per step, host reads per step, max|div| of each step's
    projected advecting velocity)."""
    from somar_tpu_torch.solvers.host_reads import read_scalars
    dt = level.compute_dt(state)
    reset_counts(counters)
    reads0 = read_scalars.count
    times, divs = [], []
    for k in range(nsteps):
        diag = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = level.advance(state, dt * (1.0 + 1e-6 * (k + 1)), diag=diag)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        divs.append(diag["max_mac_div"])
    per_step = {n: c / nsteps for n, c in read_counts(counters).items()}
    reads = (read_scalars.count - reads0) / nsteps
    return state, times, per_step, reads, [float(d) for d in divs]


def finite(torch, state):
    return all(bool(torch.isfinite(getattr(state, f)).all())
               for f in STATE_FIELDS)


def div_scale(level, state):
    """max_d max|u_d| / dx_d: the MAC divergence gate's scale."""
    return max(float(state.vel[d].abs().max()) / level.grid.dx[d]
               for d in range(level.grid.ndim))


def ms_of(times):
    return 1e3 * statistics.median(times)


def deck_card_vs_cpu(torch, deck, device, rtol, label):
    """The deck through RunDriver on the CPU and on the card; raises
    unless STATE_FIELDS agree within rtol of max|field|."""
    from somar_tpu_torch.driver import RunDriver
    ctx = context(deck)
    got = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_s7_") as out:
        for dev in ("cpu", device):
            got[dev], n = RunDriver(ctx, out_dir=out, device=dev).run(
                verbose=False)
    rel = field_diffs(got[device], got["cpu"], STATE_FIELDS)
    err = max(rel.values())
    say(f"{label} card against CPU {ctx.base_grid().nx} {n} steps: "
        f"max|diff|/max|field| " + " ".join(
            f"{f}={e:.3e}" for f, e in rel.items()) + f"; limit {rtol}")
    if not err <= rtol:
        raise PhaseError(f"{label}: the card's run differs from the CPU's")


def deck_phase(torch, deck, device, counters, label, path, timed=3):
    """A deck through RunDriver at full size (counts set to 0 just
    before), then `timed` timed steps; checks finite fields and that each
    kernel of `path` was launched in the run.  Returns (level, state,
    launches of the run, a dict of metrics)."""
    ctx = context(deck)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_s7_") as out:
        torch.cuda.reset_peak_memory_stats()
        drv, state, steps, launches, reads, secs = driver_run(
            torch, ctx, out, device, counters)
    level = drv.level
    ok = finite(torch, state)
    state, times, per_step, t_reads, divs = timed_steps(
        torch, level, state, counters, timed)
    ok = ok and finite(torch, state)
    peak = torch.cuda.max_memory_allocated()
    m = dict(grid=ctx.base_grid().nx, steps=steps, seconds=secs,
             driver_ms=ms_of(drv.step_seconds), ms=ms_of(times),
             reads=t_reads, per_step=per_step, peak=peak, divs=divs,
             scale=div_scale(level, state))
    say(f"{label} RunDriver {m['grid']} {steps} steps in {secs:.2f} s (with "
        f"set-up): finite={ok} launches={json.dumps(launches)}; then "
        f"{timed} timed steps: ms/step={m['ms']:.3f} samples="
        + ",".join(f"{1e3 * t:.3f}" for t in times)
        + f" (driver's {m['driver_ms']:.3f}) host reads/step={t_reads:.1f} "
        f"launches/step={json.dumps(per_step)} peak_mem_bytes={peak} "
        f"max|div| after each MAC projection="
        + ",".join(f"{d:.3e}" for d in divs))
    if not ok:
        raise PhaseError(f"{label}: non-finite state")
    check_launched(launches, path, label)
    return level, state, launches, m


def horiz_conv_phase(torch, counters, device, smi):
    """D4: HorizConv at 512x128x128 through RunDriver; the array-valued
    top value in the multigrid diffusive solve."""
    small = D4_DECK + D4_SMALL
    deck_card_vs_cpu(torch, small, device, CARD_CPU_RTOL["multigrid"], "D4")
    level, state, launches, m = deck_phase(
        torch, D4_DECK, device, counters, "D4 HorizConv",
        ("ppm_predict", "ctu_corr3", "ctu_final", "riemann_fluxdiv",
         "gsrb_sweeps", "helm_residual"))
    hs = level.diff_solvers[0]
    b = state.scalars[0]
    bmin, bmax = float(b.min()), float(b.max())
    say(f"D4 HorizConv: diffusive solve by "
        f"{'multigrid' if hs._fft is None else 'spectral'}, pressure "
        f"{level.projector.method}, viscous "
        f"{'batched spectral' if level._visc_batched else 'per component'}"
        f"; b in [{bmin:.6f}, {bmax:.6f}] (bound {B_BOUNDS}); MAC max|div| "
        f"limit {MAC_DIV_RTOL} x {m['scale']:.3e} on {smi}")
    if hs._fft is not None:
        raise PhaseError("D4: the array-valued top took the spectral solve")
    if not (B_BOUNDS[0] < bmin and bmax < B_BOUNDS[1]):
        raise PhaseError(f"D4: buoyancy out of {B_BOUNDS}")
    if not max(m["divs"]) <= MAC_DIV_RTOL * m["scale"]:
        raise PhaseError("D4: the MAC projection left a divergence")
    return launches


def vortex_card_vs_cpu(torch, entry, device):
    from somar_tpu_torch.solvers.multigrid import MGParams
    mg = MGParams(eps=1e-6, imax=20)
    nx, ny = D5_SMALL
    states = {}
    for dev in ("cpu", device):
        level, _ = entry.build_vortex_level(nx, ny, ramp_time=D5_RAMP,
                                            device=dev, mg=mg)
        state = level.post_initialize(level.initial_state())
        for _ in range(3):
            state = level.advance(state, 0.01)
        states[dev] = state
    rel = field_diffs(states[device], states["cpu"], STATE_FIELDS)
    rtol = CARD_CPU_RTOL["multigrid"]
    say(f"D5 card against CPU ({nx}, {ny}) 3 steps: max|diff|/max|field| "
        + " ".join(f"{f}={e:.3e}" for f, e in rel.items())
        + f"; limit {rtol}")
    if not max(rel.values()) <= rtol:
        raise PhaseError("D5: the card's run differs from the CPU's")


def vortex_reads(torch, entry, device, ramp):
    """Host reads a step of 2 steps after a first one, every solve held
    to 4 V-cycles with a smoothing bottom (so that only the binding could
    change the count)."""
    from somar_tpu_torch.solvers.host_reads import read_scalars
    from somar_tpu_torch.solvers.multigrid import MGParams
    level, _ = entry.build_vortex_level(
        *D5_SIZE, ramp_time=ramp, device=device,
        mg=MGParams(eps=1e-30, imin=4, imax=4, bottom_solver="smooth"))
    state = level.post_initialize(level.initial_state())
    state = level.advance(state, 0.002)
    r0 = read_scalars.count
    for _ in range(2):
        state = level.advance(state, 0.002)
    torch.cuda.synchronize()
    return (read_scalars.count - r0) / 2


def vortex_phase(torch, entry, counters, device, smi):
    """D5: the 1024x512 vortex street with its ramped inflow through
    entry.run, multigrid projections and viscous solves."""
    vortex_card_vs_cpu(torch, entry, device)
    level, grid = entry.build_vortex_level(*D5_SIZE, ramp_time=D5_RAMP,
                                           device=device)
    infos = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters)
    t0 = time.perf_counter()
    state = entry.run(level, level.initial_state(), D5_STEPS,
                      on_step=lambda i, s, dt: infos.append(
                          dict(level.projector.last_info)))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_counts(counters)
    ok = finite(torch, state)
    state, times, per_step, reads, divs = timed_steps(
        torch, level, state, counters, 3)
    ok = ok and finite(torch, state)
    peak = torch.cuda.max_memory_allocated()
    umax = float(state.vel.abs().max())
    inflow = float(level.vel_bcs_trace[0].lo[0].value(state.time))
    worst = max(rr for info in infos for (_, rr) in info.values())
    scale = div_scale(level, state)
    r_ramp = vortex_reads(torch, entry, device, D5_RAMP)
    r_const = vortex_reads(torch, entry, device, 0.0)
    say(f"D5 VortexStreet {grid.nx} {D5_STEPS} steps in {secs:.2f} s (with "
        f"set-up): finite={ok} t={float(state.time):.4f} inflow u0 "
        f"min(1, t/{D5_RAMP})={inflow:.6f} max|u|={umax:.4f} worst "
        f"projection relres={worst:.3e} launches={json.dumps(launches)}; "
        f"3 timed steps: ms/step={ms_of(times):.3f} samples="
        + ",".join(f"{1e3 * t:.3f}" for t in times)
        + f" host reads/step={reads:.1f} launches/step="
        f"{json.dumps(per_step)} peak_mem_bytes={peak} max|div| after each "
        f"MAC projection=" + ",".join(f"{d:.3e}" for d in divs)
        + f" (scale {scale:.3e}, no gate: the inflow-outflow imbalance); "
        f"host reads/step with 4 "
        f"V-cycles a solve: ramped {r_ramp:.1f}, ramp_time = 0 {r_const:.1f}"
        f" on {smi}")
    if not ok:
        raise PhaseError("D5: non-finite state")
    if not umax <= 10.0:
        raise PhaseError("D5: max|u| above 10 times the inflow")
    if not worst <= SOLVE_FAIL_RELRES:
        raise PhaseError("D5: a projection did not reduce its residual")
    # (no MAC divergence gate: the outflow face is not pinned and the
    # pressure BCs are Neumann, so the solvability projection leaves the
    # net inflow-outflow imbalance as a uniform divergence, in the JAX
    # package as here)
    if r_ramp != r_const:
        raise PhaseError("D5: binding the inflow added host reads")
    check_launched(launches, ("ppm_predict", "ctu_final", "riemann_fluxdiv",
                              "gsrb_sweeps", "helm_residual"), "D5")
    if launches["ctu_corr3"] != 0:
        raise PhaseError("D5: a 2D step launched K2")
    return launches


def batched_tracer_check(torch, counters, device):
    """The batched tracer (three fields, PPM, 3D 64x32x32), which no step
    calls: the card's kernels against the CPU's twins within 1e-5 of
    max|output|; prints the card's launches."""
    from somar_tpu_torch.core.bc import BC, FieldBCs, fill_ghosts_cc
    from somar_tpu_torch.core.grid import Grid
    from somar_tpu_torch.geometry.geo_source import CartesianMap
    from somar_tpu_torch.geometry.level_geometry import build_level_geometry
    from somar_tpu_torch.physics import godunov as gd
    nx = (64, 32, 32)
    grid = Grid(nx=nx, dx=tuple(1.0 / n for n in nx))
    out, launches = {}, None
    for dev in ("cpu", device):
        geo = build_level_geometry(grid, CartesianMap(), device=dev)
        bcs = FieldBCs.from_periodic(grid, BC.extrap(1))
        gen = torch.Generator().manual_seed(3)

        def rnd(shape, scale=1.0):
            return (scale * torch.randn(shape, generator=gen)).to(dev)

        fields = [rnd(grid.shape) for _ in range(3)]
        u_pad = [fill_ghosts_cc(rnd(grid.shape, 0.5), grid, bcs,
                                gd.ADVECT_GROW) for _ in range(3)]
        adv = tuple(gd.pad_valid_faces(rnd(grid.fc_shape(d), 0.5), grid, d)
                    for d in range(3))
        reset_counts(counters)
        faces = gd.trace_face_states_batched(
            fields, None, [bcs] * 3, adv, 0.02, geo, gd.AdvectionParams(),
            u_pad)
        out[dev] = faces + (gd.flux_divergence_batched(faces, adv, geo),)
        launches = read_counts(counters)
    err = max(float((g.cpu() - w).abs().max()) / float(w.abs().max())
              for g, w in zip(out[device], out["cpu"]))
    say(f"D6 batched tracer card against CPU {nx} x3 fields: max|diff|/"
        f"max|output|={err:.3e} limit 1e-05; card launches "
        f"{json.dumps(launches)}")
    if not err <= 1e-5:
        raise PhaseError("D6: the card's batched tracer differs from the "
                         "CPU's")
    check_launched(launches, ("ppm_predict", "ctu_corr3", "ctu_final"),
                   "D6 batched tracer")


def advection_phase(torch, counters, device, smi):
    """D6: the slotted disk at 2048x2048 once with every advection
    option, launches by option; then the batched tracer card against
    CPU."""
    by_option = {}
    for name, keys in D6_OPTIONS.items():
        deck = D6_DECK + keys
        deck_card_vs_cpu(torch, deck + D6_SMALL, device,
                         CARD_CPU_RTOL["spectral"], f"D6 {name}")
        route = D6_ROUTES[name]
        level, state, launches, m = deck_phase(
            torch, deck, device, counters, f"D6 AdvectionTest {name}", route)
        s = state.scalars[0]
        smin, smax = float(s.min()), float(s.max())
        off_route = [k for k in ("ppm_predict", "ctu_corr3", "ctu_final",
                                 "riemann_fluxdiv") if k not in route
                     and launches.get(k, 0) != 0]
        say(f"D6 {name}: scalar in [{smin:.6f}, {smax:.6f}] (bound "
            f"{DISK_BOUNDS if name != 'central' else 'none'}); route {list(route) or 'plain torch'}; "
            f"params vel={level.params.advection_vel} on {smi}")
        # central fluxes are not monotone: in both packages the disk
        # leaves the upwinded schemes' bound within a few steps at this
        # CFL, so they are held to the CPU and to finite fields only
        if name != "central" and not (DISK_BOUNDS[0] < smin
                                      and smax < DISK_BOUNDS[1]):
            raise PhaseError(f"D6 {name}: the disk left {DISK_BOUNDS}")
        if off_route:
            raise PhaseError(f"D6 {name}: launched {off_route} off its "
                             "route")
        by_option[name] = launches
    batched_tracer_check(torch, counters, device)
    return by_option


def stratified_phase(torch, counters, device, smi):
    """D7: InternalWave, SolitaryWave and DJL (KdV eta) at 1024x256, 3
    steps each through RunDriver."""
    by_problem = {}
    for name, (problem, profile) in D7_PROBLEMS.items():
        deck = D7_DECK.format(problem=problem, profile=profile)
        deck_card_vs_cpu(torch, deck + D7_SMALL, device,
                         CARD_CPU_RTOL["spectral"], f"D7 {name}")
        ctx = context(deck)
        geo = ctx.base_grid()
        level, state, launches, m = deck_phase(
            torch, deck, device, counters, f"D7 {name}",
            ("ppm_predict", "ctu_final", "riemann_fluxdiv"))
        bbar = level._tensor(level.problem.background_cc(level.geo))
        b0 = level.initial_state().scalars[0] + bbar
        b = state.scalars[0] + bbar
        lo0, hi0 = float(b0.min()), float(b0.max())
        pad = 0.1 * (hi0 - lo0)
        lo, hi = float(b.min()), float(b.max())
        say(f"D7 {name} {geo.nx}: total buoyancy in [{lo:.6f}, {hi:.6f}], "
            f"initially [{lo0:.6f}, {hi0:.6f}] (bound: the initial range "
            f"+- 10%); pressure {level.projector.method} on {smi}")
        if not (lo0 - pad <= lo and hi <= hi0 + pad):
            raise PhaseError(f"D7 {name}: buoyancy left its initial range")
        if not max(m["divs"]) <= MAC_DIV_RTOL * m["scale"]:
            raise PhaseError(f"D7 {name}: the MAC projection left a "
                             "divergence")
        by_problem[name] = launches
    return by_problem


def leptic_box(torch, nx, ny, nz, device):
    """The leptic design-regime box and its Neumann BCs."""
    from somar_tpu_torch.core.bc import BC, FieldBCs
    from somar_tpu_torch.core.grid import Grid
    from somar_tpu_torch.geometry.geo_source import CartesianMap
    from somar_tpu_torch.geometry.level_geometry import build_level_geometry
    grid = Grid(nx=(nx, ny, nz), dx=(2.0, 2.0, 1.0 / nz))
    geo = build_level_geometry(grid, CartesianMap(), device=device)
    return geo, FieldBCs.from_periodic(grid, BC.neumann(0.0))


def leptic_rhs(torch, geo, seed=0):
    gen = torch.Generator(device=geo.device).manual_seed(seed)
    rhs = torch.randn(geo.grid.shape, generator=gen, device=geo.device)
    return rhs - rhs.mean()


def gauge_free_diff(a, b):
    a = a - a.mean()
    b = b - b.mean()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def leptic_full(torch, counters, geo, bcs, lp, rhs, dtype, smi):
    """One full-size L1 run in `dtype`: the leptic solve alone, with its
    multigrid finisher, and LevelMultigrid on the same rhs, each timed on
    its second call with the counts set to 0 just before."""
    from somar_tpu_torch.solvers.host_reads import read_scalars
    from somar_tpu_torch.solvers.leptic import LevelLepticSolver
    from somar_tpu_torch.solvers.multigrid import LevelMultigrid, MGParams
    rhs = rhs.to(dtype)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lep = LevelLepticSolver(geo, bcs, lp, dtype=dtype)
    mg = LevelMultigrid(geo, bcs, MGParams(eps=L1_EPS, imax=20), dtype=dtype)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    plans = [op._stencil_plan is not None for op in lep.h_mg.ops]

    def timed(fn):
        fn()                                   # first call: warm
        reset_counts(counters)
        r0 = read_scalars.count
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return (out, 1e3 * (time.perf_counter() - t0),
                read_scalars.count - r0, read_counts(counters))

    (phi_o, (orders_o, rel_o, status_o)), ms_o, reads_o, _ = timed(
        lambda: lep.solve(rhs))
    (phi_l, (orders, rel_l, status)), ms_l, reads_l, launch_l = timed(
        lambda: lep.solve_with_fallback(rhs))
    (phi_m, (cycles, rel_m)), ms_m, reads_m, launch_m = timed(
        lambda: mg.solve(rhs, singular=True))
    peak = torch.cuda.max_memory_allocated()
    diff = gauge_free_diff(phi_l, phi_m)
    ok = bool(torch.isfinite(phi_l).all()) and bool(
        torch.isfinite(phi_m).all())
    say(f"L1 leptic {L1_SIZE} {dtype} eps_leptic=0.25 (set-up {setup:.2f} "
        f"s, flattened {tuple(lep.h_mg.ops[0].grid.shape)} levels with a "
        f"stencil plan {plans}): leptic alone orders={orders_o} "
        f"relres={rel_o:.3e} status={status_o} {ms_o:.3f} ms "
        f"({reads_o} host reads); with the multigrid finisher orders="
        f"{orders} status={status} final relres={rel_l:.3e} {ms_l:.3f} ms "
        f"({reads_l} host reads) launches={json.dumps(launch_l)}; "
        f"LevelMultigrid V-cycles={cycles} relres={rel_m:.3e} modes="
        f"{mg.modes} {ms_m:.3f} ms ({reads_m} host reads) launches="
        f"{json.dumps(launch_m)}; gauge-free max|phi_leptic - phi_mg| / "
        f"max|phi_mg|={diff:.3e} (limit {L1_DIFF}) finite={ok} "
        f"peak_mem_bytes={peak} on {smi}")
    if not ok:
        raise PhaseError(f"L1 {dtype}: a non-finite solution")
    return dict(solver=lep, phi_l=phi_l, phi_m=phi_m, rel_l=rel_l,
                rel_m=rel_m, diff=diff, launch_l=launch_l, launch_m=launch_m)


def leptic_solve_phase(torch, counters, device, smi, sgk, worst):
    """L1: the leptic solver against LevelMultigrid on the 512x512x32
    box, in float32 and in float64: orders, status, residuals, solution
    difference, ms and launches per solve; K7/K8 against their twins and
    timed on the flattened (512, 512) level."""
    from somar_tpu_torch.solvers.leptic import LepticParams, LevelLepticSolver
    lp = LepticParams(eps=L1_EPS, max_order=L1_ORDERS)
    # card against CPU on a small box
    phis = {}
    for dev in ("cpu", device):
        geo, bcs = leptic_box(torch, *L1_SMALL, dev)
        rhs = leptic_rhs(torch, leptic_box(torch, *L1_SMALL, "cpu")[0])
        phis[dev], info = LevelLepticSolver(geo, bcs, lp).solve_with_fallback(
            rhs.to(dev))
    err = gauge_free_diff(phis[device].cpu(), phis["cpu"])
    say(f"L1 leptic card against CPU {L1_SMALL}: gauge-free "
        f"max|diff|/max|phi|={err:.3e} limit {CARD_CPU_RTOL['multigrid']} "
        f"(card: orders={info[0]} relres={info[1]:.3e} status={info[2]})")
    if not err <= CARD_CPU_RTOL["multigrid"]:
        raise PhaseError("L1: the card's leptic solve differs from the CPU's")

    geo, bcs = leptic_box(torch, *L1_SIZE, device)
    rhs = leptic_rhs(torch, geo)
    runs = {dt: leptic_full(torch, counters, geo, bcs, lp, rhs, dt, smi)
            for dt in (torch.float32, torch.float64)}
    f32, f64 = runs[torch.float32], runs[torch.float64]
    say(f"L1 float32 against float64 gauge-free max|diff|/max|phi|: "
        f"leptic {gauge_free_diff(f32['phi_l'].double(), f64['phi_l']):.3e}"
        f" multigrid "
        f"{gauge_free_diff(f32['phi_m'].double(), f64['phi_m']):.3e}")
    # float32 solves of this random rhs stop at their rounding floor
    # (relres ~2e-3, as the JAX package's own record of this box,
    # docs/LEPTIC_AB.json, shows): the residual gate is the float64 run's
    if not (f64["rel_l"] < SOLVE_FAIL_RELRES
            and f64["rel_m"] < SOLVE_FAIL_RELRES):
        raise PhaseError("L1: a float64 solve did not reach a relative "
                         f"residual of {SOLVE_FAIL_RELRES}")
    for dt, run in runs.items():
        if not run["diff"] <= L1_DIFF:
            raise PhaseError(f"L1 {dt}: the leptic and the multigrid "
                             "solution differ")
        check_launched(run["launch_l"], ("helm_residual",
                                         "stencil_gsrb_sweeps",
                                         "stencil_helm_residual"), "L1")
    lep = f32["solver"]

    # K7/K8 on the flattened level: against the twins, then timed
    plan = lep.h_mg.ops[0]._stencil_plan
    gen = torch.Generator(device=device).manual_seed(5)
    phi, r = (torch.randn(plan.shape, generator=gen, device=device)
              for _ in range(2))
    stencil_parity_case(torch, sgk, f"flattened {plan.shape}", plan, phi, r,
                        [("plain", {})], worst)
    times = {}
    for name, cu_name, kern, plain in (
            ("stencil_gsrb_sweeps", K7_NAMES,
             lambda: sgk.stencil_gsrb_sweeps(plan, phi, r, 0.0, 1.0, 1),
             lambda: sgk.stencil_gsrb_sweeps_plain(plan, phi, r, 0.0, 1.0,
                                                   1)),
            ("stencil_helm_residual", ("stencil_helm_residual_kernel",),
             lambda: sgk.stencil_helm_residual(plan, phi, r, 0.0, 1.0),
             lambda: sgk.stencil_helm_residual_plain(plan, phi, r, 0.0,
                                                     1.0))):
        bound, by = bound_ms(name, phi.numel(), K=plan.K)
        times[name] = dict(ms=median_ms(torch, kern),
                           plain_ms=median_ms(torch, plain),
                           device_ms=device_ms(torch, kern, cu_name),
                           bound_ms=bound, K=plan.K, shape=list(plan.shape))
        say(f"timing {name:21s} flattened {str(plan.shape):12s} K={plan.K} "
            f"kernel={times[name]['ms']:.4f} ms plain="
            f"{times[name]['plain_ms']:.4f} ms kernel device time="
            f"{times[name]['device_ms']:.4f} ms bound={bound:.4f} ms ({by})")
    return f32["launch_l"], f32["launch_m"], f64["launch_l"], times


def leptic_step_phase(torch, counters, device, smi):
    """L2: the flat 3D lock exchange with projection.solver = 2 on the L1
    box through RunDriver, 3 steps, MAC max|div| after each step."""
    from somar_tpu_torch.driver import RunDriver
    small = l2_deck(*L1_SMALL, extra="amr.fixed_dt = 0.02\n"
                    "amr.maxsteps = 2\n")
    deck_card_vs_cpu(torch, small, device, CARD_CPU_RTOL["multigrid"], "L2")
    ctx = context(l2_deck(*L1_SIZE))
    if ctx.ns.pressure_solver != "leptic":
        raise PhaseError("L2: projection.solver = 2 did not select leptic")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_l2_") as out:
        drv = RunDriver(ctx, out_dir=out, device=device)
        level = drv.level
        divs, infos = [], []
        advance = level.advance

        def advance_with_diag(state, dt, diag=None):
            d = {} if diag is None else diag
            new = advance(state, dt, diag=d)
            divs.append((d["max_mac_div"], div_scale(level, new)))
            infos.append(dict(level.projector.last_info))
            return new

        level.advance = advance_with_diag
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(counters)
        t0 = time.perf_counter()
        state, steps = drv.run(verbose=False)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = read_counts(counters)
        peak = torch.cuda.max_memory_allocated()
    ok = finite(torch, state)
    divs = [(float(d), s) for d, s in divs]
    ms = ms_of(drv.step_seconds[-steps:])
    say(f"L2 leptic lock exchange {ctx.base_grid().nx} {steps} steps in "
        f"{secs:.2f} s (with set-up, initial projections and pressure "
        f"iterations): finite={ok} ms/step={ms:.3f} (driver; its "
        f"per-step divergence reads included) launches="
        f"{json.dumps(launches)} peak_mem_bytes={peak}; per advance MAC "
        f"max|div| / (max_d max|u_d|/dx_d)="
        + ",".join(f"{d / max(s, 1e-30):.3e}" for d, s in divs)
        + f" (limit {MAC_DIV_RTOL}); solves per advance "
        + "; ".join(" ".join(f"{p}: it={it} relres={rr:.3e}"
                             for p, (it, rr) in sorted(i.items()))
                    for i in infos) + f" on {smi}")
    if not ok:
        raise PhaseError("L2: non-finite state")
    if steps != 3:
        raise PhaseError(f"L2 ran {steps} steps")
    if not all(d <= MAC_DIV_RTOL * s for d, s in divs[-steps:]):
        raise PhaseError("L2: a MAC projection left a divergence")
    if not all(rr <= SOLVE_FAIL_RELRES for i in infos
               for (_, rr) in i.values()):
        raise PhaseError("L2: a leptic projection did not reduce its "
                         "residual")
    check_launched(launches, ("ppm_predict", "ctu_corr3", "ctu_final",
                              "riemann_fluxdiv", "helm_residual",
                              "stencil_gsrb_sweeps",
                              "stencil_helm_residual"), "L2")
    return launches


# --------------------------------------------------------------------------
# slice 9: the two-level AMR hierarchy (A0-A2)
# --------------------------------------------------------------------------
#: A0's small hierarchies (base nx, ny, nz; ratio), card against CPU
AMR_A0 = {"3d 32x16x16": ((32, 16, 16), (4, 1, 1)),
          "2d 48x16": ((48, None, 16), (4, 1))}
A0_DT = 0.02
A0_STEPS = 3
#: the JAX bench's AMR cell at its recorded shapes
#: (docs/PROFILE_AMR_r05.txt:18-26): base (64, 96, 64), ratio (4,1,1),
#: patch ext (128, 96, 64); and the north star's effective 512x128x128
AMR_A1 = ((64, 96, 64), (4, 1, 1))
AMR_A1_EXT = (128, 96, 64)
AMR_A2 = ((128, 128, 128), (4, 1, 1))
AMR_DT = 0.01
AMR_FIELDS = ("vel", "scalars", "lam", "pressure", "mac_phi", "cc_phi")
#: the sync solve runs the JAX package's fixed two composite passes
#: (sync_composite_iters = 2), so its final relres sits near 1e-2 (the
#: JAX package ends at 1.07e-2 on A0's 2D hierarchy, ROADMAP C.16), not
#: at the 1e-3 of C.8 (solves that iterate to a tolerance).  The limit
#: sits between the sound runs (at most 1.33e-2 on A0-A2) and the faults
#: of SYNC_FAULTS, which A0 runs and which must cross it (4.5e-2 and above
#: on A0 3D and 2D on the CPU, PERF.md PR 9).
SYNC_RELRES = 3e-2
#: faults of the sync solve that the SYNC_RELRES gate must catch: one
#: composite pass, and two passes without the FAS tau or without the
#: lagged elliptic reflux (the residual measured keeps both)
SYNC_FAULTS = ("one pass", "no tau", "no reflux")
#: tests/test_amr.py:778: the sync-projected divergence within 1.5x of
#: the unprojected one by that test's measure (base level everywhere)
DIV_FACTOR = 1.5
#: potentials, whose constant is free (pure Neumann), compared with their
#: means removed
GAUGE_FIELDS = ("mac_phi", "cc_phi")
#: average-down gate: coarse cells under the patch interior equal the
#: restricted fine interior
AVGDOWN_RTOL = 1e-6
STANDINS = ("stand-ins until inputs.LockExchange_Cartesian3D.machine is in "
            "the repository: 15 x 2 x 2, nu = kappa = 1e-4, CN, explicit "
            "gravity (path 1), buoyancy_tag_tol 0.2, tags_grow 1, "
            "MGParams(eps=1e-5, imax=12)")


def amr_hierarchy(entry, shape, ratio, device, **kw):
    """entry.build_amr_hierarchy with the AMR cell's stand-in multigrid
    parameters."""
    from somar_tpu_torch.solvers.multigrid import MGParams
    nx, ny, nz = shape
    return entry.build_amr_hierarchy(nx, ny, nz, ratio, device=device,
                                     mg=MGParams(eps=1e-5, imax=12), **kw)


def jax_test_div(h, s0, fine):
    """tests/test_amr.py:763-766: max of the base level's max|div| (its
    covered cells included) and the patch's away from its halo and the
    first interior ring (x only)."""
    H = h.halo
    d0 = float(h.level0.cell_divergence(s0).abs().max())
    d1 = float(h.couplings[0].level.cell_divergence(fine)[
        ..., 2 * H:-2 * H].abs().max())
    return max(d0, d1)


def composite_div(h, s0, fine, origin):
    """The composite divergence that the sync projection acts on (its own
    right-hand sides, hierarchy._sync_project): the base level's MAC
    divergence of its face-averaged velocity on the cells the patch does
    not cover, the CF interface faces carrying the averaged patch flux,
    and the patch's away from its halo and first interior ring (x only).
    Returns (composite, patch part)."""
    from somar_tpu_torch.amr.flux_register import PatchFluxRegister
    from somar_tpu_torch.ops.stencil import mac_divergence
    c = h.couplings[0]
    level0, lvl = h.level0, c.level
    f0 = level0.projector.cc_fluxes(s0.vel, level0.vel_bcs_trace)
    f1 = lvl.projector.cc_fluxes(fine.vel, lvl.vel_bcs_trace)
    fr = PatchFluxRegister(c)
    reg = fr.increment_coarse(fr.increment_fine(fr.zeros(), f1, 1.0), f0,
                              origin)
    d0 = fr.reflux(mac_divergence(f0, level0.geo), reg, origin, -1.0,
                   level0.geo)
    d0[tuple(slice(o, o + n) for o, n in zip(c.covered_origin_c(origin),
                                             c.covered_shape_c))] = 0.0
    H = h.halo
    d1 = float(mac_divergence(f1, lvl.geo)[..., 2 * H:-2 * H].abs().max())
    return max(float(d0.abs().max()), d1), d1


def sync_fault(stack, fault):
    """Enter `fault` of SYNC_FAULTS into the ExitStack `stack`; returns
    the hierarchy keywords it needs."""
    from unittest import mock
    from somar_tpu_torch.amr.composite import AMRCompositeSolver
    if fault == "one pass":
        return dict(sync_composite_iters=1)
    if fault == "no tau":
        stack.enter_context(mock.patch.object(
            AMRCompositeSolver, "_tau_corrected",
            lambda self, phis, rhss, *_: rhss[0]))
    elif fault == "no reflux":
        stack.enter_context(mock.patch.object(
            AMRCompositeSolver, "_lagged_reflux",
            lambda self, phis, par, *_: par))
    else:
        raise ValueError(fault)
    return {}


def avgdown_err(torch, h, s0, fine, origin):
    """max over b and u of |coarse under the patch interior - restricted
    fine interior| (a 0-d tensor), and max|b|."""
    from somar_tpu_torch.amr.transfer import extract_patch, restrict_average
    c = h.couplings[0]
    org_c = c.covered_origin_c(origin)
    errs = []
    for coarse, f in ((s0.scalars[0], fine.scalars[0]),
                      *zip(s0.vel, fine.vel)):
        want = restrict_average(extract_patch(f, c.int_start, c.int_shape),
                                c.ext_grid, c.ratio)
        errs.append((extract_patch(coarse, org_c, want.shape)
                     - want).abs().max())
    return torch.stack(errs).max(), s0.scalars[0].abs().max()


def amr_diffs(a, b):
    """{level.field: max|a - b| / max|b|} over both levels of two (base,
    patch) state pairs, the potentials GAUGE_FIELDS with their means
    removed."""
    rel = {}
    for lvl, x, y in zip(("base", "patch"), a, b):
        for f, e in field_diffs(x, y, AMR_FIELDS).items():
            rel[f"{lvl}.{f}"] = (gauge_free_diff(
                getattr(x, f), getattr(y, f).to(getattr(x, f).device))
                if f in GAUGE_FIELDS else e)
    return rel


def amr_card_vs_cpu(torch, entry, counters, device):
    """A0: each small hierarchy placed, projected and stepped A0_STEPS
    times on the CPU and on the card (its launches counted); every field
    of both levels within MG_STEP_RTOL of max|field| (the potentials
    GAUGE_FIELDS gauge-free), the same origin, beside the f32 floor of
    each field (a CPU run in float64, not gated); the sync solve's relres
    below SYNC_RELRES after every step; then the card's run with the sync
    projection off: the composite divergence (composite_div) and the
    patch's own lower with the sync on, and tests/test_amr.py's measure
    within DIV_FACTOR; then each of SYNC_FAULTS, which must cross
    SYNC_RELRES."""
    import contextlib
    for label, (shape, ratio) in AMR_A0.items():
        runs = {}
        for dev, mode in (("cpu", "sync"), ("cpu", "f64"), (device, "sync"),
                          (device, "off"),
                          *((device, f) for f in SYNC_FAULTS)):
            with contextlib.ExitStack() as stack:
                kw = (sync_fault(stack, mode) if mode in SYNC_FAULTS
                      else dict(dtype=torch.float64) if mode == "f64"
                      else dict(do_sync_projection=mode == "sync"))
                h = amr_hierarchy(entry, shape, ratio, dev, **kw)
                counted = dev == device and mode == "sync"
                if counted:
                    torch.cuda.synchronize()
                    reset_counts(counters)
                s0, fine, origin = entry.place_amr(h)
                relres = []
                s0, fine = entry.run_amr(
                    h, s0, fine, origin, A0_DT, A0_STEPS,
                    on_step=lambda i, a, b: relres.append(
                        h.last_sync_info[1] if h.do_sync_projection
                        else torch.zeros((), device=dev)))
                if counted:
                    torch.cuda.synchronize()
                    launches = read_counts(counters)
            runs[dev, mode] = (h, s0, fine, origin,
                               torch.stack(relres).tolist())
        h, s0, fine, origin, relres = runs[device, "sync"]
        _, c0, cf, corigin, _ = runs["cpu", "sync"]
        rel = amr_diffs((s0, fine), (c0, cf))
        floor = amr_diffs((c0, cf), runs["cpu", "f64"][1:3])
        err = max(rel.values())
        on, on_patch = composite_div(h, s0, fine, origin)
        off, off_patch = composite_div(*runs[device, "off"][:4])
        t_on = jax_test_div(h, s0, fine)
        t_off = jax_test_div(*runs[device, "off"][:3])
        faults = {f: runs[device, f][4] for f in SYNC_FAULTS}
        say(f"A0 {label} ratio {ratio}: origin {origin.tolist()} (CPU "
            f"{corigin.tolist()}) ext {h.ext_nx}, {A0_STEPS} coarse steps "
            f"at dt {A0_DT}: card against CPU max|diff|/max|field| "
            + " ".join(f"{k}={v:.3e}" for k, v in rel.items())
            + f"; limit {MG_STEP_RTOL}; the f32 floor (the CPU's f32 run "
            f"against its f64 run, not gated) "
            + " ".join(f"{k}={v:.3e}" for k, v in floor.items())
            + f"; composite max|div| sync on "
            f"{on:.4e} off {off:.4e}, patch part on {on_patch:.4e} off "
            f"{off_patch:.4e}; tests/test_amr.py measure on {t_on:.4e} off "
            f"{t_off:.4e} (limit {DIV_FACTOR}x); sync relres per step "
            + ",".join(f"{r:.3e}" for r in relres)
            + f" (limit {SYNC_RELRES}); faults that must cross it: "
            + "; ".join(f"{f} " + ",".join(f"{r:.3e}" for r in v)
                        for f, v in faults.items())
            + f"; the card's launches (placement, projection, steps) "
            f"{json.dumps(launches)}")
        if list(origin) != list(corigin):
            raise PhaseError(f"A0 {label}: the card placed the patch "
                             "elsewhere")
        if not err <= MG_STEP_RTOL:
            raise PhaseError(f"A0 {label}: the card's hierarchy differs "
                             "from the CPU's")
        if not all(r < SYNC_RELRES for r in relres):
            raise PhaseError(f"A0 {label}: the sync solve did not reduce "
                             "its composite residual")
        if not all(max(v) >= SYNC_RELRES for v in faults.values()):
            raise PhaseError(f"A0 {label}: a fault of the sync solve stays "
                             f"below the relres limit {SYNC_RELRES}")
        if not (on < off and on_patch < off_patch
                and t_on <= DIV_FACTOR * t_off):
            raise PhaseError(f"A0 {label}: the sync projection did not "
                             "lower the composite divergence")


def solver_level_twins(torch, gk, sgk, lvl, tag, worst):
    """K5-K6 on every multigrid level of `lvl`'s pressure hierarchy with a
    uniform plan (the patch's CF sides take boundary factor 1; its top
    level is the operator of the composite residual), K7-K8 on its levels
    with a probed plan (a mapped level's: its projector's own hierarchy)
    and on every stencil-plan level of its diffusive solve (on the patch:
    CF in x, EXTRAP(1) walls) against their twins on the card: K5, K6, K7
    bitwise, K8 within PARITY_RTOL.  Returns the plan-less levels of each
    hierarchy."""
    from somar_tpu_torch.ops import rb_sweeps as rb
    from somar_tpu_torch.solvers.multigrid import LevelMultigrid
    gen = torch.Generator(device=lvl.geo.device).manual_seed(99)
    # a mapped level's own projection hierarchy (its probed K7/K8 plans);
    # on a uniform one the K5/K6 hierarchy of its pressure BCs
    pressure = (lvl.projector.mg if not lvl.geo.is_uniform else
                LevelMultigrid(lvl.geo, lvl.projector.phi_bcs,
                               lvl.projector._mg_params))
    plain = {"pressure": [], "diffusive": []}
    for op in pressure.ops:
        plan = op._fused_plan
        if plan is None:
            splan = op._stencil_plan
            if splan is None:
                plain["pressure"].append(tuple(op.grid.shape))
                continue
            phi, rhs = (torch.randn(splan.shape, generator=gen,
                                    device=lvl.geo.device,
                                    dtype=splan.Wn.dtype)
                        for _ in range(2))
            stencil_parity_case(torch, sgk, f"A {tag} pressure "
                                f"{splan.shape}", splan, phi, rhs,
                                [("plain", {})], worst)
            continue
        phi, rhs = (torch.randn(plan.shape, generator=gen,
                                device=lvl.geo.device, dtype=lvl.geo.dtype)
                    for _ in range(2))
        label = f"A {tag} {plan.shape}"
        for alpha, beta in GSRB_COEFS:
            want = gk.gsrb_sweeps_plain(plan, phi, rhs, alpha, beta, 4)
            for var in smoother_variants(rb, plan.shape, phi.element_size()):
                got = gk.gsrb_sweeps(plan, phi, rhs, alpha, beta, 4,
                                     variant=var)
                torch.cuda.synchronize()
                worst["gsrb_sweeps"] = max(worst["gsrb_sweeps"],
                                           smoother_check(
                    "gsrb_sweeps", label, got, want,
                    f"parity gsrb_sweeps      {label:22s} a={alpha} "
                    f"b={beta} iters=4 variant={var or 'plan'} "
                    f"flo={plan.flo} fhi={plan.fhi}"))
            got = gk.helm_residual(plan, phi, rhs, alpha, beta)
            want = gk.helm_residual_plain(plan, phi, rhs, alpha, beta)
            torch.cuda.synchronize()
            worst["helm_residual"] = max(worst["helm_residual"],
                                         smoother_check(
                "helm_residual", label, got, want,
                f"parity helm_residual    {label:22s} a={alpha} b={beta}"))
    diff = lvl.diff_solvers[0]
    for op in (diff.mg.ops if diff is not None and diff._fft is None
               else []):
        plan = op._stencil_plan
        if plan is None:
            plain["diffusive"].append(tuple(op.grid.shape))
            continue
        phi, rhs = (torch.randn(plan.shape, generator=gen,
                                device=lvl.geo.device, dtype=plan.Wn.dtype)
                    for _ in range(2))
        stencil_parity_case(torch, sgk, f"A {tag} diffusive {plan.shape}",
                            plan, phi, rhs, [("plain", {})], worst)
    return plain


def amr_phase(torch, entry, counters, device, smi, label, shape, ratio,
              warm, timed, want_ext=None):
    """A1/A2: the hierarchy placed once and projected, `warm` coarse steps,
    then `timed` timed ones at dt AMR_DT (varied by 1e-6 relative a step,
    as bench.py:325-345), the counts set to 0 just before placement.
    After every coarse step: finite fields and buoyancy bounds on both
    levels, the average-down gate, the sync solve's relres.  Returns
    (the hierarchy, launches of the whole run, a dict of metrics)."""
    from somar_tpu_torch.ops.norms import composite_mapped_sum
    from somar_tpu_torch.solvers.host_reads import read_scalars
    t_setup = time.perf_counter()
    h = amr_hierarchy(entry, shape, ratio, device)
    c = h.couplings[0]
    if want_ext is not None and tuple(c.ext_nx) != want_ext:
        raise PhaseError(f"{label}: patch ext {c.ext_nx}, not {want_ext}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters)
    s0, fine, origin = entry.place_amr(h)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t_setup
    mass = lambda a, b: composite_mapped_sum(h, [a.scalars[0],
                                                 b.scalars[0]], [origin])
    mass0 = mass(s0, fine)
    checks = []
    times = []
    reads = []
    counts0 = None
    for k in range(warm + timed):
        if k == warm:
            counts0 = read_counts(counters)
        r0 = read_scalars.count
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s0, fine = h.advance(s0, fine, origin, AMR_DT * (1.0 + 1e-6 * k))
        torch.cuda.synchronize()
        if k >= warm:
            times.append(time.perf_counter() - t0)
            reads.append(read_scalars.count - r0)
        err, bmax = avgdown_err(torch, h, s0, fine, origin)
        checks.append(torch.stack([
            err, bmax, h.last_sync_info[1],
            torch.stack([s0.scalars[0].min(), fine.scalars[0].min()]).min(),
            torch.stack([s0.scalars[0].max(), fine.scalars[0].max()]).max(),
            torch.stack([torch.isfinite(getattr(s, f)).all().to(err.dtype)
                         for s in (s0, fine) for f in STATE_FIELDS]).min()]))
    launches = read_counts(counters)
    per_step = {n: (launches[n] - counts0[n]) / timed for n in launches}
    peak = torch.cuda.max_memory_allocated()
    checks = torch.stack(checks).tolist()
    mass1 = mass(s0, fine)
    m0, m1 = float(mass0), float(mass1)
    base_cells = math.prod(h.grid0.nx)
    updates = base_cells + c.nt * c.K * math.prod(c.ext_nx)
    ms = ms_of(times)
    relres = [row[2] for row in checks]
    m = dict(ms=ms, cups=updates / (ms * 1e-3), origin=origin.tolist(),
             ext=list(c.ext_nx), per_step=per_step,
             reads=statistics.mean(reads), relres=relres,
             passes=h.last_sync_info[0], peak=peak, mass0=m0, mass1=m1,
             setup_s=t_setup, updates=updates)
    say(f"{label} base {h.grid0.nx} ratio {c.ratio}, nt {c.nt}, K {c.K}: "
        f"origin {m['origin']} ext {m['ext']} (interior {c.interior_nx}); "
        f"{STANDINS}; placement + init_project {t_setup:.2f} s; {warm} "
        f"warm-up + {timed} timed coarse steps at dt {AMR_DT}: "
        f"ms/coarse step={ms:.3f} samples="
        + ",".join(f"{1e3 * t:.3f}" for t in times)
        + f" cell-updates/s={m['cups']:.4e} ({updates} a coarse step) "
        f"host reads/coarse step={m['reads']:.2f} launches/coarse step="
        f"{json.dumps(per_step)} launches in the run={json.dumps(launches)}"
        f" sync solve: {m['passes']} composite passes, final relres per "
        f"step=" + ",".join(f"{r:.3e}" for r in relres)
        + f" (limit {SYNC_RELRES}) peak_mem_bytes={peak} composite "
        f"buoyancy mass {m0:.9e} -> {m1:.9e} (drift {m1 - m0:.3e}, "
        f"{(m1 - m0) / abs(m0):.3e} relative; not gated: refluxing off) "
        f"average-down max|diff|/max|b| per step="
        + ",".join(f"{row[0] / max(row[1], 1e-30):.2e}" for row in checks)
        + f" b in [{min(r[3] for r in checks):.4f}, "
        f"{max(r[4] for r in checks):.4f}] on {smi}")
    if not all(row[5] == 1.0 for row in checks):
        raise PhaseError(f"{label}: non-finite fields")
    if not all(B_BOUNDS[0] < row[3] and row[4] < B_BOUNDS[1]
               for row in checks):
        raise PhaseError(f"{label}: buoyancy left {B_BOUNDS}")
    if not all(row[0] <= AVGDOWN_RTOL * row[1] for row in checks):
        raise PhaseError(f"{label}: the coarse cells under the patch are "
                         "not its average")
    if not all(r < SYNC_RELRES for r in relres):
        raise PhaseError(f"{label}: the sync solve did not reduce its "
                         "composite residual")
    check_launched(launches, ("ppm_predict", "ctu_corr3", "ctu_final",
                              "riemann_fluxdiv", "helm_residual"), label)
    return h, launches, m


def levels_kernel_twins(torch, ck, gk, sgk, levels, worst):
    """K1-K4 at the padded shapes of `levels` ({tag: level}; ADVECT_GROW
    ghosts) and K5-K8 on each level's solver hierarchies
    (solver_level_twins) against their twins; the worst errors folded
    into `worst`.  Returns the plan-less solver levels of each level."""
    from somar_tpu_torch.physics.godunov import ADVECT_GROW
    shapes = tuple(tuple(n + 2 * ADVECT_GROW for n in lvl.geo.grid.shape)
                   for lvl in levels.values())
    device = next(iter(levels.values())).geo.device.type
    for name, err in kernel_parity(torch, ck, device, shapes, ()).items():
        worst[name] = max(worst[name], err)
    return {tag: solver_level_twins(torch, gk, sgk, lvl, tag, worst)
            for tag, lvl in levels.items()}


def level_kernel_twins(torch, ck, gk, sgk, h, worst):
    """levels_kernel_twins on both levels of a hierarchy."""
    return levels_kernel_twins(torch, ck, gk, sgk,
                               {"base": h.level0,
                                "patch": h.couplings[0].level}, worst)


def amr_phases(torch, entry, ck, gk, sgk, counters, device, smi, worst):
    """A0, A1, A2, each printing its seconds; after A1 and A2, K1-K8 at
    their levels' shapes against their twins.  Returns {phase: (launches,
    metrics)}."""
    out = {}
    t0 = time.perf_counter()
    amr_card_vs_cpu(torch, entry, counters, device)
    say(f"phase A0: {time.perf_counter() - t0:.1f} s")
    for key, (shape, ratio), warm, timed, ext in (
            ("a1", AMR_A1, 2, 10, AMR_A1_EXT),
            ("a2", AMR_A2, 1, 5, None)):
        t0 = time.perf_counter()
        h, launches, m = amr_phase(torch, entry, counters, device, smi,
                                   key.upper(), shape, ratio, warm, timed,
                                   want_ext=ext)
        plain = level_kernel_twins(torch, ck, gk, sgk, h, worst)
        say(f"{key.upper()} solver levels without a kernel plan (plain "
            f"path): {json.dumps(plain)}")
        del h
        out[key] = (launches, m)
        say(f"phase {key.upper()}: {time.perf_counter() - t0:.1f} s")
    return out


# --------------------------------------------------------------------------
# phases 23-26: AMR decks through RunDriver (regrid, K > 1, subcycling, IO)
# --------------------------------------------------------------------------
#: R0's first deck: tests/test_driver_io.py:74-93 (AMR_CFG, 2D 48x16, ratio
#: (4,1), regrids every 2 steps) with amr.fixed_dt unset, so that
#: level_dts and the dynamic-subcycling factors set each dt; amr.max_dt
#: caps the first dt (init_dt_multiplier x max_dt), which the viscous
#: limit at rest would otherwise put at 3.1 (ROADMAP C.10)
R0_DECK = """
amr.nx = 48 16
amr.length = 15.0 2.0
amr.nx_offset = -24 0
ibc.problem = 1
amr.gravityMethod = 1
amr.viscosity = 0.0001
amr.scal_diffusion_coeffs = 0.0001
amr.maxlevel = 1
amr.refratio_lev0 = 4 1
amr.regrid_intervals = 2 2
amr.buoyancy_tag_tol = 0.2
amr.tags_grow = 1
amr.max_dt = 0.05
amr.maxsteps = 6
amr.final = 10.0
AMRMG.eps = 1e-5
AMRMG.imax = 12
plot.plot_interval = 3
plot.checkpoint_interval = 3
amr.verbosity = 0
"""
#: R0's second deck: R0_DECK on square cells (dx = dz = 0.3125) with
#: viscosity 0.1 and init_dt_multiplier 0.4, no amr.max_dt: at rest each
#: level's dt is its viscous limit, the refined level's 1/16 of the
#: base's, so the first coarse step (0.4 x the base's) overshoots the
#: refined level's 4 substeps and takes the dynamic-subcycling factor 2;
#: later steps are held to 4 x the refined level's dt (factor 1)
R0_SUBCYCLED = R0_DECK.replace("amr.length = 15.0 2.0",
                               "amr.length = 15.0 5.0").replace(
    "amr.viscosity = 0.0001", "amr.viscosity = 0.1").replace(
    "amr.max_dt = 0.05", "amr.init_dt_multiplier = 0.4")
#: R0's third deck: the two-front field of tests/test_amr.py:504-531 (2D
#: 96x12, buoyancy_tag_tol 0.12, tags_grow 1; its patch_frac 0.2 footprint
#: as amr.max_grid_size 72), amr.max_patches unset: the placement doubles
#: K from 1 to 2
R0_TWO_FRONTS = R0_DECK.replace("amr.nx = 48 16", "amr.nx = 96 12").replace(
    "amr.nx_offset = -24 0", "amr.nx_offset = -48 0").replace(
    "amr.buoyancy_tag_tol = 0.2", "amr.buoyancy_tag_tol = 0.12") \
    + "amr.max_grid_size = 72\n"
#: the two fronts: vertically (and in 3D spanwise) uniform buoyancy lumps
#: of half-width 0.8 at these x
FRONTS = (-4.0, 4.0)
#: R1: main path 1's lengths and physics (D1_DECK) on a 128^3 base with
#: one refined level at ratio (4,1,1) (the effective 512x128x128 of A2),
#: the AMR cell's stand-in tags and multigrid parameters, regrids every 5
#: steps, a CFL-limited dt, files every 10 steps, 20 coarse steps (40
#: until the mapped phases came, which the script's time limit needs)
R1_DECK = D1_DECK.replace("amr.nx = 512 128 128", "amr.nx = 128 128 128") \
    .replace("amr.nx_offset = -256 0 0", "amr.nx_offset = -64 0 0") + """
amr.maxlevel = 1
amr.refratio_lev0 = 4 1 1
amr.regrid_intervals = 5
amr.buoyancy_tag_tol = 0.2
amr.tags_grow = 1
AMRMG.eps = 1e-5
AMRMG.imax = 12
"""
#: R2: R1's base with the two fronts extruded in y; amr.max_grid_size 120
#: (ext 128 fine cells in x) so that two patches fit the 128-cell base
#: apart (R1's footprint, 94 base cells wide, cannot hold two); 6 coarse
#: steps, one regrid and its files at step 5
R2_DECK = R1_DECK.replace("amr.maxsteps = 20", "amr.maxsteps = 6") \
    .replace("amr.regrid_intervals = 5", "amr.regrid_intervals = 5\n"
             "amr.max_grid_size = 120") \
    .replace("plot.plot_interval = 10", "plot.plot_interval = 5") \
    .replace("plot.checkpoint_interval = 10", "plot.checkpoint_interval = 5")
#: the kernels of a 2D AMR deck's path (K5 runs on no CF level, ROADMAP
#: C.18): the advection on both levels, the composite residuals and the
#: patches' diffusive solves; a 3D deck adds ctu_corr3
AMR_PATH_2D = ("ppm_predict", "ctu_final", "riemann_fluxdiv",
               "helm_residual", "stencil_gsrb_sweeps",
               "stencil_helm_residual")
#: card against CPU (R0): fields within this fraction of max|field|, the
#: potentials gauge-free (multigrid stops at a tolerance); a resumed run
#: against the uninterrupted one: DRIVER_RTOL
R0_RTOL = MG_STEP_RTOL


def with_fronts(torch, drv, centres=FRONTS):
    """Replace the RunDriver's initial buoyancy by uniform lumps at x in
    `centres` (the two-front field)."""
    import numpy as np
    lvl = drv.level
    plain = lvl.initial_state

    def fronts():
        s = plain()
        x = np.asarray(lvl.geo.phys_coords_cc()[0])
        b = np.zeros(x.shape, bool)
        for c in centres:
            b |= np.abs(x - c) < 0.8
        scal = s.scalars.clone()
        scal[0] = torch.as_tensor(b, dtype=scal.dtype,
                                  device=scal.device).expand_as(scal[0])
        return dataclasses.replace(s, scalars=scal)

    lvl.initial_state = fronts


def with_lambda_bump(torch, drv):
    """Seed the RunDriver's initial lambda with the bump of
    tests/test_amr.py:779: 1 + 0.004 exp(-(x^2 + z^2) / 0.1) over the
    cells' indices mapped onto [-1, 1]."""
    lvl = drv.level
    plain = lvl.initial_state

    def bumped():
        s = plain()
        nz, nx = s.lam.shape[0], s.lam.shape[-1]
        kw = dict(dtype=s.lam.dtype, device=s.lam.device)
        xs = torch.linspace(-1, 1, nx, **kw)
        zs = torch.linspace(-1, 1, nz, **kw)
        bump = torch.exp(-(xs[None, :] ** 2 + zs[:, None] ** 2) / 0.1)
        return dataclasses.replace(s, lam=(1.0 + 0.004 * bump).expand_as(
            s.lam).clone())

    lvl.initial_state = bumped


def with_vd_cold_start(torch, drv):
    """with_lambda_bump, and every VD pass started from e_lambda = 0 on
    every level instead of the last pass's potentials: a fault that F0's
    e_lambda limit must catch."""
    with_lambda_bump(torch, drv)
    h = drv.hierarchy
    plain = h._vd_correction
    zero = lambda s: dataclasses.replace(
        s, e_lambda=torch.zeros_like(s.e_lambda))

    def cold(s0, fine_states, args, dt):
        fine_states[:] = [zero(f) for f in fine_states]
        return plain(zero(s0), fine_states, args, dt)

    h._vd_correction = cold


def patch_avgdown_err(torch, h, s0, fines, origins, weights,
                      parent_sels=None):
    """max over every refined level's active patches, over b and u, of
    |parent under the patch interior - restricted patch interior| (a 0-d
    tensor; a mapped slot's restriction weighted by its own J); each patch
    against its own parent patch."""
    from somar_tpu_torch.amr.transfer import extract_patch, restrict_average
    errs = []
    for lev, c in enumerate(h.couplings):
        parents = ([s0] if lev == 0
                   else h.couplings[lev - 1].unstack(fines[lev - 1]))
        for k, (p, o, w, q) in enumerate(zip(c.unstack(fines[lev]),
                                             c.patch_origins(origins[lev]),
                                             c.patch_weights(weights[lev]),
                                             h._psel(lev, parent_sels))):
            if w is not None and w == 0.0:
                continue
            par = parents[q]
            org_c = c.covered_origin_c(o)
            J = c.slot_J(k)
            Jb = None if J is None else extract_patch(J, c.int_start,
                                                      c.int_shape)
            avg = lambda a: restrict_average(a, c.ext_grid, c.ratio)
            for coarse, f in ((par.scalars[0], p.scalars[0]),
                              *zip(par.vel, p.vel)):
                blk = extract_patch(f, c.int_start, c.int_shape)
                want = avg(blk) if Jb is None else avg(blk * Jb) / avg(Jb)
                errs.append((extract_patch(coarse, org_c, want.shape)
                             - want).abs().max())
    return torch.stack(errs).max()


def amr_deck_run(torch, deck, device, counters, init=None, extra=None):
    """A deck through RunDriver with the counts set to 0 just before its
    run; init(torch, drv), where given, adjusts the RunDriver before it
    runs (with_fronts, with_lambda_bump).  Every coarse step (each call
    of the hierarchy's advance with its subcycling factors) records, on the device, the average-down
    difference, max|b|, the sync solve's relres, min and max b on both
    levels and whether every field is finite, and on the host its
    launches and host reads.  extra(h, s0, fine, origins) -> a list of
    0-d tensors is recorded on the first step's input and after every
    step (run["extra"]: the first row, then one per step).  Returns a
    dict."""
    import numpy as np
    from somar_tpu_torch.driver import RunDriver, level_log
    from somar_tpu_torch.solvers.host_reads import read_scalars
    from somar_tpu_torch.utils.timers import timer
    timer.reset()
    drv = RunDriver(context(deck), out_dir=os.getcwd(), device=device)
    if init is not None:
        init(torch, drv)
    h = drv.hierarchy
    plain_advance = h.advance
    rows, launches, reads, levels, placed, extras = [], [], [], {}, [], []

    def advance(*a, **kw):
        if "nt_mults" not in kw:                 # initialize_pressure
            return plain_advance(*a, **kw)
        if not placed:
            placed.append(level_log(h))
        if extra is not None and not extras:
            extras.append(torch.stack(extra(h, a[0], a[1], a[2])))
        n0, r0 = read_counts(counters), read_scalars.count
        s0, fine = plain_advance(*a, **kw)
        if extra is not None:
            extras.append(torch.stack(extra(h, s0, fine, a[2])))
        n1, r1 = read_counts(counters), read_scalars.count
        launches.append({k: n1[k] - n0[k] for k in n1})
        reads.append(r1 - r0)
        for lev, c in enumerate(h.couplings):
            levels.setdefault((lev + 1, tuple(c.ext_nx)), c)
        by_level = [[s0]] + [c.unstack(f) for c, f in zip(h.couplings, fine)]
        parts = [p for ps in by_level for p in ps]
        rows.append(torch.stack([
            patch_avgdown_err(torch, h, s0, fine, a[2], kw["weights"],
                              kw.get("parent_sels")),
            s0.scalars[0].abs().max(), h.last_sync_info[1],
            torch.stack([p.scalars[0].min() for p in parts]).min(),
            torch.stack([p.scalars[0].max() for p in parts]).max(),
            torch.stack([torch.isfinite(getattr(p, f)).all().to(
                s0.vel.dtype) for p in parts for f in STATE_FIELDS]).min()]
            # then min and max b of each level, the base first
            + [x for ps in by_level for x in (
                torch.stack([p.scalars[0].min() for p in ps]).min(),
                torch.stack([p.scalars[0].max() for p in ps]).max())]))
        return s0, fine

    h.advance = advance
    marks = []
    drv.scheduler.schedule(lambda *_: marks.append(read_scalars.count),
                           step_interval=1)
    if device != "cpu":
        # the last run's hierarchy (reference cycles) freed first, so that
        # the peak is this run's
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    reset_counts(counters)
    t0 = time.perf_counter()
    state, steps = drv.run(verbose=False)
    if device != "cpu":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    total = read_counts(counters)
    return dict(drv=drv, h=h, state=state, fine=drv.fine_state[0],
                fines=drv.fine_state, steps=steps, seconds=seconds, launches=total,
                per_step={k: statistics.mean(l[k] for l in launches)
                          for k in total},
                reads_advance=statistics.mean(reads),
                reads_step=((marks[-1] - marks[0]) / (len(marks) - 1)
                            if len(marks) > 1 else float("nan")),
                rows=torch.stack(rows).tolist(), levels=levels,
                extra=torch.stack(extras).tolist() if extras else None,
                placed=placed[0],
                peak=(torch.cuda.max_memory_allocated() if device != "cpu"
                      else 0),
                ckpt=io_seconds("write_checkpoint"),
                plot=io_seconds("write_plotfile"))


def regrid_log(run):
    """The placement and every regrid: (step, K, origins, weights) of the
    first refined level."""
    return [(step, x["K"], x["origins"], x["weights"])
            for step, x in [(0, run["placed"][0])] + [
                (r["step"], r["levels"][0]) for r in run["drv"].regrids]]


def nested_log(run):
    """The placement and every regrid: (step, per refined level (K,
    origins, weights, parent_sel))."""
    pick = lambda info: [(x["K"], x["origins"], x["weights"],
                          x["parent_sel"]) for x in info]
    return [(0, pick(run["placed"]))] + [
        (r["step"], pick(r["levels"])) for r in run["drv"].regrids]


def amr_pair_diffs(a, b, fields=None, gauge=None):
    """{level.field: max|a - b| / max|b|} over the base and every refined
    level of two runs ("patches" the first, "level<l>" the deeper), of
    `fields` (AMR_FIELDS), those in `gauge` (GAUGE_FIELDS, the
    potentials) gauge-free (per patch)."""
    fields = AMR_FIELDS if fields is None else fields
    gauge = GAUGE_FIELDS if gauge is None else gauge
    rel = {}
    pairs = [("base", a["state"], b["state"], 1)] + [
        ("patches" if lev == 0 else f"level{lev + 1}", x, y, c.K)
        for lev, (x, y, c) in enumerate(zip(a["fines"], b["fines"],
                                            a["h"].couplings))]
    for lvl, x, y, K in pairs:
        for f in fields:
            u, v = getattr(x, f), getattr(y, f).to(getattr(x, f).device)
            if f in gauge:
                k = u.shape[0] if K > 1 else None
                rel[f"{lvl}.{f}"] = max(gauge_free_diff(u[i], v[i])
                                        for i in range(k)) if k else \
                    gauge_free_diff(u, v)
            else:
                rel[f"{lvl}.{f}"] = float((u - v).abs().max()) / max(
                    float(v.abs().max()), 1e-30)
    return rel


def level_b_ranges(run):
    """Per level (the base first), [min b, max b] over the run's coarse
    steps."""
    rows = run["rows"]
    return [[min(r[6 + 2 * lev] for r in rows),
             max(r[7 + 2 * lev] for r in rows)]
            for lev in range((len(rows[0]) - 6) // 2)]


def amr_gates(run, label, unbounded=()):
    """The per-coarse-step gates of an AMR deck run, and zero dropped tags
    at the placement and after every regrid.  The buoyancy bound holds on
    every level but those in `unbounded` (levels where the JAX package's
    numerics leave it too, ROADMAP C.25), whose range is printed."""
    rows = run["rows"]
    if not all(r[5] == 1.0 for r in rows):
        raise PhaseError(f"{label}: non-finite fields")
    ranges = level_b_ranges(run)
    if unbounded:
        say(f"{label}: b range per level over the run "
            f"{[[round(x, 4) for x in r] for r in ranges]}; levels "
            f"{list(unbounded)} are held to finiteness only (ROADMAP C.25)")
    if not all(B_BOUNDS[0] < lo and hi < B_BOUNDS[1]
               for lev, (lo, hi) in enumerate(ranges)
               if lev not in unbounded):
        raise PhaseError(f"{label}: buoyancy left {B_BOUNDS}")
    if not all(r[0] <= AVGDOWN_RTOL * r[1] for r in rows):
        raise PhaseError(f"{label}: the base cells under a patch are not "
                         "its average")
    if not all(r[2] < SYNC_RELRES for r in rows):
        raise PhaseError(f"{label}: the sync solve did not reduce its "
                         "composite residual")
    drops = [[x["tag_coverage"] for x in info] for info in
             [run["placed"]] + [r["levels"]
                                          for r in run["drv"].regrids]]
    if any(d[0] != 0 for info in drops for d in info):
        raise PhaseError(f"{label}: tagged cells dropped {drops}")


def amr_deck_card_vs_cpu(torch, device, counters, files):
    """R0: each small deck through RunDriver on the CPU and on the card:
    the same K, origins and weights at the placement and after every
    regrid, the same dynamic-subcycling factors, every field of both
    levels within R0_RTOL; then on the card the run resumed from its
    mid-run checkpoint, equal to the uninterrupted one (DRIVER_RTOL).
    Returns the card's launches of both decks."""
    total = {}
    for label, deck, init in (("AMR_CFG", R0_DECK, None),
                              ("subcycled", R0_SUBCYCLED, None),
                              ("two fronts", R0_TWO_FRONTS, with_fronts)):
        runs = {}
        with tempfile.TemporaryDirectory(prefix="chip_smoke_r0_") as out:
            cwd = os.getcwd()
            os.chdir(out)
            try:
                for dev in ("cpu", device):
                    runs[dev] = amr_deck_run(torch, deck, dev, counters,
                                             init)
                card = runs[device]
                resumed = amr_deck_run(
                    torch, deck + "amr.restart_file = chkpt_000003.hdf5\n",
                    device, counters, init)
            finally:
                os.chdir(cwd)
        if files is not None:
            files.trees.clear()
        for k, v in card["launches"].items():
            total[k] = total.get(k, 0) + v
        rel = amr_pair_diffs(card, runs["cpu"])
        err = max(rel.values())
        res = max(max(field_diffs(x, y, AMR_FIELDS).values())
                  for x, y in zip((resumed["state"],) + resumed["fines"],
                                  (card["state"],) + card["fines"]))
        log, cpu_log = regrid_log(card), regrid_log(runs["cpu"])
        c = card["h"].couplings[0]
        say(f"R0 {label} {card['h'].grid0.nx} ratio {c.ratio}, "
            f"{card['steps']} coarse steps on {device} and on the CPU: "
            f"(step, K, origins, weights) at placement and every regrid "
            f"{log} (CPU {'the same' if log == cpu_log else cpu_log}); "
            f"dts {['%.6g' % d for d in card['drv'].dts]}; nt_mults "
            f"{card['drv'].nt_mults} (CPU {'the same' if card['drv'].nt_mults == runs['cpu']['drv'].nt_mults else runs['cpu']['drv'].nt_mults}); "
            "card against CPU max|diff|/max|field| "
            + " ".join(f"{k}={v:.3e}" for k, v in rel.items())
            + f" (limit {R0_RTOL}); resumed from chkpt_000003 against the "
            f"uninterrupted run {res:.3e} (limit {DRIVER_RTOL}, K "
            f"{resumed['h'].couplings[0].K}); sync relres per step "
            + ",".join(f"{r[2]:.3e}" for r in card["rows"])
            + f"; launches {json.dumps(card['launches'])}")
        amr_gates(card, f"R0 {label}")
        if log != cpu_log or card["drv"].nt_mults != runs["cpu"][
                "drv"].nt_mults:
            raise PhaseError(f"R0 {label}: the card placed or regridded "
                             "the patches otherwise than the CPU")
        if not err <= R0_RTOL:
            raise PhaseError(f"R0 {label}: the card's run differs from the "
                             "CPU's")
        if not (res <= DRIVER_RTOL and resumed["steps"] == card["steps"]
                and regrid_log(resumed)[-1][1:] == log[-1][1:]):
            raise PhaseError(f"R0 {label}: the resumed run differs")
        if init and not (c.K == 2 and all(w == 1.0 for w in c.weights)):
            raise PhaseError(f"R0 {label}: K = {c.K} weights {c.weights}, "
                             "not two active patches")
        if deck is R0_SUBCYCLED and card["drv"].nt_mults[0] != (2,):
            raise PhaseError(f"R0 {label}: the first step's subcycling "
                             f"factors {card['drv'].nt_mults[0]}, not (2,)")
        check_launched(card["launches"], AMR_PATH_2D, f"R0 {label}")
    return total


def amr_deck_phase(torch, device, counters, smi, label, deck, init=None,
                   want_k=None, unbounded=(),
                   path=("ctu_corr3",) + AMR_PATH_2D, standins=STANDINS,
                   extra=None):
    """R1 / R2: a full-width AMR deck through RunDriver on the card with
    the counts set to 0 just before; prints ms per coarse step (plain and
    regrid steps apart), seconds per regrid, K, origins and tag coverage
    at placement and after each regrid, launches and host reads per
    coarse step, file seconds and peak memory; applies amr_gates and
    requires every kernel of `path` launched.  Returns the run."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_r_") as out:
        cwd = os.getcwd()
        os.chdir(out)
        try:
            run = amr_deck_run(torch, deck, device, counters, init, extra)
        finally:
            os.chdir(cwd)
    drv, h = run["drv"], run["h"]
    c = h.couplings[0]
    regrid_steps = {r["step"] for r in drv.regrids}
    plain = [t for i, t in enumerate(drv.step_seconds, 1)
             if i not in regrid_steps]
    regrid = [t for i, t in enumerate(drv.step_seconds, 1)
              if i in regrid_steps]
    rows = run["rows"]
    say(f"{label} base {h.grid0.nx} ratio {c.ratio}, nt {c.nt}: "
        f"{run['steps']} coarse steps in {run['seconds']:.2f} s (set-up and "
        f"files included); {standins}; ms per coarse step: plain steps "
        f"median {ms_of(plain):.3f} samples "
        + ",".join(f"{1e3 * t:.3f}" for t in plain)
        + (f"; regrid steps median {ms_of(regrid):.3f} samples "
           + ",".join(f"{1e3 * t:.3f}" for t in regrid) if regrid else "")
        + "; seconds per regrid "
        + ",".join(f"{r['seconds']:.3f}" for r in drv.regrids)
        + f"; placement K {run['placed'][0]['K']} origins "
        f"{run['placed'][0]['origins']} weights "
        f"{run['placed'][0]['weights']} tag coverage (dropped, tagged) "
        f"{run['placed'][0]['tag_coverage']}; after each regrid (step, K, "
        "origins, weights, ext, coverage) "
        + "; ".join(f"({r['step']}, {x['K']}, {x['origins']}, "
                    f"{x['weights']}, {x['ext']}, {x['tag_coverage']})"
                    for r in drv.regrids for x in r["levels"][:1])
        + f"; dts {['%.5g' % d for d in drv.dts]}; nt_mults "
        f"{sorted(set(drv.nt_mults))}; launches per coarse step "
        f"{json.dumps(run['per_step'])}; launches in the run "
        f"{json.dumps(run['launches'])}; host reads per coarse step "
        f"{run['reads_advance']:.2f} in the advance, {run['reads_step']:.2f} "
        f"between step ends; cell-updates/s "
        f"{drv.cell_updates / drv.elapsed:.4e} (files included); checkpoint"
        f" write {run['ckpt'][0]} s x{run['ckpt'][1]}, plot file write "
        f"{run['plot'][0]} s x{run['plot'][1]}; peak_mem_bytes "
        f"{run['peak']}; sync relres per step "
        + ",".join(f"{r[2]:.3e}" for r in rows)
        + f" (limit {SYNC_RELRES}); average-down max|diff|/max|b| per step "
        + ",".join(f"{r[0] / max(r[1], 1e-30):.2e}" for r in rows)
        + f"; b in [{min(r[3] for r in rows):.4f}, "
        f"{max(r[4] for r in rows):.4f}] on {smi}")
    if len(h.couplings) > 1:
        lv = lambda info: "; ".join(
            f"level {i + 1}: K {x['K']} ext {x['ext']} origins "
            f"{x['origins']} weights {x['weights']} parent_sel "
            f"{x['parent_sel']} tag coverage (dropped, tagged) "
            f"{x['tag_coverage']}" for i, x in enumerate(info))
        say(f"{label} levels at placement: {lv(run['placed'])}")
        for r in drv.regrids:
            say(f"{label} levels after the regrid of step {r['step']} "
                f"(from_level {r['from_level']}, {r['seconds']:.3f} s): "
                f"{lv(r['levels'])}")
    amr_gates(run, label, unbounded)
    if want_k is not None and not all(
            r[1] == want_k and (r[3] is None or all(w == 1.0 for w in r[3]))
            for r in regrid_log(run)):
        raise PhaseError(f"{label}: not {want_k} active patches at every "
                         f"regrid: {regrid_log(run)}")
    check_launched(run["launches"], path, label)
    return run


def amr_deck_phases(torch, ck, gk, sgk, counters, device, smi, worst,
                    files):
    """R0, R1, R2 and the command line on an AMR deck, each printing its
    seconds; after R1 and R2, K1-K8 against their twins at every level
    shape the run reached.  Returns {phase: launches, per_step}."""
    out = {}
    t0 = time.perf_counter()
    out["r0"] = (amr_deck_card_vs_cpu(torch, device, counters, files), {})
    say(f"phase R0: {time.perf_counter() - t0:.1f} s")
    for key, deck, init, want_k in (("r1", R1_DECK, None, None),
                                    ("r2", R2_DECK, with_fronts, 2)):
        t0 = time.perf_counter()
        run = amr_deck_phase(torch, device, counters, smi, key.upper(), deck,
                             init, want_k)
        if files is not None:
            files.trees.clear()
        levels = {"base": run["h"].level0}
        levels.update({f"patch {ext}": c.level
                       for (_, ext), c in run["levels"].items()})
        plain = levels_kernel_twins(torch, ck, gk, sgk, levels, worst)
        say(f"{key.upper()} kernels against their twins at the padded "
            f"shapes of {list(levels)}; solver levels without a kernel "
            f"plan (plain path): {json.dumps(plain)}")
        out[key] = (run["launches"], run["per_step"])
        del run
        say(f"phase {key.upper()}: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    cli_phase(device, files, deck=R0_DECK, label="AMR deck")
    say(f"phase R-CLI: {time.perf_counter() - t0:.1f} s")
    return out


# --------------------------------------------------------------------------
# phases 27-29: nested refined levels (amr.maxlevel = 2)
# --------------------------------------------------------------------------
#: N0's first deck: R0_DECK with a second refined level at the DEM_2D-style
#: ratio (4,2) (tests/test_amr.py:167-169), both levels regridded every 2
#: steps: 16 level-2 substeps per coarse step
N0_DECK = R0_DECK.replace("amr.maxlevel = 1", "amr.maxlevel = 2").replace(
    "amr.refratio_lev0 = 4 1",
    "amr.refratio_lev0 = 4 1\namr.refratio_lev1 = 4 2")
#: N0's second deck: R0_TWO_FRONTS with two refined levels at ratio (2,1)
#: and two patches pinned at each: two level-1 patches, each the parent
#: of a level-2 patch (tests/test_amr.py:1014)
N0_TWO_CHAINS = R0_TWO_FRONTS.replace(
    "amr.maxlevel = 1", "amr.maxlevel = 2").replace(
    "amr.refratio_lev0 = 4 1",
    "amr.refratio_lev0 = 2 1\namr.refratio_lev1 = 2 1") \
    + "amr.max_patches = 2 2\n"
#: N1: R1's deck with a second refined level at ratio (4,1,2) (x by 4, z
#: by 2, the DEM_2D-style second ratio in 3D; nt 4 at both levels, so 16
#: level-2 substeps per coarse step), both levels regridded every 5
#: steps, 6 coarse steps (10 until slice 11c's phases came, which the
#: script's time limit needs), files at step 5; amr.grid_buffer_size at
#: its default 1
N1_DECK = R1_DECK.replace("amr.maxlevel = 1", "amr.maxlevel = 2").replace(
    "amr.refratio_lev0 = 4 1 1",
    "amr.refratio_lev0 = 4 1 1\namr.refratio_lev1 = 4 1 2").replace(
    "amr.regrid_intervals = 5", "amr.regrid_intervals = 5 5").replace(
    "amr.maxsteps = 20", "amr.maxsteps = 6").replace(
    "plot.plot_interval = 10", "plot.plot_interval = 5").replace(
    "plot.checkpoint_interval = 10", "plot.checkpoint_interval = 5")
#: the levels of N1 held to finiteness, not to B_BOUNDS: at R1's
#: CFL-limited dts the JAX package's nested level grows a grid-scale
#: overshoot of b at the lock's interface (ROADMAP C.25), so N1 prints
#: each level's b range and bounds the base and level 1 only
N1_UNBOUNDED = (2,)
#: the level-1 patch of R1 and N1 (A2's ext) and N1's second ratio, for
#: the level-2 footprint reckoned before the run
N1_LEVEL1_EXT, N1_RATIO2 = (384, 128, 128), (4, 1, 2)


def nested_card_vs_cpu(torch, device, counters, files):
    """N0: each three-level 2D deck through RunDriver on the CPU and on the
    card: the same K, origins, weights and parent selections on every
    level at the placement and after every regrid, the same
    dynamic-subcycling factors, every field of every level within
    R0_RTOL (the potentials gauge-free); both level-1 patches active with
    an active child each in N0_TWO_CHAINS; then on the card the run
    resumed from its mid-run checkpoint, equal to the uninterrupted one
    (DRIVER_RTOL).  Returns the card's launches of both decks."""
    total = {}
    for label, deck, init in (("three levels", N0_DECK, None),
                              ("two chains", N0_TWO_CHAINS, with_fronts)):
        runs = {}
        with tempfile.TemporaryDirectory(prefix="chip_smoke_n0_") as out:
            cwd = os.getcwd()
            os.chdir(out)
            try:
                t0 = time.perf_counter()
                runs["cpu"] = amr_deck_run(torch, deck, "cpu", counters,
                                           init)
                t_cpu = time.perf_counter() - t0
                card = runs[device] = amr_deck_run(torch, deck, device,
                                                   counters, init)
                resumed = amr_deck_run(
                    torch, deck + "amr.restart_file = chkpt_000003.hdf5\n",
                    device, counters, init)
            finally:
                os.chdir(cwd)
        if files is not None:
            files.trees.clear()
        for k, v in card["launches"].items():
            total[k] = total.get(k, 0) + v
        rel = amr_pair_diffs(card, runs["cpu"])
        err = max(rel.values())
        res = max(max(field_diffs(x, y, AMR_FIELDS).values())
                  for x, y in zip((resumed["state"],) + resumed["fines"],
                                  (card["state"],) + card["fines"]))
        log, cpu_log = nested_log(card), nested_log(runs["cpu"])
        h = card["h"]
        say(f"N0 {label} {h.grid0.nx} ratios {h.ratios}, {card['steps']} "
            f"coarse steps on {device} ({card['seconds']:.2f} s) and on the "
            f"CPU ({t_cpu:.2f} s): (step, per level (K, origins, weights, "
            f"parent_sel)) at placement and every regrid {log} (CPU "
            f"{'the same' if log == cpu_log else cpu_log}); regrids from "
            f"levels {[r['from_level'] for r in card['drv'].regrids]}; "
            f"exts {[list(c.ext_nx) for c in h.couplings]}; dts "
            f"{['%.6g' % d for d in card['drv'].dts]}; nt_mults "
            f"{card['drv'].nt_mults} (CPU {'the same' if card['drv'].nt_mults == runs['cpu']['drv'].nt_mults else runs['cpu']['drv'].nt_mults}); "
            "card against CPU max|diff|/max|field| "
            + " ".join(f"{k}={v:.3e}" for k, v in rel.items())
            + f" (limit {R0_RTOL}); resumed from chkpt_000003 against the "
            f"uninterrupted run {res:.3e} (limit {DRIVER_RTOL}); sync relres "
            "per step " + ",".join(f"{r[2]:.3e}" for r in card["rows"])
            + "; average-down max|diff|/max|b| per step "
            + ",".join(f"{r[0] / max(r[1], 1e-30):.2e}" for r in card["rows"])
            + f"; launches {json.dumps(card['launches'])}")
        amr_gates(card, f"N0 {label}")
        if log != cpu_log or card["drv"].nt_mults != runs["cpu"][
                "drv"].nt_mults:
            raise PhaseError(f"N0 {label}: the card placed or regridded "
                             "the patches otherwise than the CPU")
        if not err <= R0_RTOL:
            raise PhaseError(f"N0 {label}: the card's run differs from the "
                             "CPU's")
        if not (res <= DRIVER_RTOL and resumed["steps"] == card["steps"]
                and nested_log(resumed)[-1][1:] == log[-1][1:]):
            raise PhaseError(f"N0 {label}: the resumed run differs")
        if len(h.couplings) != 2:
            raise PhaseError(f"N0 {label}: {len(h.couplings)} refined "
                             "levels, not 2")
        if init:
            for step, levels in log:
                (k1, _, w1, _), (k2, _, w2, ps2) = levels
                chains = sorted({p for p, w in zip(ps2, w2) if w > 0})
                if not (k1 == 2 and w1 == [1.0, 1.0] and chains == [0, 1]):
                    raise PhaseError(
                        f"N0 {label}: at step {step} level 1 has K {k1} "
                        f"weights {w1}, level 2's active patches nest in "
                        f"{chains}: not two chains")
        check_launched(card["launches"], AMR_PATH_2D, f"N0 {label}")
    return total


def nested_phases(torch, ck, gk, sgk, counters, device, smi, worst, files):
    """N0, N1 and N2, each printing its seconds: the three-level decks
    card against CPU, R1's deck at three levels at full width (the
    level-2 footprint reckoned first), then K1-K8 against their twins at
    the level-2 shapes N1 reached and on their solver hierarchies.
    Returns {phase: (launches, launches per coarse step)}."""
    import math
    from somar_tpu_torch.amr.hierarchy import patch_footprint
    out = {}
    t0 = time.perf_counter()
    out["n0"] = (nested_card_vs_cpu(torch, device, counters, files), {})
    say(f"phase N0: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    interior, ext = patch_footprint(N1_LEVEL1_EXT, (False, True, False),
                                    N1_RATIO2)
    say(f"N1 level-2 footprint reckoned by patch_footprint over the level-1 "
        f"patch ext {N1_LEVEL1_EXT} at ratio {N1_RATIO2}, before the "
        f"parent's halo and the nest buffer: interior {interior} ext {ext} "
        f"= {math.prod(ext)} cells; with the parent's halo: "
        f"{patch_footprint(N1_LEVEL1_EXT, (False, True, False), N1_RATIO2, parent_halo=(4, 0, 0))}")
    run = amr_deck_phase(torch, device, counters, smi, "N1", N1_DECK,
                         unbounded=N1_UNBOUNDED)
    if files is not None:
        files.trees.clear()
    h = run["h"]
    say(f"N1 built footprints (ext per level, cells): "
        + "; ".join(f"level {lev + 1} {c.ext_nx} = {math.prod(c.ext_nx)} "
                    f"x K {c.K}" for lev, c in enumerate(h.couplings)))
    if len(h.couplings) != 2:
        raise PhaseError(f"N1: {len(h.couplings)} refined levels, not 2")
    out["n1"] = (run["launches"], run["per_step"])
    say(f"phase N1: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    levels = {f"level {lev} {ext}": c.level
              for (lev, ext), c in run["levels"].items() if lev >= 2}
    del run, h
    plain = levels_kernel_twins(torch, ck, gk, sgk, levels, worst)
    say(f"N2 kernels against their twins at the padded shapes of "
        f"{list(levels)}; solver levels without a kernel plan (plain "
        f"path): {json.dumps(plain)}")
    say(f"phase N2: {time.perf_counter() - t0:.1f} s")
    return out


# --------------------------------------------------------------------------
# phases 30-33: mapped refined levels (each slot on its own metric)
# --------------------------------------------------------------------------
#: the LockExchange_Ledge2D stand-ins (its input file is not in the repo):
#: bed elevations Hl 1, Hr 0 under a top at H = 2, a 1-deep shelf dropping
#: to the 2-deep basin across the lock (x in [-1, 1])
LEDGE_KEYS = """
geometry.coordMap = 5
geometry.ledgeMapHl = 1
geometry.ledgeMapHr = 0
geometry.ledgeMapXl = -1
geometry.ledgeMapXr = 1
plot.writeGeometry = 1
"""
LEDGE_STANDINS = ("stand-ins until inputs.LockExchange_Ledge2D.machine is "
                  "in the repository: the Ledge map with bed elevations "
                  "Hl 1, Hr 0 under H = 2 across x in [-1, 1], D1's "
                  "physics (15 x 2 [x 2], nu = kappa = 1e-4, CN, explicit "
                  "gravity), buoyancy_tag_tol 0.2, tags_grow 1, "
                  "MGParams(eps=1e-5, imax=12)")
#: M0's first deck: tests/test_amr.py:236-249's Ledge hierarchy (48x16 on
#: 8 x 1, LedgeMap depths 0.5 -> 1 over x in [-1, 1], ratio (2,2); bed
#: elevations 0.5 and 0 under H = 1) as a deck, R0's other keys (regrids
#: every 2 steps, 6 coarse steps)
M0_LEDGE = R0_DECK.replace("amr.length = 15.0 2.0", "amr.length = 8.0 1.0") \
    .replace("amr.refratio_lev0 = 4 1", "amr.refratio_lev0 = 2 2") \
    + LEDGE_KEYS.replace("ledgeMapHl = 1", "ledgeMapHl = 0.5")
#: M0's second deck: the same at amr.maxlevel = 2, ratios (4,1) then (4,2)
#: (the DEM_2D style, tests/test_amr.py:167-169), 4 coarse steps (6 until
#: slice 11c's phases came, which the script's time limit needs; the
#: regrids of steps 2 and 4 and the resume from step 3 stay)
M0_NESTED = M0_LEDGE.replace("amr.maxlevel = 1", "amr.maxlevel = 2") \
    .replace("amr.refratio_lev0 = 2 2",
             "amr.refratio_lev0 = 4 1\namr.refratio_lev1 = 4 2") \
    .replace("amr.maxsteps = 6", "amr.maxsteps = 4")
#: M0's third deck: the TwistedMap two fronts of tests/test_amr.py:296-320
#: (perturbations 0.2 0.02) on R0_TWO_FRONTS, K pinned at 2, no refluxing
M0_TWO_FRONTS = R0_TWO_FRONTS + """geometry.coordMap = 1
geometry.perturbations = 0.2 0.02
amr.max_patches = 2
plot.writeGeometry = 1
"""
#: M1: a 2D lock exchange on the Ledge map as an AMR deck (the stand-in
#: for the absent LockExchange_Ledge2D deck): D1's physics and lengths in
#: (x, z), a 1024x128 base at ratio (4,1), regrids every 5 steps, a
#: CFL-limited dt, 5 coarse steps (10 until slice 11c's phases came),
#: files at step 5.  The first dt from
#: rest is init_dt_multiplier x the base's viscous limit (ROADMAP C.20):
#: at 0.1 (0.048) the patch's substeps blow up at its CF side under the
#: top wall, on a Cartesian base too (ROADMAP C.29), so it starts at 0.01
#: and grows by max_dt_grow to the CFL limit
M1_DECK = D1_DECK.replace("amr.nx = 512 128 128", "amr.nx = 1024 128") \
    .replace("amr.length = 15 2 2", "amr.length = 15 2") \
    .replace("amr.nx_offset = -256 0 0", "amr.nx_offset = -512 0") \
    .replace("amr.isPeriodic = 0 1 0", "amr.isPeriodic = 0 0") \
    .replace("amr.maxsteps = 20", "amr.maxsteps = 5") \
    .replace("plot.plot_interval = 10", "plot.plot_interval = 5") \
    .replace("plot.checkpoint_interval = 10",
             "plot.checkpoint_interval = 5") + """
amr.init_dt_multiplier = 0.01
amr.maxlevel = 1
amr.refratio_lev0 = 4 1
amr.regrid_intervals = 5
amr.buoyancy_tag_tol = 0.2
amr.tags_grow = 1
AMRMG.eps = 1e-5
AMRMG.imax = 12
""" + LEDGE_KEYS
M1_BASE, M1_RATIO = (1024, 128), (4, 1)
#: M2: R1's deck (a 128^3 base at ratio (4,1,1), patch ext 384x128x128) on
#: the Ledge map extruded in y, 2 coarse steps (5 until slice 11c's phases
#: came), one regrid and its files at step 2, one initial pressure
#: iteration (D1: 2)
M2_DECK = R1_DECK.replace("amr.maxsteps = 20", "amr.maxsteps = 2") \
    .replace("amr.regrid_intervals = 5", "amr.regrid_intervals = 2") \
    .replace("plot.plot_interval = 10", "plot.plot_interval = 2") \
    .replace("plot.checkpoint_interval = 10",
             "plot.checkpoint_interval = 2") \
    .replace("projection.initial_pressure_iters = 2",
             "projection.initial_pressure_iters = 1") + LEDGE_KEYS
#: the kernels of a 2D mapped AMR deck's path: the advection on every
#: level and the probed-stencil residual of every solve (a mapped level
#: runs no uniform multigrid level); `mapped_path` adds the probed-stencil
#: smoother where a multigrid level smooths pointwise (vertical line
#: relaxation, which "auto" picks where the metric's vertical coupling
#: dominates, is plain torch) and ctu_corr3 in 3D
AMR_MAPPED_PATH_2D = ("ppm_predict", "ctu_final", "riemann_fluxdiv",
                      "stencil_helm_residual")


def mapped_path(h):
    """The kernels that a run of mapped hierarchy h must launch:
    AMR_MAPPED_PATH_2D, stencil_gsrb_sweeps where a multigrid level of a
    level's projection or heat solves smooths pointwise on a probed plan,
    ctu_corr3 in 3D."""
    path = list(AMR_MAPPED_PATH_2D)
    if h.grid0.ndim == 3:
        path.append("ctu_corr3")
    for lv in [h.level0] + [x for c in h.couplings for x in c.levels]:
        mgs = [lv.projector.mg] + [hs.mg for hs in lv._heat_solvers()
                                   if hs._fft is None]
        if any(mode == "gsrb" and op._stencil_plan is not None
               for mg in mgs for op, mode in zip(mg.ops, mg.modes)):
            path.append("stencil_gsrb_sweeps")
            break
    return tuple(path)


def slot_j_ranges(h):
    """Per refined level, per slot, [min J, max J] (host floats)."""
    return [[[round(float(lv.geo.J.min()), 6), round(float(lv.geo.J.max()),
                                                     6)]
             for lv in c.levels] for c in h.couplings]


def cpu_deck_summary(deck, init, threads=4):
    """amr_deck_run of `deck` on the CPU, in a worker process and a
    temporary directory of its own (with file_layer's files): what the
    card-against-CPU gates read of it (the final states, the placement and
    regrid logs, the subcycling factors, the steps and the seconds)."""
    import types
    import torch
    from somar_tpu_torch.ops import ctu_kernels as ck
    from somar_tpu_torch.ops import gsrb_kernels as gk
    from somar_tpu_torch.ops import stencil_gsrb_kernels as sgk
    torch.set_num_threads(threads)
    file_layer()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cpu_") as out:
        cwd = os.getcwd()
        os.chdir(out)
        try:
            run = amr_deck_run(torch, deck, "cpu", (ck, gk, sgk), init)
        finally:
            os.chdir(cwd)
    drv = run["drv"]
    return dict(state=run["state"], fines=run["fines"], placed=run["placed"],
                steps=run["steps"], seconds=run["seconds"],
                drv=types.SimpleNamespace(regrids=drv.regrids,
                                          nt_mults=drv.nt_mults))


def mapped_card_vs_cpu(torch, device, counters, files):
    """M0: each small mapped deck through RunDriver on the CPU and on the
    card: the same per-level K, origins, weights and parent selections at
    the placement and after every regrid, the same dynamic-subcycling
    factors, every field of every level within R0_RTOL (the potentials
    gauge-free), each slot's J range; then on the card the run resumed
    from its mid-run checkpoint, equal to the uninterrupted one
    (DRIVER_RTOL).  amr_gates hold the J-weighted average-down (1e-6) and
    the sync relres.  The CPU runs go on in a worker process
    (cpu_deck_summary) while the card's run here.  Returns the card's
    launches of the three decks."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    decks = (("ledge", M0_LEDGE, None, 1), ("nested", M0_NESTED, None, 2),
             ("two fronts", M0_TWO_FRONTS, with_fronts, 1))
    total = {}
    # the CPU runs go on in one worker process while the card's run here
    with ProcessPoolExecutor(
            max_workers=1,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        cpu_runs = {label: pool.submit(cpu_deck_summary, deck, init)
                    for label, deck, init, _ in decks}
        for label, deck, init, levels in decks:
            total = mapped_deck_check(torch, device, counters, files, label,
                                      deck, init, levels,
                                      cpu_runs[label], total)
    return total


def mapped_deck_check(torch, device, counters, files, label, deck, init,
                      levels, cpu_future, total):
    """One M0 deck: its card run and resumed run here, against the CPU
    run of `cpu_future` (cpu_deck_summary).  Returns `total` with the card
    run's launches added."""
    runs = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_m0_") as out:
        cwd = os.getcwd()
        os.chdir(out)
        try:
            card = runs[device] = amr_deck_run(torch, deck, device,
                                               counters, init)
            resumed = amr_deck_run(
                torch, deck + "amr.restart_file = chkpt_000003.hdf5\n",
                device, counters, init)
        finally:
            os.chdir(cwd)
    if files is not None:
        files.trees.clear()
    runs["cpu"] = cpu_future.result()
    t_cpu = runs["cpu"]["seconds"]
    for k, v in card["launches"].items():
        total[k] = total.get(k, 0) + v
    rel = amr_pair_diffs(card, runs["cpu"])
    err = max(rel.values())
    res = max(max(field_diffs(x, y, AMR_FIELDS).values())
              for x, y in zip((resumed["state"],) + resumed["fines"],
                              (card["state"],) + card["fines"]))
    log, cpu_log = nested_log(card), nested_log(runs["cpu"])
    h = card["h"]
    say(f"M0 {label} {h.grid0.nx} {type(h.level0.geo.geo).__name__} "
        f"map, ratios {h.ratios}, {card['steps']} coarse steps on "
        f"{device} ({card['seconds']:.2f} s) and on the CPU "
        f"({t_cpu:.2f} s): (step, per level (K, origins, weights, "
        f"parent_sel)) at placement and every regrid {log} (CPU "
        f"{'the same' if log == cpu_log else cpu_log}); exts "
        f"{[list(c.ext_nx) for c in h.couplings]}; J range per level "
        f"per slot {slot_j_ranges(h)} (base "
        f"[{float(h.level0.geo.J.min()):.6f}, "
        f"{float(h.level0.geo.J.max()):.6f}]); slots built "
        f"{h.slots_built} in {h.refresh_seconds:.3f} s; dts "
        f"{['%.6g' % d for d in card['drv'].dts]}; nt_mults "
        f"{card['drv'].nt_mults} (CPU {'the same' if card['drv'].nt_mults == runs['cpu']['drv'].nt_mults else runs['cpu']['drv'].nt_mults}); "
        "card against CPU max|diff|/max|field| "
        + " ".join(f"{k}={v:.3e}" for k, v in rel.items())
        + f" (limit {R0_RTOL}); resumed from chkpt_000003 against the "
        f"uninterrupted run {res:.3e} (limit {DRIVER_RTOL}); sync relres "
        "per step " + ",".join(f"{r[2]:.3e}" for r in card["rows"])
        + "; J-weighted average-down max|diff|/max|b| per step "
        + ",".join(f"{r[0] / max(r[1], 1e-30):.2e}" for r in card["rows"])
        + f"; launches {json.dumps(card['launches'])}")
    amr_gates(card, f"M0 {label}")
    if log != cpu_log or card["drv"].nt_mults != runs["cpu"][
            "drv"].nt_mults:
        raise PhaseError(f"M0 {label}: the card placed or regridded "
                         "the patches otherwise than the CPU")
    if not err <= R0_RTOL:
        raise PhaseError(f"M0 {label}: the card's run differs from the "
                         "CPU's")
    if not (res <= DRIVER_RTOL and resumed["steps"] == card["steps"]
            and nested_log(resumed)[-1][1:] == log[-1][1:]):
        raise PhaseError(f"M0 {label}: the resumed run differs")
    if not (h.is_mapped and len(h.couplings) == levels):
        raise PhaseError(f"M0 {label}: not {levels} mapped refined "
                         "levels")
    if init:
        c = h.couplings[0]
        j0, j1 = (lv.geo.J for lv in c.levels)
        if not (c.K == 2 and list(c.weights) == [1.0, 1.0]
                and float((j0 - j1).abs().max()) > 1e-3):
            raise PhaseError(f"M0 {label}: not two active slots on "
                             "their own metrics")
    check_launched(card["launches"], mapped_path(h), f"M0 {label}")
    return total


def refresh_split(run):
    """Per regrid: (seconds, of them rebuilding slots, slots rebuilt)."""
    return [(r["seconds"], r["refresh_seconds"], r["slots_built"])
            for r in run["drv"].regrids]


def mapped_level_twins(torch, ck, gk, sgk, run, worst, tag):
    """M3's part for one run: K1-K4 at the padded shapes of every refined
    level the run reached, and K7-K8 on every slot's own pressure and
    diffusive hierarchies (solver_level_twins).  Returns the plan-less
    solver levels."""
    levels = {}
    for (lev, ext), c in run["levels"].items():
        for k, lv in enumerate(c.levels):
            levels[f"{tag} level {lev} {ext} slot {k}"] = lv
    return levels_kernel_twins(torch, ck, gk, sgk, levels, worst)


def mapped_phases(torch, ck, gk, sgk, counters, device, smi, worst, files):
    """M0, M1, M2 and M3, each printing its seconds: the small mapped decks
    card against CPU, the 2D Ledge lock exchange at full width (its
    footprint reckoned first), R1's deck on the Ledge map, then K1-K8
    against their twins at their patch shapes and on each slot's solver
    hierarchies (M0's two fronts included).  Returns {phase: (launches,
    launches per coarse step)}, and under "times" K7/K8's times on M1's
    and M2's finest patch projection plans (plan_timing)."""
    import math
    from somar_tpu_torch.amr.hierarchy import patch_footprint
    out = {}
    t0 = time.perf_counter()
    out["m0"] = (mapped_card_vs_cpu(torch, device, counters, files), {})
    say(f"phase M0: {time.perf_counter() - t0:.1f} s")
    m3 = {}
    for key, deck in (("m1", M1_DECK), ("m2", M2_DECK)):
        t0 = time.perf_counter()
        if key == "m1":
            interior, ext = patch_footprint(M1_BASE, (False, False),
                                            M1_RATIO)
            say(f"M1 footprint reckoned by patch_footprint over the "
                f"{M1_BASE} base at ratio {M1_RATIO}: interior {interior} "
                f"ext {ext} = {math.prod(ext)} cells")
        run = amr_deck_phase(torch, device, counters, smi, key.upper(),
                             deck, path=(), standins=LEDGE_STANDINS)
        if files is not None:
            files.trees.clear()
        h = run["h"]
        check_launched(run["launches"], mapped_path(h), key.upper())
        say(f"{key.upper()} mapped slots: J range per level per slot "
            f"{slot_j_ranges(h)}; per regrid (seconds, of them rebuilding "
            f"the slots' metric and levels, slots rebuilt) "
            f"{refresh_split(run)}; tagging and placement the rest; slots "
            f"built in the run {h.slots_built} in {h.refresh_seconds:.3f} s "
            f"(placement included)")
        if not h.is_mapped:
            raise PhaseError(f"{key.upper()}: the base is not mapped")
        out[key] = (run["launches"], run["per_step"])
        m3[key] = run
        say(f"phase {key.upper()}: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    plain, times = {}, {}
    gen = torch.Generator(device=device).manual_seed(37)
    for key, run in m3.items():
        plain.update(mapped_level_twins(torch, ck, gk, sgk, run, worst,
                                        key.upper()))
        # K7/K8 per call on the slot's finest projection plan
        splan = run["h"].couplings[0].level.projector.mg.ops[0]._stencil_plan
        times[f"{key.upper()} patch {tuple(splan.shape)}"] = plan_timing(
            torch, sgk, splan, f"{key.upper()} patch", gen)
    out["times"] = times
    del m3
    # M0's two fronts on the card: two slots, each its own hierarchy
    with tempfile.TemporaryDirectory(prefix="chip_smoke_m3_") as tmp:
        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            run = amr_deck_run(torch, M0_TWO_FRONTS.replace(
                "amr.maxsteps = 6", "amr.maxsteps = 2"), device, counters,
                with_fronts)
        finally:
            os.chdir(cwd)
    if files is not None:
        files.trees.clear()
    plain.update(mapped_level_twins(torch, ck, gk, sgk, run, worst,
                                    "M0 two fronts"))
    del run
    say(f"M3 solver levels without a kernel plan (plain path): "
        f"{json.dumps(plain)}")
    say(f"phase M3: {time.perf_counter() - t0:.1f} s")
    return out


# --------------------------------------------------------------------------
# phases 34-36: refluxing, the VD correction, RK3 patch levels and
# post-regrid smoothing (slice 11c)
# --------------------------------------------------------------------------
#: the deck keys of slice 11c
F_REFLUX = """amr.advective_momentum_reflux = 1
amr.advective_scalar_reflux = 1
amr.advective_lambda_reflux = 1
"""
F_IMPLICIT = """amr.implicit_scalar_reflux = 1
amr.implicit_momentum_reflux = 1
"""
F_VD = """projection.applyVDCorrection = 1
projection.etaLambda = 0.9
"""
F_SMOOTH = """amr.smooth_after_regrid = 1
amr.postRegrid_smoothing_coeff = 1.0
"""
F_RK3 = "amr.updateScheme = 2\n"
#: F0's decks, card against CPU, 4 coarse steps each (6 in their first
#: runs; cut for the script's time limit, the regrids of steps 2 and 4 and
#: the resume from step 3 stay): (label, deck, initial state (two fronts,
#: a lambda bump, or the deck's own), refluxing, VD).  "vd bump" is
#: tests/test_amr.py:779 as a deck: the VD correction alone, lambda seeded
#: with a bump of 0.004 (without a source of lambda drift e_lambda stays
#: 0), held to max|lambda - 1| < F0_LAMBDA_DRIFT on every level; with
#: lambda refluxed too the drift grows (ROADMAP C.31), so the reflux decks
#: with the VD correction are held to a filled, finite e_lambda
F0_DECKS = tuple(
    (label, deck.replace("amr.maxsteps = 6", "amr.maxsteps = 4"), init,
     reflux, vd) for label, deck, init, reflux, vd in (
        ("reflux+vd", R0_DECK + F_REFLUX + F_VD, None, True, True),
        ("implicit", R0_DECK + F_REFLUX + F_IMPLICIT + F_VD, None, True,
         True),
        ("vd bump", R0_DECK + F_VD, with_lambda_bump, False, True),
        ("two chains", N0_TWO_CHAINS + F_REFLUX, with_fronts, True, False),
        ("mapped two fronts", M0_TWO_FRONTS + F_REFLUX, with_fronts, True,
         False),
        ("rk3", R0_DECK + F_RK3 + F_REFLUX, None, True, False),
        ("smoothing", R0_DECK + F_SMOOTH, None, False, False)))
#: the conservation gate's deck (tests/test_amr.py:365): R0_DECK inviscid,
#: dt 0.02, 8 coarse steps; with refluxing the base's buoyancy integral
#: drifts no more than without, F0_DRIFT_SLACK allowed
F0_INVISCID = R0_DECK.replace("amr.viscosity = 0.0001", "amr.viscosity = 0.0") \
    .replace("amr.scal_diffusion_coeffs = 0.0001",
             "amr.scal_diffusion_coeffs = 0.0") \
    .replace("amr.maxsteps = 6", "amr.maxsteps = 8") + "amr.fixed_dt = 0.02\n"
F0_DRIFT_SLACK = 1e-4
#: implicit against explicit refluxing (tests/test_amr.py:398): the base's
#: b of the two decks within this
F0_IMPLICIT_DIFF = 1e-4
#: the VD correction keeps lambda near 1 (tests/test_amr.py:779)
F0_LAMBDA_DRIFT = 0.016
#: card against CPU, e_lambda (gauge-free) is held apart from the
#: AMR_FIELDS (R0_RTOL): it is the potential of one composite pass whose
#: rhs is lambda - 1, a difference of nearly equal float32 numbers (the
#: lambda-bump deck's patch lambda differs by 1.5e-6 of max|lambda|
#: between card and CPU, its e_lambda by 1.1e-3 of max|e_lambda|).  F0
#: shows the limit catching a fault: the lambda-bump deck on the card
#: with every VD pass started from e_lambda = 0 (with_vd_cold_start)
#: against the sound CPU run (above 1 on the CPU against itself)
F0_ELAMBDA_RTOL = 1e-2
#: a refluxing level collects its momentum fluxes by re-upwinding the
#: stashed traces in plain torch, as the JAX package's collect path does:
#: no riemann_fluxdiv (K4) in a coarse step (the base level's single-level
#: pressure initialization before the placement still launches it); RK3
#: traces at dt = 0 without K4 either
F_PATH_2D = tuple(k for k in AMR_PATH_2D if k != "riemann_fluxdiv")
#: F1: R1's deck at full width (base 128^3, ratio (4,1,1), patch ext
#: 384x128x128), 10 coarse steps, regrids every 5, files at step 10, at
#: CFL 0.3, with velocity and buoyancy refluxed, implicit refluxing, the
#: VD correction and post-regrid smoothing, held to every gate of R1;
#: F1_OFF the same deck without any of them.  At R1's CFL 0.9 (dts up to
#: 0.124) the refluxed b leaves B_BOUNDS at the interface, in the JAX
#: package too (ROADMAP C.32); at 0.3 it stays inside.  Lambda is not
#: refluxed here, so the VD correction's rhs stays near 0 and its solves
#: run all the same
F_CFL = ("amr.cfl = 0.9", "amr.cfl = 0.3")
F_REFLUX_VB = F_REFLUX.replace("amr.advective_lambda_reflux = 1",
                               "amr.advective_lambda_reflux = 0")
F1_OFF = R1_DECK.replace("amr.maxsteps = 20", "amr.maxsteps = 10") \
    .replace(*F_CFL)
F1_DECK = F1_OFF + F_REFLUX_VB + F_IMPLICIT + F_VD + F_SMOOTH
#: F1_ALL: R1's deck as it stands (CFL 0.9), 10 coarse steps, with every
#: feature of slice 11c on (lambda refluxed too): a run of a fault of the
#: reference, held to finiteness only.  Lambda refluxing with the VD
#: correction grows lambda's drift 2.5-4x a coarse step, b follows it and
#: tags spread past the footprint, in the JAX package's RunDriver as in
#: the port's to 7 digits (ROADMAP C.31; tests/torch_jax_lambda_drift.py)
F1_ALL = R1_DECK.replace("amr.maxsteps = 20", "amr.maxsteps = 10") \
    + F_REFLUX + F_IMPLICIT + F_VD + F_SMOOTH
#: F2: F1's deck (CFL 0.3) with RK3 and all three fields refluxed, 5
#: coarse steps, files at step 5, held to every gate of R1
F2_DECK = R1_DECK.replace("amr.maxsteps = 20", "amr.maxsteps = 5") \
    .replace(*F_CFL) \
    .replace("plot.plot_interval = 10", "plot.plot_interval = 5") \
    .replace("plot.checkpoint_interval = 10",
             "plot.checkpoint_interval = 5") + F_RK3 + F_REFLUX


def f_extra(h, s0, fine, origins):
    """The composite buoyancy mass (base uncovered cells and patch
    interiors, each on its own volumes), then max|lambda - 1| of each
    level, the base first (0-d tensors)."""
    from somar_tpu_torch.ops.norms import composite_mapped_sum
    fine = list(fine) if isinstance(fine, (list, tuple)) else [fine]
    origins = (list(origins) if isinstance(origins, (list, tuple))
               else [origins])
    b = [s0.scalars[0]] + [f.scalars[:, 0] if c.K > 1 else f.scalars[0]
                           for c, f in zip(h.couplings, fine)]
    return [composite_mapped_sum(h, b, origins)] + [
        (s.lam - 1.0).abs().max() for s in [s0] + fine]


def vd_filled(torch, h, s0, fines):
    """e_lambda finite and non-zero on the base and in every active
    patch's interior."""
    from somar_tpu_torch.amr.transfer import extract_patch
    ok = bool(torch.isfinite(s0.e_lambda).all()) and bool(
        (s0.e_lambda != 0).any())
    for c, f in zip(h.couplings, fines):
        for p, w in zip(c.unstack(f), c.patch_weights(c.weights)):
            if w is not None and w == 0.0:
                continue
            e = extract_patch(p.e_lambda, c.int_start, c.int_shape)
            ok = ok and bool(torch.isfinite(p.e_lambda).all()) and bool(
                (e != 0).any())
    return ok


def feature_card_vs_cpu(torch, device, counters, files):
    """F0: each deck of F0_DECKS through RunDriver on the CPU (in a worker
    process alongside) and on the card: the same per-level K, origins,
    weights, parent selections and nt_mults at the placement and after
    every regrid, every field of every level within R0_RTOL (the
    potentials gauge-free) and e_lambda within F0_ELAMBDA_RTOL, R0's
    gates; on the card the run resumed
    from its step-3 checkpoint equal to the uninterrupted one
    (DRIVER_RTOL), e_lambda filled and lambda within F0_LAMBDA_DRIFT of 1
    on every level of the VD decks, the implicit deck's base b within
    F0_IMPLICIT_DIFF of the explicit one's, and every kernel of the
    deck's path launched; the vd bump deck once more on the card with
    every VD pass started cold (with_vd_cold_start), whose e_lambda must
    read above F0_ELAMBDA_RTOL against the sound CPU run.  Then the
    conservation gate on F0_INVISCID with and without refluxing.  Returns
    the card's launches of the decks."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    total, finals, sound_e = {}, {}, []
    with ProcessPoolExecutor(
            max_workers=1,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        cpu_runs = {label: pool.submit(cpu_deck_summary, deck, init)
                    for label, deck, init, _, _ in F0_DECKS}
        for label, deck, init, reflux, vd in F0_DECKS:
            with tempfile.TemporaryDirectory(prefix="chip_smoke_f0_") as out:
                cwd = os.getcwd()
                os.chdir(out)
                try:
                    card = amr_deck_run(torch, deck, device, counters,
                                        init)
                    resumed = amr_deck_run(
                        torch, deck + "amr.restart_file = "
                        "chkpt_000003.hdf5\n", device, counters, init)
                finally:
                    os.chdir(cwd)
            if files is not None:
                files.trees.clear()
            cpu = cpu_runs[label].result()
            for k, v in card["launches"].items():
                total[k] = total.get(k, 0) + v
            h = card["h"]
            rel = amr_pair_diffs(card, cpu)
            err = max(rel.values())
            rel_e = amr_pair_diffs(card, cpu, ("e_lambda",), ("e_lambda",))
            rel.update(rel_e)
            if vd:
                sound_e.append(max(rel_e.values()))
            if init is with_lambda_bump:
                bump = (deck, cpu)
            res = max(max(field_diffs(x, y, AMR_FIELDS + ("e_lambda",))
                          .values())
                      for x, y in zip((resumed["state"],) + resumed["fines"],
                                      (card["state"],) + card["fines"]))
            log, cpu_log = nested_log(card), nested_log(cpu)
            lam = [float((s.lam - 1.0).abs().max())
                   for s in (card["state"],) + card["fines"]]
            filled = vd_filled(torch, h, card["state"], card["fines"])
            say(f"F0 {label} {h.grid0.nx} ratios {h.ratios}, reflux "
                f"{h.reflux_fields} implicit {h.implicit_reflux} eta_lambda "
                f"{h.eta_lambda} smoothing {h.regrid_smoothing_coeff} scheme "
                f"{h.params.update_scheme}, {card['steps']} coarse steps on "
                f"{device} ({card['seconds']:.2f} s) and on the CPU "
                f"({cpu['seconds']:.2f} s): (step, per level (K, origins, "
                f"weights, parent_sel)) {log} (CPU "
                f"{'the same' if log == cpu_log else cpu_log}); nt_mults "
                f"{card['drv'].nt_mults} (CPU {'the same' if card['drv'].nt_mults == cpu['drv'].nt_mults else cpu['drv'].nt_mults}); "
                "card against CPU max|diff|/max|field| "
                + " ".join(f"{k}={v:.3e}" for k, v in rel.items())
                + f" (limit {R0_RTOL}, e_lambda {F0_ELAMBDA_RTOL}); resumed "
                "from chkpt_000003 against "
                f"the uninterrupted run {res:.3e} (limit {DRIVER_RTOL}); "
                f"max|lambda - 1| per level {['%.3e' % x for x in lam]}; "
                f"e_lambda filled on every level {filled}; sync relres per "
                "step " + ",".join(f"{r[2]:.3e}" for r in card["rows"])
                + f"; launches {json.dumps(card['launches'])}")
            amr_gates(card, f"F0 {label}")
            if log != cpu_log or card["drv"].nt_mults != cpu["drv"].nt_mults:
                raise PhaseError(f"F0 {label}: the card placed or regridded "
                                 "the patches otherwise than the CPU")
            if not (err <= R0_RTOL
                    and max(rel_e.values()) <= F0_ELAMBDA_RTOL):
                raise PhaseError(f"F0 {label}: the card's run differs from "
                                 "the CPU's")
            if not (res <= DRIVER_RTOL and resumed["steps"] == card["steps"]
                    and nested_log(resumed)[-1][1:] == log[-1][1:]):
                raise PhaseError(f"F0 {label}: the resumed run differs")
            if vd and not filled:
                raise PhaseError(f"F0 {label}: e_lambda not filled")
            if init is with_lambda_bump and not max(lam) < F0_LAMBDA_DRIFT:
                raise PhaseError(f"F0 {label}: lambda drifted {lam}")
            path = mapped_path(h) if h.is_mapped else AMR_PATH_2D
            check_launched(card["launches"],
                           [k for k in path if k in F_PATH_2D]
                           if reflux else path, f"F0 {label}")
            if reflux and card["per_step"]["riemann_fluxdiv"]:
                raise PhaseError(f"F0 {label}: K4 launched in a refluxing "
                                 "coarse step")
            finals[label] = card["state"]
            del card, resumed, cpu
    bump_deck, bump_cpu = bump
    with tempfile.TemporaryDirectory(prefix="chip_smoke_f0_") as out:
        cwd = os.getcwd()
        os.chdir(out)
        try:
            cold = amr_deck_run(torch, bump_deck, device, counters,
                                with_vd_cold_start)
        finally:
            os.chdir(cwd)
    if files is not None:
        files.trees.clear()
    fault = max(amr_pair_diffs(cold, bump_cpu, ("e_lambda",),
                               ("e_lambda",)).values())
    del cold, bump, bump_cpu
    say(f"F0 e_lambda limit {F0_ELAMBDA_RTOL}: card against CPU on the VD "
        f"decks {['%.3e' % x for x in sound_e]}; the vd bump deck on the "
        f"card with every VD pass started from e_lambda = 0 against the "
        f"sound CPU run {fault:.3e}")
    if not fault > F0_ELAMBDA_RTOL:
        raise PhaseError("F0: the e_lambda limit does not catch a VD pass "
                         "started cold")
    diff = float((finals["implicit"].scalars[0]
                  - finals["reflux+vd"].scalars[0]).abs().max())
    say(f"F0 implicit against explicit refluxing: max|b_implicit - "
        f"b_explicit| on the base {diff:.3e} (limit {F0_IMPLICIT_DIFF})")
    if not diff < F0_IMPLICIT_DIFF:
        raise PhaseError("F0: implicit refluxing left the explicit one")
    drifts = {}
    for name, deck in (("off", F0_INVISCID), ("on", F0_INVISCID + F_REFLUX)):
        with tempfile.TemporaryDirectory(prefix="chip_smoke_f0_") as out:
            cwd = os.getcwd()
            os.chdir(out)
            try:
                run = amr_deck_run(torch, deck, device, counters,
                                   extra=lambda h, s0, f, o:
                                   [s0.scalars[0].double().sum()])
            finally:
                os.chdir(cwd)
        if files is not None:
            files.trees.clear()
        amr_gates(run, f"F0 inviscid reflux {name}")
        drifts[name] = abs(run["extra"][-1][0] - run["extra"][0][0])
    say(f"F0 conservation (F0_INVISCID, 8 coarse steps at dt 0.02): "
        f"|sum b(end) - sum b(start)| on the base with refluxing "
        f"{drifts['on']:.6e}, without {drifts['off']:.6e} (gate: with <= "
        f"without + {F0_DRIFT_SLACK})")
    if not drifts["on"] <= drifts["off"] + F0_DRIFT_SLACK:
        raise PhaseError("F0: refluxing conserved buoyancy worse")
    return total


def feature_deck_summary(label, run):
    """F1/F2's figures beyond amr_deck_phase's: the composite buoyancy
    mass drift and max|lambda - 1| per level at the end."""
    ex = run["extra"]
    drift = abs(ex[-1][0] - ex[0][0])
    lam = ex[-1][1:]
    say(f"{label}: composite buoyancy mass {ex[0][0]:.9e} -> "
        f"{ex[-1][0]:.9e} (drift {drift:.3e}, relative "
        f"{drift / max(abs(ex[0][0]), 1e-30):.3e}); max|lambda - 1| per "
        f"level at the end {['%.3e' % x for x in lam]}, over the run "
        f"{['%.3e' % max(r[1 + i] for r in ex) for i in range(len(lam))]}")
    return drift, max(lam)


def feature_phases(torch, counters, device, smi, files):
    """F0, F1 and F2, each printing its seconds.  Returns {phase:
    (launches, launches per coarse step)}."""
    out = {}
    t0 = time.perf_counter()
    out["f0"] = (feature_card_vs_cpu(torch, device, counters, files), {})
    say(f"phase F0: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    f1 = {}
    path3 = ("ctu_corr3",) + F_PATH_2D
    for key, deck, path in (("f1", F1_DECK, path3),
                            ("f1_off", F1_OFF, ("ctu_corr3",) + AMR_PATH_2D)):
        run = amr_deck_phase(torch, device, counters, smi, key.upper(), deck,
                             path=path, extra=f_extra)
        if files is not None:
            files.trees.clear()
        f1[key] = feature_deck_summary(key.upper(), run) + (
            ms_of(plain_step_seconds(run)),)
        out[key] = (run["launches"], run["per_step"])
        if key == "f1" and run["per_step"]["riemann_fluxdiv"]:
            raise PhaseError("F1: K4 launched in a refluxing coarse step")
        del run
    say(f"F1 against F1_OFF: ms per plain coarse step {f1['f1'][2]:.3f} "
        f"against {f1['f1_off'][2]:.3f} "
        f"({f1['f1'][2] / f1['f1_off'][2]:.3f}x); composite buoyancy mass "
        f"drift {f1['f1'][0]:.3e} with refluxing, {f1['f1_off'][0]:.3e} "
        f"without; max|lambda - 1| at the end {f1['f1'][1]:.3e} with the VD "
        f"correction, {f1['f1_off'][1]:.3e} without")
    out["f1_all"] = fault_reference_run(torch, device, counters, smi,
                                        "F1_ALL", F1_ALL, path3)
    if files is not None:
        files.trees.clear()
    say(f"phase F1: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    run = amr_deck_phase(torch, device, counters, smi, "F2", F2_DECK,
                         path=("ctu_corr3",) + F_PATH_2D, extra=f_extra)
    if files is not None:
        files.trees.clear()
    feature_deck_summary("F2", run)
    if run["per_step"]["riemann_fluxdiv"]:
        raise PhaseError("F2: K4 launched in an RK3 coarse step")
    out["f2"] = (run["launches"], run["per_step"])
    del run
    say(f"phase F2: {time.perf_counter() - t0:.1f} s")
    return out


def plain_step_seconds(run):
    """The seconds of a deck run's coarse steps that did not regrid."""
    drv = run["drv"]
    regrid_steps = {r["step"] for r in drv.regrids}
    return [t for i, t in enumerate(drv.step_seconds, 1)
            if i not in regrid_steps]


def fault_reference_run(torch, device, counters, smi, label, deck, path):
    """A full-width deck that the reference's own numerics take out of
    R1's gates (ROADMAP C.31), through RunDriver on the card with the
    counts set to 0 just before: held to finite fields on every level and
    every kernel of `path` launched; prints ms per plain coarse step, b
    per level, tag coverage at the placement and every regrid, and
    max|lambda - 1| per level after every step.  Returns (launches,
    launches per coarse step)."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_f_") as out:
        cwd = os.getcwd()
        os.chdir(out)
        try:
            run = amr_deck_run(torch, deck, device, counters, extra=f_extra)
        finally:
            os.chdir(cwd)
    drv = run["drv"]
    drops = [[x["tag_coverage"] for x in info] for info in
             [run["placed"]] + [r["levels"] for r in drv.regrids]]
    say(f"{label} (a fault of the reference, ROADMAP C.31; held to "
        f"finiteness) base {run['h'].grid0.nx}: {run['steps']} coarse steps "
        f"in {run['seconds']:.2f} s; ms per plain coarse step median "
        f"{ms_of(plain_step_seconds(run)):.3f}; dts "
        f"{['%.5g' % d for d in drv.dts]}; b range per level "
        f"{[[round(x, 4) for x in r] for r in level_b_ranges(run)]}; tag "
        f"coverage (dropped, tagged) per level at the placement and every "
        f"regrid {drops}; max|lambda - 1| per level after each step "
        f"{[['%.3e' % x for x in r[1:]] for r in run['extra'][1:]]}; "
        f"peak_mem_bytes {run['peak']}; launches per coarse step "
        f"{json.dumps(run['per_step'])} on {smi}")
    feature_deck_summary(label, run)
    if not all(r[5] == 1.0 for r in run["rows"]):
        raise PhaseError(f"{label}: non-finite fields")
    check_launched(run["launches"], path, label)
    if run["per_step"]["riemann_fluxdiv"]:
        raise PhaseError(f"{label}: K4 launched in a refluxing coarse step")
    return run["launches"], run["per_step"]


def json_finite(x):
    """x with every non-finite float (a device time the profiler did not
    see, NaN) as None, so that the kernels line is strict JSON."""
    if isinstance(x, dict):
        return {k: json_finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [json_finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return None
    return x


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
    files = file_layer()
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
    launches, _, ms_path1, _, path1 = main_path(torch, entry, (ck,), device,
                                                smi)
    d1 = driver_lock(torch, (ck, gk, sgk), device, smi, path1, ms_path1,
                     files)
    del path1
    launches_mg, per_step_mg, _, by_level_mg, _ = main_path(
        torch, entry, (ck, gk), device, smi, label="multigrid", nsteps=10,
        sample_steps=5, pressure_solver="mg", mg=mg)
    ig_solve_parity(torch, entry, device)
    beam_step_parity(torch, entry, device)
    d2 = driver_rk3(torch, (ck, gk, sgk), device, smi)
    launches_beam, per_step_beam, _, path3 = beam_path(
        torch, entry, (ck, gk, sgk), device, smi)
    d3 = driver_beam(torch, (ck, gk, sgk), device, smi, path3, files)
    del path3
    cli_phase(device, files)

    # the phases of the other problems, options and the leptic solver:
    # each prints its own seconds
    counters = (ck, gk, sgk)
    phases = {}
    for key, fn in (
            ("d4", lambda: horiz_conv_phase(torch, counters, device, smi)),
            ("d5", lambda: vortex_phase(torch, entry, counters, device, smi)),
            ("d6", lambda: advection_phase(torch, counters, device, smi)),
            ("d7", lambda: stratified_phase(torch, counters, device, smi)),
            ("l1", lambda: leptic_solve_phase(torch, counters, device, smi,
                                              sgk, errs)),
            ("l2", lambda: leptic_step_phase(torch, counters, device, smi))):
        t0 = time.perf_counter()
        phases[key] = fn()
        say(f"phase {key.upper()}: {time.perf_counter() - t0:.1f} s")
    l1_lep, l1_mg, l1_f64, flat_times = phases["l1"]
    amr = amr_phases(torch, entry, ck, gk, sgk, counters, device, smi,
                     errs)
    amr_r = amr_deck_phases(torch, ck, gk, sgk, counters, device, smi, errs,
                            files)
    amr_n = nested_phases(torch, ck, gk, sgk, counters, device, smi, errs,
                          files)
    amr_m = mapped_phases(torch, ck, gk, sgk, counters, device, smi, errs,
                          files)
    amr_f = feature_phases(torch, counters, device, smi, files)

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
            launches_d1=d1[name], launches_d2=d2["launches"][name],
            launches_per_rk3_step=d2["per_step"][name],
            launches_d3=d3[name],
            launches_multigrid_path=launches_mg.get(name, 0),
            launches_per_multigrid_step=per_step_mg.get(name, 0.0),
            launches_beam_path=launches_beam.get(name, 0),
            launches_per_beam_step=per_step_beam.get(name, 0.0),
            max_abs_err=errs[name], bound_ms=bound, bound_by=by,
            # no single PyTorch call computes any of these functions
            library_ms=None)
        entry_.update(
            launches_d4=phases["d4"][name], launches_d5=phases["d5"][name],
            launches_d6=sum(v[name] for v in phases["d6"].values()),
            launches_d6_by_option={k: v[name]
                                   for k, v in phases["d6"].items()},
            launches_d7=sum(v[name] for v in phases["d7"].values()),
            launches_d7_by_problem={k: v[name]
                                    for k, v in phases["d7"].items()},
            launches_l1=l1_lep[name], launches_l1_multigrid=l1_mg[name],
            launches_l1_float64=l1_f64[name],
            launches_l2=phases["l2"][name],
            launches_a1=amr["a1"][0][name],
            launches_per_a1_coarse_step=amr["a1"][1]["per_step"][name],
            launches_a2=amr["a2"][0][name],
            launches_per_a2_coarse_step=amr["a2"][1]["per_step"][name],
            launches_r0=amr_r["r0"][0][name],
            launches_r1=amr_r["r1"][0][name],
            launches_per_r1_coarse_step=amr_r["r1"][1][name],
            launches_r2=amr_r["r2"][0][name],
            launches_per_r2_coarse_step=amr_r["r2"][1][name],
            launches_n0=amr_n["n0"][0][name],
            launches_n1=amr_n["n1"][0][name],
            launches_per_n1_coarse_step=amr_n["n1"][1][name],
            launches_m0=amr_m["m0"][0][name],
            launches_m1=amr_m["m1"][0][name],
            launches_per_m1_coarse_step=amr_m["m1"][1][name],
            launches_m2=amr_m["m2"][0][name],
            launches_per_m2_coarse_step=amr_m["m2"][1][name],
            launches_f0=amr_f["f0"][0][name],
            launches_f1=amr_f["f1"][0][name],
            launches_per_f1_coarse_step=amr_f["f1"][1][name],
            launches_f1_off=amr_f["f1_off"][0][name],
            launches_per_f1_off_coarse_step=amr_f["f1_off"][1][name],
            launches_f1_all=amr_f["f1_all"][0][name],
            launches_per_f1_all_coarse_step=amr_f["f1_all"][1][name],
            launches_f2=amr_f["f2"][0][name],
            launches_per_f2_coarse_step=amr_f["f2"][1][name])
        if source == STENCIL_SOURCE:
            entry_["mapped_patches"] = {
                label: dict(K=K, ms=t[name][0], plain_ms=t[name][1],
                            device_ms=t[name][2],
                            bound_ms=bound_ms(name, n, K=K)[0])
                for label, (n, K, t) in amr_m["times"].items()}
        if name in flat_times:
            entry_["flattened_leptic_level"] = flat_times[name]
        if name == "ppm_predict":
            entry_["by_axis"] = k1_axes
        if name == "helm_residual":
            entry_["by_level"] = k6_levels
        kernels.append(entry_)
    say(f"smoother launches per 4-sweep relax call by level: "
        f"{json.dumps(relax)}")
    say(f"card: {smi}")
    say(json.dumps({"kernels": json_finite(kernels)}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
