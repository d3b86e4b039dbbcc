#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its result on its own line; any failure exits
non-zero:
  1. device: nvidia-smi name and power limit, torch and CUDA versions
     (no CUDA device: exit 2, nothing else runs);
  2. build: compile the CTU kernels K1-K4 and the GSRB kernels K5-K6 with
     nvcc for sm_90a, the two libraries side by side;
  3. kernel parity: each kernel against its plain PyTorch twin on the same
     card tensors, full arrays, |err| <= 1e-6 max|input|: K1-K4 at the
     512x128x128 padded shape (136, 136, 520) f32, every stencil axis and
     mode; K5-K6 at (128, 128, 512) with the pressure BCs and with mixed
     BCs, in 2D, on the coarse multigrid shapes, on periodic extents 2 and
     3, and once in f64;
  4. kernel timing: median per-launch time of each kernel and of its twin
     (CUDA events), K1-K4 averaged over the stencil axes, K5 per sweep (two
     launches) and K6 per call at (128, 128, 512) f32; beside each the least
     time the card could take for the same bytes and operations;
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
     steps.
The line before the last is a JSON object describing each kernel; the last
line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

SHAPE3 = (136, 136, 520)      # 512x128x128 plus ADVECT_GROW ghosts
SHAPE2 = (136, 520)           # 512x128 (x, z) plus ghosts
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
KERNELS = {
    # K1 reads s, u and writes lo, hi, corr; two PPM evaluations a thread
    "ppm_predict": (CTU_SOURCE, "somar_tpu/ops/pallas_kernels.py:252",
                    5, 150),
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
    # K6: reads phi and rhs, writes the residual
    "helm_residual": (GSRB_SOURCE, "somar_tpu/ops/gsrb_pallas.py:387", 3,
                      30),
}
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

    def rnd(shape):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float32)

    cases = []
    for shape in (shape3, shape2):
        nd = len(shape)
        for ax in range(nd):
            s, u = rnd(shape), 0.5 * rnd(shape)
            for lim in ((True, False) if nd == 3 else (True,)):
                args = (s, u, 0.3, ax, lim, 0.1)
                cases.append(("ppm_predict", f"{nd}d ax{ax} lim={lim}",
                              (s, u), lambda a=args: ck.ppm_predict(*a),
                              lambda a=args: ck.ppm_predict_plain(*a)))
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
    """Returns {kernel: max abs err over its cases}; raises on a case above
    PARITY_RTOL * max|input|."""
    worst = {}
    for name, label, ins, kern, plain in kernel_cases(torch, ck, device,
                                                      shape3, shape2):
        got, want = kern(), plain()
        if device != "cpu":
            torch.cuda.synchronize()
        scale = max(float(t.abs().max()) for t in ins)
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        ok = err <= PARITY_RTOL * scale and len(got) == len(want)
        say(f"parity {name:16s} {label:18s} max_abs_err={err:.3e} "
            f"limit={PARITY_RTOL * scale:.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise PhaseError(f"{name} {label}: kernel and twin disagree")
        worst[name] = max(worst.get(name, 0.0), err)
    return worst


def median_ms(torch, fn, reps=50):
    """Median time of one call of fn over `reps` calls after warm-up (CUDA
    events)."""
    for _ in range(3):
        fn()
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
    """{kernel: (ms, plain_ms)}: median per-launch times, averaged over the
    3D stencil axes."""
    per = {}
    for name, label, _, kern, plain in kernel_cases(torch, ck, device,
                                                    SHAPE3, SHAPE2):
        if not label.startswith("3d") or ("lim=False" in label) \
                or (name == "ctu_final" and "div" not in label):
            continue      # the scalar-path variants: limited K1, want_div K3
        times = [median_ms(torch, kern), median_ms(torch, plain)]
        say(f"timing {name:16s} {label:18s} kernel={times[0]:.4f} ms "
            f"plain={times[1]:.4f} ms")
        per.setdefault(name, []).append(times)
    return {name: (statistics.mean(t[0] for t in v),
                   statistics.mean(t[1] for t in v))
            for name, v in per.items()}


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


def gsrb_parity(torch, gk, device):
    """Returns {kernel: max abs err over its cases}; raises on a case above
    PARITY_RTOL * max|input|."""
    worst = {"gsrb_sweeps": 0.0, "helm_residual": 0.0}
    gen = torch.Generator(device=device).manual_seed(4321)
    for label, (nx, per, lo, hi, dtname) in GSRB_CASES.items():
        plan = gsrb_plan(gk, nx, per, lo, hi)
        dtype = getattr(torch, dtname)
        phi, rhs = (torch.randn(plan.shape, generator=gen, device=device,
                                dtype=dtype) for _ in range(2))
        limit = PARITY_RTOL * max(float(phi.abs().max()),
                                  float(rhs.abs().max()))
        for alpha, beta in GSRB_COEFS:
            runs = [("gsrb_sweeps", f"iters={it}",
                     gk.gsrb_sweeps(plan, phi, rhs, alpha, beta, it),
                     gk.gsrb_sweeps_plain(plan, phi, rhs, alpha, beta, it))
                    for it in (1, 4)]
            runs.append(("helm_residual", "",
                         gk.helm_residual(plan, phi, rhs, alpha, beta),
                         gk.helm_residual_plain(plan, phi, rhs, alpha, beta)))
            torch.cuda.synchronize()
            for name, what, got, want in runs:
                err = float((got - want).abs().max())
                ok = err <= limit and got.shape == want.shape \
                    and bool(torch.isfinite(got).all())
                say(f"parity {name:16s} {label:22s} a={alpha} b={beta} "
                    f"{what:8s} max_abs_err={err:.3e} limit={limit:.3e} "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise PhaseError(f"{name} {label}: kernel and twin "
                                     "disagree")
                worst[name] = max(worst[name], err)
    return worst


def gsrb_timing(torch, gk, device):
    """{kernel: (ms, plain_ms)} at GSRB_SHAPE f32 with the pressure BCs:
    K5 per sweep (iters=1: two launches), K6 per call."""
    nx, per, lo, hi, _ = GSRB_CASES["pressure 128,128,512"]
    plan = gsrb_plan(gk, nx, per, lo, hi)
    gen = torch.Generator(device=device).manual_seed(99)
    phi, rhs = (torch.randn(plan.shape, generator=gen, device=device)
                for _ in range(2))
    out = {}
    for name, kern, plain in (
            ("gsrb_sweeps",
             lambda: gk.gsrb_sweeps(plan, phi, rhs, 0.0, 1.0, 1),
             lambda: gk.gsrb_sweeps_plain(plan, phi, rhs, 0.0, 1.0, 1)),
            ("helm_residual",
             lambda: gk.helm_residual(plan, phi, rhs, 0.0, 1.0),
             lambda: gk.helm_residual_plain(plan, phi, rhs, 0.0, 1.0))):
        out[name] = (median_ms(torch, kern), median_ms(torch, plain))
        say(f"timing {name:16s} {'pressure 128,128,512':22s} "
            f"kernel={out[name][0]:.4f} ms plain={out[name][1]:.4f} ms")
    return out


def bound_ms(name, ncells, itemsize=4):
    """(least ms the card could take, what bounds it): the larger of the
    bytes the function must move over the memory rate and its operations
    over the float32 rate, for `ncells` cells per array."""
    _, _, arrays, flops = KERNELS[name]
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
    Returns (launches, ms/step)."""
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
    for _ in range(samples):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(sample_steps):
            k += 1
            state = level.advance(state, dt * (1.0 + 1e-6 * k))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) / sample_steps)
    reads = (read_scalars.count - reads0) / (samples * sample_steps)
    diag = {}
    state = level.advance(state, dt, diag=diag)
    if not bool(torch.isfinite(state.vel).all()):
        raise PhaseError("non-finite state after the timed steps")
    ms = 1e3 * statistics.median(times)
    peak = torch.cuda.max_memory_allocated()
    say(f"main path {label} timing {grid.nx}: ms/step={ms:.3f} samples="
        + ",".join(f"{1e3 * t:.3f}" for t in times)
        + f" cell-updates/s={grid.ncells / (ms * 1e-3):.4e}"
        f" peak_mem_bytes={peak} solver_host_reads/step={reads:.1f}"
        f" max|div| of the projected advecting velocity="
        f"{float(diag['max_mac_div']):.3e} on {smi}")
    return launches, ms


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
    from somar_tpu_torch.solvers.multigrid import MGParams

    device = "cuda"
    smi = nvidia_smi_line()
    say(f"device: {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)} x"
        f"{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    cuda_build.build_libraries(dict([ck.LIBRARY, gk.LIBRARY]))
    ck.load()
    gk.load()
    say(f"build: {time.perf_counter() - t0:.2f} s")
    for name in (ck.LIBRARY[0], gk.LIBRARY[0]):
        for line in cuda_build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                say(f"  ptxas {name}: {line.strip()}")

    errs = kernel_parity(torch, ck, device)
    errs.update(gsrb_parity(torch, gk, device))
    timing = kernel_timing(torch, ck, device)
    timing.update(gsrb_timing(torch, gk, device))
    mg = MGParams(eps=1e-5, imax=12)
    solve_parity(torch, device, mg)
    step_parity(torch, entry, device)
    step_parity(torch, entry, device, rtol=MG_STEP_RTOL,
                pressure_solver="mg", mg=mg)
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        raise PhaseError("TF32 is on: the levels' spectral solvers switch "
                         "it off")
    launches, _ = main_path(torch, entry, (ck,), device, smi)
    launches_mg, _ = main_path(torch, entry, (ck, gk), device, smi,
                               label="multigrid", nsteps=10, sample_steps=5,
                               pressure_solver="mg", mg=mg)

    kernels = []
    for name, (source, replaces, _, _) in KERNELS.items():
        ncells = (SHAPE3[0] * SHAPE3[1] * SHAPE3[2] if source == CTU_SOURCE
                  else GSRB_SHAPE[0] * GSRB_SHAPE[1] * GSRB_SHAPE[2])
        bound, by = bound_ms(name, ncells)
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": launches.get(name, launches_mg[name]),
            "launches_multigrid_path": launches_mg[name],
            "max_abs_err": errs[name], "ms": timing[name][0],
            "plain_ms": timing[name][1], "bound_ms": bound, "bound_by": by,
            # no single PyTorch call computes any of these functions
            "library_ms": None})
    say(f"card: {smi}")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
