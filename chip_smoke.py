#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its result on its own line; any failure exits
non-zero:
  1. device: nvidia-smi name and power limit, torch and CUDA versions
     (no CUDA device: exit 2, nothing else runs);
  2. build: compile the CTU kernels K1-K4 with nvcc for sm_90a;
  3. kernel parity: each kernel against its plain PyTorch twin on the same
     card tensors at the 512x128x128 padded shape (136, 136, 520) f32,
     every stencil axis and mode, full arrays, |err| <= 1e-6 max|input|;
  4. kernel timing: median per-launch time of each kernel and of its twin
     (CUDA events), averaged over the stencil axes;
  5. step parity: the 64x16x32 lock exchange stepped 5 times at a fixed dt
     on the card and on the CPU from one state, max|diff| / max|field| <=
     1e-4 for velocity, scalars and pressure;
  6. main path: the 512x128x128 lock exchange through entry.run (20 steps,
     CFL 0.9), checked for finite fields, buoyancy within (-0.1, 1.1), no
     energy growth beyond 2e-4 E0 and launches of every kernel; then 3 timed
     samples of 10 steps.
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
ENERGY_GROWTH = 2e-4          # tests/test_lock_exchange.py:127
#: the lock exchange's buoyancy bound of tests/test_lock_exchange.py:56;
#: the PPM step itself over- and undershoots [0, 1] by a few percent
B_BOUNDS = (-0.1, 1.1)
REPLACES = {
    "ppm_predict": "somar_tpu/ops/pallas_kernels.py:252",
    "ctu_corr3": "somar_tpu/ops/pallas_kernels.py:315",
    "ctu_final": "somar_tpu/ops/pallas_kernels.py:398",
    "riemann_fluxdiv": "somar_tpu/ops/pallas_kernels.py:468",
}
SOURCE = "somar_tpu_torch/csrc/ctu_kernels.cu"


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


def kernel_timing(torch, ck, device, reps=50):
    """{kernel: (ms, plain_ms)}: median per-launch time over `reps`
    launches after warm-up, averaged over the 3D stencil axes."""
    per = {}
    for name, label, _, kern, plain in kernel_cases(torch, ck, device,
                                                    SHAPE3, SHAPE2):
        if not label.startswith("3d") or ("lim=False" in label) \
                or (name == "ctu_final" and "div" not in label):
            continue      # the scalar-path variants: limited K1, want_div K3
        times = []
        for fn in (kern, plain):
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
            times.append(statistics.median(a.elapsed_time(b)
                                           for a, b in samples))
        say(f"timing {name:16s} {label:18s} kernel={times[0]:.4f} ms "
            f"plain={times[1]:.4f} ms")
        per.setdefault(name, []).append(times)
    return {name: (statistics.mean(t[0] for t in v),
                   statistics.mean(t[1] for t in v))
            for name, v in per.items()}


# --------------------------------------------------------------------------
# phase 5: the step on the card against the step on the CPU
# --------------------------------------------------------------------------
def step_parity(torch, entry, device, nx=64, ny=16, nz=32, nsteps=5,
                dt=0.01):
    cpu_level, _ = entry.build_level(nx=nx, nz=nz, ny=ny, device="cpu")
    dev_level, _ = entry.build_level(nx=nx, nz=nz, ny=ny, device=device)
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
    say(f"step parity {nx}x{ny}x{nz} {nsteps} steps dt={dt}: "
        + " ".join(f"{f}={e:.3e}" for f, e in errs.items())
        + f" limit={STEP_RTOL}")
    if not all(e <= STEP_RTOL for e in errs.values()):
        raise PhaseError("card and CPU steps disagree")
    return errs


# --------------------------------------------------------------------------
# phase 6: the main path at full width
# --------------------------------------------------------------------------
def main_path(torch, entry, ck, device, smi="", nx=512, ny=128, nz=128,
              nsteps=20, samples=3, sample_steps=10):
    level, grid = entry.build_level(nx=nx, nz=nz, ny=ny, device=device)
    state = level.initial_state()
    energies = []

    def on_step(i, s, dt):
        energies.append(float(level.total_energy(s)))

    if device != "cpu":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    state = entry.run(level, state, nsteps, on_step=on_step)
    if device != "cpu":
        torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = ck.launch_counts()

    b = state.scalars[0]
    finite = all(bool(torch.isfinite(getattr(state, f)).all())
                 for f in ("vel", "scalars", "lam", "pressure"))
    bmin, bmax = float(b.min()), float(b.max())
    e0 = energies[0]
    emax = max(energies)
    say(f"main path {grid.nx} {nsteps} steps in {run_s:.2f} s "
        f"(with set-up): t={float(state.time):.4f} b in [{bmin:.6f}, "
        f"{bmax:.6f}] E0={e0:.6f} Emax={emax:.6f} finite={finite} "
        f"launches={json.dumps(launches)}")
    if not finite:
        raise PhaseError("non-finite state")
    if not (B_BOUNDS[0] < bmin and bmax < B_BOUNDS[1]):
        raise PhaseError(f"buoyancy out of {B_BOUNDS}")
    if emax > e0 * (1.0 + ENERGY_GROWTH):
        raise PhaseError("total energy grew")
    if not all(n > 0 for n in launches.values()):
        raise PhaseError("a CTU kernel was never launched on the main path")

    # timed samples: dt varies by 1e-6 relative on every call, one
    # synchronize per sample
    dt = level.compute_dt(state)
    k = 0
    times = []
    for _ in range(samples):
        if device != "cpu":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(sample_steps):
            k += 1
            state = level.advance(state, dt * (1.0 + 1e-6 * k))
        if device != "cpu":
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) / sample_steps)
    if not bool(torch.isfinite(state.vel).all()):
        raise PhaseError("non-finite state after the timed steps")
    ms = 1e3 * statistics.median(times)
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    say(f"main path timing {grid.nx}: ms/step={ms:.3f} samples="
        + ",".join(f"{1e3 * t:.3f}" for t in times)
        + f" cell-updates/s={grid.ncells / (ms * 1e-3):.4e}"
        f" peak_mem_bytes={peak} on {smi}")
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

    device = "cuda"
    smi = nvidia_smi_line()
    say(f"device: {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)} x"
        f"{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    ck.load()
    say(f"build: {time.perf_counter() - t0:.2f} s")
    for line in cuda_build.build_log("somar_ctu").splitlines():
        if "registers" in line or "spill" in line:
            say(f"  ptxas: {line.strip()}")

    errs = kernel_parity(torch, ck, device)
    timing = kernel_timing(torch, ck, device)
    step_parity(torch, entry, device)
    launches, _ = main_path(torch, entry, ck, device, smi)

    kernels = [{"name": name, "route": "cuda", "source": SOURCE,
                "replaces": REPLACES[name], "launches": launches[name],
                "max_abs_err": errs[name], "ms": timing[name][0],
                "plain_ms": timing[name][1]} for name in REPLACES]
    say(f"card: {smi}")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
