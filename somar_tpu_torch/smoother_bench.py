"""Times of the red-black smoothers K5 and K7 on one GPU, per call.

    python3 -m somar_tpu_torch.smoother_bench [--root DIR] [--out FILE]

Imports the `somar_tpu_torch` package found under --root (default: the
current directory), so that one call can time two trees of the repository
in turns.  Uses only wrapper arguments that every version of the port
takes.  Every measurement follows 0.2 s of back-to-back calls.  Per case
(f32, random phi and rhs, alpha = 0, beta = 1):

  * ms      median over 50 calls of a CUDA-event pair around one call;
  * dev_ms  device time per call of every kernel the call launches: the
            median of 5 windows of 20 calls (torch.profiler), each after
            50 ms of back-to-back calls, so that the card runs at its
            clocks under load;
  * host_us host clock over 1,000 calls with no synchronize, per call: the
            host's cost of a call while the device keeps up (where the
            device is slower, the launch queue fills and this is the
            device's rate);
  * launches per call, and the least time the card could take for one
            sweep's bytes (`bound_ms`, each array read or written once);
  * sm_clock the SM clock nvidia-smi reads right after the measurements.

Cases: K5 at (128,128,512), the finest level of main path 2, 1 and 4
sweeps, and at (16,16,64), 4 sweeps; K7 at (512,640), the finest level of
main path 3 (K = 8), 1 and 4 sweeps, at (32,320), 4 sweeps, and at a
twisted 3D level (128,256,256) (K = 18), 1 sweep.  Prints one JSON object
per case and writes the list to --out.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (data sheet)


def _k5_plan(gk, shape):
    from somar_tpu_torch.core.bc import BC, FieldBCs
    from somar_tpu_torch.core.grid import Grid
    nx = shape[::-1]
    grid = Grid(nx=nx, dx=(15.0 / nx[0], 2.0 / nx[1], 2.0 / nx[2]),
                periodic=(False, True, False))
    bcs = (BC.neumann(), BC.periodic(), BC.neumann())
    return gk.make_plan(grid, FieldBCs(lo=bcs, hi=bcs))


def _k7_plan(shape, device):
    import numpy as np
    import torch
    from somar_tpu_torch import entry
    from somar_tpu_torch.core.bc import BC, FieldBCs
    from somar_tpu_torch.core.grid import Grid
    from somar_tpu_torch.geometry import bathymetric, geo_source
    from somar_tpu_torch.geometry.level_geometry import build_level_geometry
    from somar_tpu_torch.solvers.poisson_op import PoissonOp
    nx = shape[::-1]
    if len(shape) == 2:
        Lx, H = entry.BEAM_LENGTH, entry.BEAM_DEPTH
        grid = Grid(nx=nx, dx=(Lx / nx[0], H / nx[1]), x0=(-Lx / 2, 0.0))
        src = bathymetric.BeamGeneratorMap(
            (0.0, H), full_depth=H,
            angle=float(np.deg2rad(entry.BEAM_ALPHA_DEG)), lx=Lx)
        lo = hi = (BC.neumann(), BC.neumann())
    else:
        grid = Grid(nx=nx, dx=tuple(1.0 / n for n in nx),
                    periodic=(True, True, False))
        src = geo_source.TwistedMap((0.07,) * 3, (1.0,) * 3)
        lo = (BC.periodic(), BC.periodic(), BC.neumann())
        hi = (BC.periodic(), BC.periodic(), BC.dirichlet())
    geo = build_level_geometry(grid, src, device=device, dtype=torch.float32)
    plan = PoissonOp(geo, FieldBCs(lo=lo, hi=hi))._stencil_plan
    if plan is None:
        raise RuntimeError(f"no stencil plan at {shape}")
    return plan


def warm(torch, fn, seconds=0.2):
    """Run fn back to back for `seconds` so that the card is at its clocks
    under load before a measurement."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(10):
            fn()
        torch.cuda.synchronize()


def device_ms(torch, fn, names=None, calls=20, windows=5):
    """Device time per call of fn in CUDA kernels (those whose name contains
    one of `names`, or all): median over `windows` profiled windows of
    `calls` calls, each after a warm-up; windows where the profiler
    recorded nothing are left out."""
    vals = []
    for _ in range(windows):
        warm(torch, fn, 0.05)
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and (names is None or any(n in e.key for n in names)))
        if us > 0:
            vals.append(us / 1e3 / calls)
    return statistics.median(vals) if vals else float("nan")


def _time(torch, fn, mod):
    """(events ms, device ms, host us, launches) per call of fn."""
    warm(torch, fn)
    samples = []
    for _ in range(50):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        samples.append((a, b))
    torch.cuda.synchronize()
    ms = statistics.median(a.elapsed_time(b) for a, b in samples)
    dev_ms = device_ms(torch, fn)
    warm(torch, fn, 0.05)
    t0 = time.perf_counter()
    for _ in range(1000):
        fn()
    host_us = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    mod.reset_launch_counts()
    fn()
    torch.cuda.synchronize()
    launches = sum(mod.launch_counts().values())
    return ms, dev_ms, host_us, launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.getcwd())
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("smoother_bench needs a CUDA device")
    from somar_tpu_torch.ops import gsrb_kernels as gk
    from somar_tpu_torch.ops import stencil_gsrb_kernels as sgk
    import somar_tpu_torch
    device = "cuda"
    gen = torch.Generator(device=device).manual_seed(99)
    rows = []
    cases = [("K5", (128, 128, 512), 1), ("K5", (128, 128, 512), 4),
             ("K5", (16, 16, 64), 4), ("K7", (512, 640), 1),
             ("K7", (512, 640), 4), ("K7", (32, 320), 4),
             ("K7", (128, 256, 256), 1)]
    plans = {}
    for kernel, shape, iters in cases:
        if (kernel, shape) not in plans:
            plans[kernel, shape] = (_k5_plan(gk, shape) if kernel == "K5"
                                    else _k7_plan(shape, device))
        plan = plans[kernel, shape]
        phi, rhs = (torch.randn(shape, generator=gen, device=device)
                    for _ in range(2))
        if kernel == "K5":
            mod, arrays, K = gk, 3, None
            fn = lambda: gk.gsrb_sweeps(plan, phi, rhs, 0.0, 1.0, iters)
        else:
            mod, K = sgk, plan.K
            arrays = K + 5
            fn = lambda: sgk.stencil_gsrb_sweeps(plan, phi, rhs, 0.0, 1.0,
                                                 iters)
        ms, dev_ms, host_us, launches = _time(torch, fn, mod)
        clock = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
            capture_output=True, text=True).stdout.strip()
        bound = 1e3 * arrays * phi.numel() * 4 / HBM_BYTES_PER_S
        row = dict(kernel=kernel, shape=list(shape), K=K, iters=iters,
                   ms=ms, dev_ms=dev_ms, host_us=host_us, launches=launches,
                   dev_ms_per_sweep=dev_ms / iters, bound_ms_per_sweep=bound,
                   sm_clock=clock,
                   root=os.path.dirname(somar_tpu_torch.__file__))
        print(json.dumps(row), flush=True)
        rows.append(row)
        del phi, rhs
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
