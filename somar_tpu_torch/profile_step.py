"""Where the time of the port's PPM step goes on one GPU.

    python3 -m somar_tpu_torch.profile_step [--nx 512 --ny 128 --nz 128]
                                            [--steps 5] [--trace FILE]

Builds the lock-exchange level of `entry.build_level`, runs
post_initialize and two warm-up steps, then profiles `--steps` steps with
torch.profiler (CPU + CUDA activities).  Prints the wall ms/step, the
device time per step split into groups (the CTU kernels K1-K4, matmuls of
the spectral solves, torch.cat copies of the ghost fills and shifts, other
elementwise and reduction kernels), the device-busy share (device time /
wall time) and the 20 kernels with the most device time.  --trace writes
a Chrome trace of the profiled window.
"""

from __future__ import annotations

import argparse
import time

import torch

from somar_tpu_torch import entry

GROUPS = (
    ("CTU kernels K1-K4", ("ppm_predict_kernel", "ctu_corr3_kernel",
                           "ctu_final_kernel", "riemann_fluxdiv_kernel")),
    ("matmul (spectral solves)", ("gemm", "gemv")),
    ("cat (ghost fills, shifts)", ("catarray",)),
    ("reductions", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized")),
)


def _group(name: str) -> str:
    low = name.lower()
    for label, keys in GROUPS:
        if any(k in low for k in keys):
            return label
    return "other"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nx", type=int, default=512)
    ap.add_argument("--ny", type=int, default=128)
    ap.add_argument("--nz", type=int, default=128)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--trace", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a CUDA device")

    level, grid = entry.build_level(nx=args.nx, nz=args.nz, ny=args.ny,
                                    device="cuda")
    state = entry.run(level, level.initial_state(), 2)
    dt = level.compute_dt(state)
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for k in range(args.steps):
            state = level.advance(state, dt * (1.0 + 1e-6 * (k + 1)))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / args.steps
    if args.trace:
        prof.export_chrome_trace(args.trace)

    kernels = {}
    launches = 0
    for evt in prof.key_averages():
        us = evt.self_device_time_total
        if us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels[evt.key] = kernels.get(evt.key, 0.0) + us
            launches += evt.count
    total_ms = sum(kernels.values()) / 1e3 / args.steps
    print(f"grid {grid.nx}: wall {1e3 * wall:.3f} ms/step, device "
          f"{total_ms:.3f} ms/step, device-busy share "
          f"{total_ms / (1e3 * wall):.3f}, {launches / args.steps:.0f} "
          f"kernel launches/step")
    if not kernels:
        print("the profiler recorded no device time")
        return 1
    groups = {}
    for name, us in kernels.items():
        g = _group(name)
        groups[g] = groups.get(g, 0.0) + us
    for g, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        ms = us / 1e3 / args.steps
        print(f"  {g:28s} {ms:9.3f} ms/step  {ms / total_ms:6.1%}")
    print("top kernels (ms/step):")
    for name, us in sorted(kernels.items(), key=lambda kv: -kv[1])[:20]:
        print(f"  {us / 1e3 / args.steps:9.3f}  {name[:110]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
