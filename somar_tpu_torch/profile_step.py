"""Where the time of the port's PPM step goes on one GPU.

    python3 -m somar_tpu_torch.profile_step [--nx 512 --ny 128 --nz 128]
                                            [--pressure-solver auto|mg]
                                            [--steps 5] [--trace FILE]

Builds the lock-exchange level of `entry.build_level` (with
`--pressure-solver mg` the multigrid-forced one, MGParams(eps=1e-5,
imax=12)), runs 10 steps of `entry.run` (initial projections,
pressure initialization, dt ramped up as that time loop does), then
profiles `--steps` steps at the loop's last dt with torch.profiler (CPU +
CUDA activities).  Prints the
wall ms/step, the device time per step split into groups (the CTU kernels
K1-K4, the GSRB kernels K5-K6, matmuls of the spectral solves, torch.cat
copies of the ghost fills and shifts, other elementwise and reduction
kernels), the device-busy share (device time / wall time), the host reads
per step and the 20 kernels with the most device time.  --trace writes a
Chrome trace of the profiled window.
"""

from __future__ import annotations

import argparse
import time

import torch

from somar_tpu_torch import entry
from somar_tpu_torch.solvers.host_reads import read_scalars
from somar_tpu_torch.solvers.multigrid import MGParams

#: steps of entry.run before the profiled window: past the pressure
#: initialization and the ramp of dt from its first tenth
WARMUP_STEPS = 10

GROUPS = (
    ("CTU kernels K1-K4", ("ppm_predict_kernel", "ctu_corr3_kernel",
                           "ctu_final_kernel", "riemann_fluxdiv_kernel")),
    ("GSRB kernels K5-K6", ("gsrb_half_kernel", "helm_residual_kernel")),
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
    ap.add_argument("--pressure-solver", default="auto",
                    choices=("auto", "mg"))
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--trace", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a CUDA device")

    level, grid = entry.build_level(
        nx=args.nx, nz=args.nz, ny=args.ny, device="cuda",
        pressure_solver=args.pressure_solver,
        mg=MGParams(eps=1e-5, imax=12))
    dts = []
    state = entry.run(level, level.initial_state(), WARMUP_STEPS,
                      on_step=lambda i, s, dt: dts.append(dt))
    dt = dts[-1]
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        reads0 = read_scalars.count
        t0 = time.perf_counter()
        for k in range(args.steps):
            state = level.advance(state, dt * (1.0 + 1e-6 * (k + 1)))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / args.steps
        reads = (read_scalars.count - reads0) / args.steps
    if args.trace:
        prof.export_chrome_trace(args.trace)
    if not bool(torch.isfinite(state.vel).all()):
        raise SystemExit("profile_step: the profiled steps left a "
                         "non-finite state")

    kernels, counts = {}, {}
    for evt in prof.key_averages():
        us = evt.self_device_time_total
        if us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels[evt.key] = kernels.get(evt.key, 0.0) + us
            counts[evt.key] = counts.get(evt.key, 0) + evt.count
    launches = sum(counts.values())
    total_ms = sum(kernels.values()) / 1e3 / args.steps
    print(f"grid {grid.nx} pressure solver {level.projector.method}: wall "
          f"{1e3 * wall:.3f} ms/step, device {total_ms:.3f} ms/step, "
          f"device-busy share {total_ms / (1e3 * wall):.3f}, "
          f"{launches / args.steps:.0f} kernel launches/step, "
          f"{reads:.1f} solver host reads/step (compute_dt adds 1 in a run)")
    if not kernels:
        print("the profiler recorded no device time")
        return 1
    groups, group_counts = {}, {}
    for name, us in kernels.items():
        g = _group(name)
        groups[g] = groups.get(g, 0.0) + us
        group_counts[g] = group_counts.get(g, 0) + counts[name]
    for g, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        ms = us / 1e3 / args.steps
        print(f"  {g:28s} {ms:9.3f} ms/step  {ms / total_ms:6.1%}  "
              f"{group_counts[g] / args.steps:8.0f} launches/step")
    print("top kernels (ms/step):")
    for name, us in sorted(kernels.items(), key=lambda kv: -kv[1])[:20]:
        print(f"  {us / 1e3 / args.steps:9.3f}  {name[:110]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
