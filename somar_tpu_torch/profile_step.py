"""Where the time of the port's step goes on one GPU.

    python3 -m somar_tpu_torch.profile_step [--config lock|beam|amr]
                                            [--nx N --ny N --nz N]
                                            [--pressure-solver auto|mg]
                                            [--scheme ppm|rk3]
                                            [--steps 5] [--trace FILE]

`--config lock` (default) builds the lock-exchange level of
`entry.build_level` (512x128x128; with `--pressure-solver mg` the
multigrid-forced one, MGParams(eps=1e-5, imax=12); with `--scheme rk3`
the same level stepped by the RK3 scheme); `--config beam` the
BeamGeneration level of `entry.build_beam_level` (640x512, mapped metric,
implicit gravity, multigrid everywhere).  Runs 10 steps of `entry.run`
(initial projections, pressure initialization, dt ramped up as that time
loop does; 3 for beam), then profiles `--steps` steps at the loop's last
dt with torch.profiler (CPU + CUDA activities).  Prints the wall ms/step,
the device time per step split into groups (the CTU kernels K1-K4, the
GSRB kernels K5-K6, the probed-stencil kernels K7-K8, matmuls of the
spectral solves, torch.cat copies of the ghost fills and shifts, other
elementwise and reduction kernels), the device-busy share (device time /
wall time), the host reads per step and the 20 kernels with the most
device time, each with its launches per step.  For beam it then
profiles, alone, the delta-weight probes that set up one implicit-gravity
CC solve (PoissonOp.delta_kernel_overrides on every MG level).  --trace
writes a Chrome trace of the profiled window.

`--config amr` builds the two-level hierarchy of
`entry.build_amr_hierarchy` (base 64x96x64 unless --nx/--ny/--nz say
otherwise, ratio (4,1,1), the chip smoke's A1 stand-ins), places and
projects it, takes 2 coarse steps at dt 0.01 and profiles `--steps`
coarse steps the same way, with the host wall time (synchronized) of
each part of a coarse step: the base advance, the patch's substep
advances, the transfers of the substep loop (time interpolation, halo
fill and overwrite, CF rings, average-down) and the sync projection
(with the transfers it makes, which are also given apart).
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from somar_tpu_torch import entry
from somar_tpu_torch.physics.navier_stokes import NSLevel
from somar_tpu_torch.solvers.host_reads import read_scalars
from somar_tpu_torch.solvers.multigrid import MGParams

#: steps of entry.run before the profiled window: past the pressure
#: initialization and the ramp of dt from its first tenth
WARMUP_STEPS = 10

GROUPS = (
    ("CTU kernels K1-K4", ("ppm_predict_march_kernel",
                           "ppm_predict_row_kernel", "ctu_corr3_kernel",
                           "ctu_final_kernel", "riemann_fluxdiv_kernel")),
    # before K5-K6: K6's name is a substring of K8's
    ("stencil kernels K7-K8", ("stencil_gsrb_whole_kernel",
                               "stencil_gsrb_tiled_kernel",
                               "stencil_helm_residual_kernel")),
    ("GSRB kernels K5-K6", ("uniform_gsrb_whole_kernel",
                            "uniform_gsrb_tiled_kernel",
                            "helm_residual_kernel")),
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


def _device_summary(prof, nsteps):
    """({kernel: device us}, {kernel: launches}, total device ms per
    step) of a profiled window."""
    kernels, counts = {}, {}
    for evt in prof.key_averages():
        us = evt.self_device_time_total
        if us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels[evt.key] = kernels.get(evt.key, 0.0) + us
            counts[evt.key] = counts.get(evt.key, 0) + evt.count
    return kernels, counts, sum(kernels.values()) / 1e3 / nsteps


def _profile_probes(level, acts, dt):
    """Device time and launches of the delta-weight probes of one
    implicit-gravity CC solve, profiled alone."""
    am = level._altered_metric
    mg = level.projector._mg_for("cc")
    deltas = am.jgup_delta_list(dt * level.params.gravity_theta)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for op, jd in zip(mg.ops, deltas):
            op.delta_kernel_overrides(jd)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _, counts, ms = _device_summary(prof, 1)
    print(f"  probe/override set-up of one IG CC solve ({len(mg.ops)} MG "
          f"levels): wall {1e3 * wall:.3f} ms, device {ms:.3f} ms, "
          f"{sum(counts.values())} launches")


#: the parts of a coarse step, as record_function labels
AMR_PARTS = ("base advance", "patch advance", "transfers (substeps)",
             "sync projection", "transfers (sync)")


def _label_parts(h, walls):
    """Wrap the hierarchy's parts in record_function ranges (one label
    each; the coupling's transfers are labelled by where they are called
    from) that also sum their host wall time, synchronized, into walls."""
    from somar_tpu_torch.amr import hierarchy as hmod
    c = h.couplings[0]
    where = {"sync": False}

    def wrap(obj, name, label):
        fn = getattr(obj, name)

        def run(*a, **k):
            lab = label() if callable(label) else label
            with torch.profiler.record_function(lab):
                if lab == "sync projection":
                    where["sync"] = True
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    torch.cuda.synchronize()
                    walls[lab] = walls.get(lab, 0.0) + (
                        time.perf_counter() - t0)
                    if lab == "sync projection":
                        where["sync"] = False

        setattr(obj, name, run)

    transfers = lambda: ("transfers (sync)" if where["sync"]
                         else "transfers (substeps)")
    wrap(h.level0, "advance", "base advance")
    wrap(c.level, "advance", "patch advance")
    wrap(h, "_sync_project", "sync projection")
    for name in ("_interp_state_ext", "_overwrite_halo", "_ring",
                 "average_down"):
        wrap(c, name, transfers)
    wrap(hmod, "time_interp", transfers)


def _amr_main(args, acts) -> int:
    """--config amr: see the module docstring."""
    nx = (args.nx or 64, args.ny or 96, args.nz or 64)
    h = entry.build_amr_hierarchy(*nx, (4, 1, 1), device="cuda",
                                  mg=MGParams(eps=1e-5, imax=12))
    s0, fine, origin = entry.place_amr(h)
    dt = 0.01
    s0, fine = entry.run_amr(h, s0, fine, origin, dt, 2)
    walls = {}
    _label_parts(h, walls)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        reads0 = read_scalars.count
        t0 = time.perf_counter()
        for k in range(args.steps):
            s0, fine = h.advance(s0, fine, origin, dt * (1.0 + 1e-6 * k))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / args.steps
        reads = (read_scalars.count - reads0) / args.steps
    if args.trace:
        prof.export_chrome_trace(args.trace)
    kernels, counts, _ = _device_summary(prof, args.steps)
    # the parts' ranges appear as device spans too: count kernels only
    for part in AMR_PARTS:
        kernels.pop(part, None)
        counts.pop(part, None)
    total_ms = sum(kernels.values()) / 1e3 / args.steps
    c = h.couplings[0]
    print(f"AMR base {h.grid0.nx} patch ext {c.ext_nx} nt {c.nt}: wall "
          f"{1e3 * wall:.3f} ms/coarse step (parts synchronized), device "
          f"{total_ms:.3f} ms/coarse step, device-busy share "
          f"{total_ms / (1e3 * wall):.3f}, "
          f"{sum(counts.values()) / args.steps:.0f} launches/coarse step, "
          f"{reads:.1f} host reads/coarse step")
    for part in AMR_PARTS:
        ms = 1e3 * walls.get(part, 0.0) / args.steps
        print(f"  {part:22s} wall {ms:9.3f} ms per coarse step")
    groups, group_counts = {}, {}
    for name, us in kernels.items():
        g = _group(name)
        groups[g] = groups.get(g, 0.0) + us
        group_counts[g] = group_counts.get(g, 0) + counts[name]
    for g, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        ms = us / 1e3 / args.steps
        print(f"  {g:28s} {ms:9.3f} ms/coarse step  {ms / total_ms:6.1%}  "
              f"{group_counts[g] / args.steps:8.0f} launches/coarse step")
    return 0 if kernels else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="lock",
                    choices=("lock", "beam", "amr"))
    ap.add_argument("--nx", type=int, default=None)
    ap.add_argument("--ny", type=int, default=None)
    ap.add_argument("--nz", type=int, default=None)
    ap.add_argument("--pressure-solver", default="auto",
                    choices=("auto", "mg"))
    ap.add_argument("--scheme", default="ppm", choices=("ppm", "rk3"))
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--trace", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a CUDA device")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    if args.config == "amr":
        return _amr_main(args, acts)

    if args.config == "beam":
        level, grid = entry.build_beam_level(args.nx or 640, args.nz or 512,
                                             device="cuda")
        warmup = 3
    else:
        level, grid = entry.build_level(
            nx=args.nx or 512, nz=args.nz or 128, ny=args.ny or 128,
            device="cuda",
            pressure_solver=args.pressure_solver,
            mg=MGParams(eps=1e-5, imax=12))
        if args.scheme == "rk3":
            level = NSLevel(level.geo, level.problem, dataclasses.replace(
                level.params, update_scheme="rk3"))
        warmup = WARMUP_STEPS
    dts = []
    state = entry.run(level, level.initial_state(), warmup,
                      on_step=lambda i, s, dt: dts.append(dt))
    dt = dts[-1]
    torch.cuda.synchronize()

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

    kernels, counts, total_ms = _device_summary(prof, args.steps)
    launches = sum(counts.values())
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
    print("top kernels (ms/step, launches/step):")
    for name, us in sorted(kernels.items(), key=lambda kv: -kv[1])[:20]:
        print(f"  {us / 1e3 / args.steps:9.3f} {counts[name] / args.steps:7.1f}"
              f"  {name[:100]}")
    if level._altered_metric is not None:
        _profile_probes(level, acts, dt)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
