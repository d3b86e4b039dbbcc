"""The run driver of one level: time loop, dt assignment, plot and
checkpoint cadence (PyTorch port of the single-level parts of
`somar_tpu.driver`).

  * initial projections and the first dt, init_dt_multiplier times the CFL
    dt, then the lagged-pressure initialization; or a restart from
    amr.restart_file;
  * dt = min(compute_dt, max_dt_grow * dt, max_dt), or amr.fixed_dt;
  * a `halt` file in the output directory, polled every step, and SIGINT
    stop the run cleanly after the current step;
  * the scheduler hook, the plot_interval / plot_period /
    checkpoint_interval cadences, the amr.verbosity >= 2 diagnostics
    (energy, max|div|, max|lambda - 1|);
  * the concluding report (cell updates, cell-updates/s, elapsed time,
    peak host RSS and peak device memory), the timer report and the final
    checkpoint.

With the same parameters the loop takes the same steps as `entry.run`:
the same dt arithmetic in Python floats, so both give the same state.
Besides compute_dt's one read a step, the loop reads the state's time on
the host (its end condition, the step line, the plot period), each read
counted by `solvers/host_reads.read_scalars`.

Limits: `amr.maxlevel >= 1` raises (RunDriver, the CLI and the
checkpoints of an AMR run are slice 10 of the port, ROADMAP A.5; the
two-level hierarchy of slice 9 runs through
`entry.amr_hierarchy_from_context` and `entry.run_amr`); the run stays on
the one device it is given (the JAX driver's multi-device decomposition
is `parallel/`, ROADMAP A.7); there is no CPU fallback: without
device="cpu" the run is on the GPU or raises.
"""

from __future__ import annotations

import os
import resource
import signal
import time
from typing import Optional

import torch

from somar_tpu_torch.geometry.level_geometry import (
    build_level_geometry, require_device)
from somar_tpu_torch.io.checkpoint import (
    read_checkpoint, write_checkpoint, write_chombo_plotfile)
from somar_tpu_torch.physics.navier_stokes import NSLevel
from somar_tpu_torch.solvers.host_reads import read_scalars
from somar_tpu_torch.utils.debug import assert_finite_host
from somar_tpu_torch.utils.printing import pout, set_pout_dir
from somar_tpu_torch.utils.scheduler import Scheduler
from somar_tpu_torch.utils.timers import timer


def _time(state) -> float:
    """The state's time on the host: one counted device-to-host read."""
    return read_scalars(state.time)[0]


class RunDriver:
    def __init__(self, ctx, out_dir: str = ".", device="cuda"):
        if ctx.amr.max_level >= 1:
            raise NotImplementedError(
                f"amr.maxlevel = {ctx.amr.max_level}: RunDriver with AMR is "
                "slice 10 of the port (ROADMAP A.5); use amr.maxlevel = 0, "
                "or entry.amr_hierarchy_from_context and entry.run_amr")
        self.ctx = ctx
        self.out_dir = out_dir
        self.device = require_device(device)
        self.grid = ctx.base_grid()
        self.geo = build_level_geometry(self.grid, ctx.new_geo_source(),
                                        device=self.device,
                                        dtype=ctx.ns.dtype)
        self.problem = ctx.new_problem()
        self.level = NSLevel(self.geo, self.problem, ctx.ns)
        self._interrupted = False
        #: periodic in-run callbacks fn(step, time, state)
        self.scheduler = Scheduler()
        #: host wall seconds of each step: the advance (synchronized) and
        #: the reads of the new time and the next dt
        self.step_seconds = []
        #: cells updated and seconds of the last run's loop (files included)
        self.cell_updates = 0
        self.elapsed = 0.0
        set_pout_dir(out_dir)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _initial(self):
        """(state, dt) to start from: restored from amr.restart_file, or
        the projected initial state with its converged lagged pressure."""
        ctx, level, p = self.ctx, self.level, self.ctx.ns
        if ctx.amr.restart_file:
            state, step, dt = read_checkpoint(
                os.path.join(self.out_dir, ctx.amr.restart_file), level)
            return state, step, dt
        state = level.post_initialize(
            level.initial_state(),
            num_proj=max(1, ctx.amr.init_projection_iters))
        dt = min(level.compute_dt(state) * p.init_dt_multiplier, p.max_dt)
        if p.fixed_dt > 0.0:
            dt = p.fixed_dt
        state = level.initialize_pressure(
            state, dt, iters=max(1, ctx.amr.init_pressure_iters))
        return state, 0, dt

    # ---------------------------------------------------------------- run
    def run(self, max_steps: Optional[int] = None,
            final_time: Optional[float] = None, verbose: bool = True):
        """Step until step number max_steps (amr.maxsteps) or time
        final_time (amr.final).  Returns (state, step)."""
        ctx, level, p = self.ctx, self.level, self.ctx.ns
        plot = ctx.plot
        max_steps = ctx.amr.max_steps if max_steps is None else max_steps
        final_time = ctx.amr.final_time if final_time is None else final_time

        state, step, dt = self._initial()
        prev_handler = signal.signal(
            signal.SIGINT, lambda *_: setattr(self, "_interrupted", True))
        cell_updates = 0
        t_start = time.perf_counter()
        t_now = _time(state)
        last_plot_time = t_now
        state_old = None
        try:
            # max_steps is the largest step NUMBER, so a restarted run goes
            # on to the same absolute step count
            while step < max_steps and t_now < final_time:
                if self._interrupted or os.path.exists(
                        os.path.join(self.out_dir, "halt")):
                    if verbose:
                        print("halt requested — stopping cleanly")
                    break
                t0 = time.perf_counter()
                state_old = state
                with timer("advance"):
                    state = level.advance(state, dt)
                    self._sync()
                wc = time.perf_counter() - t0
                if ctx.amr.verbosity >= 3:
                    assert_finite_host(state.vel, f"step {step + 1} velocity")
                step += 1
                cell_updates += self.grid.ncells
                t_now = _time(state)
                # the next step's dt: CFL-limited, growth-capped
                dt = min(level.compute_dt(state), p.max_dt_grow * dt,
                         p.max_dt)
                if p.fixed_dt > 0.0:
                    dt = p.fixed_dt
                self.step_seconds.append(time.perf_counter() - t0)

                self.scheduler.execute(step, t_now, state)

                line = (f"step {step:6d}  t = {t_now:.6g}  dt = {dt:.4g}  "
                        f"wall = {wc * 1e3:.1f} ms")
                if ctx.amr.verbosity >= 2:
                    e, dmax, ldrift = read_scalars(
                        level.total_energy(state),
                        level.max_divergence(state),
                        torch.max(torch.abs(state.lam - 1.0)))
                    line += (f"  E = {e:.8g}  max|div| = {dmax:.3e}  "
                             f"max|lambda-1| = {ldrift:.3e}")
                pout(line)
                if verbose and ctx.amr.verbosity > 0:
                    print(line)

                do_plot = (plot.plot_interval > 0
                           and step % plot.plot_interval == 0)
                if plot.plot_period > 0 and \
                        t_now - last_plot_time >= plot.plot_period:
                    do_plot = True
                if do_plot:
                    last_plot_time = t_now
                    with timer("write_plotfile"):
                        write_chombo_plotfile(
                            os.path.join(self.out_dir,
                                         f"{plot.plot_prefix}{step:06d}."
                                         f"{self.grid.ndim}d.hdf5"),
                            state, level, step, plot, dt=dt)
                if plot.checkpoint_interval > 0 and \
                        step % plot.checkpoint_interval == 0:
                    with timer("write_checkpoint"):
                        write_checkpoint(
                            os.path.join(self.out_dir,
                                         f"{plot.checkpoint_prefix}"
                                         f"{step:06d}.hdf5"),
                            state, level, step, dt, old_state=state_old,
                            cfl=p.cfl)
        finally:
            signal.signal(signal.SIGINT, prev_handler)

        elapsed = time.perf_counter() - t_start
        self.cell_updates, self.elapsed = cell_updates, elapsed
        report = [f"total cell updates: {cell_updates}"]
        if elapsed > 0:
            report.append(f"cell updates/sec: {cell_updates / elapsed:.4g}")
        report.append(f"total elapsed: {elapsed:.2f} s")
        rss_mb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0
        report.append(f"peak host RSS: {rss_mb:.0f} MB")
        if self.device.type == "cuda":
            peak = torch.cuda.max_memory_allocated(self.device)
            total = torch.cuda.get_device_properties(self.device).total_memory
            report.append(f"peak device memory: {peak / 2**20:.0f} MB of "
                          f"{total / 2**20:.0f} MB")
        report.append(timer.report())
        for line in report:
            pout(line)
        if verbose:
            for line in report[:-1]:
                print(line)
            if ctx.amr.verbosity >= 2:
                print(report[-1])
        write_checkpoint(
            os.path.join(self.out_dir,
                         f"{plot.checkpoint_prefix}final.hdf5"),
            state, level, step, dt, old_state=state_old, cfl=p.cfl)
        return state, step
