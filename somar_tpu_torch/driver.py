"""The run driver: time loop, dt assignment, plot and checkpoint cadence
(PyTorch port of `somar_tpu.driver`).

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

With amr.maxlevel >= 1 the run is an AMR hierarchy of that many nested
refined levels (`entry.amr_hierarchy_from_context`): the patches are
placed on the initialized base state, projected with the composite
initial projection and their pressures initialized by dummy coarse steps;
each coarse step takes the dynamic-subcycling factors of
`subcycle_multipliers` (unless amr.fixed_dt is set or subcycling is off),
regrids where a level's amr.regrid_intervals is due (the shallowest level
due sets from_level; right-sizing K and the footprint; the previous
step's snapshot is re-pointed at the new patches when any level's shapes
changed), takes the next dt from `level_dts`, and writes every refined
level into plot files and checkpoints; a restart restores the patches,
their K, footprints, origins, weights and parent selections exactly.
Cell updates count (product of the substep counts down to the level) K
prod(ext) per refined level beside the base cells.

With the same parameters the single-level loop takes the same steps as
`entry.run`: the same dt arithmetic in Python floats, so both give the
same state.  Besides compute_dt's one read a step, the loop reads the
state's time on the host (its end condition, the step line, the plot
period), each read counted by `solvers/host_reads.read_scalars`.

Limits: the run stays on the one device it is given (the JAX driver's
multi-device decomposition is `parallel/`, ROADMAP A.7); there is no CPU
fallback: without device="cpu" the run is on the GPU or raises.
"""

from __future__ import annotations

import dataclasses
import math
import os
import resource
import signal
import time
from typing import Optional

import numpy as np
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


def level_log(h):
    """Per refined level of hierarchy h: its K, origins, weights, parent
    selections, ext and tag coverage as placed (host values)."""
    return [dict(K=c.K, origins=np.asarray(c.origin_f).tolist(),
                 weights=None if c.weights is None else c.weights.tolist(),
                 parent_sel=(None if c.parent_sel is None
                             else c.parent_sel.tolist()),
                 ext=list(c.ext_nx), tag_coverage=tuple(c.tag_coverage))
            for c in h.couplings]


def _time(state) -> float:
    """The state's time on the host: one counted device-to-host read."""
    return read_scalars(state.time)[0]


class RunDriver:
    def __init__(self, ctx, out_dir: str = ".", device="cuda"):
        self.ctx = ctx
        self.out_dir = out_dir
        self.device = require_device(device)
        self.grid = ctx.base_grid()
        #: the AMR hierarchy (amr.maxlevel >= 1), else None
        self.hierarchy = None
        if ctx.amr.max_level >= 1:
            from somar_tpu_torch.entry import amr_hierarchy_from_context
            self.hierarchy = amr_hierarchy_from_context(ctx, self.device)
            self.level = self.hierarchy.level0
            self.geo = self.level.geo
            self.problem = self.level.problem
            self.regrid_intervals = self.hierarchy.regrid_intervals
        else:
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
        #: AMR: the refined levels' states, origins and weights (tuples,
        #: one entry per refined level) at the end of the last run; the dt
        #: and the dynamic-subcycling factors of each step; per regrid a
        #: dict of step, seconds (of which refresh_seconds rebuilt mapped
        #: slots, slots_built of them), from_level and `levels`, per
        #: refined level its K, origins, weights, parent selections, ext
        #: and tag coverage (`level_log`)
        self.fine_state = self.origin = self.weights = None
        self.dts, self.nt_mults, self.regrids = [], [], []
        set_pout_dir(out_dir)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _fine_grids(self):
        return [c.ext_grid for c in self.hierarchy.couplings]

    def _initial(self):
        """(state, step, dt, fine) to start from: restored from
        amr.restart_file, or the projected initial state with its
        converged lagged pressure; fine is the refined levels' (states,
        origins, weights) tuples, or None without AMR."""
        ctx, level, p = self.ctx, self.level, self.ctx.ns
        h = self.hierarchy
        if ctx.amr.restart_file:
            got = read_checkpoint(
                os.path.join(self.out_dir, ctx.amr.restart_file), level,
                fine_grid=None if h is None else self._fine_grids())
            if h is None:
                return got + (None,)
            if len(got) <= 3:
                raise ValueError("the checkpoint holds no refined level")
            state, step, dt, fines, origins, weights, psels = got
            return state, step, dt, h.restore(fines, origins, weights,
                                              psels)
        state = level.post_initialize(
            level.initial_state(),
            num_proj=max(1, ctx.amr.init_projection_iters))
        dt = min(level.compute_dt(state) * p.init_dt_multiplier, p.max_dt)
        if p.fixed_dt > 0.0:
            dt = p.fixed_dt
        state = level.initialize_pressure(
            state, dt, iters=max(1, ctx.amr.init_pressure_iters))
        if h is None:
            return state, 0, dt, None
        got = h.initial_patch_states(state)
        fine, origin = got[0], got[1]
        weights = got[2] if len(got) > 2 else (None,) * len(fine)
        state, fine = h.init_project(
            state, fine, origin, weights=weights, parent_sels=h.parent_sels,
            iters=max(1, ctx.amr.init_projection_iters))
        if ctx.amr.init_pressure_iters > 0:
            state, fine = h.initialize_pressure(
                state, fine, origin, dt, weights=weights,
                parent_sels=h.parent_sels,
                iters=max(1, ctx.amr.init_pressure_iters))
        return state, 0, dt, (tuple(fine), tuple(origin), tuple(weights))

    def _amr_step(self, state, fine, origin, weights, dt, level_dts):
        """One coarse step of the hierarchy with its dynamic-subcycling
        factors.  Returns (state, fine, cell updates of the refined
        levels)."""
        ctx, h = self.ctx, self.hierarchy
        nt_mults = (1,) * len(h.couplings)
        if ctx.ns.fixed_dt <= 0.0 and ctx.amr.use_subcycling:
            nt_mults = h.subcycle_multipliers(dt, level_dts)
            if any(m > 1 for m in nt_mults) and ctx.amr.verbosity >= 2:
                pout(f"  subcycling: factors {nt_mults}")
        self.nt_mults.append(nt_mults)
        state, fine = h.advance(state, fine, origin, dt, weights=weights,
                                nt_mults=nt_mults,
                                parent_sels=h.parent_sels)
        updates, factor = 0, 1
        for c, m in zip(h.couplings, nt_mults):
            factor *= c.nt * m
            updates += factor * c.K * math.prod(c.ext_nx)
        return state, tuple(fine), updates

    def _amr_regrid(self, step, state, fine, fine_old, dt):
        """The regrid due at this step, if any: the shallowest level due
        sets from_level.  Returns (fine, origin, weights, fine_old), the
        old snapshot re-pointed at the new patches when their shapes
        changed; None when no regrid is due."""
        due = [lev for lev, iv in enumerate(self.regrid_intervals)
               if iv > 0 and step % iv == 0]
        if not due:
            return None
        h = self.hierarchy
        t0 = time.perf_counter()
        r0, n0 = h.refresh_seconds, h.slots_built
        with timer("regrid"):
            got = h.regrid(state, fine, dt=dt, from_level=min(due))
        fine, origin = tuple(got[0]), tuple(got[1])
        weights = tuple(got[2]) if len(got) > 2 else (None,) * len(fine)
        self._sync()
        self.regrids.append(dict(
            step=step, seconds=time.perf_counter() - t0,
            refresh_seconds=h.refresh_seconds - r0,
            slots_built=h.slots_built - n0,
            from_level=min(due), levels=level_log(h)))
        shapes = lambda fs: [tuple(getattr(f, n.name).shape) for f in fs
                             for n in dataclasses.fields(f)]
        if shapes(fine_old) != shapes(fine):
            fine_old = fine
        return fine, origin, weights, fine_old

    def _amr_next_dt(self, state, fine, dt):
        """(level_dts, the next coarse dt) from the levels' CFL dts."""
        p, h = self.ctx.ns, self.hierarchy
        level_dts = h.level_dts(state, fine)
        dt_new, f = level_dts[0], 1
        for c, d in zip(h.couplings, level_dts[1:]):
            f *= c.nt
            dt_new = min(dt_new, f * d)
        dt = min(dt_new, p.max_dt_grow * dt, p.max_dt)
        return level_dts, (p.fixed_dt if p.fixed_dt > 0.0 else dt)

    def _amr_files(self, fine, origin, fine_old):
        """The keyword arguments of write_checkpoint for the hierarchy."""
        h = self.hierarchy
        if h is None:
            return {}
        return dict(fine_state=fine, fine_grid=self._fine_grids(),
                    origin=[np.asarray(o) for o in origin],
                    weights=[None if c.weights is None
                             else np.asarray(c.weights)
                             for c in h.couplings],
                    parent_sels=[None if c.parent_sel is None
                                 else np.asarray(c.parent_sel)
                                 for c in h.couplings],
                    old_fine=fine_old, hierarchy=h)

    # ---------------------------------------------------------------- run
    def run(self, max_steps: Optional[int] = None,
            final_time: Optional[float] = None, verbose: bool = True):
        """Step until step number max_steps (amr.maxsteps) or time
        final_time (amr.final).  Returns (state, step)."""
        ctx, level, p = self.ctx, self.level, self.ctx.ns
        plot = ctx.plot
        max_steps = ctx.amr.max_steps if max_steps is None else max_steps
        final_time = ctx.amr.final_time if final_time is None else final_time

        state, step, dt, amr = self._initial()
        h = self.hierarchy
        fine = origin = weights = level_dts = None
        if h is not None:
            fine, origin, weights = amr
            level_dts = h.level_dts(state, fine)
        prev_handler = signal.signal(
            signal.SIGINT, lambda *_: setattr(self, "_interrupted", True))
        cell_updates = 0
        t_start = time.perf_counter()
        t_now = _time(state)
        last_plot_time = t_now
        state_old = fine_old = None
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
                state_old, fine_old = state, fine
                self.dts.append(dt)
                with timer("advance"):
                    if h is None:
                        state = level.advance(state, dt)
                    else:
                        state, fine, updates = self._amr_step(
                            state, fine, origin, weights, dt, level_dts)
                        cell_updates += updates
                    self._sync()
                wc = time.perf_counter() - t0
                if ctx.amr.verbosity >= 3:
                    assert_finite_host(state.vel, f"step {step + 1} velocity")
                step += 1
                cell_updates += self.grid.ncells
                if h is not None:
                    got = self._amr_regrid(step, state, fine, fine_old, dt)
                    if got is not None:
                        fine, origin, weights, fine_old = got
                t_now = _time(state)
                # the next step's dt: CFL-limited, growth-capped
                if h is None:
                    dt = min(level.compute_dt(state), p.max_dt_grow * dt,
                             p.max_dt)
                    if p.fixed_dt > 0.0:
                        dt = p.fixed_dt
                else:
                    level_dts, dt = self._amr_next_dt(state, fine, dt)
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
                            state, level, step, plot, hierarchy=h,
                            fine_states=fine, dt=dt)
                if plot.checkpoint_interval > 0 and \
                        step % plot.checkpoint_interval == 0:
                    with timer("write_checkpoint"):
                        write_checkpoint(
                            os.path.join(self.out_dir,
                                         f"{plot.checkpoint_prefix}"
                                         f"{step:06d}.hdf5"),
                            state, level, step, dt, old_state=state_old,
                            cfl=p.cfl,
                            **self._amr_files(fine, origin, fine_old))
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
            state, level, step, dt, old_state=state_old, cfl=p.cfl,
            **self._amr_files(fine, origin, fine_old))
        self.fine_state, self.origin, self.weights = fine, origin, weights
        return state, step
