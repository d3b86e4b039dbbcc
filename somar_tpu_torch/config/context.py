"""ProblemContext: the typed run configuration and its factories (the
port's counterpart of `somar_tpu.config.context`).

Reads the whole input file once through ParmParse (the key names of the
reference's input files; namespaces amr./geometry./plot./ibc./advection./
projection./AMRMG./bottom.) into typed dataclasses, and builds the
coordinate map (`new_geo_source`) and the problem (`new_problem`).

`amr.precision = 64` selects `torch.float64` for `NSParams.dtype`; no
process-wide switch is flipped (the JAX package turns on jax x64 there).
The per-solver multigrid blocks of AMR, `syncProjection_*` and `VD_*`, go
into NSParams (`mg_sync`, `mg_vd`) as in the JAX package.

Enums: CoordMap 0=Cartesian, 1=Twisted, 2=BeamGenerator, 4=Cylindrical,
5=Ledge, 8=DEM; ProblemType 0=AdvectionTest, 1=LockExchange,
2=BeamGeneration, 3=InternalWave, 4=TaylorGreen, 5=VortexStreet,
6=HorizConv, 7=SolitaryWave, 8=DJL.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

import torch

from somar_tpu_torch.config.parmparse import ParmParse
from somar_tpu_torch.core.grid import Grid
from somar_tpu_torch.physics.godunov import AdvectionParams
from somar_tpu_torch.physics.navier_stokes import NSParams
from somar_tpu_torch.solvers.multigrid import MGParams


def _sponge_widths(pp, side: str, ndim: int, length):
    """Per-direction sponge width FRACTIONS from the ibc.* namespace:
    spongeWidthFrac{side} directly, or spongeWidth{side} / length."""
    frac = pp.get_real_vect(f"ibc.spongeWidthFrac{side}", ndim, None)
    if frac is not None:
        return tuple(frac)
    w = pp.get_real_vect(f"ibc.spongeWidth{side}", ndim, None)
    if w is not None:
        return tuple(wi / L for wi, L in zip(w, length))
    return (0.0,) * ndim


def precision_dtype(prec) -> torch.dtype:
    """The torch dtype of an `amr.precision` value: 32 / "single" /
    "f32" / "float32" / "" or 64 / "double" / "f64" / "float64"."""
    prec = str(prec).strip().lower()
    if prec in ("64", "double", "f64", "float64"):
        return torch.float64
    if prec in ("32", "single", "f32", "float32", ""):
        return torch.float32
    raise ValueError(f"amr.precision = {prec!r}: use 32 or 64")


class CoordMap:
    CARTESIAN = 0
    TWISTED = 1
    BEAMGENERATOR = 2
    CYLINDRICAL = 4
    LEDGE = 5
    DEMMAP = 8


class ProblemType:
    ADVECTION_TEST = 0
    LOCK_EXCHANGE = 1
    BEAM_GENERATION = 2
    INTERNAL_WAVE = 3
    TAYLOR_GREEN = 4
    VORTEX_STREET = 5
    HORIZ_CONV = 6
    SOLITARY_WAVE = 7
    DJL = 8


@dataclasses.dataclass
class PlotConfig:
    """plot.* namespace (ProblemContext::readPlot, .H:209-232)."""
    plot_prefix: str = "plot_"
    checkpoint_prefix: str = "chkpt_"
    plot_interval: int = -1
    plot_period: float = -1.0
    checkpoint_interval: int = -1
    write_scalars: bool = True
    write_scalars_minus_background: bool = False
    write_pressure: bool = True
    write_divergence: bool = False
    write_lambda: bool = False
    write_vorticity: bool = False
    write_displacement: bool = True
    write_geometry: bool = False
    write_proc_ids: bool = False
    write_level_ids: bool = False
    write_grids: bool = False
    write_streamfunction: bool = False
    write_grad_e_lambda: bool = False
    write_ri: bool = False


@dataclasses.dataclass
class AMRConfig:
    """amr.* grid/time hierarchy knobs (ProblemContext::readAMR)."""
    ndim: int = 2
    nx: Tuple[int, ...] = (64, 64)
    nx_offset: Tuple[int, ...] = (0, 0)
    length: Tuple[float, ...] = (1.0, 1.0)
    is_periodic: Tuple[bool, ...] = (False, False)
    max_level: int = 0
    ref_ratios: Tuple[Tuple[int, ...], ...] = ()
    regrid_intervals: Tuple[int, ...] = ()
    tags_grow: int = 0
    vel_tag_tol: float = 0.0
    buoyancy_tag_tol: float = 0.0
    magvort_tag_quota: float = 0.0
    pressure_tag_tol: float = 0.0
    vert_extrude_tags: bool = False
    # amr.do_Ri_tagging / amr.Ri_tag_tol (ProblemContext.cpp:441-454)
    do_ri_tagging: bool = False
    ri_tag_tol: float = 0.25
    final_time: float = 1.0
    max_steps: int = 100
    restart_file: str = ""
    verbosity: int = 1
    # CF conservation knobs (reference: ProblemContext.cpp:522-548,
    # :530-544 — advective_*_reflux select which fields reflux;
    # implicit_*_reflux switch the diffusive/viscous corrections to
    # Helmholtz solves)
    advective_momentum_reflux: bool = False
    advective_scalar_reflux: bool = False
    advective_lambda_reflux: bool = False
    implicit_scalar_reflux: bool = False
    implicit_momentum_reflux: bool = False
    # post-regrid antidiffusive smoothing (reference:
    # amr.smooth_after_regrid / amr.postRegrid_smoothing_coeff,
    # ProblemContext.cpp:512-519)
    regrid_smoothing_coeff: float = 0.0
    # max patches per (finest) refined level — the TPU analog of the
    # reference's multi-box levels (LepticMeshRefine box lists): K
    # same-shape patches with traced origins/weights, so the number of
    # active clusters never recompiles the step; a per-level tuple gives
    # every level its own budget (multi-box at any level)
    max_patches: object = 1
    # freestream preservation (reference: projection.applyVDCorrection /
    # etaLambda, ProblemContext.cpp:1384-1401)
    apply_vd_correction: bool = False
    eta_lambda: float = 0.0
    # reference: amr.useSubcycling (time refinement on/off) and
    # amr.max_grid_size (box-extent cap -> static patch-interior cap)
    use_subcycling: bool = True
    max_grid_size: int = 0
    # per-component |vorticity| thresholds (amr.vort_tag_tol, 3-vector;
    # 2D uses component z, AMRNavierStokesRegrid.cpp:334-373)
    vort_tag_tol: Tuple[float, ...] = (0.0, 0.0, 0.0)
    # Berger-Rigoutsos clustering knobs (reference: ProblemContext.cpp:
    # 237-309 — block_factor = min box side, fill_ratio = tagged/total
    # efficiency target, grid_buffer_size = proper-nesting buffer,
    # splitDirs = directions the clusterer may chop, max_base_grid_size =
    # level-0 box cap for load balance; the dense TPU levels consume the
    # first two directly and keep the rest for the sharding planner)
    block_factor: int = 8
    fill_ratio: float = 0.8
    grid_buffer_size: int = 1
    split_dirs: Tuple[int, ...] = (1, 1, 1)
    max_base_grid_size: Tuple[int, ...] = (0, 0, 0)
    # projection.* iteration/gate knobs (ProblemContext.cpp:1360-1401)
    init_projection_iters: int = 1
    init_pressure_iters: int = 1
    do_sync_projection: bool = True
    sync_projection_iters: int = 1
    sync_composite_iters: int = 2
    apply_sync_correction: bool = True


@dataclasses.dataclass
class ProblemContext:
    amr: AMRConfig
    ns: NSParams
    plot: PlotConfig
    coord_map: int = CoordMap.CARTESIAN
    problem: int = ProblemType.LOCK_EXCHANGE
    pert: Tuple[float, ...] = (0.0, 0.0)
    # ledge map
    ledge_transition_order: int = 3
    ledge_hl: float = 0.2
    ledge_hr: float = 1.0
    ledge_xl: float = -1.0
    ledge_xr: float = 1.0
    # beam generator map
    beam_gen_alpha: float = 0.0
    # DEM map
    dem_file: str = ""
    #: geometry.Interpolation_Order: 0 = bilinear, > 0 = Hermite/spline
    #: (DEMMap node sampling, reference DEMMap.cpp:178-302)
    dem_interp_order: int = 0
    # ibc extras
    use_background_scalar: bool = False
    bg_profile: int = 0
    tidal_u0: Tuple[float, ...] = (0.0, 0.0)
    tidal_omega: float = 0.0
    use_sponge_layer: bool = False
    sponge_widths_lo: Tuple[float, ...] = (0.0, 0.0, 0.0)
    sponge_widths_hi: Tuple[float, ...] = (0.0, 0.0, 0.0)
    sponge_time_coeff: float = 15.0

    # ------------------------------------------------------------ factory
    @classmethod
    def from_file(cls, path: str, overrides: Sequence[str] = ()):
        import os
        ctx = cls.from_parmparse(ParmParse.from_file(path, overrides))
        # resolve input-file-relative resource paths (the reference's
        # shipped configs point at ../src/geometry/maps/DEMMaps/...)
        if ctx.dem_file and not os.path.isabs(ctx.dem_file) \
                and not os.path.exists(ctx.dem_file):
            cand = os.path.join(os.path.dirname(os.path.abspath(path)),
                                ctx.dem_file)
            if os.path.exists(cand):
                ctx.dem_file = cand
        return ctx

    @classmethod
    def from_parmparse(cls, pp: ParmParse) -> "ProblemContext":
        # dimensionality: length of amr.nx
        if not pp.contains("amr.nx"):
            raise KeyError("required input 'amr.nx' not found")
        nx_list = [int(v) for v in pp._table["amr.nx"]]
        ndim = len(nx_list)
        nx = tuple(nx_list)

        length = pp.require_real_vect("amr.length", ndim)
        nx_offset = tuple(pp.get_int_vect("amr.nx_offset", ndim,
                                          (0,) * ndim) or (0,) * ndim)
        is_per = tuple(bool(v) for v in (
            pp.get_int_vect("amr.isPeriodic", ndim, (0,) * ndim)
            or (0,) * ndim))

        max_level = pp.get_int("amr.maxlevel", 0)
        # per-level anisotropic ratios: refratio_lev<l> overrides refratio
        base_ratio = tuple(pp.get_int_vect("amr.refratio", ndim,
                                           (2,) * ndim) or (2,) * ndim)
        ratios = []
        for lev in range(max_level):
            r = pp.get_int_vect(f"amr.refratio_lev{lev}", ndim, None)
            ratios.append(tuple(r) if r else base_ratio)

        regrid = pp.get_int_vect("amr.regrid_intervals", max(max_level, 1),
                                 None)
        regrid = tuple(regrid) if regrid else (10,) * max(max_level, 1)

        # amr.max_patches: a single int = K patches at the FINEST level
        # only (back-compat, cheap); a per-level list gives every level
        # its own multi-box budget (general multi-box AMR)
        mp_raw = pp._table.get("amr.max_patches")
        if mp_raw is not None and len(mp_raw) > 1:
            max_patches = tuple(int(v) for v in mp_raw)
        else:
            max_patches = pp.get_int("amr.max_patches", 1)

        amr = AMRConfig(
            ndim=ndim, nx=nx, nx_offset=nx_offset, length=tuple(length),
            is_periodic=is_per, max_level=max_level,
            ref_ratios=tuple(ratios), regrid_intervals=regrid,
            tags_grow=pp.get_int("amr.tags_grow", 0),
            vel_tag_tol=pp.get_real("amr.vel_tag_tol", 0.0),
            buoyancy_tag_tol=pp.get_real("amr.buoyancy_tag_tol", 0.0),
            magvort_tag_quota=pp.get_real(
                "amr.magvort_tag_quota",
                # deprecated alias (ProblemContext.cpp:396-402)
                pp.get_real("amr.vorticity_tag_factor",
                            pp.get_real("amr.vort_tag_factor", 0.0))),
            pressure_tag_tol=pp.get_real("amr.pressure_tag_tol", 0.0),
            vort_tag_tol=tuple(
                pp.get_real_vect("amr.vort_tag_tol", 3, (0.0,) * 3)
                or (0.0,) * 3),
            block_factor=pp.get_int("amr.block_factor", 8),
            fill_ratio=pp.get_real("amr.fill_ratio", 0.8),
            grid_buffer_size=pp.get_int("amr.grid_buffer_size", 1),
            split_dirs=tuple(
                pp.get_int_vect("amr.splitDirs", ndim, (1,) * ndim)
                or (1,) * ndim),
            max_base_grid_size=tuple(
                pp.get_int_vect("amr.max_base_grid_size", ndim,
                                (0,) * ndim) or (0,) * ndim),
            vert_extrude_tags=bool(pp.get_int("amr.vert_extrude_tags", 0)),
            do_ri_tagging=bool(pp.get_int("amr.do_Ri_tagging", 0)),
            ri_tag_tol=pp.get_real("amr.Ri_tag_tol", 0.25),
            final_time=pp.get_real("amr.final", 1.0),
            max_steps=pp.get_int("amr.maxsteps", 100),
            restart_file=pp.get_str("amr.restart_file", "") or "",
            verbosity=pp.get_int("amr.verbosity", 1),
            advective_momentum_reflux=bool(
                pp.get_int("amr.advective_momentum_reflux", 0)),
            advective_scalar_reflux=bool(
                pp.get_int("amr.advective_scalar_reflux", 0)),
            advective_lambda_reflux=bool(
                pp.get_int("amr.advective_lambda_reflux", 0)),
            implicit_scalar_reflux=bool(
                pp.get_int("amr.implicit_scalar_reflux", 0)),
            implicit_momentum_reflux=bool(
                pp.get_int("amr.implicit_momentum_reflux", 0)),
            max_patches=max_patches,
            regrid_smoothing_coeff=(
                pp.get_real("amr.postRegrid_smoothing_coeff", 0.0)
                if pp.get_int("amr.smooth_after_regrid", 0) else 0.0),
            apply_vd_correction=bool(
                pp.get_int("projection.applyVDCorrection", 0)),
            eta_lambda=pp.get_real("projection.etaLambda",
                                   pp.get_real("projection.eta", 0.0)),
            use_subcycling=bool(pp.get_int("amr.useSubcycling", 1)),
            max_grid_size=pp.get_int("amr.max_grid_size", 0),
            init_projection_iters=pp.get_int(
                "projection.initial_projection_iters", 1),
            init_pressure_iters=pp.get_int(
                "projection.initial_pressure_iters", 1),
            do_sync_projection=bool(
                pp.get_int("projection.doSyncProjection", 1)),
            sync_projection_iters=pp.get_int(
                "projection.sync_projection_iters", 1),
            sync_composite_iters=pp.get_int(
                "projection.syncCompositeIters", 2),
            apply_sync_correction=bool(
                pp.get_int("projection.applySyncCorrection", 1)),
        )

        kappa_raw = pp.get_real("amr.scal_diffusion_coeffs", 0.0)
        kappa = tuple(kappa_raw) if isinstance(kappa_raw, list) else (
            float(kappa_raw),)

        adv_vel = AdvectionParams(
            normal_pred_order=pp.get_int("advection.normalPredOrderVel", 2),
            use_fourth_order_slopes=bool(
                pp.get_int("advection.useFourthOrderSlopesVel", 1)),
            use_limiting=bool(pp.get_int("advection.useLimitingVel", 0)),
            use_high_order_limiter=bool(
                pp.get_int("advection.useHighOrderLimiterVel", 0)),
            use_upwinding=bool(pp.get_int("advection.useUpwindingVel", 1)),
        )
        adv_scal = AdvectionParams(
            normal_pred_order=pp.get_int("advection.normalPredOrderScal", 2),
            use_fourth_order_slopes=bool(
                pp.get_int("advection.useFourthOrderSlopesScal", 1)),
            use_limiting=bool(pp.get_int("advection.useLimitingScal", 1)),
            use_high_order_limiter=bool(
                pp.get_int("advection.useHighOrderLimiterScal", 0)),
            use_upwinding=bool(pp.get_int("advection.useUpwindingScal", 1)),
        )

        relax_modes = {-1: "none", 0: "jacobi", 1: "gsrb", 2: "gsrb",
                       3: "line"}

        def read_mg(ctx=None):
            """Layered MG/bottom namespaces: the per-solver namespaces
            (e.g. MACprojection_AMRMG.*, viscous_bottom.*) default to the
            base AMRMG.*/bottom.* values and override per key (reference:
            ProblemContext.cpp:1243-1795)."""
            mg_ns = ["AMRMG"] + ([f"{ctx}_AMRMG"] if ctx else [])
            bot_ns = ["bottom"] + ([f"{ctx}_bottom"] if ctx else [])

            def layered(get, spaces, key, default):
                v = default
                for ns in spaces:
                    v = get(f"{ns}.{key}", v)
                return v

            gi = lambda k, d, s=mg_ns: layered(pp.get_int, s, k, d)
            gr = lambda k, d, s=mg_ns: layered(pp.get_real, s, k, d)
            bi = lambda k, d: layered(pp.get_int, bot_ns, k, d)
            br = lambda k, d: layered(pp.get_real, bot_ns, k, d)
            return MGParams(
                eps=gr("eps", 1e-6),
                imin=gi("imin", 5),
                imax=gi("imax", 20),
                hang=gr("hang", 1e-15),
                norm_thresh=gr("normThresh", 1e-30),
                num_smooth_down=gi("num_smooth_down", 2),
                num_smooth_up=gi("num_smooth_up", 2),
                num_smooth_bottom=max(
                    4 * gi("num_smooth_bottom", 2), 8),
                num_smooth_precond=gi("num_smooth_precond", 2),
                precond_mode=gi("precond_mode", 1),
                num_mg=gi("numMG", 1),
                max_depth=gi("maxDepth", -1),
                # unspecified -> "auto" (per-MG-level smoother choice:
                # line relaxation where the metric's vertical coupling
                # dominates, else GSRB); an explicit relax_mode key keeps
                # the reference's numeric meaning
                relax_mode=relax_modes.get(gi("relax_mode", -999), "auto"),
                verbosity=gi("verbosity", 0),
                bottom_eps=br("eps", 1e-6),
                bottom_imax=bi("imax", 80),
                bottom_hang=br("hang", 1e-8),
                bottom_small=br("small", 1e-30),
                bottom_reps=br("reps", 1e-12),
                bottom_num_restarts=bi("numRestarts", 5),
                bottom_norm_type=bi("normType", 2),
                bottom_verbosity=bi("verbosity", 0),
            )

        mg = read_mg()

        # run precision: 32 (default) or 64 ("single"/"double" too)
        dtype = precision_dtype(pp.get_str("amr.precision", "32"))

        ns = NSParams(
            dtype=dtype,
            nu=pp.get_real("amr.viscosity", 0.0),
            kappa=kappa,
            viscous_solver_type=pp.get_int("amr.viscous_solver_type", 1),
            diffusive_solver_type=pp.get_int("amr.diffusive_solver_type", 1),
            gravity_method=pp.get_int("amr.gravityMethod", 1),
            gravity_theta=pp.get_real("amr.gravityTheta", 0.6),
            cfl=pp.get_real("amr.cfl", 0.8),
            max_dt=pp.get_real("amr.max_dt", 1e8),
            max_dt_grow=pp.get_real("amr.max_dt_grow", 1.5),
            init_dt_multiplier=pp.get_real("amr.init_dt_multiplier", 0.1),
            fixed_dt=pp.get_real("amr.fixed_dt", -1.0),
            limit_dt_via_viscosity=bool(
                pp.get_int("amr.limitDtViaViscosity", 1)),
            limit_dt_via_diffusion=bool(
                pp.get_int("amr.limitDtViaDiffusion", 1)),
            limit_dt_via_pressure_gradient=bool(
                pp.get_int("amr.limitDtViaPressureGradient", 0)),
            limit_dt_via_internal_wave_speed=bool(
                pp.get_int("amr.limitDtViaInternalWaveSpeed", 0)),
            nonlinear_differencing_form=pp.get_int(
                "advection.nonlinearDifferencingForm", 0),
            update_scheme={0: "ppm", 1: "ppm", 2: "rk3"}.get(
                pp.get_int("amr.updateScheme", 0), "ppm"),
            advection_vel=adv_vel,
            advection_scal=adv_scal,
            mg=mg,
            mg_mac=read_mg("MACprojection"),
            mg_sync=read_mg("syncProjection"), mg_vd=read_mg("VD"),
            mg_cc=read_mg("CCprojection"),
            mg_viscous=read_mg("viscous"),
            mg_diffusive=read_mg("diffusive"),
            is_incompressible=bool(
                pp.get_int("projection.isIncompressible", 1)),
            pressure_solver={0: "auto", 1: "mg", 2: "leptic",
                             3: "bicgstab", 4: "fft"}.get(
                pp.get_int("projection.solver", 0), "auto"),
            level_projection_iters=pp.get_int(
                "projection.level_projection_iters", 1),
        )

        plot = PlotConfig(
            plot_prefix=pp.get_str("plot.plot_prefix", "plot_") or "plot_",
            checkpoint_prefix=pp.get_str("plot.checkpoint_prefix",
                                         "chkpt_") or "chkpt_",
            plot_interval=pp.get_int("plot.plot_interval", -1),
            plot_period=pp.get_real("plot.plot_period", -1.0),
            checkpoint_interval=pp.get_int("plot.checkpoint_interval", -1),
            write_scalars=bool(pp.get_int("plot.writeScalars", 1)),
            write_scalars_minus_background=bool(
                pp.get_int("plot.writeScalarsMinusBackground", 0)),
            write_pressure=bool(pp.get_int("plot.writePressure", 1)),
            write_divergence=bool(pp.get_int("plot.writeDivergence", 0)),
            write_lambda=bool(pp.get_int("plot.writeLambda", 0)),
            write_vorticity=bool(pp.get_int("plot.writeVorticity", 0)),
            write_displacement=bool(pp.get_int("plot.writeDisplacement", 1)),
            write_geometry=bool(pp.get_int("plot.writeGeometry", 0)),
            write_streamfunction=bool(
                pp.get_int("plot.writeStreamFunction", 0)
                or pp.get_int("plot.writeStreamfunction", 0)),
            write_proc_ids=bool(pp.get_int("plot.writeProcIDs", 0)),
            write_level_ids=bool(pp.get_int("plot.writeLevelIDs", 0)),
            write_grids=bool(pp.get_int("plot.writeGrids", 0)),
            write_grad_e_lambda=bool(
                pp.get_int("plot.writeGradELambda", 0)),
            write_ri=bool(pp.get_int("plot.writeRi", 0)),
        )

        tidal_u0 = tuple(pp.get_real_vect("ibc.tidalU0", 1, (0.0,))
                         or (0.0,))
        tidal_u0 = (tuple(tidal_u0) + (0.0, 0.0, 0.0))[:3]
        return cls(
            amr=amr, ns=ns, plot=plot,
            coord_map=pp.get_int("geometry.coordMap", 0),
            problem=pp.get_int("ibc.problem", 1),
            pert=tuple(pp.get_real_vect("geometry.perturbations", ndim,
                                        (0.0,) * ndim) or (0.0,) * ndim),
            ledge_transition_order=pp.get_int(
                "geometry.ledgeMapTransitionOrder", 3),
            ledge_hl=pp.get_real("geometry.ledgeMapHl", 0.2),
            ledge_hr=pp.get_real("geometry.ledgeMapHr", 1.0),
            ledge_xl=pp.get_real("geometry.ledgeMapXl", -1.0),
            ledge_xr=pp.get_real("geometry.ledgeMapXr", 1.0),
            # the input value is in DEGREES; the reference converts at
            # parse time (ProblemContext.cpp:641: alpha *= PI/180)
            beam_gen_alpha=np.deg2rad(pp.get_real(
                "geometry.beamGenMapAlpha",
                pp.get_real("geometry.alpha", 0.0))),
            dem_interp_order=pp.get_int("geometry.Interpolation_Order", 0),
            dem_file=(pp.get_str("geometry.DemFile", "")
                      or pp.get_str("geometry.demFile", "") or ""),
            use_background_scalar=bool(
                pp.get_int("ibc.useBackgroundScalar", 0)),
            bg_profile=pp.get_int("ibc.bgScalarProfile", 1),
            tidal_u0=tidal_u0,
            tidal_omega=pp.get_real("ibc.tidalOmega", 0.0),
            use_sponge_layer=bool(pp.get_int("ibc.useSpongeLayer", 0)),
            sponge_widths_lo=_sponge_widths(pp, "Lo", ndim, length),
            sponge_widths_hi=_sponge_widths(pp, "Hi", ndim, length),
            sponge_time_coeff=(
                pp.get_real("ibc.spongeTimeCoeff", 0.0)
                or next((v for v in (
                    pp.get_real_vect("ibc.spongeDtMultLo", ndim, None)
                    or ()) if v > 0), 15.0)),
        )

    def sponge_spec(self):
        """SpongeSpec from the ibc.* sponge namespace (reference:
        ProblemContext.cpp:899-975: widths via spongeWidth[Frac]{Lo,Hi},
        strength via spongeDtMult{Lo,Hi})."""
        if not self.use_sponge_layer:
            return None
        from somar_tpu_torch.problems.base import SpongeSpec
        return SpongeSpec(width_lo=self.sponge_widths_lo,
                          width_hi=self.sponge_widths_hi,
                          time_coeff=self.sponge_time_coeff)

    # -------------------------------------------------------------- grids
    def base_grid(self) -> Grid:
        a = self.amr
        dx = tuple(L / n for L, n in zip(a.length, a.nx))
        x0 = tuple(off * d for off, d in zip(a.nx_offset, dx))
        return Grid(nx=a.nx, dx=dx, x0=x0, periodic=a.is_periodic)

    def new_geo_source(self):
        """Factory for the coordinate map (reference:
        ProblemContext::newGeoSourceInterface, .H:165)."""
        from somar_tpu_torch.geometry.geo_source import (
            CartesianMap, CylindricalMap, TwistedMap)
        from somar_tpu_torch.geometry.bathymetric import (
            BeamGeneratorMap, DEMMap, LedgeMap)

        a = self.amr
        vert = (a.nx_offset[-1] * a.length[-1] / a.nx[-1],
                a.nx_offset[-1] * a.length[-1] / a.nx[-1] + a.length[-1])
        if self.coord_map == CoordMap.CARTESIAN:
            return CartesianMap()
        if self.coord_map == CoordMap.TWISTED:
            return TwistedMap(self.pert, a.length)
        if self.coord_map == CoordMap.CYLINDRICAL:
            return CylindricalMap()
        if self.coord_map == CoordMap.LEDGE:
            # the reference's ledgeMapHl/Hr are BED ELEVATIONS: its
            # vertical map is z = elev + (H - elev) * phi(zeta/H)
            # (FILL_BATHYVERTMAP, maps/BathymetricBaseMapF.ChF:84-111 —
            # the column spans [elev, H] with a flat top), while LedgeMap
            # here takes water THICKNESSES D = H - elev (the shipped
            # inputs.LockExchange_Ledge2D Hl=1 Hr=0 with H=2 is a 1-deep
            # shelf dropping to the 2-deep basin)
            H = a.length[-1]
            return LedgeMap(vert, hl=H - self.ledge_hl,
                            hr=H - self.ledge_hr,
                            xl=self.ledge_xl, xr=self.ledge_xr,
                            transition_order=self.ledge_transition_order)
        if self.coord_map == CoordMap.BEAMGENERATOR:
            return BeamGeneratorMap(vert, full_depth=a.length[-1],
                                    angle=self.beam_gen_alpha,
                                    lx=a.length[0])
        if self.coord_map == CoordMap.DEMMAP:
            return DEMMap.from_hdf5(vert, self.dem_file, a.ndim,
                                    interp_order=self.dem_interp_order)
        raise ValueError(f"unknown coordMap {self.coord_map}")

    def new_problem(self):
        """Factory for the problem definition (reference:
        ProblemContext::newPhysBCUtil, .H:242)."""
        from somar_tpu_torch.problems import make_problem
        return make_problem(self)
