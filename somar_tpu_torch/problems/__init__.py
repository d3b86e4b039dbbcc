"""The problems of the PyTorch package (the lock exchange, the
Taylor-Green vortex and the library of `problems/library.py`) and the
registry `make_problem` of the `ibc.problem` input: all nine values of
config/context.py's ProblemType."""

from somar_tpu_torch.problems.base import (
    BackgroundProfile, LinearProfile, NoBackground, Problem,
    QuadraticProfile, SpongeSpec, TanhProfile, TidalSpec)
from somar_tpu_torch.problems.library import (
    AdvectionTest, BeamGeneration, DJL, HorizConv, InternalWave,
    SolitaryWave, VortexStreet)
from somar_tpu_torch.problems.lock_exchange import LockExchange
from somar_tpu_torch.problems.taylor_green import TaylorGreen

__all__ = [
    "Problem", "BackgroundProfile", "NoBackground", "LinearProfile",
    "QuadraticProfile", "TanhProfile", "SpongeSpec", "TidalSpec",
    "LockExchange", "TaylorGreen", "AdvectionTest", "BeamGeneration",
    "InternalWave", "VortexStreet", "HorizConv", "SolitaryWave", "DJL",
    "make_problem",
]


def make_problem(ctx):
    """Build the Problem selected by ibc.problem (config/context.py
    ProblemType)."""
    from somar_tpu_torch.config.context import ProblemType

    profiles = {0: NoBackground(), 1: LinearProfile(), 2: QuadraticProfile(),
                3: TanhProfile()}
    bg = (profiles.get(ctx.bg_profile, LinearProfile())
          if ctx.use_background_scalar else NoBackground())
    sponge = ctx.sponge_spec()

    t = ctx.problem
    if t == ProblemType.ADVECTION_TEST:
        return AdvectionTest()
    if t == ProblemType.LOCK_EXCHANGE:
        return LockExchange()
    if t == ProblemType.BEAM_GENERATION:
        if ctx.use_background_scalar and ctx.bg_profile == 1:
            # the beam problem's linear stratification is fixed in the
            # problem, not read from the input file: N^2 = 1.493e-5,
            # bbar = -N^2 z (with the generic slope -1, omega/N would be
            # ~1e-3 instead of sin(15 deg) and no critical-slope beams form)
            bg = LinearProfile(b0=0.0, slope=-1.493e-5)
        prob = BeamGeneration(background=bg, tidal_u0=ctx.tidal_u0[0],
                              tidal_omega=ctx.tidal_omega,
                              ndim=ctx.amr.ndim,
                              sponge_time_coeff=ctx.sponge_time_coeff)
        if sponge is not None:
            prob.sponge = sponge   # ibc.spongeWidth* override
        return prob
    if t == ProblemType.INTERNAL_WAVE:
        return InternalWave(background=bg)
    if t == ProblemType.TAYLOR_GREEN:
        return TaylorGreen(lengths=ctx.amr.length, nu=ctx.ns.nu)
    if t == ProblemType.VORTEX_STREET:
        return VortexStreet(sponge=sponge)
    if t == ProblemType.HORIZ_CONV:
        return HorizConv()
    if t == ProblemType.SOLITARY_WAVE:
        return SolitaryWave(background=bg)
    if t == ProblemType.DJL:
        return DJL(background=bg)
    raise ValueError(f"unknown ibc.problem {t}")
