"""Problems ported to the PyTorch package (the lock exchange, the
Taylor-Green vortex and the internal-tide beam generation), and the
registry `make_problem` of the `ibc.problem` input."""

from somar_tpu_torch.problems.base import (
    BackgroundProfile, LinearProfile, NoBackground, Problem,
    QuadraticProfile, SpongeSpec, TanhProfile, TidalSpec)
from somar_tpu_torch.problems.library import BeamGeneration
from somar_tpu_torch.problems.lock_exchange import LockExchange
from somar_tpu_torch.problems.taylor_green import TaylorGreen

__all__ = [
    "Problem", "BackgroundProfile", "NoBackground", "LinearProfile",
    "QuadraticProfile", "TanhProfile", "SpongeSpec", "TidalSpec",
    "LockExchange", "TaylorGreen", "BeamGeneration", "make_problem",
]

#: ibc.problem values of the problems not ported yet
_NOT_PORTED = {0: "AdvectionTest", 3: "InternalWave", 5: "VortexStreet",
               6: "HorizConv", 7: "SolitaryWave", 8: "DJL"}


def make_problem(ctx):
    """Build the Problem selected by ibc.problem (config/context.py
    ProblemType)."""
    from somar_tpu_torch.config.context import ProblemType

    t = ctx.problem
    if t in _NOT_PORTED:
        raise NotImplementedError(
            f"ibc.problem = {t} ({_NOT_PORTED[t]}) is not ported yet "
            "(ROADMAP A.4)")
    if t == ProblemType.LOCK_EXCHANGE:
        return LockExchange()
    if t == ProblemType.TAYLOR_GREEN:
        return TaylorGreen(lengths=ctx.amr.length, nu=ctx.ns.nu)
    if t == ProblemType.BEAM_GENERATION:
        profiles = {0: NoBackground(), 1: LinearProfile(),
                    2: QuadraticProfile(), 3: TanhProfile()}
        bg = (profiles.get(ctx.bg_profile, LinearProfile())
              if ctx.use_background_scalar else NoBackground())
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
        sponge = ctx.sponge_spec()
        if sponge is not None:
            prob.sponge = sponge   # ibc.spongeWidth* override
        return prob
    raise ValueError(f"unknown ibc.problem {t}")
