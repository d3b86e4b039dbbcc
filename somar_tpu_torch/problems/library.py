"""Problems of the JAX package's library ported so far (PyTorch port of
`somar_tpu.problems.library`): BeamGeneration.  The other problems
(AdvectionTest, InternalWave, VortexStreet, HorizConv, SolitaryWave, DJL)
are not ported yet (ROADMAP)."""

from __future__ import annotations

from somar_tpu_torch.problems.base import (
    LinearProfile, Problem, SpongeSpec, TidalSpec)


class BeamGeneration(Problem):
    """Internal-tide beam generation over a ridge: linear background
    stratification, oscillating tidal body force, sponges at the
    horizontal boundaries.  The ridge lives in the BeamGeneratorMap
    geometry."""

    name = "BeamGeneration"
    use_background_scalar = True

    def __init__(self, background=None, tidal_u0=0.01, tidal_omega=1.0,
                 sponge_frac: float = 0.05, sponge_time_coeff: float = 15.0,
                 ndim: int = 2):
        self.background = background or LinearProfile(b0=0.0, slope=-1.0)
        self.tidal = TidalSpec(u0=(float(tidal_u0),) + (0.0,) * 2,
                               omega=float(tidal_omega))
        w = [0.0] * ndim
        w[0] = sponge_frac
        self.sponge = SpongeSpec(width_lo=tuple(w), width_hi=tuple(w),
                                 time_coeff=sponge_time_coeff)
