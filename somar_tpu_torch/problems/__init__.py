"""Problems ported to the PyTorch package: the lock exchange, the
Taylor-Green vortex and the internal-tide beam generation."""

from somar_tpu_torch.problems.base import (
    BackgroundProfile, LinearProfile, NoBackground, Problem, SpongeSpec,
    TidalSpec)
from somar_tpu_torch.problems.library import BeamGeneration
from somar_tpu_torch.problems.lock_exchange import LockExchange
from somar_tpu_torch.problems.taylor_green import TaylorGreen

__all__ = [
    "Problem", "BackgroundProfile", "NoBackground", "LinearProfile",
    "SpongeSpec", "TidalSpec", "LockExchange", "TaylorGreen",
    "BeamGeneration",
]
