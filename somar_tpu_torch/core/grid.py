"""Grid: the index-space description of one level's rectangular domain.

Pure numpy, identical to `somar_tpu.core.grid` (the JAX package's Grid):
every per-direction quantity is a tuple indexed by *logical* direction d
(0=x, 1=y, 2=z; the vertical is always d = ndim-1).

Array layout: arrays are stored vertical-major, i.e. a CC field on a 3D
grid has shape (nz, ny, nx) and on a 2D grid (nz, nx).  Logical direction
d corresponds to array axis `ndim - 1 - d`, so x is always the contiguous
(stride-1) axis.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Grid:
    """Index space + mapped (xi) coordinates of one refinement level.

    Attributes:
      nx: cells per logical direction, (nx,) * ndim order (x, [y,] z).
      dx: mapped-space cell size per logical direction.  In mapped
          coordinates the grid is always uniform; all stretching lives in
          the coordinate map (geometry layer).
      x0: mapped-space coordinate of the low *face* of cell 0 per direction
          (reference: `amr.nx_offset` scaled by dx).
      periodic: per-direction periodicity flags.
    """

    nx: Tuple[int, ...]
    dx: Tuple[float, ...]
    x0: Tuple[float, ...] = None  # type: ignore[assignment]
    periodic: Tuple[bool, ...] = None  # type: ignore[assignment]

    def __post_init__(self):
        nx = tuple(int(n) for n in self.nx)
        object.__setattr__(self, "nx", nx)
        object.__setattr__(self, "dx", tuple(float(d) for d in self.dx))
        if self.x0 is None:
            object.__setattr__(self, "x0", (0.0,) * len(nx))
        else:
            object.__setattr__(self, "x0", tuple(float(v) for v in self.x0))
        if self.periodic is None:
            object.__setattr__(self, "periodic", (False,) * len(nx))
        else:
            object.__setattr__(self, "periodic", tuple(bool(p) for p in self.periodic))
        assert len(self.dx) == len(nx) and len(self.x0) == len(nx)
        assert len(self.periodic) == len(nx)
        # 2D (x,z) and 3D (x,y,z) domains; 1D grids arise as the flattened
        # horizontal grids of the leptic solver (Subspace.H analog)
        assert len(nx) in (1, 2, 3)

    # ---------------------------------------------------------------- basic
    @property
    def ndim(self) -> int:
        return len(self.nx)

    @property
    def vertical_dir(self) -> int:
        """Logical direction of the vertical (SOMAR: SpaceDim-1)."""
        return self.ndim - 1

    def axis(self, d: int) -> int:
        """Array axis corresponding to logical direction d."""
        return self.ndim - 1 - d

    def dir_of_axis(self, ax: int) -> int:
        return self.ndim - 1 - ax

    @property
    def shape(self) -> Tuple[int, ...]:
        """CC array shape (vertical-major: reversed logical order)."""
        return tuple(self.nx[::-1])

    def fc_shape(self, d: int) -> Tuple[int, ...]:
        """Face-centered array shape for faces normal to logical dir d."""
        s = list(self.shape)
        s[self.axis(d)] += 1
        return tuple(s)

    @property
    def ncells(self) -> int:
        return int(np.prod(self.nx))

    def domain_length(self, d: int) -> float:
        return self.nx[d] * self.dx[d]

    # ---------------------------------------------------------- coordinates
    def cc_coord_1d(self, d: int) -> np.ndarray:
        """Mapped-space cell-center coordinates along logical dir d, 1D."""
        return self.x0[d] + (np.arange(self.nx[d]) + 0.5) * self.dx[d]

    def fc_coord_1d(self, d: int) -> np.ndarray:
        """Mapped-space face coordinates along logical dir d, 1D."""
        return self.x0[d] + np.arange(self.nx[d] + 1) * self.dx[d]

    def coords(self, centering: Sequence[int] | None = None) -> Tuple[np.ndarray, ...]:
        """Broadcastable mapped-space coordinate arrays, one per logical dir.

        centering[d] = 0 for cell-centered, 1 for face-centered along d.
        Returned arrays have singleton axes so that products/ sums broadcast
        to the full (possibly face-centered) array shape.
        """
        if centering is None:
            centering = (0,) * self.ndim
        out = []
        for d in range(self.ndim):
            c = self.fc_coord_1d(d) if centering[d] else self.cc_coord_1d(d)
            shape = [1] * self.ndim
            shape[self.axis(d)] = c.size
            out.append(c.reshape(shape))
        return tuple(out)

    # ------------------------------------------------------------ refinement
    def refine(self, ratio: Sequence[int]) -> "Grid":
        """Anisotropically refined grid (per-direction IntVect ratio).

        Reference: AnisotropicRefinementTools.H:37-98.
        """
        r = tuple(int(v) for v in ratio)
        assert len(r) == self.ndim
        return Grid(
            nx=tuple(n * ri for n, ri in zip(self.nx, r)),
            dx=tuple(d / ri for d, ri in zip(self.dx, r)),
            x0=self.x0,
            periodic=self.periodic,
        )

    def coarsen(self, ratio: Sequence[int]) -> "Grid":
        r = tuple(int(v) for v in ratio)
        assert len(r) == self.ndim
        assert all(n % ri == 0 for n, ri in zip(self.nx, r)), (
            f"cannot coarsen {self.nx} by {r}"
        )
        return Grid(
            nx=tuple(n // ri for n, ri in zip(self.nx, r)),
            dx=tuple(d * ri for d, ri in zip(self.dx, r)),
            x0=self.x0,
            periodic=self.periodic,
        )

    def coarsenable(self, ratio: Sequence[int]) -> bool:
        return all(
            n % ri == 0 and n // ri >= 2 if ri > 1 else True
            for n, ri in zip(self.nx, ratio)
        )
