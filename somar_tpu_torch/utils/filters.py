"""Shapiro filters: high-wavenumber smoothing (PyTorch port of
`somar_tpu.utils.filters`).

The 1D 2nd-order Shapiro filter  f_i <- f_i + (s/4)(f_{i-1} - 2 f_i +
f_{i+1})  along one direction (s = 1 is the full 1-2-1 filter, which
removes the Nyquist mode exactly), with its ghosts from the field's BCs,
and its sequential composition over all directions.  Nothing in the step
calls it; it is there for smoothing and diagnostics.
"""

from __future__ import annotations

from somar_tpu_torch.core.bc import FieldBCs, fill_ghosts_cc
from somar_tpu_torch.core.grid import Grid
from somar_tpu_torch.ops.stencil import slc


def shapiro_filter_1d(field, grid: Grid, bcs: FieldBCs, d: int,
                      strength: float = 1.0, passes: int = 1):
    """2nd-order Shapiro filter along logical direction d."""
    ax = grid.axis(d)
    out = field
    for _ in range(passes):
        ng = [0] * grid.ndim
        ng[d] = 1
        p = fill_ghosts_cc(out, grid, bcs, ng)
        lap = slc(p, ax, 0, -2) - 2.0 * slc(p, ax, 1, -1) \
            + slc(p, ax, 2, None)
        out = out + 0.25 * strength * lap
    return out


def shapiro_filter(field, grid: Grid, bcs: FieldBCs,
                   strength: float = 1.0, passes: int = 1):
    """Sequential per-direction Shapiro filtering, x first."""
    out = field
    for _ in range(passes):
        for d in range(grid.ndim):
            out = shapiro_filter_1d(out, grid, bcs, d, strength, 1)
    return out
