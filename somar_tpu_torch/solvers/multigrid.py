"""Multigrid parameters (PyTorch port of `somar_tpu.solvers.multigrid`).

Only `MGParams` is ported in this slice: `NSParams` carries it.  The
solver itself comes with slice 2 (ROADMAP), together with the GSRB
kernels it runs.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MGParams:
    eps: float = 1e-6            # AMRMG.eps: relative residual tolerance
    imin: int = 2                # AMRMG.imin: min V-cycles
    imax: int = 20               # AMRMG.imax: max V-cycles
    hang: float = 1e-15          # AMRMG.hang: stall detection
    norm_thresh: float = 1e-30   # AMRMG.normThresh
    num_smooth_down: int = 4     # AMRMG.num_smooth_down
    num_smooth_up: int = 4       # AMRMG.num_smooth_up
    num_smooth_bottom: int = 16  # bottom-level smooth count
    num_mg: int = 1              # 1 = V-cycle, 2 = W-cycle
    max_depth: int = -1          # AMRMG.maxDepth
    relax_mode: str = "auto"
    prolong_order: int = 1
    verbosity: int = 0
    bottom_solver: str = "bicgstab"
    num_smooth_precond: int = 2
    precond_mode: int = 1
    bottom_eps: float = 1e-6     # bottom.eps
    bottom_imax: int = 80        # bottom.imax
    bottom_hang: float = 1e-8    # bottom.hang
    bottom_small: float = 1e-30  # bottom.small
    bottom_reps: float = 1e-12   # bottom.reps
    bottom_num_restarts: int = 5     # bottom.numRestarts
    bottom_norm_type: int = 2        # bottom.normType (0 max / 2 L2)
    bottom_verbosity: int = 0        # bottom.verbosity


class LevelMultigrid:
    """Placeholder for the level multigrid solver of slice 2."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError("multigrid is ported in slice 2, see ROADMAP")
