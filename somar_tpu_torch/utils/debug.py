"""Debug safety nets: NaN sweeps (PyTorch port of
`somar_tpu.utils.debug`).  In eager torch these are plain checks, each a
device-to-host read, so the per-step sweeps run only with
SOMAR_DEBUG_CHECKS=1.
"""

from __future__ import annotations

import os

import numpy as np
import torch

#: per-step NaN sweeps of check_state
CHECKS_ENABLED = os.environ.get("SOMAR_DEBUG_CHECKS", "0") == "1"


def nan_check(x, name: str = "field"):
    """Print a line when x holds a NaN or Inf (with CHECKS_ENABLED)."""
    if CHECKS_ENABLED and not bool(torch.isfinite(x).all()):
        print(f"somar_tpu_torch NaN check FAILED: {name}")
    return x


def check_state(state, where: str = ""):
    """nan_check every field of an NSState (with CHECKS_ENABLED)."""
    if not CHECKS_ENABLED:
        return state
    for fname in ("vel", "scalars", "lam", "mac_phi", "cc_phi", "pressure"):
        nan_check(getattr(state, fname), f"{where}:{fname}")
    return state


def assert_finite_host(x, name: str = "field"):
    """Raise FloatingPointError when x (tensor or array) is not all
    finite."""
    arr = (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
           else np.asarray(x))
    if not np.all(np.isfinite(arr)):
        n_bad = int(np.sum(~np.isfinite(arr)))
        raise FloatingPointError(
            f"{name}: {n_bad}/{arr.size} non-finite values")
    return x
