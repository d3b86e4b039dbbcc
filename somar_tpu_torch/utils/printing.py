"""Logging: the per-process run log pout.<rank>, rank-filtered terminal
output, ANSI colors and plain-text field dumps (PyTorch port of
`somar_tpu.utils.printing`).  The rank is torch.distributed's when a
process group is initialized, else 0.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch


class color:
    """ANSI colors."""
    reset = "\033[0m"
    black = "\033[30m"
    red = "\033[31m"
    green = "\033[32m"
    yellow = "\033[33m"
    blue = "\033[34m"
    magenta = "\033[35m"
    cyan = "\033[36m"
    white = "\033[37m"
    hired = "\033[91m"
    higreen = "\033[92m"
    hiyellow = "\033[93m"
    hiblue = "\033[94m"


_pout_file = None


def _rank() -> int:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def set_pout_dir(path: str):
    """Point the pout.<rank> log at a run directory (the RunDriver's
    out_dir); closes any open log."""
    global _pout_file
    if _pout_file is not None:
        _pout_file.close()
        _pout_file = None
    os.environ["SOMAR_POUT_DIR"] = path


def pout(*args, **kw):
    """Append a line to the per-process log file pout.<rank>."""
    global _pout_file
    if _pout_file is None:
        path = os.environ.get("SOMAR_POUT_DIR", ".")
        _pout_file = open(os.path.join(path, f"pout.{_rank()}"), "a")
    print(*args, file=_pout_file, **kw)
    _pout_file.flush()


def tout(*args, rank: int = 0, verbosity: int = 1,
         min_verbosity: int = 1, **kw):
    """Terminal output printed only on the given rank and when
    verbosity >= min_verbosity."""
    if _rank() == rank and verbosity >= min_verbosity:
        print(*args, **kw)
        sys.stdout.flush()


def write_text_file(path: str, array, fmt: str = "%.8g"):
    """Plain-text field dump, one value per line."""
    if isinstance(array, torch.Tensor):
        array = array.detach().cpu().numpy()
    np.savetxt(path, np.asarray(array).reshape(-1), fmt=fmt)
