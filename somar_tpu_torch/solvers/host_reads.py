"""Device-to-host reads of the solvers' and the time loop's control flow.

The iterative solvers keep their arithmetic on the device and read a few
scalars per iteration to decide whether to go on; every such read goes
through `read_scalars`, which counts them in `read_scalars.count` (each read
waits for the device, so reads per step is a metric of the host path).
"""

from __future__ import annotations

from typing import List

import torch


def read_scalars(*scalars) -> List[float]:
    """The values of a few 0-d tensors of one device and dtype, in ONE
    transfer."""
    read_scalars.count += 1
    return torch.stack(scalars).tolist()


read_scalars.count = 0
