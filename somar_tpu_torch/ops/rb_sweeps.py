"""Which launch shape a red-black smoother (K5, K7) takes on a level.

The two variants live in csrc/rb_sweep.cuh, whose tile extents this module
mirrors:

  "whole"  one block keeps the level's p ping-pong pair in shared memory and
           runs every half sweep of a smoothing call: 1 launch per call;
  "tiled"  one launch per full red+black sweep on shared-memory tiles with
           2-cell halos (3D: marching along array axis 0 over chunks of
           `tz` planes): `iters` launches per call.

`choose_variant` is a pure function of the level's shape, the item size,
the number of stencil offsets and the shared memory one block may use; the
wrappers call it once per plan and dtype, through `setup`.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

#: dynamic shared memory one block may use on the H100 (sm_90) after the
#: opt-in (cudaFuncAttributeMaxDynamicSharedMemorySize)
SMEM_PER_BLOCK = 232_448
#: the whole-level variant keeps p's ping-pong pair in at most this much
#: shared memory (the rest of the SM's 256 KB stays L1 for rhs and weights)
WHOLE_BYTES = 200 * 1024
#: tile extents along array axes 1 and 2 and planes per rolling window, by
#: number of array axes (rb::Tile in csrc/rb_sweep.cuh)
TILE = {2: (32, 32, 1), 3: (16, 64, 3)}
#: chunk depth along axis 0 of a 3D tiled sweep: enough blocks for two per
#: SM of the H100's 132, between these bounds
CHUNK = (4, 16)
TARGET_BLOCKS = 2 * 132

WHOLE, TILED = "whole", "tiled"


def tiled_smem_bytes(ndim: int, itemsize: int) -> int:
    """Shared memory of one tiled block: its rolling windows of old values
    (tile + 2-cell halo) and red values (tile + 1-cell ring)."""
    ty, tx, planes = TILE[ndim]
    return planes * ((ty + 4) * (tx + 4) + (ty + 2) * (tx + 2)) * itemsize


def chunk_depth(shape: Sequence[int]) -> int:
    """Planes along axis 0 per tiled block (1 in 2D)."""
    if len(shape) == 2:
        return 1
    ty, tx, _ = TILE[3]
    tiles = math.ceil(shape[1] / ty) * math.ceil(shape[2] / tx)
    tz = shape[0] * tiles // TARGET_BLOCKS
    return max(1, min(shape[0], max(CHUNK[0], min(CHUNK[1], tz))))


def choose_variant(shape: Sequence[int], itemsize: int, K: int = 0,
                   smem_per_block: int = SMEM_PER_BLOCK) -> Tuple[str, int]:
    """(variant, chunk depth) of a smoother on a 2D or 3D level.  "whole"
    where 2 * cells * itemsize fits WHOLE_BYTES and one block's shared
    memory, else "tiled".  K does not enter: both variants read the stencil
    weights from device memory."""
    if len(shape) not in TILE:
        raise ValueError(f"the smoothers take 2D or 3D arrays, got "
                         f"{len(shape)}D")
    if 2 * math.prod(shape) * itemsize <= min(WHOLE_BYTES, smem_per_block):
        return WHOLE, 0
    if tiled_smem_bytes(len(shape), itemsize) > smem_per_block:
        raise ValueError("a tiled block does not fit the shared memory of "
                         f"one block ({smem_per_block} bytes)")
    return TILED, chunk_depth(shape)


def launches_per_call(variant: str, iters: int) -> int:
    """Kernel launches of one smoothing call of `iters` sweeps."""
    if iters <= 0:
        return 0
    return 1 if variant == WHOLE else iters


def check_forced(variant: str, shape, itemsize: int,
                 smem_per_block: int = SMEM_PER_BLOCK) -> Tuple[str, int]:
    """(variant, chunk depth) for a variant a caller asks for by name."""
    if variant == TILED:
        return TILED, chunk_depth(shape)
    if variant == WHOLE:
        if 2 * math.prod(shape) * itemsize > smem_per_block:
            raise ValueError(f"level {tuple(shape)} does not fit one "
                             "block's shared memory")
        return WHOLE, 0
    raise ValueError(f"unknown smoother variant {variant!r}")


def setup(plan, phi, variant: Optional[str], bind):
    """(entry point, its arguments after the arrays, variant) of a smoother
    on `plan` for phi's dtype, chosen once and kept on the plan
    (plan._sweeps); `variant` forces one by name.  bind() returns the
    entry point and the plan's own arguments, to which the variant flag
    and the chunk depth are appended."""
    key = (phi.dtype, variant)
    got = plan._sweeps.get(key)
    if got is None:
        smem = smem_per_block(phi.device)
        item = phi.element_size()
        var, tz = (choose_variant(plan.shape, item, getattr(plan, "K", 0),
                                  smem)
                   if variant is None else
                   check_forced(variant, plan.shape, item, smem))
        fn, args = bind()
        got = plan._sweeps[key] = (fn, args + (int(var == TILED), tz), var)
    return got


def smem_per_block(device) -> int:
    """The opt-in shared memory per block of a CUDA device."""
    props = torch.cuda.get_device_properties(device)
    return int(getattr(props, "shared_memory_per_block_optin",
                       SMEM_PER_BLOCK))


def raw_stream(t) -> int:
    """The current CUDA stream of t's device, as an int."""
    get = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if get is not None:
        return get(t.device.index if t.device.index is not None
                   else torch.cuda.current_device())
    return torch.cuda.current_stream(t.device).cuda_stream
