"""Red-black Gauss-Seidel and residual kernels K7-K8 of the MAPPED-metric
Helmholtz operator  L[phi] = alpha*phi + beta*Jinv*div(Jgup grad phi):
hand-written CUDA for Hopper, each beside its plain PyTorch twin, and the
set-up that gives them their stencil.

Kernel (csrc/stencil_gsrb_kernels.cu)  replaces
                                  (somar_tpu/ops/stencil_gsrb_pallas.py)
  K7 stencil_gsrb_sweeps          gsrb_sweeps   (_small_kernel, _slab_kernel)
  K8 stencil_helm_residual        helm_residual (same kernels, residual_only)

The stencil is EXTRACTED, not derived: `build_stencil_plan` probes the
operator's own plain path (PoissonOp.apply, alpha=0, beta=1, homogeneous
BCs) with lattice-colouring indicator fields,

    W_o[c] = Lambda[chi_{colour(c+o)}][c],

where the colouring modulus per axis (3, or 4 on a periodic axis whose
extent is not divisible by 3) makes every offset of the 3^nd neighbourhood
colour-distinct.  BC ghost folds and the cross-metric quirks (Neumann cross
zeroing, corner ghosts) are in the probed weights by construction; offsets
whose weights are all exactly 0 are dropped; the plan is checked against
the operator on a random field (f32 values, 1e-4 of max|Lambda x|) and
dropped when the stencil is not representable.  An offset that points out
of the domain lands on a colour with no in-range support, so its weight is
exactly 0 and the kernels wrap every neighbour read.

Both kernels evaluate the DIFFERENCE form

    lap[c] = R[c]*phi[c] + sum_{o != 0} W_o[c] * (phi[c+o] - phi[c])

(R = Lambda[1], the row sum), accumulated in the plan's offset order
(itertools.product order, zero offset skipped); the gathered form's
O(W*|phi|) roundoff floor stalls multigrid on anisotropic metrics in f32.
The smoother's diagonal is the operator's own diagonal w0 = op.diag(0, 1),
not the probed centre weight, so the sweeps equal PoissonOp's plain
red-black smoother.  Wn, R and w0 can be overridden per call: the altered
metric of implicit gravity enters the operator linearly, and its solves
pass plan.Wn + dWn etc. (`delta_stencil_weights`, once per solve).

What bounds the kernels on the card: device-memory bandwidth.  A sweep must
read phi, rhs, K weight planes, R and w0 and write phi: K+5 arrays (K = 8
in 2D with a non-diagonal metric; at most 18 in 3D, since the cross terms
couple two axes at a time and the 8 corner offsets probe to 0), about 3K
flops per cell.  K7 has two variants, chosen once per plan and dtype by
`rb_sweeps.choose_variant`: on levels whose phi ping-pong pair fits one
block's shared memory (up to (32,320) on the BeamGeneration path), one
launch runs every half sweep of the call in shared memory (a cluster of
up to 8 blocks); on larger levels one launch does a full red+black sweep
on shared-memory tiles (red on the tile and a 1-cell ring from 2-cell
halos, black on the tile) and reads each weight plane about once, and
consecutive sweeps ping-pong between two device buffers.  With a 3^nd
stencil a cell's diagonal neighbours share its colour, and on a periodic
extent of 3 a cell wraps onto its own colour: each half sweep updates its
colour from the array as it was before it, in shared memory too, as the
Pallas kernel does.  K8 is one thread per cell.  Compiled with
-fmad=false so that kernel and twin round alike.

Dispatch is by the tensor's device: a CPU tensor goes to the `*_plain`
twin; a CUDA tensor launches the kernel or raises.  There is no fallback
from a CUDA tensor to the twin.  Each wrapper counts its launches in
`<wrapper>.launches`.
"""

from __future__ import annotations

import ctypes
import itertools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from somar_tpu_torch import cuda_build
from somar_tpu_torch.ops import rb_sweeps

#: (library name, sources under csrc/) for cuda_build
LIBRARY = ("somar_stencil", ("stencil_gsrb_kernels.cu",))
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
#: validation of a probed plan: f32 random field, relative limit
VALIDATE_RTOL = 1e-4


# --------------------------------------------------------------------------
# stencil extraction by lattice-colouring probes (set-up, plain torch)
# --------------------------------------------------------------------------
def moduli(shape, periodic) -> Optional[Tuple[int, ...]]:
    """Colouring modulus per array axis, or None when no colouring makes
    the 3^nd offsets distinct (an extent below 3, or a periodic extent
    divisible by neither 3 nor 4)."""
    mods = []
    for n, per in zip(shape, periodic):
        if n < 3:
            return None
        if not per or n % 3 == 0:
            mods.append(3)
        elif n % 4 == 0:
            mods.append(4)
        else:
            return None
    return tuple(mods)


class _Colouring:
    """colour(c + off) fields of a lattice colouring with moduli `mods`."""

    def __init__(self, shape, mods, device):
        nd = len(shape)
        self.idx = []
        for a, n in enumerate(shape):
            view = [1] * nd
            view[a] = n
            self.idx.append(torch.arange(n, device=device).reshape(view))
        self.shape = tuple(shape)
        self.mods = mods
        self.strides = [math.prod(mods[a + 1:]) for a in range(nd)]
        self.ncolours = math.prod(mods)
        self.base = self.of((0,) * nd)

    def of(self, off):
        c = torch.zeros(self.shape, dtype=torch.int64,
                        device=self.idx[0].device)
        for a, o in enumerate(off):
            c = c + ((self.idx[a] + o) % self.mods[a]) * self.strides[a]
        return c

    def probe(self, apply_fn, dtype):
        """(ncolours,)+shape: apply_fn of each colour's indicator field."""
        return torch.stack([apply_fn((self.base == v).to(dtype))
                            for v in range(self.ncolours)])

    def weights(self, Y, off):
        """w[c] = Y[colour(c + off)][c]."""
        return torch.gather(Y, 0, self.of(off)[None])[0]


def probe_stencil(apply_fn, shape, periodic, dtype, device):
    """Extract the interior stencil of a linear operator with support in
    the 3^nd neighbourhood: (offsets, Wn, R) with the nonzero offsets in
    itertools.product order (all-zero weights pruned), Wn the stacked
    (K,)+shape weights (out[c] weights phi[c + offset]) and R the exact row
    sum apply_fn(ones); None when no colouring exists."""
    mods = moduli(shape, periodic)
    if mods is None:
        return None
    col = _Colouring(shape, mods, device)
    Y = col.probe(apply_fn, dtype)
    offsets, ws = [], []
    for off in itertools.product((-1, 0, 1), repeat=len(shape)):
        if all(o == 0 for o in off):
            continue
        w = col.weights(Y, off)
        if not bool((w != 0.0).any()):
            continue
        offsets.append(off)
        ws.append(w)
    R = apply_fn(torch.ones(shape, dtype=dtype, device=device))
    if not offsets:
        return (), torch.zeros((0,) + tuple(shape), dtype=dtype,
                               device=device), R
    return tuple(offsets), torch.stack(ws), R


class StencilPlan:
    """Probed-stencil data of the kernels: K nonzero offsets (array axes),
    the (K,)+shape neighbour weights Wn, the row sum R, the smoother
    diagonal D = op.diag(0, 1), the shape and the per-axis periodic flags."""

    def __init__(self, offsets, Wn, R, D, shape, periodic):
        self.offsets = tuple(tuple(int(o) for o in off) for off in offsets)
        self.Wn = Wn
        self.R = R
        self.D = D
        self.shape = tuple(shape)
        self.periodic = tuple(periodic)
        self.ndim = len(shape)
        self.K = len(self.offsets)
        self._kernel_args = None    # the ctypes form, built at first launch
        self._sweeps = {}           # (dtype, variant) -> K7 launch set-up


def build_stencil_plan(op) -> Optional[StencilPlan]:
    """StencilPlan of a PoissonOp's homogeneous Lambda (alpha=0, beta=1, no
    jgup_delta), or None: 1D grids, no colouring, or a stencil that the
    3^nd box cannot represent (validation)."""
    grid = op.grid
    if grid.ndim < 2:
        return None
    geo = op.geo
    per = [grid.periodic[grid.dir_of_axis(a)] for a in range(grid.ndim)]

    def lam(x):
        return op.apply(x, 0.0, 1.0, homogeneous=True)

    got = probe_stencil(lam, grid.shape, per, geo.dtype, geo.device)
    if got is None:
        return None
    offsets, Wn, R = got
    D = op.diag(0.0, 1.0) * torch.ones(grid.shape, dtype=geo.dtype,
                                       device=geo.device)
    plan = StencilPlan(offsets, Wn, R, D.contiguous(), grid.shape, per)
    rng = np.random.default_rng(12345)
    x = torch.as_tensor(rng.standard_normal(grid.shape).astype(
        np.float32)).to(device=geo.device, dtype=geo.dtype)
    want = lam(x)
    scale = float(want.abs().max()) + 1e-30
    if float((apply_reference(plan, x) - want).abs().max()) \
            > VALIDATE_RTOL * scale:
        return None
    return plan


def roll_to(p, off):
    """out[c] = p[c + off], wrapped on every axis."""
    dims = tuple(a for a, o in enumerate(off) if o)
    if not dims:
        return p
    return torch.roll(p, tuple(-off[a] for a in dims), dims)


def _lap(offsets, p, Wn, R):
    lap = R * p
    for k, off in enumerate(offsets):
        lap = lap + Wn[k] * (roll_to(p, off) - p)
    return lap


def apply_reference(plan: StencilPlan, phi):
    """Lambda(phi) rebuilt from the plan (validation)."""
    return _lap(plan.offsets, phi, plan.Wn, plan.R)


def delta_stencil_weights(plan: StencilPlan, op, jgup_delta):
    """Stencil weights of a jgup_delta contribution at the plan's offsets:
    the altered metric of implicit gravity enters the operator linearly,
    Lambda_total = Lambda_base + Lambda_delta.  Returns (dWn, dR) to add to
    plan.Wn / plan.R, or None when the plan's offsets might not cover the
    delta's support (the delta carries cross-metric terms, so the plan must
    span the full 3^nd - 1 neighbourhood, as it does on non-diagonal
    metrics).  Costs 2 * (ncolours + 1) operator applications: once per
    solve (LevelMultigrid), never per relax call."""
    nd = plan.ndim
    if plan.K != 3 ** nd - 1:
        return None
    mods = moduli(plan.shape, plan.periodic)
    if mods is None:
        return None

    def dapply(x):
        return (op.apply(x, 0.0, 1.0, homogeneous=True,
                         jgup_delta=jgup_delta)
                - op.apply(x, 0.0, 1.0, homogeneous=True))

    dtype, device = plan.Wn.dtype, plan.Wn.device
    col = _Colouring(plan.shape, mods, device)
    Y = col.probe(dapply, dtype)
    dWn = torch.stack([col.weights(Y, off) for off in plan.offsets])
    dR = dapply(torch.ones(plan.shape, dtype=dtype, device=device))
    return dWn, dR


# --------------------------------------------------------------------------
# plain PyTorch twins (the kernels' arithmetic, in their operation order)
# --------------------------------------------------------------------------
def _check(plan: StencilPlan, phi, *pairs):
    """Raise unless every (tensor, shape) pair has that shape and phi's
    dtype and device."""
    for t, shape in ((phi, plan.shape),) + pairs:
        if tuple(t.shape) != tuple(shape) or t.dtype != phi.dtype \
                or t.device != phi.device:
            raise ValueError(
                f"operand {tuple(t.shape)} {t.dtype} {t.device} does not "
                f"match the plan's {tuple(shape)} / phi's {phi.dtype} "
                f"{phi.device}")


def _weights(plan: StencilPlan, phi, rhs, Wn, R):
    """The plan's weights and row sum unless overridden, checked."""
    Wn = plan.Wn if Wn is None else Wn
    R = plan.R if R is None else R
    _check(plan, phi, (rhs, plan.shape), (Wn, (plan.K,) + plan.shape),
           (R, plan.shape))
    return Wn, R


def _diagonal(plan: StencilPlan, phi, w0):
    """The smoother diagonal: the plan's unless overridden, checked."""
    w0 = plan.D if w0 is None else w0
    _check(plan, phi, (w0, plan.shape))
    return w0


def _red_mask(shape, device):
    parity = torch.zeros(shape, dtype=torch.int64, device=device)
    nd = len(shape)
    for a, n in enumerate(shape):
        view = [1] * nd
        view[a] = n
        parity = parity + torch.arange(n, device=device).reshape(view)
    return (parity % 2) == 0


def stencil_helm_residual_plain(plan: StencilPlan, phi, rhs, alpha, beta,
                                Wn=None, R=None):
    Wn, R = _weights(plan, phi, rhs, Wn, R)
    return rhs - float(alpha) * phi \
        - float(beta) * _lap(plan.offsets, phi, Wn, R)


def stencil_gsrb_sweeps_plain(plan: StencilPlan, phi, rhs, alpha, beta,
                              iters: int, weight: float = 1.0, Wn=None,
                              R=None, w0=None):
    Wn, R = _weights(plan, phi, rhs, Wn, R)
    w0 = _diagonal(plan, phi, w0)
    alpha, beta = float(alpha), float(beta)
    den = alpha + beta * w0
    inv_den = torch.full_like(den, float(weight)) / den   # IEEE division
    red = _red_mask(plan.shape, phi.device)
    p = phi
    for _ in range(iters):
        for mask in (red, ~red):
            r = rhs - alpha * p - beta * _lap(plan.offsets, p, Wn, R)
            p = torch.where(mask, p + inv_den * r, p)
    return p.clone() if p is phi else p


# --------------------------------------------------------------------------
# CUDA launch plumbing
# --------------------------------------------------------------------------
_VP = ctypes.c_void_p
_INT3 = ctypes.c_int * 3


def load():
    """Build (first use only) and load the kernels' shared library, with
    every entry point's argument types declared."""
    lib = cuda_build.load_library(*LIBRARY)
    if getattr(lib, "_somar_declared", False):
        return lib
    ip = ctypes.POINTER(ctypes.c_int)
    plan_args = [ctypes.c_int, ip, ctypes.c_int, ip]
    for suf in _SUFFIX.values():
        fn = getattr(lib, f"stencil_gsrb_sweeps_{suf}")
        fn.argtypes = [_VP] * 7 + plan_args + [ctypes.c_int] * 2 \
            + [ctypes.c_double] * 3 + [ctypes.c_int, _VP]
        fn.restype = ctypes.c_int
        fn = getattr(lib, f"stencil_helm_residual_{suf}")
        fn.argtypes = [_VP] * 5 + plan_args + [ctypes.c_double] * 2 + [_VP]
        fn.restype = ctypes.c_int
    lib._somar_declared = True
    return lib


def _on_cpu(t) -> bool:
    """True when the twin should run: the tensor lies on the CPU.  A tensor
    on another device than CUDA raises."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"stencil GSRB kernels take CPU or CUDA tensors, "
                         f"got {t.device}")
    return False


def _plan_args(plan: StencilPlan):
    """(ndim, extents padded to three axes, K, offsets padded to three
    axes), kept on the plan."""
    if plan._kernel_args is None:
        pad = 3 - plan.ndim
        if pad < 0 or plan.ndim < 2:
            raise ValueError(f"stencil GSRB kernels take 2D or 3D arrays, "
                             f"got {plan.ndim}D")
        if plan.K > 26:
            raise ValueError(f"a 3^nd stencil has at most 26 offsets, got "
                             f"{plan.K}")
        flat = [v for off in plan.offsets for v in (0,) * pad + off]
        plan._kernel_args = (plan.ndim, _INT3(*([1] * pad), *plan.shape),
                             plan.K, (ctypes.c_int * max(1, len(flat)))(
                                 *flat))
    return plan._kernel_args


def _prepare(plan, phi, rhs, *weights):
    if phi.dtype not in _SUFFIX:
        raise TypeError(f"stencil GSRB kernels take float32/float64, got "
                        f"{phi.dtype}")
    if not 0 < math.prod(plan.shape) < 2 ** 31:
        raise ValueError("stencil GSRB kernels take non-empty arrays of "
                         "fewer than 2^31 cells")
    return [t.contiguous() for t in (phi, rhs) + weights]


def _check_rc(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"CUDA launch of {name} failed: error {rc} "
                           f"(cudaGetLastError)")


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------
def stencil_gsrb_sweeps(plan: StencilPlan, phi, rhs, alpha, beta,
                        iters: int, weight: float = 1.0, Wn=None, R=None,
                        w0=None, variant: Optional[str] = None):
    """K7 — `iters` full red-black sweeps of the probed-stencil Helmholtz
    smoother:
        p += weight/(alpha + beta*w0) * (rhs - alpha*p - beta*lap(p))
    on the cells whose index sum is even, then on the odd ones with the
    even ones updated.  Wn/R/w0 override the plan's weights, row sum and
    smoother diagonal.  alpha, beta are Python floats, rounded to the
    arrays' dtype.  On the card one launch runs the whole call ("whole")
    or one launch runs each sweep ("tiled"), as `rb_sweeps.choose_variant`
    picks for the plan; `variant` forces one.  Returns a new tensor; phi is
    left alone."""
    if _on_cpu(phi):
        return stencil_gsrb_sweeps_plain(plan, phi, rhs, alpha, beta, iters,
                                         weight, Wn, R, w0)
    Wn, R = _weights(plan, phi, rhs, Wn, R)
    w0 = _diagonal(plan, phi, w0)
    phi, rhs, Wn, R, w0 = _prepare(plan, phi, rhs, Wn, R, w0)
    if iters <= 0:
        return phi.clone()
    name = f"stencil_gsrb_sweeps_{_SUFFIX[phi.dtype]}"
    fn, pargs, var = rb_sweeps.setup(
        plan, phi, variant, lambda: (getattr(load(), name), _plan_args(plan)))
    outs = [torch.empty_like(phi)]
    if var == rb_sweeps.TILED and iters > 1:
        outs.append(torch.empty_like(phi))
    rc = fn(phi.data_ptr(), rhs.data_ptr(), Wn.data_ptr(), R.data_ptr(),
            w0.data_ptr(), outs[0].data_ptr(), outs[-1].data_ptr(), *pargs,
            float(alpha), float(beta), float(weight), iters,
            rb_sweeps.raw_stream(phi))
    _check_rc(rc, "stencil_gsrb_sweeps")
    stencil_gsrb_sweeps.launches += rb_sweeps.launches_per_call(var, iters)
    return outs[(iters - 1) % len(outs)]


def stencil_helm_residual(plan: StencilPlan, phi, rhs, alpha, beta,
                          Wn=None, R=None):
    """K8 — rhs - (alpha*phi + beta*lap(phi)) with the probed stencil
    (Wn/R override the plan's)."""
    if _on_cpu(phi):
        return stencil_helm_residual_plain(plan, phi, rhs, alpha, beta, Wn,
                                           R)
    Wn, R = _weights(plan, phi, rhs, Wn, R)
    phi, rhs, Wn, R = _prepare(plan, phi, rhs, Wn, R)
    out = torch.empty_like(phi)
    rc = getattr(load(), f"stencil_helm_residual_{_SUFFIX[phi.dtype]}")(
        phi.data_ptr(), rhs.data_ptr(), Wn.data_ptr(), R.data_ptr(),
        out.data_ptr(), *_plan_args(plan), float(alpha), float(beta),
        rb_sweeps.raw_stream(phi))
    _check_rc(rc, "stencil_helm_residual")
    stencil_helm_residual.launches += 1
    return out


#: the two probed-stencil kernels' wrappers, in K7-K8 order
KERNELS = (stencil_gsrb_sweeps, stencil_helm_residual)
for _k in KERNELS:
    _k.launches = 0


def reset_launch_counts():
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}
