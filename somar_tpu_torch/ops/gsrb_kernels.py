"""Red-black Gauss-Seidel and residual kernels K5-K6 of the uniform-metric
Helmholtz operator  L[phi] = alpha*phi + beta*lap(phi): hand-written CUDA
for Hopper, each beside its plain PyTorch twin.

Kernel (csrc/gsrb_kernels.cu)   replaces (somar_tpu/ops/gsrb_pallas.py)
  K5 gsrb_sweeps                gsrb_sweeps    (_small_kernel, _slab_kernel)
  K6 helm_residual              helm_residual  (same kernels, residual_only)

Scope, decided once per (grid, BCs) by `make_plan`:
  * uniform scalar metric (J = Jinv = Jgup = 1), at least two dimensions;
  * homogeneous BCs whose ghost formulas reduce to a boundary-face coupling
    factor with no ghost-neighbour term, so the kernels reproduce
    fill_ghosts_cc + mac_gradient + mac_divergence to roundoff:
      DIRICHLET  ghost = -c  -> face flux 2c/dx, factor 2
      NEUMANN    ghost = +c  -> face flux 0,     factor 0
      CF (hom)   ghost = 0   -> face flux c/dx,  factor 1
      EXTRAP(0)  ghost = c   -> face flux 0,     factor 0
      PERIODIC   wrap        -> factor 1, wrapped neighbour
A level outside that scope has no plan, and PoissonOp takes its generic
ghost-fill path; a level with a plan always goes through these wrappers.

Per array axis a the Laplacian term is
    coef[a] * (w_hi*(p[+1] - p) - w_lo*(p - p[-1])),
w_lo = flo[a] at index 0, w_hi = fhi[a] at index n-1, 1 elsewhere; a
neighbour outside a non-periodic domain counts as 0.  Differences are taken
FIRST: the gathered form sum(W*p) + diag*p cancels O(coef*|phi|) terms and
its f32 roundoff floor stalls multigrid on anisotropic grids.

What bounds the kernels on the card: device-memory bandwidth (K6 reads two
arrays and writes one; a sweep must do the same), a dozen flops per cell
and half sweep.  K5 has two variants, chosen once per plan and dtype by
`rb_sweeps.choose_variant` from the level's shape: on levels whose p
ping-pong pair fits one block's shared memory (up to (16,16,64) in f32),
one launch runs every half sweep of the call in shared memory (a cluster
of up to 8 blocks); on larger levels one launch does a full red+black
sweep on shared-memory tiles (red on the tile and a 1-cell ring from
2-cell halos, black on the tile), and consecutive sweeps ping-pong between
two device buffers.  Every read of a
half sweep sees the array as it was before that half sweep, on every
shape, including periodic axes of odd extent or of extent 2, where a
cell's wrap neighbour has its own colour.  K6 is one thread per cell.
Compiled with -fmad=false so that kernel and twin round alike.

Dispatch is by the tensor's device: a CPU tensor goes to the `*_plain`
twin; a CUDA tensor launches the kernel or raises.  There is no fallback
from a CUDA tensor to the twin.  Each wrapper counts its launches in
`<wrapper>.launches`.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from somar_tpu_torch import cuda_build
from somar_tpu_torch.core.bc import BCType, FieldBCs
from somar_tpu_torch.core.grid import Grid
from somar_tpu_torch.ops import rb_sweeps

#: (library name, sources under csrc/) for cuda_build
LIBRARY = ("somar_gsrb", ("gsrb_kernels.cu",))
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}

_FACTOR = {BCType.DIRICHLET: 2.0, BCType.NEUMANN: 0.0, BCType.CF: 1.0}


def _bc_factor(bc) -> Optional[float]:
    if bc.type == BCType.PERIODIC:
        return 1.0
    if bc.type == BCType.EXTRAP:
        return 0.0 if bc.order == 0 else None
    return _FACTOR.get(bc.type)


class FusedPlan:
    """Static per-(grid, BCs) data of the kernels, per ARRAY axis a
    (vertical-major layout): the face coefficient coef[a] = 1/dx_d^2, the
    periodic flag and the lo/hi boundary-face factors."""

    def __init__(self, grid: Grid, bcs: FieldBCs):
        self.ok = False
        nd = grid.ndim
        if nd < 2:
            return      # 1D grids take PoissonOp's generic path
        coef, periodic, flo, fhi = [], [], [], []
        for a in range(nd):
            d = grid.dir_of_axis(a)
            coef.append(1.0 / (grid.dx[d] ** 2))
            bc_per = bcs.lo[d].type == BCType.PERIODIC
            if bc_per != (bcs.hi[d].type == BCType.PERIODIC):
                return
            if bc_per and not grid.periodic[d]:
                return  # the BC wraps but the grid does not
            periodic.append(bc_per)
            lo = _bc_factor(bcs.lo[d])
            hi = _bc_factor(bcs.hi[d])
            if lo is None or hi is None:
                return
            flo.append(lo)
            fhi.append(hi)
        self.coef = tuple(coef)
        self.periodic = tuple(periodic)
        self.flo = tuple(flo)
        self.fhi = tuple(fhi)
        self.shape = grid.shape
        self.ndim = nd
        self.ok = True
        self._kernel_args = None    # the ctypes form, built at first launch
        self._sweeps = {}           # (dtype, variant) -> K5 launch set-up


def make_plan(grid: Grid, bcs: FieldBCs, geo=None) -> Optional[FusedPlan]:
    """FusedPlan or None.  geo (LevelGeometry) gates on uniform metric."""
    if geo is not None and not geo.is_uniform:
        return None
    plan = FusedPlan(grid, bcs)
    return plan if plan.ok else None


# --------------------------------------------------------------------------
# plain PyTorch twins (the kernels' arithmetic, in their operation order)
# --------------------------------------------------------------------------
def _iota(n: int, ax: int, nd: int, device):
    shape = [1] * nd
    shape[ax] = n
    return torch.arange(n, device=device).reshape(shape)


def _nbr(p, ax: int, sign: int, periodic: bool, idx):
    """p at index+sign along ax: wrapped on a periodic axis, zero outside
    the domain otherwise."""
    r = torch.roll(p, -sign, dims=ax)
    if periodic:
        return r
    edge = idx == (p.shape[ax] - 1 if sign > 0 else 0)
    return torch.where(edge, p.new_zeros(()), r)


def _edge_weights(plan: FusedPlan, p, iotas):
    """Per axis the broadcastable (w_lo, w_hi) boundary-face factors."""
    ws = []
    for a in range(plan.ndim):
        n = plan.shape[a]
        one = torch.ones_like(iotas[a], dtype=p.dtype)
        if plan.periodic[a]:
            ws.append((one, one))
            continue
        ws.append((torch.where(iotas[a] == 0, plan.flo[a] * one, one),
                   torch.where(iotas[a] == n - 1, plan.fhi[a] * one, one)))
    return ws


def _lap(plan: FusedPlan, p, iotas, ws):
    lap = None
    for a in range(plan.ndim):
        hi = _nbr(p, a, +1, plan.periodic[a], iotas[a])
        lo = _nbr(p, a, -1, plan.periodic[a], iotas[a])
        term = plan.coef[a] * (ws[a][1] * (hi - p) - ws[a][0] * (p - lo))
        lap = term if lap is None else lap + term
    return lap


def _check_plan(plan: FusedPlan, phi, rhs):
    if tuple(phi.shape) != tuple(plan.shape) or phi.shape != rhs.shape \
            or phi.dtype != rhs.dtype or phi.device != rhs.device:
        raise ValueError(
            f"phi {tuple(phi.shape)} {phi.dtype} {phi.device} / rhs "
            f"{tuple(rhs.shape)} {rhs.dtype} {rhs.device} do not match the "
            f"plan's shape {tuple(plan.shape)}")


def helm_residual_plain(plan: FusedPlan, phi, rhs, alpha, beta):
    _check_plan(plan, phi, rhs)
    iotas = [_iota(n, a, plan.ndim, phi.device)
             for a, n in enumerate(plan.shape)]
    ws = _edge_weights(plan, phi, iotas)
    return rhs - float(alpha) * phi - float(beta) * _lap(plan, phi, iotas, ws)


def gsrb_sweeps_plain(plan: FusedPlan, phi, rhs, alpha, beta, iters: int,
                      weight: float = 1.0):
    _check_plan(plan, phi, rhs)
    alpha, beta = float(alpha), float(beta)
    nd = plan.ndim
    iotas = [_iota(n, a, nd, phi.device) for a, n in enumerate(plan.shape)]
    ws = _edge_weights(plan, phi, iotas)
    diag = torch.zeros([1] * nd, dtype=phi.dtype, device=phi.device)
    for a in range(nd):
        diag = diag - plan.coef[a] * (ws[a][0] + ws[a][1])
    den = alpha + beta * diag
    inv_den = den.new_full((), float(weight)) / den     # one IEEE division
    parity = iotas[0]
    for a in range(1, nd):
        parity = parity + iotas[a]
    red = (parity % 2) == 0
    p = phi
    for _ in range(iters):
        for mask in (red, ~red):
            r = rhs - alpha * p - beta * _lap(plan, p, iotas, ws)
            p = torch.where(mask, p + inv_den * r, p)
    return p.clone() if p is phi else p


# --------------------------------------------------------------------------
# CUDA launch plumbing
# --------------------------------------------------------------------------
_VP = ctypes.c_void_p
_INT3 = ctypes.c_int * 3
_DBL3 = ctypes.c_double * 3


def load():
    """Build (first use only) and load the kernels' shared library, with
    every entry point's argument types declared."""
    lib = cuda_build.load_library(*LIBRARY)
    if getattr(lib, "_somar_declared", False):
        return lib
    ip, dp = ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_double)
    plan_args = [ctypes.c_int, ip, ip, dp, dp, dp]
    for suf in _SUFFIX.values():
        fn = getattr(lib, f"gsrb_sweeps_{suf}")
        fn.argtypes = [_VP] * 4 + plan_args + [ctypes.c_int] * 2 \
            + [ctypes.c_double] * 3 + [ctypes.c_int, _VP]
        fn.restype = ctypes.c_int
        fn = getattr(lib, f"helm_residual_{suf}")
        fn.argtypes = [_VP] * 3 + plan_args + [ctypes.c_double] * 2 + [_VP]
        fn.restype = ctypes.c_int
    lib._somar_declared = True
    return lib


def _on_cpu(t) -> bool:
    """True when the twin should run: the tensor lies on the CPU.  A tensor
    on another device than CUDA raises."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"GSRB kernels take CPU or CUDA tensors, got "
                         f"{t.device}")
    return False


def _plan_args(plan: FusedPlan):
    """The plan padded to three array axes (leading axes of extent 1 are
    inactive): (first active axis, extents, periodic flags, coef, flo,
    fhi), kept on the plan."""
    if plan._kernel_args is None:
        pad = 3 - plan.ndim
        if pad < 0:
            raise ValueError(f"GSRB kernels take 2D or 3D arrays, got "
                             f"{plan.ndim}D")
        plan._kernel_args = (
            pad, _INT3(*([1] * pad), *plan.shape),
            _INT3(*([0] * pad), *map(int, plan.periodic)),
            _DBL3(*([0.0] * pad), *plan.coef),
            _DBL3(*([1.0] * pad), *plan.flo),
            _DBL3(*([1.0] * pad), *plan.fhi))
    return plan._kernel_args


def _prepare(plan: FusedPlan, phi, rhs):
    _check_plan(plan, phi, rhs)
    if phi.dtype not in _SUFFIX:
        raise TypeError(f"GSRB kernels take float32/float64, got {phi.dtype}")
    if not 0 < math.prod(plan.shape) < 2 ** 31:
        raise ValueError("GSRB kernels take non-empty arrays of fewer than "
                         "2^31 cells")
    return phi.contiguous(), rhs.contiguous()


def _check(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"CUDA launch of {name} failed: error {rc} "
                           f"(cudaGetLastError)")


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------
def gsrb_sweeps(plan: FusedPlan, phi, rhs, alpha, beta, iters: int,
                weight: float = 1.0, variant: Optional[str] = None):
    """K5 — `iters` full red-black sweeps of the uniform-metric Helmholtz
    smoother on homogeneous BCs:
        p += weight/(alpha + beta*diag) * (rhs - alpha*p - beta*lap(p))
    on the cells whose index sum is even, then on the odd ones with the
    even ones updated.  alpha, beta are Python floats, rounded to the
    arrays' dtype.  On the card one launch runs the whole call ("whole")
    or one launch runs each sweep ("tiled"), as `rb_sweeps.choose_variant`
    picks for the plan; `variant` forces one.  Returns a new tensor; phi is
    left alone."""
    if _on_cpu(phi):
        return gsrb_sweeps_plain(plan, phi, rhs, alpha, beta, iters, weight)
    phi, rhs = _prepare(plan, phi, rhs)
    if iters <= 0:
        return phi.clone()
    name = f"gsrb_sweeps_{_SUFFIX[phi.dtype]}"
    fn, pargs, var = rb_sweeps.setup(
        plan, phi, variant, lambda: (getattr(load(), name), _plan_args(plan)))
    outs = [torch.empty_like(phi)]
    if var == rb_sweeps.TILED and iters > 1:
        outs.append(torch.empty_like(phi))
    rc = fn(phi.data_ptr(), rhs.data_ptr(), outs[0].data_ptr(),
            outs[-1].data_ptr(), *pargs, float(alpha), float(beta),
            float(weight), iters, rb_sweeps.raw_stream(phi))
    _check(rc, "gsrb_sweeps")
    gsrb_sweeps.launches += rb_sweeps.launches_per_call(var, iters)
    return outs[(iters - 1) % len(outs)]


def helm_residual(plan: FusedPlan, phi, rhs, alpha, beta):
    """K6 — rhs - (alpha*phi + beta*lap(phi)) on homogeneous BCs."""
    if _on_cpu(phi):
        return helm_residual_plain(plan, phi, rhs, alpha, beta)
    phi, rhs = _prepare(plan, phi, rhs)
    out = torch.empty_like(phi)
    rc = getattr(load(), f"helm_residual_{_SUFFIX[phi.dtype]}")(
        phi.data_ptr(), rhs.data_ptr(), out.data_ptr(), *_plan_args(plan),
        float(alpha), float(beta), rb_sweeps.raw_stream(phi))
    _check(rc, "helm_residual")
    helm_residual.launches += 1
    return out


#: the two GSRB kernels' wrappers, in K5-K6 order
KERNELS = (gsrb_sweeps, helm_residual)
for _k in KERNELS:
    _k.launches = 0


def reset_launch_counts():
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}
