"""CTU advection kernels K1-K4: hand-written CUDA for Hopper, each beside
its plain PyTorch twin.

Kernel (csrc/ctu_kernels.cu)   replaces (somar_tpu/ops/pallas_kernels.py)
  K1 ppm_predict               ppm_predict_pallas      (_ppm_kernel)
  K2 ctu_corr3                 ctu_corr3_pallas        (_corr3_kernel)
  K3 ctu_final                 ctu_final_pallas        (_final_kernel)
  K4 riemann_fluxdiv           riemann_fluxdiv_pallas  (_reflux_kernel)

All arrays are full padded cell arrays of one shape (face-indexed: entry f
is the face between cells f and f+1, edge entries junk; see
physics/godunov.py), and every stencil runs along exactly one array axis
`ax`.  What bounds them on the card: device-memory bandwidth.  K1 reads 2
arrays and writes 3 (~20 bytes per cell in f32), K2 reads 3 + ncorr and
writes ncorr, K3 reads up to 6 and writes up to 3, K4 reads 1 + 2 nf and
writes nf; each does a few dozen flops per cell.  Design of this first
version: one thread per output element, each recomputing the few
neighbour values it needs along `ax` (no shared-memory tiling), float and
double instantiations, compiled with -fmad=false so that kernel and twin
round identically.

Dispatch is by the tensor's device: a CPU tensor goes to the `*_plain`
twin; a CUDA tensor launches the kernel or raises (unsupported dtype,
mismatched shapes or devices, a failed launch).  There is no fallback from
a CUDA tensor to the twin.  Each wrapper counts its launches in
`<wrapper>.launches`.
"""

from __future__ import annotations

import ctypes
import math
from typing import List, Optional, Sequence, Tuple

import torch

from somar_tpu_torch import cuda_build
from somar_tpu_torch.ops.stencil import shift_m, shift_p

#: (library name, sources under csrc/) for cuda_build
LIBRARY = ("somar_ctu", ("ctu_kernels.cu",))
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_MAX_FIELDS = 4   # kMaxFields of csrc/ctu_kernels.cu


# --------------------------------------------------------------------------
# plain PyTorch twins (the math of the Pallas kernel bodies)
# --------------------------------------------------------------------------
def riemann(lo, hi, vf):
    """Passive-advection Riemann: upwind by the face velocity, average
    where |vf| <= 1e-12."""
    avg = 0.5 * (lo + hi)
    return torch.where(vf > 1e-12, lo, torch.where(vf < -1e-12, hi, avg))


def ppm_face_states(s, u, dt_over_dx, ax: int, use_limiting: bool):
    """Face-indexed PPM traced states (lo, hi) along `ax`: 4th-order face
    values, optional CW84 limiting and characteristic tracing with
    nu = u dt/dx on cells [2, n-2), edge-padded back to length n."""
    n = s.shape[ax]
    m = n - 4

    def cell(k):
        return s.narrow(ax, 2 + k, m)

    c_m2, c_m1, c_0, c_p1, c_p2 = (cell(k) for k in (-2, -1, 0, 1, 2))
    nu = u.narrow(ax, 2, m) * dt_over_dx
    sR = (7.0 / 12.0) * (c_0 + c_p1) - (1.0 / 12.0) * (c_m1 + c_p2)
    sL = (7.0 / 12.0) * (c_m1 + c_0) - (1.0 / 12.0) * (c_m2 + c_p1)
    if use_limiting:
        flat = (sR - c_0) * (c_0 - sL) <= 0.0
        dsum0 = sR - sL
        s6t = 6.0 * (c_0 - 0.5 * (sL + sR))
        cond_l = dsum0 * s6t > dsum0 * dsum0
        cond_r = -dsum0 * dsum0 > dsum0 * s6t
        sLn = torch.where(flat, c_0,
                          torch.where(cond_l, 3.0 * c_0 - 2.0 * sR, sL))
        sRn = torch.where(flat, c_0,
                          torch.where(cond_r, 3.0 * c_0 - 2.0 * sL, sR))
        sL, sR = sLn, sRn
    dsum = sR - sL
    s6 = 6.0 * (c_0 - 0.5 * (sL + sR))
    sig_p = torch.clamp_min(nu, 0.0)
    sig_m = torch.clamp_min(-nu, 0.0)
    splus = sR - 0.5 * sig_p * (dsum - (1.0 - (2.0 / 3.0) * sig_p) * s6)
    sminus = sL + 0.5 * sig_m * (dsum + (1.0 - (2.0 / 3.0) * sig_m) * s6)

    def edge_pad(arr):
        first = arr.narrow(ax, 0, 1)
        last = arr.narrow(ax, m - 1, 1)
        return torch.cat([first, first, arr, last, last], dim=ax)

    return edge_pad(splus), shift_p(edge_pad(sminus), ax)


def ppm_predict_plain(sp, up, dt_over_dx, ax: int, use_limiting: bool,
                      corr_coef_over_dx=0.0):
    lo, hi = ppm_face_states(sp, up, dt_over_dx, ax, use_limiting)
    rie = riemann(lo, hi, 0.5 * (up + shift_p(up, ax)))
    corr = -corr_coef_over_dx * up * (rie - shift_m(rie, ax))
    return lo, hi, corr


def ctu_corr3_plain(lo1, hi1, u, corr2_list: Sequence, dt_half_over_dx,
                    ax: int) -> List:
    vf = 0.5 * (u + shift_p(u, ax))
    out = []
    for c in corr2_list:
        rie2 = riemann(lo1 + c, hi1 + shift_p(c, ax), vf)
        out.append(-dt_half_over_dx * u * (rie2 - shift_m(rie2, ax)))
    return out


def ctu_final_plain(lo1, hi1, adv, c3_list: Sequence, src, half_dt,
                    ax: int, want_pre: bool = False, want_rie: bool = True,
                    want_div: bool = False) -> Tuple:
    csum = c3_list[0]
    for c in c3_list[1:]:
        csum = csum + c
    if src is not None:
        csum = csum + half_dt * src
    lo_f = lo1 + csum
    hi_f = hi1 + shift_p(csum, ax)
    out = []
    if want_div:
        F = riemann(lo_f, hi_f, adv) * adv
        out.append(F - shift_m(F, ax))
    elif want_rie:
        out.append(riemann(lo_f, hi_f, adv))
    if want_pre:
        out += [lo_f, hi_f]
    return tuple(out)


def riemann_fluxdiv_plain(pre_pairs: Sequence, adv, ax: int) -> List:
    out = []
    for lo, hi in pre_pairs:
        F = riemann(lo, hi, adv) * adv
        out.append(F - shift_m(F, ax))
    return out


# --------------------------------------------------------------------------
# CUDA launch plumbing
# --------------------------------------------------------------------------
_VP = ctypes.c_void_p
_I64 = ctypes.c_longlong
_INT = ctypes.c_int


def load():
    """Build (first use only) and load the kernels' shared library, with
    every entry point's argument types declared."""
    lib = cuda_build.load_library(*LIBRARY)
    if getattr(lib, "_somar_declared", False):
        return lib
    for suf, sc in (("f32", ctypes.c_float), ("f64", ctypes.c_double)):
        fn = getattr(lib, f"ctu_ppm_predict_{suf}")
        fn.argtypes = [_VP] * 5 + [_I64, _I64, _INT, _INT, sc, sc, _VP]
        fn = getattr(lib, f"ctu_corr3_{suf}")
        fn.argtypes = [_VP] * 7 + [_INT, _I64, _I64, _INT, sc, _VP]
        fn = getattr(lib, f"ctu_final_{suf}")
        fn.argtypes = [_VP] * 9 + [_I64, _I64, _INT, sc, _INT, _VP]
        fn = getattr(lib, f"ctu_riemann_fluxdiv_{suf}")
        fn.argtypes = [_VP, ctypes.POINTER(_VP), ctypes.POINTER(_VP),
                       ctypes.POINTER(_VP), _INT, _I64, _I64, _INT, _VP]
        for name in ("ppm_predict", "corr3", "final", "riemann_fluxdiv"):
            getattr(lib, f"ctu_{name}_{suf}").restype = _INT
    lib._somar_declared = True
    return lib


def _on_cpu(*tensors) -> bool:
    """True when the twin should run: the first tensor lies on the CPU.
    Any tensor on another device than CUDA raises."""
    dev = tensors[0].device
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"CTU kernels take CPU or CUDA tensors, got {dev}")
    return False


def _prepare(ref, tensors):
    """Validate CUDA operands against `ref` and make them contiguous."""
    if ref.dtype not in _SUFFIX:
        raise TypeError(f"CTU kernels take float32/float64, got {ref.dtype}")
    out = []
    for t in tensors:
        if t is None:
            out.append(None)
            continue
        if t.device != ref.device or t.dtype != ref.dtype \
                or t.shape != ref.shape:
            raise ValueError(
                f"operand {tuple(t.shape)} {t.dtype} {t.device} does not "
                f"match {tuple(ref.shape)} {ref.dtype} {ref.device}")
        out.append(t.contiguous())
    return out


def _line(shape, ax: int):
    """(total elements, stride of axis ax, length of axis ax)."""
    if not 0 <= ax < len(shape):
        raise ValueError(f"axis {ax} out of range for shape {tuple(shape)}")
    return math.prod(shape), math.prod(shape[ax + 1:]), shape[ax]


def _ptr(t) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _stream(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"CUDA launch of {name} failed: error {rc} "
                           f"(cudaGetLastError)")


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------
def ppm_predict(sp, up, dt_over_dx, ax: int, use_limiting: bool,
                corr_coef_over_dx=0.0):
    """K1 — fused PPM stage-1 for one direction on a padded array.

    sp, up: padded scalar / tracing velocity (same shape, length >= 5
    along ax).  Returns (lo, hi, corr2) face-indexed arrays of sp's shape,
    corr2 = -coef/dx * u * (rie[c] - rie[c-1]) with rie the stage-1
    Riemann state against the face-averaged u."""
    if _on_cpu(sp):
        return ppm_predict_plain(sp, up, dt_over_dx, ax, use_limiting,
                                 corr_coef_over_dx)
    sp, up = _prepare(sp, (sp, up))
    total, st, n = _line(sp.shape, ax)
    if n < 5:
        raise ValueError(f"PPM needs >= 5 cells along axis {ax}, got {n}")
    lo, hi, corr = (torch.empty_like(sp) for _ in range(3))
    suf = _SUFFIX[sp.dtype]
    rc = getattr(load(), f"ctu_ppm_predict_{suf}")(
        _ptr(sp), _ptr(up), _ptr(lo), _ptr(hi), _ptr(corr), total, st, n,
        int(bool(use_limiting)), float(dt_over_dx),
        -float(corr_coef_over_dx), _stream(sp))
    _check(rc, "ppm_predict")
    ppm_predict.launches += 1
    return lo, hi, corr


def ctu_corr3(lo1_j, hi1_j, u_pad_j, corr2_list: Sequence, dt_half_over_dx,
              ax: int) -> List:
    """K2 — 3D CTU cross terms for face direction j (array axis ax): for
    each corr2_k returns -(dt/2)/dx_j * u_j * d/dxi_j Riemann(lo1_j +
    corr2_k, hi1_j + shift_p(corr2_k), facevg(u_j))."""
    if _on_cpu(lo1_j):
        return ctu_corr3_plain(lo1_j, hi1_j, u_pad_j, corr2_list,
                               dt_half_over_dx, ax)
    lo1, hi1, u, *cs = _prepare(lo1_j, (lo1_j, hi1_j, u_pad_j, *corr2_list))
    total, st, n = _line(lo1.shape, ax)
    fn = getattr(load(), f"ctu_corr3_{_SUFFIX[lo1.dtype]}")
    out = []
    for i in range(0, len(cs), 2):      # the kernel takes two per launch
        chunk = cs[i:i + 2]
        outs = [torch.empty_like(lo1) for _ in chunk]
        rc = fn(_ptr(lo1), _ptr(hi1), _ptr(u), _ptr(chunk[0]),
                _ptr(chunk[-1]), _ptr(outs[0]), _ptr(outs[-1]), len(chunk),
                total, st, n, -float(dt_half_over_dx), _stream(lo1))
        _check(rc, "ctu_corr3")
        ctu_corr3.launches += 1
        out += outs
    return out


def ctu_final(lo1_d, hi1_d, adv_pad_d, c3_list: Sequence, src_pad, half_dt,
              ax: int, want_pre: bool = False, want_rie: bool = True,
              want_div: bool = False) -> Tuple:
    """K3 — final face states of direction d (array axis ax):
      csum = sum(c3_list) + (dt/2) src
      lo_f = lo1 + csum;  hi_f = hi1 + shift_p(csum, ax)
    Returns, in order: the Riemann state against adv (want_rie) or the
    undivided flux difference (rie*adv)[c] - (rie*adv)[c-1] (want_div,
    which overrides want_rie); then (lo_f, hi_f) with want_pre."""
    if not (want_rie or want_pre or want_div):
        raise ValueError("ctu_final: nothing requested")
    if not 1 <= len(c3_list) <= 2:
        raise ValueError("ctu_final takes one or two corrections")
    if _on_cpu(lo1_d):
        return ctu_final_plain(lo1_d, hi1_d, adv_pad_d, c3_list, src_pad,
                               half_dt, ax, want_pre, want_rie, want_div)
    want_main = want_rie or want_div
    if want_main and adv_pad_d is None:
        raise ValueError("ctu_final: the Riemann output needs adv")
    c3b = c3_list[1] if len(c3_list) == 2 else None
    lo1, hi1, adv, c3a, c3b, src = _prepare(
        lo1_d, (lo1_d, hi1_d, adv_pad_d if want_main else None, c3_list[0],
                c3b, src_pad))
    total, st, n = _line(lo1.shape, ax)
    main = torch.empty_like(lo1) if want_main else None
    lo_f = torch.empty_like(lo1) if want_pre else None
    hi_f = torch.empty_like(lo1) if want_pre else None
    rc = getattr(load(), f"ctu_final_{_SUFFIX[lo1.dtype]}")(
        _ptr(lo1), _ptr(hi1), _ptr(adv), _ptr(c3a), _ptr(c3b), _ptr(src),
        _ptr(main), _ptr(lo_f), _ptr(hi_f), total, st, n, float(half_dt),
        int(bool(want_div)), _stream(lo1))
    _check(rc, "ctu_final")
    ctu_final.launches += 1
    out = (main,) if want_main else ()
    return out + ((lo_f, hi_f) if want_pre else ())


def riemann_fluxdiv(pre_pairs: Sequence, adv_pad_d, ax: int) -> List:
    """K4 — for each stashed (lo_f, hi_f) pair (padded face-indexed)
    returns the undivided flux difference (rie*adv)[c] - (rie*adv)[c-1],
    rie = Riemann(lo_f, hi_f, adv); up to four fields per launch."""
    if _on_cpu(adv_pad_d):
        return riemann_fluxdiv_plain(pre_pairs, adv_pad_d, ax)
    flat = _prepare(adv_pad_d, [adv_pad_d] + [x for p in pre_pairs for x in p])
    adv, rest = flat[0], flat[1:]
    los, his = rest[0::2], rest[1::2]
    total, st, n = _line(adv.shape, ax)
    fn = getattr(load(), f"ctu_riemann_fluxdiv_{_SUFFIX[adv.dtype]}")
    out = []
    for i in range(0, len(los), _MAX_FIELDS):
        lo_c, hi_c = los[i:i + _MAX_FIELDS], his[i:i + _MAX_FIELDS]
        outs = [torch.empty_like(adv) for _ in lo_c]
        k = len(lo_c)
        rc = fn(_ptr(adv), (_VP * k)(*map(_ptr, lo_c)),
                (_VP * k)(*map(_ptr, hi_c)), (_VP * k)(*map(_ptr, outs)), k,
                total, st, n, _stream(adv))
        _check(rc, "riemann_fluxdiv")
        riemann_fluxdiv.launches += 1
        out += outs
    return out


#: the four CTU kernels' wrappers, in K1-K4 order
KERNELS = (ppm_predict, ctu_corr3, ctu_final, riemann_fluxdiv)
for _k in KERNELS:
    _k.launches = 0


def reset_launch_counts():
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}
