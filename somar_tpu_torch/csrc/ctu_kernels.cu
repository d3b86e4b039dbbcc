// CTU advection kernels K1-K4 for Hopper (sm_90a), replacing the Pallas TPU
// kernels of somar_tpu/ops/pallas_kernels.py:
//
//   K1 ppm_predict      <- ppm_predict_pallas      (_ppm_kernel)
//   K2 ctu_corr3        <- ctu_corr3_pallas        (_corr3_kernel)
//   K3 ctu_final        <- ctu_final_pallas        (_final_kernel)
//   K4 riemann_fluxdiv  <- riemann_fluxdiv_pallas  (_reflux_kernel)
//
// Every array is a contiguous padded cell array viewed as a flat buffer of
// `total` elements; the stencil runs along one array axis, whose length is
// `n` and whose element stride is `st`.  Entry f of a face-indexed array is
// the face between cells f and f+1 (godunov.py convention); the edge
// entries hold junk exactly as the Pallas kernels leave it:
//   shift_p(a)[i] = a[min(i+1, n-1)],  shift_m(a)[i] = a[max(i-1, 0)],
//   the PPM states are edge-padded from cells [2, n-3].
//
// Design: one thread per output element (grid-stride loop).  Each thread
// recomputes the handful of neighbour values it needs along the stencil
// axis instead of sharing them through shared memory.  The kernels are
// bound by device-memory bandwidth (K1 reads 2 arrays and writes 3: ~20
// bytes per cell in f32); neighbour re-reads mostly hit L1/L2.
//
// Build with -fmad=false: a contracted multiply-add can flip a limiter
// comparison or a Riemann branch at an isolated cell, which would make the
// kernel-vs-plain comparison meaningless.
//
// C ABI: every entry point takes the CUDA stream as its last argument and
// returns cudaGetLastError() right after the launch.

#include <cuda_runtime.h>

namespace {

typedef long long i64;

constexpr int kBlock = 256;

inline int grid_for(i64 total) {
  i64 blocks = (total + kBlock - 1) / kBlock;
  const i64 cap = 132 * 64;  // enough resident blocks for every SM
  return (int)(blocks < cap ? (blocks > 0 ? blocks : 1) : cap);
}

template <typename T>
__device__ __forceinline__ T riemann(T lo, T hi, T v) {
  const T avg = T(0.5) * (lo + hi);
  return v > T(1e-12) ? lo : (v < T(-1e-12) ? hi : avg);
}

// PPM traced states (splus, sminus) of cell c (2 <= c <= n-3) of the line
// starting at `base` (same math and operation order as _ppm_kernel).
template <typename T>
__device__ __forceinline__ void ppm_states(const T* __restrict__ s,
                                           const T* __restrict__ u, i64 base,
                                           i64 st, int c, T dtdx, bool lim,
                                           T* splus, T* sminus) {
  const T cm2 = s[base + (i64)(c - 2) * st];
  const T cm1 = s[base + (i64)(c - 1) * st];
  const T c0 = s[base + (i64)c * st];
  const T cp1 = s[base + (i64)(c + 1) * st];
  const T cp2 = s[base + (i64)(c + 2) * st];
  const T nu = u[base + (i64)c * st] * dtdx;
  const T a7 = T(7.0 / 12.0), a1 = T(1.0 / 12.0);
  T sR = a7 * (c0 + cp1) - a1 * (cm1 + cp2);
  T sL = a7 * (cm1 + c0) - a1 * (cm2 + cp1);
  if (lim) {  // CW84 monotonization
    const bool flat = (sR - c0) * (c0 - sL) <= T(0);
    const T dsum0 = sR - sL;
    const T s6t = T(6) * (c0 - T(0.5) * (sL + sR));
    const bool cond_l = dsum0 * s6t > dsum0 * dsum0;
    const bool cond_r = (-dsum0) * dsum0 > dsum0 * s6t;
    const T sLn = flat ? c0 : (cond_l ? T(3) * c0 - T(2) * sR : sL);
    const T sRn = flat ? c0 : (cond_r ? T(3) * c0 - T(2) * sL : sR);
    sL = sLn;
    sR = sRn;
  }
  const T dsum = sR - sL;
  const T s6 = T(6) * (c0 - T(0.5) * (sL + sR));
  const T sig_p = nu > T(0) ? nu : T(0);
  const T sig_m = -nu > T(0) ? -nu : T(0);
  const T two3 = T(2.0 / 3.0);
  *splus = sR - T(0.5) * sig_p * (dsum - (T(1) - two3 * sig_p) * s6);
  *sminus = sL + T(0.5) * sig_m * (dsum + (T(1) - two3 * sig_m) * s6);
}

__device__ __forceinline__ int clamp_cell(int c, int n) {
  return c < 2 ? 2 : (c > n - 3 ? n - 3 : c);
}

// ---------------------------------------------------------------- K1
template <typename T>
__global__ void __launch_bounds__(kBlock)
ppm_predict_kernel(const T* __restrict__ s, const T* __restrict__ u,
                   T* __restrict__ lo, T* __restrict__ hi,
                   T* __restrict__ corr, i64 total, i64 st, int n, int lim,
                   T dtdx, T neg_cc) {
  for (i64 idx = blockIdx.x * (i64)blockDim.x + threadIdx.x; idx < total;
       idx += (i64)gridDim.x * blockDim.x) {
    const int i = (int)((idx / st) % n);
    const i64 base = idx - (i64)i * st;
    const int cb = clamp_cell(i, n), cc = clamp_cell(i + 1, n);
    T sp_b, sm_b, sp_c, sm_c;
    ppm_states(s, u, base, st, cb, dtdx, lim != 0, &sp_b, &sm_b);
    ppm_states(s, u, base, st, cc, dtdx, lim != 0, &sp_c, &sm_c);
    const T lo_i = sp_b, hi_i = sm_c;
    const T u_i = u[idx];
    const T u_ip = u[i + 1 < n ? idx + st : idx];
    const T rie_i = riemann(lo_i, hi_i, T(0.5) * (u_i + u_ip));
    T rie_m = rie_i;
    if (i > 0) {
      T sp_a, sm_a;
      ppm_states(s, u, base, st, clamp_cell(i - 1, n), dtdx, lim != 0, &sp_a,
                 &sm_a);
      rie_m = riemann(sp_a, sm_b, T(0.5) * (u[idx - st] + u_i));
    }
    lo[idx] = lo_i;
    hi[idx] = hi_i;
    corr[idx] = (neg_cc * u_i) * (rie_i - rie_m);
  }
}

// ---------------------------------------------------------------- K2
template <typename T>
struct Corr3Args {
  const T* c[2];
  T* out[2];
};

template <typename T>
__global__ void __launch_bounds__(kBlock)
ctu_corr3_kernel(const T* __restrict__ lo1, const T* __restrict__ hi1,
                 const T* __restrict__ u, Corr3Args<T> a, int ncorr,
                 i64 total, i64 st, int n, T neg_dt2dx) {
  for (i64 idx = blockIdx.x * (i64)blockDim.x + threadIdx.x; idx < total;
       idx += (i64)gridDim.x * blockDim.x) {
    const int i = (int)((idx / st) % n);
    const i64 ip = i + 1 < n ? idx + st : idx;
    const T u_i = u[idx];
    const T vf_i = T(0.5) * (u_i + u[ip]);
    const T vf_m = i > 0 ? T(0.5) * (u[idx - st] + u_i) : T(0);
#pragma unroll
    for (int k = 0; k < 2; ++k) {  // unrolled: static indices into `a`
      if (k >= ncorr) break;
      const T* __restrict__ c = a.c[k];
      const T c_i = c[idx];
      const T r_i = riemann(lo1[idx] + c_i, hi1[idx] + c[ip], vf_i);
      T r_m = r_i;
      if (i > 0) {
        const i64 im = idx - st;
        r_m = riemann(lo1[im] + c[im], hi1[im] + c_i, vf_m);
      }
      a.out[k][idx] = (neg_dt2dx * u_i) * (r_i - r_m);
    }
  }
}

// ---------------------------------------------------------------- K3
template <typename T>
struct FinalArgs {
  const T* lo1;
  const T* hi1;
  const T* adv;  // null unless want_rie or want_div
  const T* c3a;
  const T* c3b;  // null for one correction (2D)
  const T* src;  // null without a source
  T* out;        // rie or the flux difference; null for pre only
  T* lo_f;       // null unless want_pre
  T* hi_f;
};

template <typename T>
__device__ __forceinline__ T csum_at(const FinalArgs<T>& a, i64 j,
                                     T half_dt) {
  T cs = a.c3a[j];
  if (a.c3b) cs = cs + a.c3b[j];
  if (a.src) cs = cs + half_dt * a.src[j];
  return cs;
}

template <typename T>
__global__ void __launch_bounds__(kBlock)
ctu_final_kernel(FinalArgs<T> a, i64 total, i64 st, int n, T half_dt,
                 int want_div) {
  for (i64 idx = blockIdx.x * (i64)blockDim.x + threadIdx.x; idx < total;
       idx += (i64)gridDim.x * blockDim.x) {
    const int i = (int)((idx / st) % n);
    const i64 ip = i + 1 < n ? idx + st : idx;
    const T cs_i = csum_at(a, idx, half_dt);
    const T lo_i = a.lo1[idx] + cs_i;
    const T hi_i = a.hi1[idx] + csum_at(a, ip, half_dt);
    if (a.out) {
      const T adv_i = a.adv[idx];
      const T r_i = riemann(lo_i, hi_i, adv_i);
      if (want_div) {
        const T F_i = r_i * adv_i;
        T F_m = F_i;
        if (i > 0) {
          const i64 im = idx - st;
          const T adv_m = a.adv[im];
          // face i-1: lo_f = lo1 + csum[i-1], hi_f = hi1 + csum[i]
          F_m = riemann(a.lo1[im] + csum_at(a, im, half_dt),
                        a.hi1[im] + cs_i, adv_m) * adv_m;
        }
        a.out[idx] = F_i - F_m;
      } else {
        a.out[idx] = r_i;
      }
    }
    if (a.lo_f) {
      a.lo_f[idx] = lo_i;
      a.hi_f[idx] = hi_i;
    }
  }
}

// ---------------------------------------------------------------- K4
constexpr int kMaxFields = 4;

template <typename T>
struct FluxArgs {
  const T* lo[kMaxFields];
  const T* hi[kMaxFields];
  T* out[kMaxFields];
};

template <typename T>
__global__ void __launch_bounds__(kBlock)
riemann_fluxdiv_kernel(const T* __restrict__ adv, FluxArgs<T> a, int nf,
                       i64 total, i64 st, int n) {
  for (i64 idx = blockIdx.x * (i64)blockDim.x + threadIdx.x; idx < total;
       idx += (i64)gridDim.x * blockDim.x) {
    const int i = (int)((idx / st) % n);
    const i64 im = i > 0 ? idx - st : idx;
    const T adv_i = adv[idx];
    const T adv_m = adv[im];
#pragma unroll
    for (int f = 0; f < kMaxFields; ++f) {  // unrolled: static indices
      if (f >= nf) break;
      const T F_i = riemann(a.lo[f][idx], a.hi[f][idx], adv_i) * adv_i;
      const T F_m = riemann(a.lo[f][im], a.hi[f][im], adv_m) * adv_m;
      a.out[f][idx] = F_i - F_m;
    }
  }
}

}  // namespace

// ------------------------------------------------------------- C entry points
#define SOMAR_CTU_ENTRY_POINTS(T, SUF)                                        \
  extern "C" int ctu_ppm_predict_##SUF(                                       \
      const void* s, const void* u, void* lo, void* hi, void* corr,           \
      i64 total, i64 st, int n, int lim, T dtdx, T neg_cc, void* stream) {    \
    ppm_predict_kernel<T><<<grid_for(total), kBlock, 0,                       \
                            (cudaStream_t)stream>>>(                          \
        (const T*)s, (const T*)u, (T*)lo, (T*)hi, (T*)corr, total, st, n,     \
        lim, dtdx, neg_cc);                                                   \
    return (int)cudaGetLastError();                                           \
  }                                                                           \
  extern "C" int ctu_corr3_##SUF(                                             \
      const void* lo1, const void* hi1, const void* u, const void* c0,        \
      const void* c1, void* o0, void* o1, int ncorr, i64 total, i64 st,       \
      int n, T neg_dt2dx, void* stream) {                                     \
    Corr3Args<T> a;                                                           \
    a.c[0] = (const T*)c0;                                                    \
    a.c[1] = (const T*)c1;                                                    \
    a.out[0] = (T*)o0;                                                        \
    a.out[1] = (T*)o1;                                                        \
    ctu_corr3_kernel<T><<<grid_for(total), kBlock, 0,                         \
                          (cudaStream_t)stream>>>(                            \
        (const T*)lo1, (const T*)hi1, (const T*)u, a, ncorr, total, st, n,    \
        neg_dt2dx);                                                           \
    return (int)cudaGetLastError();                                           \
  }                                                                           \
  extern "C" int ctu_final_##SUF(                                             \
      const void* lo1, const void* hi1, const void* adv, const void* c3a,     \
      const void* c3b, const void* src, void* out, void* lo_f, void* hi_f,    \
      i64 total, i64 st, int n, T half_dt, int want_div, void* stream) {      \
    FinalArgs<T> a;                                                           \
    a.lo1 = (const T*)lo1;                                                    \
    a.hi1 = (const T*)hi1;                                                    \
    a.adv = (const T*)adv;                                                    \
    a.c3a = (const T*)c3a;                                                    \
    a.c3b = (const T*)c3b;                                                    \
    a.src = (const T*)src;                                                    \
    a.out = (T*)out;                                                          \
    a.lo_f = (T*)lo_f;                                                        \
    a.hi_f = (T*)hi_f;                                                        \
    ctu_final_kernel<T><<<grid_for(total), kBlock, 0,                         \
                          (cudaStream_t)stream>>>(a, total, st, n, half_dt,   \
                                                  want_div);                  \
    return (int)cudaGetLastError();                                           \
  }                                                                           \
  extern "C" int ctu_riemann_fluxdiv_##SUF(                                   \
      const void* adv, const void* const* lo, const void* const* hi,          \
      void* const* out, int nf, i64 total, i64 st, int n, void* stream) {     \
    if (nf < 1 || nf > kMaxFields) return (int)cudaErrorInvalidValue;         \
    FluxArgs<T> a;                                                            \
    for (int f = 0; f < kMaxFields; ++f) {                                    \
      a.lo[f] = f < nf ? (const T*)lo[f] : nullptr;                           \
      a.hi[f] = f < nf ? (const T*)hi[f] : nullptr;                           \
      a.out[f] = f < nf ? (T*)out[f] : nullptr;                               \
    }                                                                         \
    riemann_fluxdiv_kernel<T><<<grid_for(total), kBlock, 0,                   \
                                (cudaStream_t)stream>>>((const T*)adv, a, nf, \
                                                        total, st, n);        \
    return (int)cudaGetLastError();                                           \
  }

SOMAR_CTU_ENTRY_POINTS(float, f32)
SOMAR_CTU_ENTRY_POINTS(double, f64)
