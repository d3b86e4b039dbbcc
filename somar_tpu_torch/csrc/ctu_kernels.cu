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
// What bounds them: device-memory bandwidth.  K1 must read 2 arrays and
// write 3 (20 bytes a cell in f32) for about 70 flops; K2-K4 move 7-10
// arrays for a few dozen.
//
// K1 reads s and u from device memory about once and computes each cell's
// PPM states once.  Along a strided axis (0, or 1 of three) one thread owns
// a line (threads along the contiguous axis, so loads coalesce) and marches
// over a chunk of faces with the five s values of its newest cell, that
// cell's states and the previous face's Riemann state in registers; the
// chunk length (ops/ctu_kernels.ppm_launch_shape, 4-64 faces) gives about
// eight threads per resident slot on the card, and only a 3-cell halo is
// read twice.
// Along the contiguous axis a block stages a row segment of s and u (a
// whole row up to ROW_SEG faces) with a 3-cell halo in shared memory,
// computes the segment's cell states into shared memory, syncs once and
// writes the faces.  Index math is 32-bit (the wrapper takes fewer than
// 2^31 elements).  K2-K4 (first versions): one thread per output element
// (grid-stride loop), recomputing the few neighbour values it needs along
// the stencil axis; neighbour re-reads mostly hit L1/L2.
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

// PPM traced states (splus, sminus) of a cell c (2 <= c <= n-3) from
// s[c-2..c+2] and u[c] (same math and operation order as _ppm_kernel).
template <typename T>
__device__ __forceinline__ void ppm_state(T cm2, T cm1, T c0, T cp1, T cp2,
                                          T uc, T dtdx, bool lim, T* splus,
                                          T* sminus) {
  const T nu = uc * dtdx;
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
// Face i of a line takes lo = splus of cell clamp(i), hi = sminus of cell
// clamp(i+1), rie = Riemann(lo, hi, (u[i] + u[min(i+1, n-1)])/2) and
// corr = (neg_cc u[i]) (rie - rie of face i-1), with rie of face -1 taken
// as rie of face 0 (the twin's edge padding and shifts).

constexpr int kRowBlock = 128;  // threads of a row block
constexpr int kRowSmem = 48 * 1024;  // shared memory a launch gets unasked

// Strided stencil axis: one thread per line and chunk [i0, i1) of faces,
// threads along the contiguous axis.  It marches along the line with a
// rolling window of five s values, the newest cell's states, splus of the
// cell before, u[i] and the Riemann state of the face before, so each
// thread loads s and u about once per face and computes each cell's states
// once.  EDGE: the chunk reaches the clamped cells (i0 < 3 or i1 > n-3).
template <typename T, bool EDGE>
__device__ __forceinline__ void ppm_march(
    const T* __restrict__ s, const T* __restrict__ u, T* __restrict__ lo,
    T* __restrict__ hi, T* __restrict__ corr, int base, int st, int n,
    int i0, int i1, bool lim, T dtdx, T neg_cc) {
  int c = clamp_cell(i0 - 1, n);
  T w0 = __ldg(s + base + (c - 2) * st), w1 = __ldg(s + base + (c - 1) * st),
    w2 = __ldg(s + base + c * st), w3 = __ldg(s + base + (c + 1) * st),
    w4 = __ldg(s + base + (c + 2) * st);
  T sp, sm;
  ppm_state(w0, w1, w2, w3, w4, __ldg(u + base + c * st), dtdx, lim, &sp,
            &sm);
  const T sp_before = sp;  // splus of cell clamp(i0 - 1)
  if (!EDGE || clamp_cell(i0, n) != c) {  // then clamp(i0) = i0 = c + 1
    ++c;
    w0 = w1;
    w1 = w2;
    w2 = w3;
    w3 = w4;
    w4 = __ldg(s + base + (c + 2) * st);
    ppm_state(w0, w1, w2, w3, w4, __ldg(u + base + c * st), dtdx, lim, &sp,
              &sm);
  }
  T u_i = __ldg(u + base + i0 * st);
  T rie_prev = T(0);
  if (i0 > 0) {
    const T u_m = __ldg(u + base + (i0 - 1) * st);
    rie_prev = riemann(sp_before, sm, T(0.5) * (u_m + u_i));
  }
  T sp_i = sp;  // splus of cell clamp(i)
#pragma unroll 4
  for (int i = i0; i < i1; ++i) {
    const int ip = EDGE && i + 1 >= n ? n - 1 : i + 1;
    const T u_ip = __ldg(u + base + ip * st);
    if (!EDGE || clamp_cell(i + 1, n) != c) {  // a new cell, c + 1 = i + 1
      ++c;
      w0 = w1;
      w1 = w2;
      w2 = w3;
      w3 = w4;
      w4 = __ldg(s + base + (c + 2) * st);
      ppm_state(w0, w1, w2, w3, w4, u_ip, dtdx, lim, &sp, &sm);
    }
    const T rie = riemann(sp_i, sm, T(0.5) * (u_i + u_ip));
    const T rie_m = (!EDGE || i > 0) ? rie_prev : rie;
    const int o = base + i * st;
    lo[o] = sp_i;
    hi[o] = sm;
    corr[o] = (neg_cc * u_i) * (rie - rie_m);
    sp_i = sp;
    u_i = u_ip;
    rie_prev = rie;
  }
}

template <typename T>
__global__ void __launch_bounds__(kBlock)
ppm_predict_march_kernel(const T* __restrict__ s, const T* __restrict__ u,
                         T* __restrict__ lo, T* __restrict__ hi,
                         T* __restrict__ corr, int cols, int st, int n,
                         int chunk, int lim, T dtdx, T neg_cc) {
  const int col = blockIdx.x * kBlock + threadIdx.x;
  if (col >= cols) return;
  const int outer = col / st;
  const int base = outer * n * st + (col - outer * st);
  const int i0 = blockIdx.y * chunk;
  const int i1 = min(i0 + chunk, n);
  if (i0 >= 3 && i1 <= n - 3)
    ppm_march<T, false>(s, u, lo, hi, corr, base, st, n, i0, i1, lim != 0,
                        dtdx, neg_cc);
  else
    ppm_march<T, true>(s, u, lo, hi, corr, base, st, n, i0, i1, lim != 0,
                       dtdx, neg_cc);
}

// Contiguous stencil axis: one block per segment [x0, x1) of a line (its
// length `seg` is chosen by the caller, ops/ctu_kernels.ppm_launch_shape).  It stages s and u of the segment with a
// 3-cell halo in shared memory (coalesced, each element once), computes the
// states of cells clamp(x0-1) .. clamp(x1) once into shared memory, syncs,
// and writes the faces.
template <typename T>
__global__ void __launch_bounds__(kRowBlock)
ppm_predict_row_kernel(const T* __restrict__ s, const T* __restrict__ u,
                       T* __restrict__ lo, T* __restrict__ hi,
                       T* __restrict__ corr, int n, int seg, int nseg,
                       int lim, T dtdx, T neg_cc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_sm = reinterpret_cast<T*>(smem_raw);  // seg + 6 entries
  T* u_sm = s_sm + seg + 6;                  // seg + 6
  T* sp_sm = u_sm + seg + 6;                 // seg + 2
  T* sm_sm = sp_sm + seg + 2;                // seg + 2
  const int row = blockIdx.x / nseg;
  const int x0 = (blockIdx.x - row * nseg) * seg;
  const int x1 = min(x0 + seg, n);
  const int base = row * n;
  const int cL = clamp_cell(x0 - 1, n), cH = clamp_cell(x1, n);
  const int ncell = cH - cL + 1;
  const int sL = cL - 2;
  const int uL = min(max(x0 - 1, 0), cL);
  const int uH = max(min(x1, n - 1), cH);
  for (int k = threadIdx.x; k < ncell + 4; k += kRowBlock)
    s_sm[k] = __ldg(s + base + sL + k);
  for (int k = threadIdx.x; k <= uH - uL; k += kRowBlock)
    u_sm[k] = __ldg(u + base + uL + k);
  __syncthreads();
  for (int k = threadIdx.x; k < ncell; k += kRowBlock)
    ppm_state(s_sm[k], s_sm[k + 1], s_sm[k + 2], s_sm[k + 3], s_sm[k + 4],
              u_sm[cL + k - uL], dtdx, lim != 0, sp_sm + k, sm_sm + k);
  __syncthreads();
  for (int i = x0 + threadIdx.x; i < x1; i += kRowBlock) {
    const T u_i = u_sm[i - uL];
    const T u_ip = u_sm[min(i + 1, n - 1) - uL];
    const int ci = clamp_cell(i, n) - cL;
    const T lo_i = sp_sm[ci];
    const T hi_i = sm_sm[clamp_cell(i + 1, n) - cL];
    const T rie = riemann(lo_i, hi_i, T(0.5) * (u_i + u_ip));
    T rie_m = rie;
    if (i > 0)
      rie_m = riemann(sp_sm[clamp_cell(i - 1, n) - cL], sm_sm[ci],
                      T(0.5) * (u_sm[i - 1 - uL] + u_i));
    lo[base + i] = lo_i;
    hi[base + i] = hi_i;
    corr[base + i] = (neg_cc * u_i) * (rie - rie_m);
  }
}

// st == 1: the row kernel with segments of `chunk` faces; otherwise the
// march with chunks of `chunk` faces.
template <typename T>
int launch_ppm_predict(const T* s, const T* u, T* lo, T* hi, T* corr,
                       int total, int st, int n, int chunk, int lim, T dtdx,
                       T neg_cc, cudaStream_t stream) {
  if (n < 5 || chunk < 1 || total < n) return (int)cudaErrorInvalidValue;
  const int nchunk = (n + chunk - 1) / chunk;
  if (st == 1) {
    const size_t smem = (size_t)(4 * chunk + 16) * sizeof(T);
    if (smem > kRowSmem) return (int)cudaErrorInvalidValue;
    ppm_predict_row_kernel<T><<<(total / n) * nchunk, kRowBlock, smem,
                                stream>>>(s, u, lo, hi, corr, n, chunk,
                                          nchunk, lim, dtdx, neg_cc);
  } else {
    if (nchunk > 65535) return (int)cudaErrorInvalidValue;
    const int cols = total / n;
    const dim3 grid((cols + kBlock - 1) / kBlock, nchunk);
    ppm_predict_march_kernel<T><<<grid, kBlock, 0, stream>>>(
        s, u, lo, hi, corr, cols, st, n, chunk, lim, dtdx, neg_cc);
  }
  return (int)cudaGetLastError();
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
      int total, int st, int n, int chunk, int lim, T dtdx, T neg_cc,         \
      void* stream) {                                                         \
    return launch_ppm_predict<T>((const T*)s, (const T*)u, (T*)lo, (T*)hi,    \
                                 (T*)corr, total, st, n, chunk, lim, dtdx,    \
                                 neg_cc, (cudaStream_t)stream);               \
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
