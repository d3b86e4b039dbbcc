// Red-black Gauss-Seidel and residual kernels K7-K8 for Hopper (sm_90a),
// replacing the Pallas TPU kernels of somar_tpu/ops/stencil_gsrb_pallas.py:
//
//   K7 stencil_gsrb_half (two launches per sweep) <- gsrb_sweeps
//                                                   (_small_kernel,
//                                                    _slab_kernel)
//   K8 stencil_helm_residual                      <- helm_residual
//
// Operator: L[p] = alpha*p + beta*lap(p) on a mapped metric, with the
// interior stencil probed from the plain operator
// (ops/stencil_gsrb_kernels.py):
//
//   lap[c] = R[c]*p[c] + sum_k W[k][c] * (p[c + o_k] - p[c])
//
// accumulated in the plan's offset order (k = 0..K-1), K <= 8 in 2D and
// <= 18 in 3D (the operator's cross terms couple two axes at a time).
// Neighbours wrap on every axis; an offset that leaves a non-periodic
// domain carries weight exactly 0.  Differences are taken
// first: the gathered form sum(W*p) + diag*p cancels O(W*|p|) terms and its
// f32 roundoff floor stalls multigrid on anisotropic metrics.
//
// Arrays are contiguous, unpadded cell arrays of two or three axes, viewed
// as (n0, n1, n2) with an inactive leading axis of extent 1 in 2D; the
// kernels are templated on the number of active axes.  W is K contiguous
// planes of the array's shape.  Design: one thread per cell (grid-stride
// loop), no shared memory; neighbour re-reads of p hit L1/L2.  The kernels
// are bound by device-memory bandwidth: a half sweep reads p, rhs, the K
// weight planes, R and w0 and writes p (K+5 arrays) for about 3K flops a
// cell.
//
// A half sweep reads p_in and writes EVERY cell of p_out: cells of its
// colour (index sum parity) get the update
//   p + weight/(alpha + beta*w0) * (rhs - alpha*p - beta*lap),
// the others are copied.  The wrapper ping-pongs between two buffers, so
// every read of a half sweep sees the array as it was before that half
// sweep: a 3^nd stencil couples a cell to diagonal neighbours of its own
// colour, and on a periodic extent of 3 a cell wraps onto its own colour.
//
// Build with -fmad=false: every multiply and add is rounded separately, as
// the plain PyTorch versions compute them.
//
// C ABI: every entry point takes the CUDA stream as its last argument and
// returns cudaGetLastError() right after the launch.

#include <cuda_runtime.h>

namespace {

typedef long long i64;

constexpr int kBlock = 256;
constexpr int kMaxK = 26;

inline int grid_for(i64 total) {
  i64 blocks = (total + kBlock - 1) / kBlock;
  const i64 cap = 132 * 64;  // enough resident blocks for every SM
  return (int)(blocks < cap ? (blocks > 0 ? blocks : 1) : cap);
}

// The stencil, passed by value: extents, offsets per array axis, and the
// linear index step of each offset when no axis wraps.
struct Stencil {
  int n[3];
  int K;
  int total;
  signed char off[kMaxK][3];
  int step[kMaxK];
};

Stencil make_stencil(const int* n, int K, const int* offs) {
  Stencil s;
  for (int a = 0; a < 3; ++a) s.n[a] = n[a];
  s.K = K;
  s.total = n[0] * n[1] * n[2];
  const int st[3] = {n[1] * n[2], n[2], 1};
  for (int k = 0; k < K; ++k) {
    s.step[k] = 0;
    for (int a = 0; a < 3; ++a) {
      s.off[k][a] = (signed char)offs[3 * k + a];
      s.step[k] += offs[3 * k + a] * st[a];
    }
  }
  return s;
}

// The wrapper takes arrays of fewer than 2^31 cells: 32-bit index math.
template <int ND>
__device__ __forceinline__ void cell_index(int idx, const int* n, int* i) {
  const unsigned u = (unsigned)idx;
  const unsigned q = u / (unsigned)n[2];
  i[2] = (int)(u - q * (unsigned)n[2]);
  if (ND == 3) {
    const unsigned r = q / (unsigned)n[1];
    i[1] = (int)(q - r * (unsigned)n[1]);
    i[0] = (int)r;
  } else {
    i[1] = (int)q;
    i[0] = 0;
  }
}

// Linear index of cell i + off[k], wrapped on every active axis.
template <int ND>
__device__ __forceinline__ int neighbour(const Stencil& s, int idx,
                                         const int* i, int k) {
  int j = idx + s.step[k];
  const int st[3] = {s.n[1] * s.n[2], s.n[2], 1};
#pragma unroll
  for (int a = 3 - ND; a < 3; ++a) {
    const int o = s.off[k][a];
    if (o > 0 && i[a] == s.n[a] - 1) j -= s.n[a] * st[a];
    if (o < 0 && i[a] == 0) j += s.n[a] * st[a];
  }
  return j;
}

template <typename T, int ND>
__device__ __forceinline__ T lap_at(const T* __restrict__ p,
                                    const T* __restrict__ w,
                                    const T* __restrict__ r,
                                    const Stencil& s, int idx, const int* i,
                                    T pc) {
  T lap = r[idx] * pc;
  for (int k = 0; k < s.K; ++k) {
    const T pn = p[neighbour<ND>(s, idx, i, k)];
    lap = lap + w[(i64)k * s.total + idx] * (pn - pc);
  }
  return lap;
}

// ---------------------------------------------------------------- K7
template <typename T, int ND>
__global__ void __launch_bounds__(kBlock)
stencil_gsrb_half_kernel(const T* __restrict__ p, const T* __restrict__ rhs,
                         const T* __restrict__ w, const T* __restrict__ r,
                         const T* __restrict__ w0, T* __restrict__ out,
                         Stencil s, T alpha, T beta, T weight, int colour) {
  for (int idx = blockIdx.x * blockDim.x + threadIdx.x; idx < s.total;
       idx += gridDim.x * blockDim.x) {
    int i[3];
    cell_index<ND>(idx, s.n, i);
    const T pc = p[idx];
    if (((i[0] + i[1] + i[2]) & 1) != colour) {
      out[idx] = pc;
      continue;
    }
    const T lap = lap_at<T, ND>(p, w, r, s, idx, i, pc);
    const T res = rhs[idx] - alpha * pc - beta * lap;
    const T inv_den = weight / (alpha + beta * w0[idx]);
    out[idx] = pc + inv_den * res;
  }
}

// ---------------------------------------------------------------- K8
template <typename T, int ND>
__global__ void __launch_bounds__(kBlock)
stencil_helm_residual_kernel(const T* __restrict__ p,
                             const T* __restrict__ rhs,
                             const T* __restrict__ w,
                             const T* __restrict__ r, T* __restrict__ out,
                             Stencil s, T alpha, T beta) {
  for (int idx = blockIdx.x * blockDim.x + threadIdx.x; idx < s.total;
       idx += gridDim.x * blockDim.x) {
    int i[3];
    cell_index<ND>(idx, s.n, i);
    const T pc = p[idx];
    const T lap = lap_at<T, ND>(p, w, r, s, idx, i, pc);
    out[idx] = rhs[idx] - alpha * pc - beta * lap;
  }
}

template <typename T>
int launch_gsrb_half(const void* p, const void* rhs, const void* w,
                     const void* r, const void* w0, void* out, int ndim,
                     const int* n, int K, const int* offs, double alpha,
                     double beta, double weight, int colour, void* stream) {
  if (K < 0 || K > kMaxK || (ndim != 2 && ndim != 3))
    return (int)cudaErrorInvalidValue;
  const Stencil s = make_stencil(n, K, offs);
  const int blocks = grid_for(s.total);
  cudaStream_t st = (cudaStream_t)stream;
  if (ndim == 3)
    stencil_gsrb_half_kernel<T, 3><<<blocks, kBlock, 0, st>>>(
        (const T*)p, (const T*)rhs, (const T*)w, (const T*)r, (const T*)w0,
        (T*)out, s, (T)alpha, (T)beta, (T)weight, colour);
  else
    stencil_gsrb_half_kernel<T, 2><<<blocks, kBlock, 0, st>>>(
        (const T*)p, (const T*)rhs, (const T*)w, (const T*)r, (const T*)w0,
        (T*)out, s, (T)alpha, (T)beta, (T)weight, colour);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_helm_residual(const void* p, const void* rhs, const void* w,
                         const void* r, void* out, int ndim, const int* n,
                         int K, const int* offs, double alpha, double beta,
                         void* stream) {
  if (K < 0 || K > kMaxK || (ndim != 2 && ndim != 3))
    return (int)cudaErrorInvalidValue;
  const Stencil s = make_stencil(n, K, offs);
  const int blocks = grid_for(s.total);
  cudaStream_t st = (cudaStream_t)stream;
  if (ndim == 3)
    stencil_helm_residual_kernel<T, 3><<<blocks, kBlock, 0, st>>>(
        (const T*)p, (const T*)rhs, (const T*)w, (const T*)r, (T*)out, s,
        (T)alpha, (T)beta);
  else
    stencil_helm_residual_kernel<T, 2><<<blocks, kBlock, 0, st>>>(
        (const T*)p, (const T*)rhs, (const T*)w, (const T*)r, (T*)out, s,
        (T)alpha, (T)beta);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int stencil_gsrb_half_f32(const void* p, const void* rhs, const void* w,
                          const void* r, const void* w0, void* out, int ndim,
                          const int* n, int K, const int* offs, double alpha,
                          double beta, double weight, int colour,
                          void* stream) {
  return launch_gsrb_half<float>(p, rhs, w, r, w0, out, ndim, n, K, offs,
                                 alpha, beta, weight, colour, stream);
}

int stencil_gsrb_half_f64(const void* p, const void* rhs, const void* w,
                          const void* r, const void* w0, void* out, int ndim,
                          const int* n, int K, const int* offs, double alpha,
                          double beta, double weight, int colour,
                          void* stream) {
  return launch_gsrb_half<double>(p, rhs, w, r, w0, out, ndim, n, K, offs,
                                  alpha, beta, weight, colour, stream);
}

int stencil_helm_residual_f32(const void* p, const void* rhs, const void* w,
                              const void* r, void* out, int ndim,
                              const int* n, int K, const int* offs,
                              double alpha, double beta, void* stream) {
  return launch_helm_residual<float>(p, rhs, w, r, out, ndim, n, K, offs,
                                     alpha, beta, stream);
}

int stencil_helm_residual_f64(const void* p, const void* rhs, const void* w,
                              const void* r, void* out, int ndim,
                              const int* n, int K, const int* offs,
                              double alpha, double beta, void* stream) {
  return launch_helm_residual<double>(p, rhs, w, r, out, ndim, n, K, offs,
                                      alpha, beta, stream);
}

}  // extern "C"
