// Red-black Gauss-Seidel and residual kernels K7-K8 for Hopper (sm_90a),
// replacing the Pallas TPU kernels of somar_tpu/ops/stencil_gsrb_pallas.py:
//
//   K7 stencil_gsrb_whole  (one launch per smoothing call) <- gsrb_sweeps
//      stencil_gsrb_tiled  (one launch per sweep)             (_small_kernel,
//                                                              _slab_kernel)
//   K8 stencil_helm_residual                               <- helm_residual
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
// planes of the array's shape.  The kernels are bound by device-memory
// bandwidth: a sweep must read p, rhs, the K weight planes, R and w0 and
// write p (K+5 arrays) for about 3K flops a cell.
//
// K7 has two variants (csrc/rb_sweep.cuh), chosen per plan by
// ops/rb_sweeps.py: on a level whose p ping-pong pair fits one block's
// shared memory, one launch runs every half sweep of the call there (a
// cluster of up to 8 blocks shares the level through distributed shared
// memory; the weights stay in device memory); on larger levels
// one launch does a full red+black sweep on shared-memory tiles of p
// (2-cell halos, red on the tile and a ring, black on the tile) and reads
// each weight plane about once.  A cell updates to
//   p + weight/(alpha + beta*w0) * (rhs - alpha*p - beta*lap)
// from the array as it was before its half sweep: a 3^nd stencil couples a
// cell to diagonal neighbours of its own colour, and on a periodic extent
// of 3 a cell wraps onto its own colour.  K8 is one thread per cell
// (grid-stride loop), no shared memory; neighbour re-reads hit L1/L2.
//
// Build with -fmad=false: every multiply and add is rounded separately, as
// the plain PyTorch versions compute them.
//
// C ABI: every entry point takes the CUDA stream as its last argument and
// returns cudaGetLastError() right after its last launch.

#include <cuda_runtime.h>

#include "rb_sweep.cuh"

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
// The smoother as an rb::Op: the arithmetic of lap_at, with the neighbours
// taken from shared memory.  The loop over the offsets is unrolled (at most
// 8 in 2D, 26 in 3D), so a cell's weight loads are issued together: in 2D
// by fetch(), with rhs, R and w0; in 3D inside apply(), where the compiler
// schedules the 18-26 loads within its register budget.
template <typename T_, int ND_>
struct StencilOp {
  typedef T_ T;
  static constexpr int ND = ND_;
  static constexpr int kMaxOffsets = ND == 2 ? 8 : kMaxK;
  static constexpr int kFetched = ND == 2 ? kMaxOffsets : 1;
  struct Operands {
    T rhs, r, w0;
    T w[kFetched];
    int gidx;
  };
  int n[3];
  int K;
  int total;
  signed char off[kMaxK][3];
  const T* rhs;
  const T* w;
  const T* r;
  const T* w0;
  T alpha, beta, weight;

  __device__ bool wraps(int) const { return true; }

  __device__ __forceinline__ Operands fetch(int gidx) const {
    Operands o;
    o.gidx = gidx;
    o.rhs = __ldg(rhs + gidx);
    o.r = __ldg(r + gidx);
    o.w0 = __ldg(w0 + gidx);
    if (ND == 2) {
#pragma unroll
      for (int k = 0; k < kFetched; ++k)
        if (k < K) o.w[k] = __ldg(w + (i64)k * total + gidx);
    }
    return o;
  }

  template <class Nb>
  __device__ __forceinline__ T apply(const Operands& o, const int*, T pc,
                                     Nb nb) const {
    T lap = o.r * pc;
#pragma unroll
    for (int k = 0; k < kMaxOffsets; ++k) {
      if (k < K) {
        const T wk = ND == 2 ? o.w[k < kFetched ? k : 0]
                             : __ldg(w + (i64)k * total + o.gidx);
        const T pn = nb(off[k][0], off[k][1], off[k][2]);
        lap = lap + wk * (pn - pc);
      }
    }
    const T res = o.rhs - alpha * pc - beta * lap;
    const T inv_den = weight / (alpha + beta * o.w0);
    return pc + inv_den * res;
  }
};

template <typename T, int ND>
__global__ void __launch_bounds__(rb::kWholeThreads)
stencil_gsrb_whole_kernel(const T* __restrict__ p, T* __restrict__ out,
                          StencilOp<T, ND> op, int iters, int slice) {
  rb::whole_body(op, p, out, iters, slice);
}

template <typename T, int ND>
__global__ void __launch_bounds__(rb::kTileThreads, sizeof(T) == 4 ? 4 : 2)
stencil_gsrb_tiled_kernel(const T* __restrict__ p, T* __restrict__ out,
                          StencilOp<T, ND> op, int tz) {
  rb::tiled_body(op, p, out, tz);
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

// variant 0: one whole-level launch p -> out0; variant 1: `iters` tiled
// sweeps p -> out0 -> out1 -> out0 ... (chunks of tz planes along axis 0)
template <typename T, int ND>
int launch_gsrb_sweeps(const T* p, const T* rhs, const T* w, const T* r,
                       const T* w0, T* out0, T* out1, const Stencil& s,
                       double alpha, double beta, double weight, int iters,
                       int variant, int tz, cudaStream_t stream) {
  StencilOp<T, ND> op;
  for (int a = 0; a < 3; ++a) op.n[a] = s.n[a];
  op.K = s.K;
  op.total = s.total;
  for (int k = 0; k < s.K; ++k)
    for (int a = 0; a < 3; ++a) op.off[k][a] = s.off[k][a];
  op.rhs = rhs;
  op.w = w;
  op.r = r;
  op.w0 = w0;
  op.alpha = (T)alpha;
  op.beta = (T)beta;
  op.weight = (T)weight;
  if (variant == 0) {
    static size_t set = 0;
    const rb::WholeShape w = rb::whole_shape(s.total);
    const size_t smem = 2 * (size_t)w.slice * sizeof(T);
    cudaError_t e =
        rb::allow_smem(stencil_gsrb_whole_kernel<T, ND>, smem, &set);
    if (e == cudaSuccess)
      e = rb::launch_whole(stencil_gsrb_whole_kernel<T, ND>, w, smem, stream,
                           p, out0, op, iters, w.slice);
    return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
  }
  if (tz < 1) return (int)cudaErrorInvalidValue;
  static size_t set = 0;
  const size_t smem = rb::tiled_smem_cells<ND>() * sizeof(T);
  const cudaError_t e =
      rb::allow_smem(stencil_gsrb_tiled_kernel<T, ND>, smem, &set);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((s.n[2] + rb::Tile<ND>::X - 1) / rb::Tile<ND>::X,
                  (s.n[1] + rb::Tile<ND>::Y - 1) / rb::Tile<ND>::Y,
                  (s.n[0] + tz - 1) / tz);
  const T* src = p;
  for (int k = 0; k < iters; ++k) {
    T* dst = (k & 1) ? out1 : out0;
    stencil_gsrb_tiled_kernel<T, ND>
        <<<grid, rb::kTileThreads, smem, stream>>>(src, dst, op, tz);
    const int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
    src = dst;
  }
  return 0;
}

template <typename T>
int gsrb_sweeps(const void* p, const void* rhs, const void* w, const void* r,
                const void* w0, void* out0, void* out1, int ndim,
                const int* n, int K, const int* offs, int variant, int tz,
                double alpha, double beta, double weight, int iters,
                void* stream) {
  if (K < 0 || K > (ndim == 2 ? 8 : kMaxK) || (ndim != 2 && ndim != 3) ||
      (variant != 0 && variant != 1))
    return (int)cudaErrorInvalidValue;
  const Stencil s = make_stencil(n, K, offs);
  if (ndim == 3)
    return launch_gsrb_sweeps<T, 3>(
        (const T*)p, (const T*)rhs, (const T*)w, (const T*)r, (const T*)w0,
        (T*)out0, (T*)out1, s, alpha, beta, weight, iters, variant, tz,
        (cudaStream_t)stream);
  return launch_gsrb_sweeps<T, 2>(
      (const T*)p, (const T*)rhs, (const T*)w, (const T*)r, (const T*)w0,
      (T*)out0, (T*)out1, s, alpha, beta, weight, iters, variant, tz,
      (cudaStream_t)stream);
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

int stencil_gsrb_sweeps_f32(const void* p, const void* rhs, const void* w,
                            const void* r, const void* w0, void* out0,
                            void* out1, int ndim, const int* n, int K,
                            const int* offs, int variant, int tz,
                            double alpha, double beta, double weight,
                            int iters, void* stream) {
  return gsrb_sweeps<float>(p, rhs, w, r, w0, out0, out1, ndim, n, K, offs,
                            variant, tz, alpha, beta, weight, iters, stream);
}

int stencil_gsrb_sweeps_f64(const void* p, const void* rhs, const void* w,
                            const void* r, const void* w0, void* out0,
                            void* out1, int ndim, const int* n, int K,
                            const int* offs, int variant, int tz,
                            double alpha, double beta, double weight,
                            int iters, void* stream) {
  return gsrb_sweeps<double>(p, rhs, w, r, w0, out0, out1, ndim, n, K, offs,
                             variant, tz, alpha, beta, weight, iters, stream);
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
