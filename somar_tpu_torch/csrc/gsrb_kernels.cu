// Red-black Gauss-Seidel and residual kernels K5-K6 for Hopper (sm_90a),
// replacing the Pallas TPU kernels of somar_tpu/ops/gsrb_pallas.py:
//
//   K5 gsrb_half (two launches per sweep)  <- gsrb_sweeps
//                                             (_small_kernel, _slab_kernel)
//   K6 helm_residual                       <- helm_residual
//
// Operator: L[p] = alpha*p + beta*lap(p) on a uniform metric with
// homogeneous BCs folded into boundary-face factors.  Per array axis a
//
//   lap += coef[a] * (w_hi*(p[+1] - p) - w_lo*(p - p[-1]))
//   diag -= coef[a] * (w_lo + w_hi)
//
// with w_lo = flo[a] at index 0, w_hi = fhi[a] at index n-1 and 1 elsewhere
// (both 1 on a periodic axis); a neighbour outside a non-periodic domain
// counts as 0, a periodic one wraps.  Differences are taken first: the
// gathered form sum(W*p) + diag*p cancels O(coef*|p|) terms and its f32
// roundoff floor stalls multigrid on anisotropic grids.
//
// Arrays are contiguous, unpadded cell arrays of two or three axes, viewed
// as (n0, n1, n2) with inactive leading axes of extent 1 (`first` is the
// first active axis).  Design: one thread per cell (grid-stride loop), no
// shared memory; neighbour re-reads hit L1/L2.  The kernels are bound by
// device-memory bandwidth: each reads two arrays and writes one (12 bytes a
// cell in f32) for a dozen flops.
//
// A half sweep reads p_in and writes EVERY cell of p_out: cells of its
// colour (index sum parity) get the update, the others are copied.  The
// wrapper ping-pongs between two buffers, so every read of a half sweep
// sees the array as it was before that half sweep, on any shape: on a
// periodic axis of odd extent, or of extent 2, a cell's wrap neighbour has
// the cell's own colour and an in-place update would race.
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

inline int grid_for(i64 total) {
  i64 blocks = (total + kBlock - 1) / kBlock;
  const i64 cap = 132 * 64;  // enough resident blocks for every SM
  return (int)(blocks < cap ? (blocks > 0 ? blocks : 1) : cap);
}

template <typename T>
struct Plan {
  int n[3];
  int per[3];
  int first;
  i64 st[3];
  T coef[3];
  T flo[3];
  T fhi[3];
};

template <typename T>
Plan<T> make_plan(int first, const int* n, const int* per, const double* coef,
                  const double* flo, const double* fhi) {
  Plan<T> pl;
  pl.first = first;
  for (int a = 0; a < 3; ++a) {
    pl.n[a] = n[a];
    pl.per[a] = per[a];
    pl.coef[a] = (T)coef[a];
    pl.flo[a] = (T)flo[a];
    pl.fhi[a] = (T)fhi[a];
  }
  pl.st[2] = 1;
  pl.st[1] = n[2];
  pl.st[0] = (i64)n[1] * n[2];
  return pl;
}

// The wrapper takes arrays of fewer than 2^31 cells, so the index splits
// with 32-bit divisions (a 64-bit one costs several times as much).
__device__ __forceinline__ void cell_index(i64 idx, const int* n, int* i) {
  const unsigned u = (unsigned)idx;
  const unsigned q = u / (unsigned)n[2];
  i[2] = (int)(u - q * (unsigned)n[2]);
  const unsigned r = q / (unsigned)n[1];
  i[1] = (int)(q - r * (unsigned)n[1]);
  i[0] = (int)r;
}

// lap(p) at cell idx (value pc); *diag receives the operator's Laplacian
// diagonal there.  Axes are accumulated in array-axis order.
template <typename T>
__device__ __forceinline__ T lap_diag(const T* __restrict__ p,
                                      const Plan<T>& pl, i64 idx,
                                      const int* i, T pc, T* diag) {
  T lap = T(0), dg = T(0);
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    if (a < pl.first) continue;
    const int n = pl.n[a];
    const i64 st = pl.st[a];
    const bool at_lo = i[a] == 0, at_hi = i[a] == n - 1;
    T lo, hi, wlo = T(1), whi = T(1);
    if (pl.per[a]) {
      lo = p[at_lo ? idx + (i64)(n - 1) * st : idx - st];
      hi = p[at_hi ? idx - (i64)(n - 1) * st : idx + st];
    } else {
      lo = at_lo ? T(0) : p[idx - st];
      hi = at_hi ? T(0) : p[idx + st];
      if (at_lo) wlo = pl.flo[a];
      if (at_hi) whi = pl.fhi[a];
    }
    lap = lap + pl.coef[a] * (whi * (hi - pc) - wlo * (pc - lo));
    dg = dg - pl.coef[a] * (wlo + whi);
  }
  *diag = dg;
  return lap;
}

// ---------------------------------------------------------------- K5
template <typename T>
__global__ void __launch_bounds__(kBlock)
gsrb_half_kernel(const T* __restrict__ p, const T* __restrict__ rhs,
                 T* __restrict__ out, Plan<T> pl, i64 total, T alpha, T beta,
                 T weight, int colour) {
  for (i64 idx = blockIdx.x * (i64)blockDim.x + threadIdx.x; idx < total;
       idx += (i64)gridDim.x * blockDim.x) {
    int i[3];
    cell_index(idx, pl.n, i);
    const T pc = p[idx];
    if (((i[0] + i[1] + i[2]) & 1) != colour) {
      out[idx] = pc;
      continue;
    }
    T dg;
    const T lap = lap_diag(p, pl, idx, i, pc, &dg);
    const T r = rhs[idx] - alpha * pc - beta * lap;
    const T inv_den = weight / (alpha + beta * dg);
    out[idx] = pc + inv_den * r;
  }
}

// ---------------------------------------------------------------- K6
template <typename T>
__global__ void __launch_bounds__(kBlock)
helm_residual_kernel(const T* __restrict__ p, const T* __restrict__ rhs,
                     T* __restrict__ out, Plan<T> pl, i64 total, T alpha,
                     T beta) {
  for (i64 idx = blockIdx.x * (i64)blockDim.x + threadIdx.x; idx < total;
       idx += (i64)gridDim.x * blockDim.x) {
    int i[3];
    cell_index(idx, pl.n, i);
    const T pc = p[idx];
    T dg;
    const T lap = lap_diag(p, pl, idx, i, pc, &dg);
    out[idx] = rhs[idx] - alpha * pc - beta * lap;
  }
}

template <typename T>
int launch_gsrb_half(const void* p, const void* rhs, void* out, int first,
                     const int* n, const int* per, const double* coef,
                     const double* flo, const double* fhi, double alpha,
                     double beta, double weight, int colour, void* stream) {
  const Plan<T> pl = make_plan<T>(first, n, per, coef, flo, fhi);
  const i64 total = (i64)n[0] * n[1] * n[2];
  gsrb_half_kernel<T><<<grid_for(total), kBlock, 0, (cudaStream_t)stream>>>(
      (const T*)p, (const T*)rhs, (T*)out, pl, total, (T)alpha, (T)beta,
      (T)weight, colour);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_helm_residual(const void* p, const void* rhs, void* out, int first,
                         const int* n, const int* per, const double* coef,
                         const double* flo, const double* fhi, double alpha,
                         double beta, void* stream) {
  const Plan<T> pl = make_plan<T>(first, n, per, coef, flo, fhi);
  const i64 total = (i64)n[0] * n[1] * n[2];
  helm_residual_kernel<T>
      <<<grid_for(total), kBlock, 0, (cudaStream_t)stream>>>(
          (const T*)p, (const T*)rhs, (T*)out, pl, total, (T)alpha, (T)beta);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int gsrb_half_f32(const void* p, const void* rhs, void* out, int first,
                  const int* n, const int* per, const double* coef,
                  const double* flo, const double* fhi, double alpha,
                  double beta, double weight, int colour, void* stream) {
  return launch_gsrb_half<float>(p, rhs, out, first, n, per, coef, flo, fhi,
                                 alpha, beta, weight, colour, stream);
}

int gsrb_half_f64(const void* p, const void* rhs, void* out, int first,
                  const int* n, const int* per, const double* coef,
                  const double* flo, const double* fhi, double alpha,
                  double beta, double weight, int colour, void* stream) {
  return launch_gsrb_half<double>(p, rhs, out, first, n, per, coef, flo, fhi,
                                  alpha, beta, weight, colour, stream);
}

int helm_residual_f32(const void* p, const void* rhs, void* out, int first,
                      const int* n, const int* per, const double* coef,
                      const double* flo, const double* fhi, double alpha,
                      double beta, void* stream) {
  return launch_helm_residual<float>(p, rhs, out, first, n, per, coef, flo,
                                     fhi, alpha, beta, stream);
}

int helm_residual_f64(const void* p, const void* rhs, void* out, int first,
                      const int* n, const int* per, const double* coef,
                      const double* flo, const double* fhi, double alpha,
                      double beta, void* stream) {
  return launch_helm_residual<double>(p, rhs, out, first, n, per, coef, flo,
                                      fhi, alpha, beta, stream);
}

}  // extern "C"
