// Red-black Gauss-Seidel and residual kernels K5-K6 for Hopper (sm_90a),
// replacing the Pallas TPU kernels of somar_tpu/ops/gsrb_pallas.py:
//
//   K5 uniform_gsrb_whole  (one launch per smoothing call)  <- gsrb_sweeps
//      uniform_gsrb_tiled  (one launch per sweep)              (_small_kernel,
//                                                               _slab_kernel)
//   K6 helm_residual                                        <- helm_residual
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
// first active axis).  The kernels are bound by device-memory bandwidth: a
// sweep must read p and rhs and write p (12 bytes a cell in f32) for a few
// dozen flops.
//
// K5 has two variants (csrc/rb_sweep.cuh), chosen per plan by
// ops/rb_sweeps.py: on a level whose p ping-pong pair fits one block's
// shared memory, one launch runs every half sweep of the call there (a
// cluster of up to 8 blocks shares the level through distributed shared
// memory); on larger levels one launch does a full red+black sweep on
// shared-memory tiles (2-cell halos, red on the tile and a ring, black on
// the tile) and moves p, rhs and the output about once.  The boundary-face
// factors come from global indices, as in K6.  K6 is one thread per cell
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
// The smoother as an rb::Op: the same arithmetic as lap_diag and K6, with
// the neighbours taken from shared memory.  Away from non-periodic
// boundaries every cell has the same diagonal, so its division is done once
// per thread (`inv_in`, by the same operations).
template <typename T_, int ND_>
struct UniformOp {
  typedef T_ T;
  static constexpr int ND = ND_;
  struct Operands {
    T rhs;
  };
  int n[3];
  int per[3];
  T coef[3], flo[3], fhi[3];
  const T* rhs;
  T alpha, beta, weight;
  T inv_in;  // weight / (alpha + beta*diag) away from non-periodic edges

  __device__ bool wraps(int a) const { return per[a] != 0; }

  __device__ __forceinline__ Operands fetch(int gidx) const {
    return Operands{__ldg(rhs + gidx)};
  }

  __device__ __forceinline__ T interior_inv() const {
    T dg = T(0);
#pragma unroll
    for (int a = 3 - ND; a < 3; ++a) dg = dg - coef[a] * (T(1) + T(1));
    return weight / (alpha + beta * dg);
  }

  template <class Nb>
  __device__ __forceinline__ T apply(const Operands& o, const int* gi, T pc,
                                     Nb nb) const {
    T lap = T(0), dg = T(0);
    bool edge = false;
#pragma unroll
    for (int a = 3 - ND; a < 3; ++a) {
      const bool at_lo = gi[a] == 0, at_hi = gi[a] == n[a] - 1;
      T lo, hi, wlo = T(1), whi = T(1);
      if (per[a]) {
        lo = nb(-(a == 0), -(a == 1), -(a == 2));
        hi = nb(a == 0, a == 1, a == 2);
      } else {
        lo = at_lo ? T(0) : nb(-(a == 0), -(a == 1), -(a == 2));
        hi = at_hi ? T(0) : nb(a == 0, a == 1, a == 2);
        if (at_lo) wlo = flo[a];
        if (at_hi) whi = fhi[a];
        edge = edge || at_lo || at_hi;
      }
      lap = lap + coef[a] * (whi * (hi - pc) - wlo * (pc - lo));
      dg = dg - coef[a] * (wlo + whi);
    }
    const T r = o.rhs - alpha * pc - beta * lap;
    const T inv_den = edge ? weight / (alpha + beta * dg) : inv_in;
    return pc + inv_den * r;
  }
};

template <typename T, int ND>
__global__ void __launch_bounds__(rb::kWholeThreads)
uniform_gsrb_whole_kernel(const T* __restrict__ p, T* __restrict__ out,
                          UniformOp<T, ND> op, int iters, int slice) {
  op.inv_in = op.interior_inv();
  rb::whole_body(op, p, out, iters, slice);
}

template <typename T, int ND>
__global__ void __launch_bounds__(rb::kTileThreads, 4)
uniform_gsrb_tiled_kernel(const T* __restrict__ p, T* __restrict__ out,
                          UniformOp<T, ND> op, int tz) {
  op.inv_in = op.interior_inv();
  rb::tiled_body(op, p, out, tz);
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

// variant 0: one whole-level launch p -> out0; variant 1: `iters` tiled
// sweeps p -> out0 -> out1 -> out0 ... (chunks of tz planes along axis 0)
template <typename T, int ND>
int launch_gsrb_sweeps(const T* p, const T* rhs, T* out0, T* out1,
                       const int* n, const int* per, const double* coef,
                       const double* flo, const double* fhi, double alpha,
                       double beta, double weight, int iters, int variant,
                       int tz, cudaStream_t stream) {
  UniformOp<T, ND> op;
  for (int a = 0; a < 3; ++a) {
    op.n[a] = n[a];
    op.per[a] = per[a];
    op.coef[a] = (T)coef[a];
    op.flo[a] = (T)flo[a];
    op.fhi[a] = (T)fhi[a];
  }
  op.rhs = rhs;
  op.alpha = (T)alpha;
  op.beta = (T)beta;
  op.weight = (T)weight;
  const int total = n[0] * n[1] * n[2];
  if (variant == 0) {
    static size_t set = 0;
    const rb::WholeShape w = rb::whole_shape(total);
    const size_t smem = 2 * (size_t)w.slice * sizeof(T);
    cudaError_t e =
        rb::allow_smem(uniform_gsrb_whole_kernel<T, ND>, smem, &set);
    if (e == cudaSuccess)
      e = rb::launch_whole(uniform_gsrb_whole_kernel<T, ND>, w, smem, stream,
                           p, out0, op, iters, w.slice);
    return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
  }
  if (tz < 1) return (int)cudaErrorInvalidValue;
  static size_t set = 0;
  const size_t smem = rb::tiled_smem_cells<ND>() * sizeof(T);
  const cudaError_t e =
      rb::allow_smem(uniform_gsrb_tiled_kernel<T, ND>, smem, &set);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((n[2] + rb::Tile<ND>::X - 1) / rb::Tile<ND>::X,
                  (n[1] + rb::Tile<ND>::Y - 1) / rb::Tile<ND>::Y,
                  (n[0] + tz - 1) / tz);
  const T* src = p;
  for (int k = 0; k < iters; ++k) {
    T* dst = (k & 1) ? out1 : out0;
    uniform_gsrb_tiled_kernel<T, ND>
        <<<grid, rb::kTileThreads, smem, stream>>>(src, dst, op, tz);
    const int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
    src = dst;
  }
  return 0;
}

template <typename T>
int gsrb_sweeps(const void* p, const void* rhs, void* out0, void* out1,
                int first, const int* n, const int* per, const double* coef,
                const double* flo, const double* fhi, double alpha,
                double beta, double weight, int iters, int variant, int tz,
                void* stream) {
  if ((first != 0 && first != 1) || (variant != 0 && variant != 1))
    return (int)cudaErrorInvalidValue;
  if (first == 0)
    return launch_gsrb_sweeps<T, 3>(
        (const T*)p, (const T*)rhs, (T*)out0, (T*)out1, n, per, coef, flo,
        fhi, alpha, beta, weight, iters, variant, tz, (cudaStream_t)stream);
  return launch_gsrb_sweeps<T, 2>(
      (const T*)p, (const T*)rhs, (T*)out0, (T*)out1, n, per, coef, flo, fhi,
      alpha, beta, weight, iters, variant, tz, (cudaStream_t)stream);
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

int gsrb_sweeps_f32(const void* p, const void* rhs, void* out0, void* out1,
                    int first, const int* n, const int* per,
                    const double* coef, const double* flo, const double* fhi,
                    int variant, int tz, double alpha, double beta,
                    double weight, int iters, void* stream) {
  return gsrb_sweeps<float>(p, rhs, out0, out1, first, n, per, coef, flo, fhi,
                            alpha, beta, weight, iters, variant, tz, stream);
}

int gsrb_sweeps_f64(const void* p, const void* rhs, void* out0, void* out1,
                    int first, const int* n, const int* per,
                    const double* coef, const double* flo, const double* fhi,
                    int variant, int tz, double alpha, double beta,
                    double weight, int iters, void* stream) {
  return gsrb_sweeps<double>(p, rhs, out0, out1, first, n, per, coef, flo,
                             fhi, alpha, beta, weight, iters, variant, tz,
                             stream);
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
