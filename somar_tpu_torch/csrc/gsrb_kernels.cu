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
// first active axis), of fewer than 2^31 cells (32-bit index math).  The
// kernels are bound by device-memory bandwidth: a sweep must read p and
// rhs and write p, the residual must read p and rhs and write out (12
// bytes a cell in f32), for a few dozen flops.
//
// K5 has two variants (csrc/rb_sweep.cuh), chosen per plan by
// ops/rb_sweeps.py: on a level whose p ping-pong pair fits one block's
// shared memory, one launch runs every half sweep of the call there (a
// cluster of up to 8 blocks shares the level through distributed shared
// memory); on larger levels one launch does a full red+black sweep on
// shared-memory tiles (2-cell halos, red on the tile and a ring, black on
// the tile) and moves p, rhs and the output about once.  The boundary-face
// factors come from global indices, as in K6.
//
// K6 reads p and rhs from device memory once and writes out once.  Each
// thread owns one column of a tile across the first active axis (3D: 8 x
// 32 cells of the (axis 1, axis 2) plane, neighbouring threads on
// neighbouring addresses along axis 2; 2D: 128 cells of axis 2) and marches
// along the first active axis over a chunk of planes, with p[-1], p[0] and
// p[+1] of its column in registers: each plane of p is fetched once as the
// plane ahead and then moves through registers.  The in-plane neighbours
// are loaded directly; the rows they sit in were fetched by the same block
// one plane step earlier, so L1 serves them without a sync (only the tile's
// one-cell halo comes from L2).  Chunks are sized so that the finest level
// has about 16 blocks per SM (residual_chunk).  Blocks whose tile and chunk
// touch no boundary and no periodic seam take a fast path with no
// per-axis boundary code; only edge blocks apply flo/fhi and the wraps.
//
// Build with -fmad=false: every multiply and add is rounded separately, as
// the plain PyTorch versions compute them.
//
// C ABI: every entry point takes the CUDA stream as its last argument and
// returns cudaGetLastError() right after its last launch.

#include <cuda_runtime.h>

#include "rb_sweep.cuh"

namespace {

// One axis's Laplacian term, in the twin's operation order.
template <typename T>
__device__ __forceinline__ T lap_term(T coef, T wlo, T whi, T lo, T hi,
                                      T pc) {
  return coef * (whi * (hi - pc) - wlo * (pc - lo));
}

// The term of an in-plane axis of extent n and stride st at a cell with
// index i along it (value pc, flat index idx), with its boundary factors or
// periodic wrap.
template <typename T>
__device__ __forceinline__ T edge_term(const T* __restrict__ p, int idx,
                                       int i, int n, int st, bool per,
                                       T coef, T flo, T fhi, T pc) {
  const bool at_lo = i == 0, at_hi = i == n - 1;
  T lo, hi, wlo = T(1), whi = T(1);
  if (per) {
    lo = __ldg(p + (at_lo ? idx + (n - 1) * st : idx - st));
    hi = __ldg(p + (at_hi ? idx - (n - 1) * st : idx + st));
  } else {
    lo = at_lo ? T(0) : __ldg(p + idx - st);
    hi = at_hi ? T(0) : __ldg(p + idx + st);
    if (at_lo) wlo = flo;
    if (at_hi) whi = fhi;
  }
  return lap_term(coef, wlo, whi, lo, hi, pc);
}

// ---------------------------------------------------------------- K5
// The smoother as an rb::Op: the same arithmetic as K6 (lap_term), with
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
// Tile of one block across the march axis: 3D 32 (axis 2) x 8 (axis 1)
// columns marching along axis 0; 2D 128 columns of axis 2 marching along
// axis 1.
template <int ND>
struct ResTile;
template <>
struct ResTile<3> {
  static constexpr int X = 32, Y = 8;
};
template <>
struct ResTile<2> {
  static constexpr int X = 128, Y = 1;
};

constexpr int kResBlocks = 132 * 16;  // blocks wanted on the finest level
constexpr int kResMinChunk = 4;       // planes a block marches where the
                                      // level has blocks enough for that

template <typename T>
struct ResArgs {
  int n[3];
  int per[3];
  T coef[3], flo[3], fhi[3];
  T alpha, beta;
  int chunk;  // planes per block along the march axis
};

template <typename T, int ND>
__global__ void __launch_bounds__(ResTile<ND>::X* ResTile<ND>::Y)
helm_residual_kernel(const T* __restrict__ p, const T* __restrict__ rhs,
                     T* __restrict__ out, ResArgs<T> a) {
  constexpr int M = 3 - ND;  // march axis: the first active one
  constexpr int X = ResTile<ND>::X, Y = ResTile<ND>::Y;
  const int nm = a.n[M], n1 = a.n[1], n2 = a.n[2];
  const int P = ND == 3 ? n1 * n2 : n2;  // plane stride
  const int b2 = blockIdx.x * X, b1 = blockIdx.y * Y;
  const int c0 = blockIdx.z * a.chunk;
  const int c1 = min(c0 + a.chunk, nm);
  const int i2 = b2 + threadIdx.x;
  const int i1 = ND == 3 ? b1 + threadIdx.y : 0;
  if (i2 >= n2 || i1 >= n1) return;
  int idx = c0 * P + (ND == 3 ? i1 * n2 : 0) + i2;
  // Block-uniform: the block's box and its one-cell halo stay inside the
  // domain, so no neighbour wraps and every boundary factor is 1.
  const bool interior = c0 >= 1 && c1 <= nm - 1 && b2 >= 1 &&
                        b2 + X <= n2 - 1 &&
                        (ND == 2 || (b1 >= 1 && b1 + Y <= n1 - 1));
  if (interior) {
    T prev = __ldg(p + idx - P), cur = __ldg(p + idx);
    for (int c = c0; c < c1; ++c, idx += P) {
      const T next = __ldg(p + idx + P);
      T lap = a.coef[M] * ((next - cur) - (cur - prev));
      if (ND == 3)
        lap = lap + a.coef[1] * ((__ldg(p + idx + n2) - cur) -
                                 (cur - __ldg(p + idx - n2)));
      lap = lap + a.coef[2] * ((__ldg(p + idx + 1) - cur) -
                               (cur - __ldg(p + idx - 1)));
      out[idx] = __ldg(rhs + idx) - a.alpha * cur - a.beta * lap;
      prev = cur;
      cur = next;
    }
    return;
  }
  const bool per_m = a.per[M] != 0;
  T prev = c0 > 0 ? __ldg(p + idx - P)
                  : (per_m ? __ldg(p + idx + (nm - 1) * P) : T(0));
  T cur = __ldg(p + idx);
  for (int c = c0; c < c1; ++c, idx += P) {
    const T next = c + 1 < nm ? __ldg(p + idx + P)
                              : (per_m ? __ldg(p + idx - (nm - 1) * P) : T(0));
    T wlo = T(1), whi = T(1);
    if (!per_m) {
      if (c == 0) wlo = a.flo[M];
      if (c == nm - 1) whi = a.fhi[M];
    }
    T lap = lap_term(a.coef[M], wlo, whi, prev, next, cur);
    if (ND == 3)
      lap = lap + edge_term(p, idx, i1, n1, n2, a.per[1] != 0, a.coef[1],
                            a.flo[1], a.fhi[1], cur);
    lap = lap + edge_term(p, idx, i2, n2, 1, a.per[2] != 0, a.coef[2],
                          a.flo[2], a.fhi[2], cur);
    out[idx] = __ldg(rhs + idx) - a.alpha * cur - a.beta * lap;
    prev = cur;
    cur = next;
  }
}

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

// Planes per K6 block along the march axis (extent nm) for a level of
// `tiles` tiles: about kResBlocks blocks in all; at least kResMinChunk
// planes a block where that still leaves a quarter of kResBlocks (longer
// marches read fewer halo planes), else down to one plane a block so that
// small levels keep every column parallel; equal chunks, at most 65,535.
inline int residual_chunk(int nm, int tiles) {
  const int want = (kResBlocks + tiles - 1) / tiles;
  const int few = (nm + kResMinChunk - 1) / kResMinChunk;
  int chunks = want < nm ? want : nm;
  if ((long long)tiles * few >= kResBlocks / 4 && few < chunks) chunks = few;
  int chunk = (nm + chunks - 1) / chunks;
  if ((nm + chunk - 1) / chunk > 65535) chunk = (nm + 65534) / 65535;
  return chunk;
}

template <typename T, int ND>
int launch_helm_residual(const T* p, const T* rhs, T* out, const int* n,
                         const int* per, const double* coef,
                         const double* flo, const double* fhi, double alpha,
                         double beta, cudaStream_t stream) {
  constexpr int X = ResTile<ND>::X, Y = ResTile<ND>::Y;
  ResArgs<T> a;
  for (int k = 0; k < 3; ++k) {
    a.n[k] = n[k];
    a.per[k] = per[k];
    a.coef[k] = (T)coef[k];
    a.flo[k] = (T)flo[k];
    a.fhi[k] = (T)fhi[k];
  }
  a.alpha = (T)alpha;
  a.beta = (T)beta;
  const int tx = (n[2] + X - 1) / X;
  const int ty = ND == 3 ? (n[1] + Y - 1) / Y : 1;
  if (ty > 65535) return (int)cudaErrorInvalidValue;
  const int nm = n[3 - ND];
  a.chunk = residual_chunk(nm, tx * ty);
  const dim3 grid(tx, ty, (nm + a.chunk - 1) / a.chunk);
  helm_residual_kernel<T, ND><<<grid, dim3(X, Y), 0, stream>>>(p, rhs, out, a);
  return (int)cudaGetLastError();
}

template <typename T>
int helm_residual(const void* p, const void* rhs, void* out, int first,
                  const int* n, const int* per, const double* coef,
                  const double* flo, const double* fhi, double alpha,
                  double beta, void* stream) {
  if (first != 0 && first != 1) return (int)cudaErrorInvalidValue;
  if (first == 0)
    return launch_helm_residual<T, 3>((const T*)p, (const T*)rhs, (T*)out,
                                      n, per, coef, flo, fhi, alpha, beta,
                                      (cudaStream_t)stream);
  return launch_helm_residual<T, 2>((const T*)p, (const T*)rhs, (T*)out, n,
                                    per, coef, flo, fhi, alpha, beta,
                                    (cudaStream_t)stream);
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
  return helm_residual<float>(p, rhs, out, first, n, per, coef, flo, fhi,
                              alpha, beta, stream);
}

int helm_residual_f64(const void* p, const void* rhs, void* out, int first,
                      const int* n, const int* per, const double* coef,
                      const double* flo, const double* fhi, double alpha,
                      double beta, void* stream) {
  return helm_residual<double>(p, rhs, out, first, n, per, coef, flo, fhi,
                               alpha, beta, stream);
}

}  // extern "C"
