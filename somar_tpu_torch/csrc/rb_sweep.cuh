// The two launch shapes of a red-black Gauss-Seidel smoother on Hopper,
// shared by K5 (csrc/gsrb_kernels.cu) and K7 (csrc/stencil_gsrb_kernels.cu).
//
// A smoother is an Op: its extents n[3] (n[0] = 1 in 2D), `wraps(a)`
// (whether a neighbour across the edge of array axis a is the wrapped cell;
// otherwise there is none and the Op never asks for it), `fetch(gidx)`
// (the cell's operands in device memory, loaded together so that their
// latencies overlap) and `apply(operands, gi, pc, nb)`: the new value of
// the cell at array indices gi whose value is pc, where nb(o0, o1, o2)
// returns the value of the neighbour at that offset (each in -1..1).
//
// A half sweep of colour c updates the cells whose index sum has parity c
// from the array as it was before the half sweep and keeps the others.
// Both variants keep that rule on every shape: a 3^nd stencil couples a
// cell to diagonal neighbours of its own colour, and on a periodic extent
// of 2 or of an odd extent a cell wraps onto its own colour, so no half
// sweep updates in place, not even in shared memory.  A thread takes two
// neighbouring cells at a time, the one of colour c first: where colours
// alternate (everywhere but across a periodic seam of odd extent) every
// lane of a warp updates one cell and keeps the other, and the update has
// one call site, so the kernels stay small enough for the instruction
// cache.
//
//   whole_body  one cluster of up to 8 blocks holds the level's p
//               ping-pong pair in its distributed shared memory and runs
//               all 2*iters half sweeps, cluster.sync() between them: one
//               launch per smoothing call (the counterpart of the Pallas
//               _small_kernel).
//   tiled_body  one full red+black sweep per launch, with no copy-through
//               in device memory: a block loads its tile of p with a
//               2-cell halo into shared memory, computes the red half sweep
//               on the tile and a 1-cell ring into a second shared buffer,
//               then the black half sweep on the tile from it, and writes
//               each tile cell once (the counterpart of _slab_kernel).  In
//               3D the block marches along array axis 0 over a chunk of
//               planes with rolling windows of three old and three red
//               planes, so each plane of p, rhs and the weights comes from
//               device memory about once per sweep; the next old plane is
//               loaded into registers while the black half sweep runs.
//               Halo and ring cells are computed by neighbouring blocks
//               too, by the same code from the same values, so they round
//               alike.
//
// The tile extents below are mirrored by ops/rb_sweeps.py, which chooses
// the variant and the chunk depth.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace rb {

//: threads of a whole-level block at most, blocks of its cluster at most
//: (the portable cluster size), and threads of a tiled block
constexpr int kWholeThreads = 1024;
constexpr int kWholeCluster = 8;
constexpr int kTileThreads = 256;

// tile extents along array axes 1 and 2 (even: cells go in pairs) and the
// planes of each rolling window (3D: the planes j-1, j, j+1 around the
// plane being updated)
template <int ND>
struct Tile;
template <>
struct Tile<2> {
  static constexpr int Y = 32, X = 32, PLANES = 1;
};
template <>
struct Tile<3> {
  static constexpr int Y = 16, X = 64, PLANES = 3;
};

// shared memory of a tiled block, in cells: the windows of old values
// (tile + 2-cell halo) and of red values (tile + ring)
template <int ND>
constexpr int tiled_smem_cells() {
  return Tile<ND>::PLANES * ((Tile<ND>::Y + 4) * (Tile<ND>::X + 4) +
                             (Tile<ND>::Y + 2) * (Tile<ND>::X + 2));
}

__device__ __noinline__ int wrap_far(int g, int n) {
  const int r = g % n;
  return r < 0 ? r + n : r;
}

// g mod n in [0, n): the identity inside the array
__device__ __forceinline__ int wrap(int g, int n) {
  return (unsigned)g < (unsigned)n ? g : wrap_far(g, n);
}

// g mod n for g in [-n, 2n): a neighbour's index
__device__ __forceinline__ int wrap1(int g, int n) {
  return g < 0 ? g + n : (g >= n ? g - n : g);
}

extern __shared__ __align__(16) unsigned char rb_smem[];

// the extents of a region of a tile, as types
template <int R, int C>
struct Extents {
  static constexpr int ROWS = R, COLS = C;
};

// ------------------------------------------------------------ whole level
// A cluster of C blocks (C = 1..kWholeCluster, on C SMs) holds the level:
// block r keeps the cells [r*S, r*S + S) of both ping-pong buffers in its
// shared memory and reads its neighbours' cells from the other blocks'
// (distributed shared memory); cluster.sync() separates the half sweeps.
// Thread t of a block takes the cell pairs (lo + 2t, lo + 2t + 1),
// (lo + 2t + 2B, ...) (B = blockDim.x); the first cell's array indices
// advance by 2B in mixed radix, without divisions.
template <class Op, typename T>
__device__ __forceinline__ void whole_body(const Op& op,
                                           const T* __restrict__ p,
                                           T* __restrict__ out, int iters,
                                           int slice) {
  constexpr int ND = Op::ND;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int n0 = op.n[0], n1 = op.n[1], n2 = op.n[2];
  const int total = n0 * n1 * n2;
  const int lo = (int)cluster.block_rank() * slice;
  const int hi = min(lo + slice, total);
  T* a = reinterpret_cast<T*>(rb_smem);
  T* b = a + slice;
  for (int c = lo + threadIdx.x; c < hi; c += blockDim.x) a[c - lo] = p[c];
  const int step = 2 * blockDim.x;
  const int f = lo + 2 * threadIdx.x;
  const int f2 = f % n2, f1 = f / n2 % n1, f0 = f / n2 / n1;
  const int s2 = step % n2, s1 = step / n2 % n1, s0 = step / n2 / n1;
  // cell idx of the level buffer `buf` (in this block's slice or another's)
  auto at = [&](const T* buf, int idx) -> T {
    if ((unsigned)(idx - lo) < (unsigned)(hi - lo)) return buf[idx - lo];
    const int owner = idx / slice;
    return cluster.map_shared_rank(buf, owner)[idx - owner * slice];
  };
  const bool alone = cluster.num_blocks() == 1;
  auto sync = [&] {
    if (alone)
      __syncthreads();
    else
      cluster.sync();
  };
  sync();
  for (int h = 0; h < 2 * iters; ++h) {
    const int colour = h & 1;
    int i0 = f0, i1 = f1, i2 = f2;
    for (int c = f; c < hi; c += step) {
      // the pair's second cell
      int j0 = i0, j1 = i1, j2 = i2 + 1;
      if (j2 == n2) {
        j2 = 0;
        if (++j1 == n1) j1 = 0, ++j0;
      }
      const bool first = ((i0 + i1 + i2) & 1) == colour;
#pragma unroll 1
      for (int t = 0; t < 2; ++t) {
        const bool use_i = (t == 0) == first;
        const int cc = use_i ? c : c + 1;
        if (cc >= hi) continue;
        const int gi[3] = {use_i ? i0 : j0, use_i ? i1 : j1,
                           use_i ? i2 : j2};
        const T pc = a[cc - lo];
        if (((gi[0] + gi[1] + gi[2]) & 1) != colour) {
          b[cc - lo] = pc;
          continue;
        }
        bool inner = true;
#pragma unroll
        for (int d = 3 - ND; d < 3; ++d)
          inner = inner && gi[d] >= 1 && gi[d] < op.n[d] - 1;
        const T* src = a;
        b[cc - lo] =
            op.apply(op.fetch(cc), gi, pc, [&](int o0, int o1, int o2) {
              return at(src, inner ? cc + (o0 * n1 + o1) * n2 + o2
                                   : (wrap1(gi[0] + o0, n0) * n1 +
                                      wrap1(gi[1] + o1, n1)) *
                                             n2 +
                                         wrap1(gi[2] + o2, n2));
            });
      }
      i2 += s2;
      if (i2 >= n2) i2 -= n2, ++i1;
      i1 += s1;
      if (i1 >= n1) i1 -= n1, ++i0;
      i0 += s0;
    }
    sync();
    T* t = a;
    a = b;
    b = t;
  }
  for (int c = lo + threadIdx.x; c < hi; c += blockDim.x) out[c] = a[c - lo];
}

// ------------------------------------------------------------ tiled sweep
// Block (bx, by, bz) owns the tile [by*Y, by*Y + Y) x [bx*X, bx*X + X) of
// axes 1 and 2 and, in 3D, the planes [bz*tz, bz*tz + tz) of axis 0.
// Launched with kTileThreads threads.
template <class Op, typename T>
__device__ __forceinline__ void tiled_body(const Op& op,
                                           const T* __restrict__ p,
                                           T* __restrict__ out, int tz) {
  constexpr int ND = Op::ND, NT = kTileThreads;
  constexpr int TY = Tile<ND>::Y, TX = Tile<ND>::X, NP = Tile<ND>::PLANES;
  constexpr int OY = TY + 4, OX = TX + 4;  // old values: tile + 2-cell halo
  constexpr int RY = TY + 2, RX = TX + 2;  // red half sweep: tile + ring
  constexpr int LOADS = (OY * OX + NT - 1) / NT;  // old cells per thread
  T* old = reinterpret_cast<T*>(rb_smem);
  T* red = old + NP * OY * OX;
  const int n0 = op.n[0], n1 = op.n[1], n2 = op.n[2];
  const int y0 = blockIdx.y * TY, x0 = blockIdx.x * TX;
  const int z0 = blockIdx.z * tz;
  const int z1 = min(z0 + tz, n0);
  // the window slot of plane j >= -2
  auto slot = [](int j) { return NP == 1 ? 0 : (j + 3) % 3; };
  // a plane along axis 0 exists where it lies in the array or wraps
  auto plane_in = [&](int j) { return op.wraps(0) || (j >= 0 && j < n0); };

  // old plane j (the tile with a 2-cell halo, wrapped, zero outside a
  // non-wrapping axis): read into registers, then stored to its slot
  T held[LOADS];
  auto fetch_old = [&](int j) {
    const bool zin = plane_in(j);
    const int gz = wrap(j, n0);
#pragma unroll
    for (int k = 0; k < LOADS; ++k) {
      const int e = threadIdx.x + k * NT;
      const int gy = y0 + e / OX - 2, gx = x0 + e % OX - 2;
      const bool in = e < OY * OX && zin &&
                      (op.wraps(1) || (unsigned)gy < (unsigned)n1) &&
                      (op.wraps(2) || (unsigned)gx < (unsigned)n2);
      held[k] = in ? p[(gz * n1 + wrap(gy, n1)) * n2 + wrap(gx, n2)] : T(0);
    }
  };
  auto store_old = [&](int j) {
    T* dst = old + slot(j) * (OY * OX);
#pragma unroll
    for (int k = 0; k < LOADS; ++k) {
      const int e = threadIdx.x + k * NT;
      if (e < OY * OX) dst[e] = held[k];
    }
  };

  // One half sweep over ROWS x COLS local positions (r, x) read from the
  // planes sm/sc/su (row width sw, position (r, x) at (r+1, x+1)) into dst
  // (row width dw, at (r, x)) or, where gdst is given, into the array gdst:
  // the cells of colour `colour` are updated, the others kept.  row(r, g)
  // gives row r's global indices g[0], g[1] (wrapped) and whether it
  // exists; col(x, g2) the same along axis 2.  A thread's work items are
  // the pairs x = 2s, 2s+1.
  auto half = [&](auto extents, auto row, auto col, int colour, const T* sm,
                  const T* sc, const T* su, int sw, T* dst, int dw,
                  T* gdst) {
    constexpr int M = decltype(extents)::COLS / 2;
    constexpr int N = decltype(extents)::ROWS * M;
    for (int q = threadIdx.x; q < N; q += NT) {
      const int r = q / M, x2 = 2 * (q % M);
      int g[3];
      if (!row(r, g)) continue;
      int ga, gb;
      const bool ina = col(x2, ga), inb = col(x2 + 1, gb);
      const bool first = ((g[0] + g[1] + ga) & 1) == colour;
#pragma unroll 1
      for (int t = 0; t < 2; ++t) {
        const bool use_a = (t == 0) == first;
        if (!(use_a ? ina : inb)) continue;
        const int x = use_a ? x2 : x2 + 1;
        const int gi[3] = {g[0], g[1], use_a ? ga : gb};
        const int gidx = (gi[0] * n1 + gi[1]) * n2 + gi[2];
        const int o = (r + 1) * sw + x + 1;
        T v = sc[o];
        if (((gi[0] + gi[1] + gi[2]) & 1) == colour)
          v = op.apply(op.fetch(gidx), gi, v, [&](int o0, int o1, int o2) {
            const T* s = o0 < 0 ? sm : (o0 > 0 ? su : sc);
            return s[o + o1 * sw + o2];
          });
        if (gdst)
          gdst[gidx] = v;
        else
          dst[r * dw + x] = v;
      }
    }
  };

  // red cells of the tile and its ring (local rows/columns -1..T) from the
  // old planes j-1, j, j+1; the other cells keep their old values
  auto red_plane = [&](int j) {
    if (!plane_in(j)) return;  // outside a non-wrapping axis: never read
    const int gz = wrap(j, n0);
    half(
        Extents<RY, RX>(),
        [&](int r, int* g) {
          const int gy = y0 + r - 1;
          g[0] = gz;
          g[1] = wrap(gy, n1);
          return op.wraps(1) || (unsigned)gy < (unsigned)n1;
        },
        [&](int x, int& g2) {
          const int gx = x0 + x - 1;
          g2 = wrap(gx, n2);
          return op.wraps(2) || (unsigned)gx < (unsigned)n2;
        },
        0, old + slot(j - (NP > 1)) * (OY * OX),
        old + slot(j) * (OY * OX), old + slot(j + (NP > 1)) * (OY * OX), OX,
        red + slot(j) * (RY * RX), RX, nullptr);
  };

  // black cells of the tile from the red planes j-1, j, j+1; every tile
  // cell inside the array is written once
  auto black_plane = [&](int j) {
    half(
        Extents<TY, TX>(),
        [&](int r, int* g) {
          g[0] = j;
          g[1] = y0 + r;
          return g[1] < n1;
        },
        [&](int x, int& g2) {
          g2 = x0 + x;
          return g2 < n2;
        },
        1, red + slot(j - (NP > 1)) * (RY * RX),
        red + slot(j) * (RY * RX), red + slot(j + (NP > 1)) * (RY * RX), RX,
        nullptr, 0, out);
  };

  if constexpr (NP == 1) {
    fetch_old(0);
    store_old(0);
    __syncthreads();
    red_plane(0);
    __syncthreads();
    black_plane(0);
  } else {
    // red plane j needs old planes j-1..j+1, black plane j red planes
    // j-1..j+1: per step j store old j+1, red j, then fetch old j+2 and
    // black j-1
    fetch_old(z0 - 2);
    store_old(z0 - 2);
    fetch_old(z0 - 1);
    store_old(z0 - 1);
    fetch_old(z0);
    for (int j = z0 - 1; j <= z1; ++j) {
      store_old(j + 1);
      __syncthreads();
      red_plane(j);
      if (j < z1) fetch_old(j + 2);
      __syncthreads();
      if (j - 1 >= z0) black_plane(j - 1);
    }
  }
}

// Dynamic shared memory above 48 KB needs an opt-in per kernel; `*set`
// remembers the most that kernel was given.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes, size_t* set) {
  if (bytes <= 48 * 1024 || bytes <= *set) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) *set = bytes;
  return e;
}

// The whole-level launch of a level of `total` cells: blocks in the
// cluster (a block per 1024 cells, at most kWholeCluster), the even number
// of cells each block keeps, and a thread per pair of them (at most
// kWholeThreads).
struct WholeShape {
  int blocks, slice, threads;
};
inline WholeShape whole_shape(int total) {
  WholeShape w;
  w.blocks = (total + 1023) / 1024;
  if (w.blocks > kWholeCluster) w.blocks = kWholeCluster;
  w.slice = (total + w.blocks - 1) / w.blocks;
  w.slice += w.slice & 1;
  w.threads = ((w.slice / 2) + 31) / 32 * 32;
  if (w.threads > kWholeThreads) w.threads = kWholeThreads;
  return w;
}

// Launch a whole-level kernel as one cluster of w.blocks blocks.
template <typename K, typename... Args>
inline cudaError_t launch_whole(K kernel, const WholeShape& w, size_t smem,
                                cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(w.blocks);
  cfg.blockDim = dim3(w.threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = w.blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

}  // namespace rb
