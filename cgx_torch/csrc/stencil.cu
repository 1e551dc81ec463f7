// K1: constant-coefficient 3-D stencil SpMV, y = A·x, zero Dirichlet boundary.
//
// Replaces the Pallas kernel cgx/kernels/stencil.py:_kernel (entry
// stencil3d_spmv_pallas), which DMAs one halo window of rows per grid step
// into VMEM.  Its floor on the card is bytes: x read once and y written
// once, 8 B a row (5.01 µs at 128³ on an H100's 3.35 TB/s).
//
// The march (stencil_march_kernel, cgx_stencil3d_march; the entry points'
// kernel).  Node (i, j, k) is row (i·ny + j)·nz + k.  Each thread owns one
// (j, k) column of W consecutive z-values (W = 4, a float4, when nz % 4 ==
// 0 and x and y are 16-byte aligned; else W = 1, the scalar form) and
// marches a chunk of kChunk rows along i (stride ny·nz):
//   - x at i−1 .. i0+kChunk of its column, and the y neighbours of its
//     rows, are loaded into registers before the first row is summed, so
//     every x value is read once for the three x-axis taps of its column
//     and all the chunk's loads are in flight at once (a chunk reads its
//     column's x (kChunk + 2) / kChunk times; the extra planes mostly hit
//     the L2);
//   - the z±1 neighbours come from its own vector and from the lane
//     neighbours' (one __shfl_up_sync and one __shfl_down_sync: a warp's
//     32 columns are consecutive, so lane ± 1 holds column ± 1, which is
//     the same z line wherever the tap lies inside the grid); the ends of
//     a warp that are not ends of a z line load theirs;
//   - the y±1 neighbours (±nz) are other threads' columns at the same i:
//     a block covers adjacent j, so their __ldg loads mostly hit the
//     caches;
//   - (j, k) comes from the thread index once (one division a thread), i
//     from the march: no division per row.
// Each row sums its taps in stencil_row's order (centre, z+, z−, y+, y−,
// x+, x−: _TAPS7), each product and sum rounded on its own from 0, taps
// outside the grid skipped, so the march equals the first design bit for
// bit on finite x.
//
// The first design (stencil_spmv_kernel, cgx_stencil3d_spmv; reached only
// by kernels/stencil.py _before_spmv, counted nowhere, the same-run
// "before" of the tests and the smoke): one thread per row in a
// grid-stride loop, two divisions and seven guarded scalar loads a row
// (cgx::stencil_row), each x value loaded by seven rows.
#include <cuda_runtime.h>

#include "stencil.cuh"

namespace {

constexpr int kThreads = 256;
// The block and the chunk, picked by a sweep on the card (chunks of 2 to
// 32 rows, blocks of 128 to 512 threads; PERF.md §6): 4 warps, i.e. 4
// z lines of 128 at W = 4, and 4 rows of i a thread.
constexpr int kMarchThreads = 128;
constexpr int kChunk = 4;
constexpr unsigned kFull = 0xFFFFFFFFu;

__global__ void __launch_bounds__(kThreads)
    stencil_spmv_kernel(const float* __restrict__ x, float* __restrict__ y,
                        int nx, int ny, int nz, cgx::StencilTaps taps) {
  const long long n = static_cast<long long>(nx) * ny * nz;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long row = static_cast<long long>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
       row < n; row += stride) {
    y[row] = cgx::stencil_row<true, 7>(x, static_cast<int>(row), nx, ny,
                                       nz, taps);
  }
}

// The seven coefficients in tap order: centre, z+, z−, y+, y−, x+, x−.
struct Coeffs7 {
  float c[7];
};

template <int W>
__device__ __forceinline__ void load_vec(const float* __restrict__ p,
                                         float (&v)[W]) {
  if constexpr (W == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
    v[0] = __ldg(p);
  }
}

template <int W>
__device__ __forceinline__ void store_vec(float* __restrict__ p,
                                          const float (&v)[W]) {
  if constexpr (W == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    p[0] = v[0];
  }
}

// acc + c·v, each rounded on its own, where the tap lies inside the grid.
__device__ __forceinline__ float tap(float acc, bool inside, float c,
                                     float v) {
  return inside ? __fadd_rn(acc, __fmul_rn(c, v)) : acc;
}

// Grid (ceil(ny·nz/W / kMarchThreads), ceil(nx / kChunk)): column col =
// blockIdx.x·kMarchThreads + threadIdx.x is (j, q) = divmod(col, nz/W),
// z-values k0 = q·W .. k0+W−1; rows i0 = blockIdx.y·kChunk .. i0+kChunk−1
// (those < nx).  Threads past the last column shadow it (their loads stay
// in range, they store nothing) so that every lane takes the shuffles.
template <int W>
__global__ void __launch_bounds__(kMarchThreads)
    stencil_march_kernel(const float* __restrict__ x, float* __restrict__ y,
                         int nx, int ny, int nz, Coeffs7 cf) {
  const int nq = nz / W;
  const int ncols = ny * nq;
  const int col = blockIdx.x * kMarchThreads + threadIdx.x;
  const bool active = col < ncols;
  const int cc = active ? col : ncols - 1;
  const int j = cc / nq;
  const int k0 = (cc - j * nq) * W;
  const int lane = threadIdx.x & 31;
  const int plane = ny * nz;
  const int i0 = blockIdx.y * kChunk;
  const int rows = min(kChunk, nx - i0);
  const int p = j * nz + k0;
  const bool y_hi = j + 1 < ny, y_lo = j > 0;
  const bool z_hi = k0 + W < nz, z_lo = k0 > 0;

  // x of the column at i0−1 .. i0+kChunk (slot m holds i = i0−1+m; zero
  // outside the grid, where no tap reads it).
  float v[kChunk + 2][W];
#pragma unroll
  for (int m = 0; m < kChunk + 2; ++m) {
    const int i = i0 - 1 + m;
    if (i >= 0 && i < nx) {
      load_vec<W>(x + i * plane + p, v[m]);
    } else {
#pragma unroll
      for (int e = 0; e < W; ++e) v[m][e] = 0.0f;
    }
  }

  // The y±1 neighbours of every row of the chunk, also loaded before the
  // first row is summed.
  float yp[kChunk][W] = {}, ym[kChunk][W] = {};
#pragma unroll
  for (int m = 0; m < kChunk; ++m) {
    if (m >= rows) break;  // the same for the whole block
    const int r = (i0 + m) * plane + p;
    if (y_hi) load_vec<W>(x + r + nz, yp[m]);
    if (y_lo) load_vec<W>(x + r - nz, ym[m]);
  }

#pragma unroll
  for (int m = 1; m <= kChunk; ++m) {
    if (m > rows) break;  // the same for the whole block
    const int i = i0 + m - 1;
    const int r = i * plane + p;
    float zl = __shfl_up_sync(kFull, v[m][W - 1], 1);
    float zr = __shfl_down_sync(kFull, v[m][0], 1);
    if (lane == 0 && z_lo) zl = __ldg(x + r - 1);
    if (lane == 31 && z_hi) zr = __ldg(x + r + W);
    float out[W];
#pragma unroll
    for (int e = 0; e < W; ++e) {
      const int k = k0 + e;
      float acc = __fadd_rn(0.0f, __fmul_rn(cf.c[0], v[m][e]));
      acc = tap(acc, k + 1 < nz, cf.c[1],
                e + 1 < W ? v[m][min(e + 1, W - 1)] : zr);
      acc = tap(acc, k > 0, cf.c[2], e > 0 ? v[m][max(e - 1, 0)] : zl);
      acc = tap(acc, y_hi, cf.c[3], yp[m - 1][e]);
      acc = tap(acc, y_lo, cf.c[4], ym[m - 1][e]);
      acc = tap(acc, i + 1 < nx, cf.c[5], v[m + 1][e]);
      acc = tap(acc, i > 0, cf.c[6], v[m - 1][e]);
      out[e] = acc;
    }
    if (active) store_vec<W>(y + r, out);
  }
}

}  // namespace

// The first design (the "before"): launches on `stream`; returns
// cudaGetLastError() after the launch.
extern "C" int cgx_stencil3d_spmv(const float* x, float* y, int nx, int ny,
                                  int nz, int ntaps, const int* taps,
                                  const float* coeffs, void* stream) {
  if (ntaps < 1 || ntaps > 7) return cudaErrorInvalidValue;
  const cgx::StencilTaps t = cgx::make_taps(ntaps, taps, coeffs);
  const long long n = static_cast<long long>(nx) * ny * nz;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > (1 << 20)) blocks = 1 << 20;
  if (blocks < 1) blocks = 1;
  stencil_spmv_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(x, y, nx, ny,
                                                             nz, t);
  return static_cast<int>(cudaGetLastError());
}

// The march: `coeffs` the seven coefficients in tap order (centre, z+, z−,
// y+, y−, x+, x−).  The float4 form where nz % 4 == 0 and x and y are
// 16-byte aligned, else the scalar form.  Launches on `stream`; returns
// cudaGetLastError() after the launch.
extern "C" int cgx_stencil3d_march(const float* x, float* y, int nx, int ny,
                                   int nz, const float* coeffs,
                                   void* stream) {
  if (nx < 1 || ny < 1 || nz < 1) return cudaErrorInvalidValue;
  Coeffs7 cf;
  for (int s = 0; s < 7; ++s) cf.c[s] = coeffs[s];
  const bool vec = nz % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const int w = vec ? 4 : 1;
  const long long ncols = static_cast<long long>(ny) * (nz / w);
  const dim3 grid(static_cast<unsigned>((ncols + kMarchThreads - 1) /
                                        kMarchThreads),
                  static_cast<unsigned>((nx + kChunk - 1) / kChunk));
  const auto st = static_cast<cudaStream_t>(stream);
  if (vec) {
    stencil_march_kernel<4><<<grid, kMarchThreads, 0, st>>>(x, y, nx, ny, nz,
                                                           cf);
  } else {
    stencil_march_kernel<1><<<grid, kMarchThreads, 0, st>>>(x, y, nx, ny, nz,
                                                           cf);
  }
  return static_cast<int>(cudaGetLastError());
}
