// Operator rows, reductions and launch helpers shared by the kernels: the
// stencil SpMV (stencil.cu), the whole-solve CG (resident_cg.cu) and the
// two-pass engines for one and for k right-hand sides (fused_engine.cu,
// fused_multi.cu).
//
// stencil_row: y[row] = sum_t c[t] * x[(i+dx[t], j+dy[t], k+dz[t])] over
// the taps whose neighbour lies inside the nx × ny × nz grid (zero
// Dirichlet boundary): the boundary masks come from index arithmetic,
// nothing is stored.  Node (i, j, k) is row (i*ny + j)*nz + k, as in the
// JAX package.
//
// plane_row: the same with coefficient-plane taps mixed in (the Jacobi-
// scaled DIA operators): a plane tap t reads planes[t][row] · x[row+off]
// with off = dx·ny·nz + dy·nz + dz under a flat range guard.  The boundary
// zeros live in the plane data, which is why the DIA routes require
// wrap_entries_zero: under that condition the flat reading equals the JAX
// package's halo-padded lane layout.  In the symmetric mode each plane
// also serves its mirror tap, planes[t][row−off] · x[row−off].
//
// Each product and sum is rounded on its own, in tap order, as the plain
// PyTorch versions (GeneralStencil3D.matvec, fused_engine.tap_matvec)
// round them.
//
// Element types.  The vectors a row reader reads (V) and the coefficient
// planes (P) are float or __nv_bfloat16, each on its own: the bf16 modes of
// the two-pass engine, the whole-solve kernel and the multi-RHS engine.
// Every value is widened to fp32 in registers as it is loaded (exact), the
// row is summed in fp32, and a caller that stores a narrower type rounds
// once (narrow<V>, round to nearest even, as torch's .to(bfloat16)).  A
// bf16 value is read as its 16 bits with a 2-byte load: the shifted
// neighbour reads are not 4-byte aligned.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace cgx {

constexpr int kMaxTaps = 27;

// Taps by value: a kernel parameter, read from the constant bank.
struct StencilTaps {
  int n;
  int dx[kMaxTaps];
  int dy[kMaxTaps];
  int dz[kMaxTaps];
  float c[kMaxTaps];
};

// A mixed operator: constant taps (plane[t] < 0, coefficient s.c[t]) and
// plane taps (plane[t] = index of the tap's coefficient plane).
struct PlaneTaps {
  StencilTaps s;
  int plane[kMaxTaps];
  int off[kMaxTaps];  // flat offset dx·ny·nz + dy·nz + dz
};

// Host side: pack (n, taps[3n], coeffs[n]) host arrays into the struct.
inline StencilTaps make_taps(int n, const int* taps, const float* coeffs) {
  StencilTaps t{};
  t.n = n;
  for (int s = 0; s < n; ++s) {
    t.dx[s] = taps[3 * s];
    t.dy[s] = taps[3 * s + 1];
    t.dz[s] = taps[3 * s + 2];
    t.c[s] = coeffs[s];
  }
  return t;
}

inline PlaneTaps make_plane_taps(int n, const int* taps, const float* coeffs,
                                 const int* plane, int ny, int nz) {
  PlaneTaps t{};
  t.s = make_taps(n, taps, coeffs);
  for (int s = 0; s < n; ++s) {
    t.plane[s] = plane[s];
    t.off[s] = (t.s.dx[s] * ny + t.s.dy[s]) * nz + t.s.dz[s];
  }
  return t;
}

// Widen a stored value to fp32 (exact) and round an fp32 value to the
// stored type once.
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T narrow(float v) {
  if constexpr (std::is_same_v<T, float>) {
    return v;
  } else {
    return __float2bfloat16_rn(v);
  }
}

// kReadOnly selects the non-coherent read-only path (__ldg).  It is only
// valid for data no thread writes during the kernel (the SpMV's x, the
// two-pass engine's p and planes).  The whole-solve kernel rewrites p
// every iteration, so it reads with plain loads, which the grid-wide
// barrier orders.  T is float or __nv_bfloat16; the value comes back
// widened to fp32.
template <bool kReadOnly, typename T>
__device__ __forceinline__ float load(const T* p) {
  if constexpr (std::is_same_v<T, float>) {
    if constexpr (kReadOnly) {
      return __ldg(p);
    } else {
      return *p;
    }
  } else {
    const unsigned short* u = reinterpret_cast<const unsigned short*>(p);
    const unsigned short bits = kReadOnly ? __ldg(u) : *u;
    return __uint_as_float(static_cast<unsigned int>(bits) << 16);
  }
}

// One constant tap at node (i, j, k): c·x[neighbour], 0 outside the grid.
template <bool kReadOnly, typename V>
__device__ __forceinline__ float const_tap(const V* x, int i, int j,
                                           int k, int nx, int ny, int nz,
                                           const StencilTaps& t, int s) {
  const int ii = i + t.dx[s];
  const int jj = j + t.dy[s];
  const int kk = k + t.dz[s];
  if (ii >= 0 && ii < nx && jj >= 0 && jj < ny && kk >= 0 && kk < nz)
    return __fmul_rn(t.c[s], load<kReadOnly>(x + (ii * ny + jj) * nz + kk));
  return 0.0f;
}

// kTaps bounds the unrolled tap loop (7 for the 7-point operator, kMaxTaps
// otherwise): every tap field is then a static index into the parameter
// struct, and a 7-point row runs 7 guarded taps instead of 27.
template <bool kReadOnly, int kTaps, typename V>
__device__ __forceinline__ float stencil_row(const V* x, int row, int nx,
                                             int ny, int nz,
                                             const StencilTaps& t) {
  const int line = row / nz;
  const int k = row - line * nz;
  const int i = line / ny;
  const int j = line - i * ny;
  float acc = 0.0f;
#pragma unroll
  for (int s = 0; s < kTaps; ++s) {
    if (s < t.n) {
      const int ii = i + t.dx[s];
      const int jj = j + t.dy[s];
      const int kk = k + t.dz[s];
      if (ii >= 0 && ii < nx && jj >= 0 && jj < ny && kk >= 0 && kk < nz) {
        acc = __fadd_rn(
            acc, __fmul_rn(t.c[s], load<kReadOnly>(x + (ii * ny + jj) * nz +
                                                    kk)));
      }
    }
  }
  return acc;
}

// Row of a mixed operator over n = nx·ny·nz rows.  Plane p is
// planes[p·n .. p·n + n).  The range guards are written so that nothing
// overflows int32 for any n < 2³¹.
template <bool kReadOnly, int kTaps, bool kSym, typename V, typename P>
__device__ __forceinline__ float plane_row(const V* x, const P* planes,
                                           int row,
                                           int n, int nx, int ny, int nz,
                                           const PlaneTaps& t) {
  float acc = 0.0f;
#pragma unroll
  for (int s = 0; s < kTaps; ++s) {
    if (s < t.s.n) {
      const int pl = t.plane[s];
      if (pl < 0) {
        if (t.s.dx[s] == 0 && t.s.dy[s] == 0 && t.s.dz[s] == 0) {
          // The centre tap (the unit diagonal of a scaled DIA operator).
          acc = __fadd_rn(acc, __fmul_rn(t.s.c[s], load<kReadOnly>(x + row)));
        } else {
          const int line = row / nz;
          const int i = line / ny;
          acc = __fadd_rn(acc, const_tap<kReadOnly>(x, i, line - i * ny,
                                                    row - line * nz, nx, ny,
                                                    nz, t.s, s));
        }
        continue;
      }
      const P* w = planes + static_cast<size_t>(pl) * n;
      const int off = t.off[s];
      float term = 0.0f;
      if (off >= -row && off < n - row)
        term = __fmul_rn(load<kReadOnly>(w + row),
                         load<kReadOnly>(x + row + off));
      if (kSym && off != 0 && off <= row && off > row - n) {
        const int m = row - off;
        term = __fadd_rn(term, __fmul_rn(load<kReadOnly>(w + m),
                                         load<kReadOnly>(x + m)));
      }
      acc = __fadd_rn(acc, term);
    }
  }
  return acc;
}

// -- k-column rows (the multi-RHS engine, fused_multi.cu) ---------------------
// The rows of nc ≤ kCols columns at once: column c is x + c·ld (fp32).  A
// boundary mask and a coefficient-plane value (fp32 or bf16, widened) are
// read once per tap and applied to every column from a register.  Each column adds its terms in tap order and
// rounds every product and sum on its own, exactly as stencil_row and
// plane_row do, so acc[c] equals the one-column reader on column c bit for
// bit.  Read-only loads: the two-pass engine never writes p during pass A.

template <int kTaps, int kCols>
__device__ __forceinline__ void stencil_row_multi(const float* x, size_t ld,
                                                  int nc, int row, int nx,
                                                  int ny, int nz,
                                                  const StencilTaps& t,
                                                  float (&acc)[kCols]) {
  const int line = row / nz;
  const int k = row - line * nz;
  const int i = line / ny;
  const int j = line - i * ny;
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc[c] = 0.0f;
#pragma unroll
  for (int s = 0; s < kTaps; ++s) {
    if (s < t.n) {
      const int ii = i + t.dx[s];
      const int jj = j + t.dy[s];
      const int kk = k + t.dz[s];
      if (ii >= 0 && ii < nx && jj >= 0 && jj < ny && kk >= 0 && kk < nz) {
        const int idx = (ii * ny + jj) * nz + kk;
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          if (c < nc)
            acc[c] = __fadd_rn(acc[c],
                               __fmul_rn(t.c[s], __ldg(x + c * ld + idx)));
        }
      }
    }
  }
}

template <int kTaps, bool kSym, int kCols, typename P>
__device__ __forceinline__ void plane_row_multi(
    const float* x, size_t ld, int nc, const P* planes, int row, int n,
    int nx, int ny, int nz, const PlaneTaps& t, float (&acc)[kCols]) {
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc[c] = 0.0f;
#pragma unroll
  for (int s = 0; s < kTaps; ++s) {
    if (s < t.s.n) {
      const int pl = t.plane[s];
      if (pl < 0) {
        // A constant tap: one mask, then c·x[neighbour] (0 outside).
        int idx = row;
        bool in = true;
        if (!(t.s.dx[s] == 0 && t.s.dy[s] == 0 && t.s.dz[s] == 0)) {
          const int line = row / nz;
          const int i = line / ny;
          const int ii = i + t.s.dx[s];
          const int jj = line - i * ny + t.s.dy[s];
          const int kk = row - line * nz + t.s.dz[s];
          in = ii >= 0 && ii < nx && jj >= 0 && jj < ny && kk >= 0 && kk < nz;
          idx = (ii * ny + jj) * nz + kk;
        }
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          if (c < nc)
            acc[c] = __fadd_rn(
                acc[c], in ? __fmul_rn(t.s.c[s], __ldg(x + c * ld + idx))
                           : 0.0f);
        }
        continue;
      }
      const P* w = planes + static_cast<size_t>(pl) * n;
      const int off = t.off[s];
      const bool fwd = off >= -row && off < n - row;
      const bool mir = kSym && off != 0 && off <= row && off > row - n;
      const int m = row - off;
      const float wf = fwd ? load<true>(w + row) : 0.0f;
      const float wm = mir ? load<true>(w + m) : 0.0f;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        if (c < nc) {
          const float* xc = x + c * ld;
          float term = 0.0f;
          if (fwd) term = __fmul_rn(wf, __ldg(xc + row + off));
          if (mir) term = __fadd_rn(term, __fmul_rn(wm, __ldg(xc + m)));
          acc[c] = __fadd_rn(acc[c], term);
        }
      }
    }
  }
}

// -- Reductions ---------------------------------------------------------------
// Fixed-order sums, no atomics: the same inputs give bit-identical sums.
// T is float (the whole-solve kernel) or double (the two-pass engine).

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Block tree sum of one value per thread; every thread gets the result.
// smem holds kThreads/32 + 1 values.
template <int kThreads, typename T>
__device__ __forceinline__ T block_sum(T v, T* smem) {
  constexpr int kWarps = kThreads / 32;
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) smem[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    T s = 0;
    for (int w = 0; w < kWarps; ++w) s += smem[w];
    smem[kWarps] = s;
  }
  __syncthreads();
  const T s = smem[kWarps];
  __syncthreads();
  return s;
}

// Sum of `count` block partials, in the same order in every block.
// __ldcg reads through L2, where the other blocks' writes land.
template <int kThreads, typename T>
__device__ __forceinline__ T grid_sum(const T* part, int count, T* smem) {
  T v = 0;
  for (int b = threadIdx.x; b < count; b += kThreads) v += __ldcg(part + b);
  return block_sum<kThreads>(v, smem);
}

// -- Launch helpers (the two-pass engines) --------------------------------------

// A grid of as many blocks as fit on the card at once: every block then
// runs in one wave and the number of partials is fixed for the card.
template <int kThreads>
inline int full_grid(int device, const void* kernel, int* grid) {
  int sms = 0;
  int per_sm = 0;
  cudaError_t e =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                    0);
  if (e != cudaSuccess) return static_cast<int>(e);
  *grid = per_sm * sms;
  return *grid > 0 ? 0 : static_cast<int>(cudaErrorInvalidConfiguration);
}

// Launch a kernel that takes one argument struct; returns the launch error.
template <int kThreads>
inline int launch(const void* kernel, int grid, void* args, void* stream) {
  void* params[] = {args};
  cudaError_t e = cudaLaunchKernel(kernel, dim3(grid), dim3(kThreads), params,
                                   0, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cgx
