// Operator rows, reductions and launch helpers shared by the kernels: the
// stencil SpMV (stencil.cu), the whole-solve CG (resident_cg.cu), the
// two-pass engines for one and for k right-hand sides (fused_engine.cu,
// fused_multi.cu), the semi-resident whole-solve CG (semiresident.cu) and
// the one-pass iteration (onepass.cu).
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

#include <cstddef>
#include <cstdint>
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
// overflows int32 for any n < 2³¹.  kPlanesReadOnly: the planes through
// the read-only path (default: as x).
template <bool kReadOnly, int kTaps, bool kSym, typename V, typename P,
          bool kPlanesReadOnly = kReadOnly>
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
        term = __fmul_rn(load<kPlanesReadOnly>(w + row),
                         load<kReadOnly>(x + row + off));
      if (kSym && off != 0 && off <= row && off > row - n) {
        const int m = row - off;
        term = __fadd_rn(term, __fmul_rn(load<kPlanesReadOnly>(w + m),
                                         load<kReadOnly>(x + m)));
      }
      acc = __fadd_rn(acc, term);
    }
  }
  return acc;
}

// -- Carried nodes (the two-phase whole-solve kernel, resident_cg.cu, and the
// one-pass kernel, onepass.cu) -----------------------------------------------
// A thread walks rows row₀, row₀ + step, row₀ + 2·step, …  Rather than two
// integer divisions a row (stencil_row's), it carries its row's node (i, j,
// k) and adds the step's own node (di, dj, dk), dk < nz and dj < ny, with
// one compare-and-subtract an axis: k + dk < 2·nz and j + dj + 1 < 2·ny.
// Two divisions a walk remain, in the constructor.  A row past n carries a
// node with i ≥ nx; the walks stop at n.  kernels/stencil.py `carried_nodes`
// is its plain mirror.
struct Walk {
  int i, j, k;
  int di, dj, dk;
  Walk() = default;
  __device__ __forceinline__ Walk(int row, int step, int ny, int nz) {
    int line = row / nz;
    k = row - line * nz;
    i = line / ny;
    j = line - i * ny;
    line = step / nz;
    dk = step - line * nz;
    di = line / ny;
    dj = line - di * ny;
  }
  __device__ __forceinline__ void advance(int ny, int nz) {
    k += dk;
    const int ck = k >= nz ? 1 : 0;
    k -= ck * nz;
    j += dj + ck;
    const int cj = j >= ny ? 1 : 0;
    j -= cj * ny;
    i += di + cj;
  }
};

// -- Shards of a row-partitioned grid (the distributed two-pass engines,
// fused_engine.cu and fused_multi.cu) ----------------------------------------
// A shard holds x-planes [0, nx) of its part of the grid, rows [0, n), and
// its vector p one ghost x-plane beyond them on each side where a neighbour
// shard exists (the neighbour's boundary plane, sent before kernel A).
// Span says what a row reader may read around the local rows: the flat range
// [lo, hi) of p (lo = −ny·nz with a left neighbour, else 0; hi = n + ny·nz
// with a right one, else n), the x-planes [xlo, xhi) a constant tap may
// reach, and the elements from one coefficient plane to the next (pstride:
// n, or n + 2·ny·nz where the planes carry ghost planes for the symmetric
// mode's mirror taps; the plane pointer is then the interior's).  A whole
// grid on one card is the span {0, n, 0, nx, n} (whole_grid): the readers
// below are then stencil_row and plane_row at a carried node, bit for bit,
// and at a shard they equal the whole grid's rows bit for bit.
struct Span {
  int lo, hi;
  int xlo, xhi;
  int pstride;
};

__device__ __forceinline__ Span whole_grid(int n, int nx) {
  return Span{0, n, 0, nx, n};
}

// stencil_row at a carried node, each value read through ld(index): the
// same taps, guards, products and sums in the same order as stencil_row, so
// the same bits.  ld lets a caller form the vector as it reads it (the
// two-phase kernel's p = r + β·p_old at each neighbour).
template <int kTaps, typename Load>
__device__ __forceinline__ float stencil_row_span(Load ld, const Walk& w,
                                                  const Span& sp, int ny,
                                                  int nz,
                                                  const StencilTaps& t) {
  float acc = 0.0f;
#pragma unroll
  for (int s = 0; s < kTaps; ++s) {
    if (s < t.n) {
      const int ii = w.i + t.dx[s];
      const int jj = w.j + t.dy[s];
      const int kk = w.k + t.dz[s];
      if (ii >= sp.xlo && ii < sp.xhi && jj >= 0 && jj < ny && kk >= 0 &&
          kk < nz)
        acc = __fadd_rn(acc, __fmul_rn(t.c[s], ld((ii * ny + jj) * nz + kk)));
    }
  }
  return acc;
}

// plane_row at a carried node, x read through ld(index), the planes through
// the read-only path (no kernel writes them): plane_row's arithmetic, bit
// for bit.  The guards are written against lo − row and hi − row so that
// nothing overflows int32 for any n + ny·nz < 2³¹.
template <int kTaps, bool kSym, typename P, typename Load>
__device__ __forceinline__ float plane_row_span(Load ld, const P* planes,
                                                int row, const Walk& w,
                                                const Span& sp, int ny,
                                                int nz, const PlaneTaps& t) {
  float acc = 0.0f;
#pragma unroll
  for (int s = 0; s < kTaps; ++s) {
    if (s < t.s.n) {
      const int pl = t.plane[s];
      if (pl < 0) {
        if (t.s.dx[s] == 0 && t.s.dy[s] == 0 && t.s.dz[s] == 0) {
          acc = __fadd_rn(acc, __fmul_rn(t.s.c[s], ld(row)));
        } else {
          const int ii = w.i + t.s.dx[s];
          const int jj = w.j + t.s.dy[s];
          const int kk = w.k + t.s.dz[s];
          float term = 0.0f;
          if (ii >= sp.xlo && ii < sp.xhi && jj >= 0 && jj < ny && kk >= 0 &&
              kk < nz)
            term = __fmul_rn(t.s.c[s], ld((ii * ny + jj) * nz + kk));
          acc = __fadd_rn(acc, term);
        }
        continue;
      }
      const P* c = planes + static_cast<ptrdiff_t>(pl) * sp.pstride;
      const int off = t.off[s];
      float term = 0.0f;
      if (off >= sp.lo - row && off < sp.hi - row)
        term = __fmul_rn(load<true>(c + row), ld(row + off));
      if (kSym && off != 0 && off <= row - sp.lo && off > row - sp.hi) {
        const int m = row - off;
        term = __fadd_rn(term, __fmul_rn(load<true>(c + m), ld(m)));
      }
      acc = __fadd_rn(acc, term);
    }
  }
  return acc;
}

// The readers over a whole grid: the span's zeros are constants here, so the
// compiler folds the guards to stencil_row's and plane_row's.
template <int kTaps, typename Load>
__device__ __forceinline__ float stencil_row_at(Load ld, const Walk& w,
                                                int nx, int ny, int nz,
                                                const StencilTaps& t) {
  return stencil_row_span<kTaps>(ld, w, whole_grid(nx * ny * nz, nx), ny, nz,
                                 t);
}

template <int kTaps, bool kSym, typename P, typename Load>
__device__ __forceinline__ float plane_row_at(Load ld, const P* planes,
                                              int row, const Walk& w, int n,
                                              int nx, int ny, int nz,
                                              const PlaneTaps& t) {
  return plane_row_span<kTaps, kSym>(ld, planes, row, w, whole_grid(n, nx),
                                     ny, nz, t);
}

// One row of the CG update (the two-pass engine's kernel B and the
// semi-resident kernel's update sweep): x' = x + αp, r' = r − αq and p' =
// r' + βp from the widened values, each taken in fp32 and rounded once to
// V, p' from the rounded r'.
template <typename V>
struct Updated {
  V x, r, p;
};

template <typename V>
__device__ __forceinline__ Updated<V> cg_update(float x, float r, float p,
                                                float q, float alpha,
                                                float beta) {
  const V rs = narrow<V>(__fsub_rn(r, __fmul_rn(alpha, q)));
  return {narrow<V>(__fadd_rn(x, __fmul_rn(alpha, p))), rs,
          narrow<V>(__fadd_rn(widen(rs), __fmul_rn(beta, p)))};
}

// A grid-stride walk over rows first, first + stride, … < n with the node
// carried, kRows rows in flight: value(row, walk) does a row's loads and
// arithmetic, use(row, v) its stores and sums.  The values of kRows rows
// are formed before any of them is used, so their loads overlap, and they
// are used in row order, so every sum keeps the one-row walk's order.  The
// caller must not read in value what use writes at another row.
template <int kRows, typename Value, typename Use>
__device__ __forceinline__ void walk_rows(int first, int stride, int n,
                                          int ny, int nz, Value value,
                                          Use use) {
  Walk w(first, stride, ny, nz);
  int row = first;
  if constexpr (kRows == 2) {
    for (; row + stride < n; row += 2 * stride) {
      const auto v0 = value(row, w);
      w.advance(ny, nz);
      const auto v1 = value(row + stride, w);
      w.advance(ny, nz);
      use(row, v0);
      use(row + stride, v1);
    }
  }
  for (; row < n; row += stride) {
    use(row, value(row, w));
    w.advance(ny, nz);
  }
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
                                                  int nc, int row,
                                                  const Span& sp, int ny,
                                                  int nz,
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
      if (ii >= sp.xlo && ii < sp.xhi && jj >= 0 && jj < ny && kk >= 0 &&
          kk < nz) {
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
    const float* x, size_t ld, int nc, const P* planes, int row,
    const Span& sp, int ny, int nz, const PlaneTaps& t,
    float (&acc)[kCols]) {
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
          in = ii >= sp.xlo && ii < sp.xhi && jj >= 0 && jj < ny &&
               kk >= 0 && kk < nz;
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
      const P* w = planes + static_cast<ptrdiff_t>(pl) * sp.pstride;
      const int off = t.off[s];
      const bool fwd = off >= sp.lo - row && off < sp.hi - row;
      const bool mir =
          kSym && off != 0 && off <= row - sp.lo && off > row - sp.hi;
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

// -- Asynchronous copies into shared memory ----------------------------------
// cp.async: a copy from global into shared memory that runs while the
// thread goes on; commit closes a group of them, wait<N> returns once at
// most N of the thread's groups are still in flight (a __syncthreads after
// it makes every thread's copies visible to the block).

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A float at a 32-bit shared-window address.  The march's readers address
// their stage this way, so a load is one LDS at a register plus an offset;
// a generic pointer into dynamic shared memory made the compiler rebuild
// the window's base before every load.
__device__ __forceinline__ float lds(unsigned addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}

// Copy the chunk x[first .. first + 4) into dst, elements outside [lo, hi)
// (a shard's span of x; [0, n) on one card) left unwritten: one 16-byte copy
// where the chunk lies in range and is 16-byte aligned in memory, else one
// 4-byte copy an element.
__device__ __forceinline__ void stage_chunk(float* dst, const float* x,
                                            long first, int lo, int hi) {
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(x) + first * sizeof(float)) & 15) == 0;
  if (aligned && first >= lo && first + 4 <= hi) {
    cp_async16(dst, x + first);
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (first + e >= lo && first + e < hi) cp_async4(dst + e, x + first + e);
}

// -- The 2.5-D march (the redesigned multi-RHS kernel A, fused_multi.cu) -----
// A block owns a tile of tj × tk nodes of an x-plane (tj lines j of tk
// nodes k; a thread takes `rows` of them, tj / rows lines apart) and
// marches along i over `len` planes.  The x-plane
// i' of each of the kCols columns is staged as lines j0 − hj … j0 + tj + hj
// − 1, each the flat elements (i'·ny + j)·nz + k0 − hk … + tk + hk − 1
// (hk a multiple of 4, so a line starts 16-byte aligned when nz, k0 and the
// column are); a ring of slots holds planes i − 1, i, i + 1 and the ones in
// flight.  Every flat read of a tap, x[row + off] with off = (dx·ny
// + dy)·nz + dz, |dx| ≤ 1, |dy| ≤ hj, |dz| ≤ hk, is the element at (dx, dy,
// dz) from the node in the stage, including reads that wrap past a line or a
// plane (the copy is by flat index, clamped to [0, n)).  The row readers are
// stencil_row_multi and plane_row_multi with those reads: bit for bit.
// kernels/fused_multi.py `march_plan` makes the plan, `march_reference`
// mirrors the walk.
struct MarchPlan {
  int tj, tk;  // the tile: tj lines of tk nodes
  int rows;    // nodes a thread takes in a plane, tj / rows lines apart
  int len;     // x-planes a block marches over
  int hj, hk;  // halo of the staged lines (hk a multiple of 4)
  int tiles_j, tiles_k, chunks;
  int rel[kMaxTaps];  // a tap's stage offset (dy·(tk + 2hk) + dz) in bytes
};

// The taps whose neighbour of node (i, j, k) lies in the grid, one bit a
// tap: the j and k conditions (fixed along a thread's march) and the i
// conditions (|dx| ≤ 1: only the first and last x-plane drop taps).  The
// same booleans as stencil_row's guards.
__device__ __forceinline__ unsigned jk_taps(int j, int k, int ny, int nz,
                                            const StencilTaps& t) {
  unsigned m = 0;
  for (int s = 0; s < t.n; ++s) {
    const int jj = j + t.dy[s], kk = k + t.dz[s];
    if (jj >= 0 && jj < ny && kk >= 0 && kk < nz) m |= 1u << s;
  }
  return m;
}

// (A shard's taps may reach its ghost planes: ii in [xlo, xhi).)
__device__ __forceinline__ unsigned i_taps(int i, int xlo, int xhi,
                                           const StencilTaps& t) {
  unsigned m = 0;
  for (int s = 0; s < t.n; ++s) {
    const int ii = i + t.dx[s];
    if (ii >= xlo && ii < xhi) m |= 1u << s;
  }
  return m;
}

// The rows of the march.  sm, s0, sp: the shared addresses of the thread's
// node in column 0 of the slots of x-planes i − 1, i, i + 1; cstride: bytes
// from one column to the next; in: the taps inside the grid (jk_taps &
// i_taps); rel: the taps' stage offsets in bytes (MarchPlan::rel × 4).
// Every column is computed (the callers store only the first nc), so no
// load waits on a branch; the arithmetic per column is stencil_row_multi's
// and plane_row_multi's.
template <int kTaps, int kCols>
__device__ __forceinline__ void stencil_tile_multi(
    unsigned sm, unsigned s0, unsigned sp, unsigned cstride, unsigned in,
    const int* rel, const StencilTaps& t, float (&acc)[kCols]) {
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc[c] = 0.0f;
#pragma unroll
  for (int s = 0; s < kTaps; ++s) {
    if (s < t.n && ((in >> s) & 1u)) {
      const unsigned x = (t.dx[s] < 0 ? sm : t.dx[s] > 0 ? sp : s0) + rel[s];
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        acc[c] = __fadd_rn(acc[c],
                           __fmul_rn(t.c[s], lds(x + c * cstride)));
    }
  }
}

template <int kTaps, bool kSym, int kCols, typename P>
__device__ __forceinline__ void plane_tile_multi(
    unsigned sm, unsigned s0, unsigned sp, unsigned cstride,
    unsigned in_taps, const int* rel, const P* planes, int row,
    const Span& span, const PlaneTaps& t, float (&acc)[kCols]) {
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc[c] = 0.0f;
#pragma unroll
  for (int s = 0; s < kTaps; ++s) {
    if (s < t.s.n) {
      const int dx = t.s.dx[s];
      const unsigned fwd_x = (dx < 0 ? sm : dx > 0 ? sp : s0) + rel[s];
      const int pl = t.plane[s];
      if (pl < 0) {
        // A constant tap: one mask (the centre's always holds), then
        // c·x[neighbour] (0 outside).
        const bool in = (in_taps >> s) & 1u;
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const float term =
              in ? __fmul_rn(t.s.c[s], lds(fwd_x + c * cstride)) : 0.0f;
          acc[c] = __fadd_rn(acc[c], term);
        }
        continue;
      }
      // The plane values from global memory (their mirrors from the L2):
      // staging them beside P measured slower on the H100.
      const P* w = planes + static_cast<ptrdiff_t>(pl) * span.pstride;
      const int off = t.off[s];
      const bool fwd = off >= span.lo - row && off < span.hi - row;
      const bool mir =
          kSym && off != 0 && off <= row - span.lo && off > row - span.hi;
      const float wf = fwd ? load<true>(w + row) : 0.0f;
      const float wm = mir ? load<true>(w + row - off) : 0.0f;
      const unsigned mir_x = (dx > 0 ? sm : dx < 0 ? sp : s0) - rel[s];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        float term = 0.0f;
        if (fwd) term = __fmul_rn(wf, lds(fwd_x + c * cstride));
        if (mir)
          term = __fadd_rn(term,
                           __fmul_rn(wm, lds(mir_x + c * cstride)));
        acc[c] = __fadd_rn(acc[c], term);
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

// Two block sums with one tree's barriers, each in block_sum's order (the
// same bits as two calls).  smem holds 2·(kThreads/32 + 1) values.
template <int kThreads, typename T>
__device__ __forceinline__ void block_sum2(T& a, T& b, T* smem) {
  constexpr int kWarps = kThreads / 32;
  a = warp_sum(a);
  b = warp_sum(b);
  if ((threadIdx.x & 31) == 0) {
    smem[threadIdx.x >> 5] = a;
    smem[kWarps + 1 + (threadIdx.x >> 5)] = b;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    T s = 0, t = 0;
    for (int w = 0; w < kWarps; ++w) {
      s += smem[w];
      t += smem[kWarps + 1 + w];
    }
    smem[kWarps] = s;
    smem[2 * kWarps + 1] = t;
  }
  __syncthreads();
  a = smem[kWarps];
  b = smem[2 * kWarps + 1];
  __syncthreads();
}

// Sum of `count` block partials, in the same order in every block.
// __ldcg reads through L2, where the other blocks' writes land.
template <int kThreads, typename T>
__device__ __forceinline__ T grid_sum(const T* part, int count, T* smem) {
  T v = 0;
  for (int b = threadIdx.x; b < count; b += kThreads) v += __ldcg(part + b);
  return block_sum<kThreads>(v, smem);
}

// grid_sum of part[0, count) and of part[count, 2·count) at once, each in
// grid_sum's order (the same bits as two calls).
template <int kThreads, typename T>
__device__ __forceinline__ void grid_sum2(const T* part, int count, T& a,
                                          T& b, T* smem) {
  a = 0;
  b = 0;
  for (int i = threadIdx.x; i < count; i += kThreads) {
    a += __ldcg(part + i);
    b += __ldcg(part + count + i);
  }
  block_sum2<kThreads>(a, b, smem);
}

// True in the block that finishes last (the multi-RHS engine and the
// redesigned two-pass engine fold their partials there, once a launch).
// Thread 0 has written the block's partials; the fence orders them before
// its ticket, so the last block reads every partial through L2 (grid_sum
// uses __ldcg).  The last block resets the counter for the next launch:
// every other block has taken its ticket by then.
__device__ __forceinline__ bool last_block(int* count) {
  __shared__ bool last;
  if (threadIdx.x == 0) {
    __threadfence();
    const unsigned int ticket =
        atomicAdd(reinterpret_cast<unsigned int*>(count), 1u);
    last = ticket == gridDim.x - 1;
    if (last) *count = 0;
  }
  __syncthreads();
  return last;
}

// A grid-wide barrier whose last arriving block runs fold() (every thread
// of it) before it releases the others: the fold is done once, on the
// barrier's own critical path, and costs no ticket of its own.  A
// cooperative launch keeps every block resident, so the others may spin.
// count: the arrivals (0 between barriers); gen: the barrier's generation.
// As cooperative_groups' grid.sync(), each block's thread 0 fences before
// it arrives and after it is released, so every write before the barrier
// (and fold()'s) is visible to every block after it.
template <typename Fold>
__device__ __forceinline__ void barrier_fold(unsigned int* count,
                                             unsigned int* gen, Fold fold) {
  __shared__ bool last;
  volatile unsigned int* vgen = gen;
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned int g = *vgen;  // before arriving: no release can pass
    __threadfence();
    last = atomicAdd(count, 1u) == gridDim.x - 1;
    if (!last) {
      while (*vgen == g) {
      }
      __threadfence();
    }
  }
  __syncthreads();
  if (last) {
    fold();
    __syncthreads();
    if (threadIdx.x == 0) {
      *count = 0;
      __threadfence();
      atomicAdd(gen, 1u);
    }
    __syncthreads();
  }
}

// -- Launch helpers -----------------------------------------------------------

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

// The same as a cooperative launch (grid-wide barriers): a grid larger than
// the blocks that fit on the card at once (full_grid) is refused.
template <int kThreads>
inline int launch_cooperative(const void* kernel, int grid, void* args,
                              void* stream) {
  void* params[] = {args};
  cudaError_t e = cudaLaunchCooperativeKernel(
      kernel, dim3(grid), dim3(kThreads), params, 0,
      static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// -- Sums over another kernel's partition (the semi-resident and one-pass
// kernels, semiresident.cu and onepass.cu) -------------------------------------
// The two-pass engine sums a vector over its own grid: thread t of block b
// adds rows b·256 + t, + g·256, … in order (fp64), then a block tree.  A
// kernel that must take the same sums bit for bit walks the same "virtual"
// blocks of a grid of g blocks, whatever its own grid: block B takes the
// virtual blocks B, B + gridDim.x, … in turn, each with the thread layout
// and tree of the engine's block.  Every sum then equals the engine's to
// the last bit, and the kernel's own grid does not change the trajectory.
// Row(row, acc) adds row `row`'s terms to the thread's accumulators; Store
// (vb, acc) reduces them over the block and writes the partials.
template <int kThreads, typename Row, typename Store>
__device__ __forceinline__ void virtual_sweep(int g, int n, Row row_fn,
                                              Store store_fn) {
  for (int vb = blockIdx.x; vb < g; vb += gridDim.x) {
    double acc[2] = {0.0, 0.0};
    for (int row = vb * kThreads + threadIdx.x; row < n; row += g * kThreads)
      row_fn(row, acc);
    store_fn(vb, acc);
  }
}

// The same sums with carried nodes (the redesigned one-pass kernel): block
// B takes the virtual blocks B, B + gridDim.x, … in turn, thread t walks
// each one's rows vb·kThreads + t + m·g·kThreads with the node carried
// (Walk) instead of two divisions a row.  value(row, walk) does a row's
// loads and arithmetic, use(row, v, acc) its stores and sums, store(vb,
// acc) the block tree (it syncs the block: every thread calls it).
template <int kThreads, typename Value, typename Use, typename Store>
__device__ __forceinline__ void virtual_sweep_walk(int g, int n, int ny,
                                                   int nz, Value value,
                                                   Use use, Store store) {
  const int step = g * kThreads;
  for (int vb = blockIdx.x; vb < g; vb += gridDim.x) {
    double acc[2] = {0.0, 0.0};
    int row = vb * kThreads + threadIdx.x;
    for (Walk w(row < n ? row : 0, step, ny, nz); row < n; row += step) {
      use(row, value(row, w), acc);
      w.advance(ny, nz);
    }
    store(vb, acc);
  }
}

// The same with kRows (1 or 2) of a thread's rows in flight (the
// redesigned semi-resident kernel, as the redesigned kernel A of the
// two-pass engine reads): value(row, walk) of rows r and r + g·kThreads is
// formed before either is used, and use(row, v, acc) takes them in row
// order, so every sum keeps the one-row order.  walk = false: value never
// reads the node, which is then not carried.
template <int kThreads, int kRows, typename Value, typename Use,
          typename Store>
__device__ __forceinline__ void virtual_sweep_rows(int g, int n, int ny,
                                                   int nz, bool walk,
                                                   Value value, Use use,
                                                   Store store) {
  static_assert(kRows == 1 || kRows == 2, "one or two rows in flight");
  using T = decltype(value(0, Walk()));
  const int step = g * kThreads;
  const int u = threadIdx.x;
  for (int vb = blockIdx.x; vb < g; vb += gridDim.x) {
    double acc[2] = {0.0, 0.0};
    int s = vb * kThreads;
    Walk w(s + u, step, ny, nz);
    if constexpr (kRows == 2) {
      for (; s + step < n; s += 2 * step) {
        const int r0 = s + u, r1 = r0 + step;  // r0 < n
        Walk w1 = w;
        if (walk) w1.advance(ny, nz);
        const T v0 = value(r0, w);
        T v1{};
        if (r1 < n) v1 = value(r1, w1);
        use(r0, v0, acc);
        if (r1 < n) use(r1, v1, acc);
        w = w1;
        if (walk) w.advance(ny, nz);
      }
    }
    for (; s + u < n; s += step) {
      use(s + u, value(s + u, w), acc);
      if (walk) w.advance(ny, nz);
    }
    store(vb, acc);
  }
}

}  // namespace cgx
