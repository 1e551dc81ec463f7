// K7, K8, K9, K10, P1 and P3: the WBELL (windowed block-ELL) product
// Y = A·X for nrhs right-hand sides in the internal layout (nrhs, nt, 8,
// 128) or, for K10, the stacked layout (nt, nrhs·8, 128).
//
// Replaces four Pallas kernels of cgx/kernels/wbell.py and two of
// experiments/, which compute the same Y:
//   K7  _kernel_resident          over the row layout, x from the L2
//   K9  _kernel                   over the windowed row layout, x staged
//   K8  _kernel_resident_tiers    over its tier plan's row layout (K7's)
//   P1  tier_proto _kernel_tiers  over its tiers' row layout
//   P3  halfblock _kernel_half    over a segmented row layout
//   K10 _kernel_resident_stacked  over K7's row layout, stacked x and y
//
// -- The row layouts (K7, K8, K9, K10, P1, P3) -------------------------------
// The TPU kernels stream slot planes of 8×8 blocks, one block per lane of a
// (8, 128) vreg.  At thermal2 scale a block holds 5.6 nonzeros of its 64
// entries and 66 % of the lane slots hold one: the planes are 17.5× the
// nonzeros, 620 MB a product, a byte bound (185 µs) twice torch's whole CSR
// product.  The card has no vreg shape to fill, so these kernels read the
// nonzeros alone, as sliced ELL over the internal rows
// (cgx_torch/sparse/wbell.py: WBellRows, built once from the planes on
// their device): within each group of 1024 rows the rows are sorted by
// length (a row map puts each sum back), 32 consecutive rows form a slice,
// stored slot-major, so a warp's loads of values and columns are
// coalesced.  A column is a 16-bit offset from its group's (K9: its
// stage's) window start.  At thermal2 scale that is 2 % padding and 58 MB
// a product.  Each kernel's layout comes from its own planes and walk:
// K7's (and K10's) from the matrix's planes in plane order, K8's from its
// tier plan's
// class-major planes in the original plane order (the same entries in the
// same order, so the same arrays: K8 is K7's kernel), P1's from its tiers
// in their stored class-major order, P3's from its 4×8 half-block planes
// (P, 4, 8, 128), row og·1024 + (4·half + i)·128 + l, half = lc bit 14.
//
// Each row keeps its nonzeros in its walk's order (plane order, then j),
// and each product and sum is rounded on its own (__fmul_rn, __fadd_rn)
// from 0, as the plane walk sums them: the left-out zeros add exact ±0
// products, which leave a sum that started at +0 unchanged.  So each
// equals its plane walk, and through it the TPU kernels, bit for bit on
// finite x.  No two threads write one output, there are no atomics, every
// output (pad groups included) is written once, and two runs are bitwise
// equal.
//
// P3's layout is segmented: the prototype sums each plane's 4×8 product
// from 0 on its own and then adds it to the row's sum.  Bit e of the word
// flags[sbase[k] / 32 + t] marks slot t of slice k's lane e as continuing
// the previous slot's (row, plane) segment.  kSeg keeps a segment sum
// `part`: an unflagged slot adds part to acc and restarts it from 0, and
// the row's end adds the last part.  A one-entry segment rounds as acc +
// v·x does.  The flag word costs 1/32 of a word a slot (1.1 MB at thermal2
// scale); a flag in the column word's top bit would leave 15 bits, fewer
// than that matrix's widest group window (40,852 floats) needs.  A warp
// reads 32 slots' flag words in one load and transposes them (lane_flags),
// so a slot costs no load of its own (a load a slot measured slower).
//
// K7 (and K8, K10, P1, P3): one thread per row, one warp per slice, half
// a group (16 slices) a block, so that the L1 serves the gathers of
// neighbouring warps; kUnroll slots' loads in flight; up to NR columns of x
// per value read.  What bounds it on the card is the x gathers, not the
// layout's bytes: a warp's 32 rows read 32 unrelated columns, about a
// 32-byte sector each, and at k = 4 K7 takes 3.6× its k = 1 time for 1.45×
// the bytes (chip_smoke.py W5).  The layout is loaded evict-first so that
// the caches keep x.
//
// K10 is K7's kernel over K7's layout with x and y in the stacked layout
// (the Stacked row map): internal row r = x0 + col of column c lies at
// ((r >> 10)·nrhs + c)·1024 + (r & 1023), and each output row from the row
// map is written at the same index.  A group's k columns are one
// contiguous k·4 KB window, so a gather's k columns fall in one window
// rather than k windows nt·4 KB apart; whether that helps the gathers is
// what the smoke's E6 measures (on the TPU it lost: each column still
// needed its own vreg gather).
//
// K9: the card's form of the TPU kernel's windowed DMA.  One block of 1024
// threads per output group; the group's entries are split into stages, one
// per run of planes with one window start (a bucket of `span` groups), and
// each stage's window of x (at most 16 groups, 64 KB, a column at the
// default span; a wider run is cut into parts of 28 groups) is copied into
// shared memory by one cp.async.bulk on an mbarrier, two buffers deep,
// while the block sums the stage before it; the gathers then read shared
// memory.  Columns are staged one after another.  At span 16 the two
// buffers take 128 KB, one block an SM, and the copies move each stage's
// whole window through the L2: about 28 times the bytes of x a product at
// thermal2 scale.
//
// -- The slot planes (the plane walks the row layouts replace) ---------------
// These differ in how a plane finds its output group og and its window
// start ga, and in layout:
//   plane walk (K7's walk)    og = p_og[p], ga = p_ga[p]        (plane order)
//   plane walk (K8's, P1's)   og, ga unpacked from packed[p]     (class-major)
//   plane walk (K9's walk)    og = outg[t], ga = g0[t] + pgo[p]  (virtual tiles)
//   plane walk (K10's first)  K7's walk; x and y stacked: column c, row j
//                             of group g at x[(g·nrhs + c)·8 + j][m]
//   plane walk (P3's)         K7's walk over (P, 4, 8, 128) half-block
//                             planes; lc bits 0-13 the offset, bit 14
//                             the half of the 8 rows the block fills
// For each plane p, lane l, row i and column c:
//   lc = lc[p, 0, l];  g = ga + lc / 128;  m = lc % 128
//   Y[c, og, i, l] += sum_j values[p, i, j, l] * X[c, g, j, m]
//
// On the TPU the grid runs in order on one core and carries Y in VMEM from
// step to step.  Here one block owns one output group (128 lanes × 8 rows ×
// up to NR columns) and walks that group's planes in the order the TPU grid
// visits them, from per-group ranges built once on the host side
// (cgx_torch/sparse/wbell.py: group_walk), rounding as the row kernels do.
// The plane walks of K7's, K8's, K9's, P1's and P3's order stay as the row
// kernels' same-run "before" (chip_smoke.py W5, E6); no user-facing path
// launches them.
//
// The planes' floor is bytes: they stream once (65 words per lane per
// plane, fill included); x stays in the L2.  A warp reads one (i, j) row of
// a plane as 32 consecutive floats; the 8 operands of a block sit 128
// floats apart and neighbouring lanes read unrelated columns, so the x
// reads are gathers that hit the L2.
//
// K10's first design is the plane walk with the column index moved inside
// the group index: one lc load per plane and lane serves every column of
// the block's chunk.  It streams the planes, 17.5× the nonzeros.
//
// P3's plane walk stores 4×8 half-blocks: plane p holds, per lane, the top
// or the bottom four rows of the lane's 8-row block row (bit 14 of lc).
// The thread of each half of the rows adds a plane's block at its lane only
// where the lane's half bit names its half: a plane's 4×8 product is summed
// on its own (j in order, from 0) and then added to the accumulator, as the
// prototype does.  Fewer stored zeros (fill) buy more planes and half the
// threads idle per plane.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;  // 128 lanes × 2 halves of the 8 rows
constexpr int kRows = 4;       // rows i per thread

__device__ __forceinline__ float load_value(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_value(const __nv_bfloat16* p) {
  return __bfloat162float(*p);  // bf16 planes: upcast in registers
}

// Where the (8, 128) tile of column c, group g starts in x and y.
struct Batched {  // (nrhs, nt, 8, 128)
  __device__ static long long at(int c, long long g, int nt, int nrhs) {
    return (static_cast<long long>(c) * nt + g) * 1024;
  }
};
struct Stacked {  // (nt, nrhs·8, 128): a group's columns side by side
  __device__ static long long at(int c, long long g, int nt, int nrhs) {
    return (g * nrhs + c) * 1024;
  }
};

// Loads the 8 rows j of x at (group g, lane m) for columns c0 .. c0+NR-1
// (0 for columns >= nrhs).
template <int NR, typename L>
__device__ __forceinline__ void load_x(const float* __restrict__ x,
                                       long long g, int m, int nt, int nrhs,
                                       int c0, float (&xv)[NR][8]) {
#pragma unroll
  for (int c = 0; c < NR; ++c) {
    if (c0 + c < nrhs) {
      const float* xp = x + L::at(c0 + c, g, nt, nrhs) + m;
#pragma unroll
      for (int j = 0; j < 8; ++j) xv[c][j] = __ldg(xp + j * 128);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) xv[c][j] = 0.0f;
    }
  }
}

// Adds plane p (window start group ga) to this thread's accumulators:
// columns c0 .. c0+NR-1 (those < nrhs), rows i0 .. i0+kRows-1, one lane.
template <typename V, int NR, typename L>
__device__ __forceinline__ void add_plane(
    const V* __restrict__ values, const int* __restrict__ lc, long long p,
    int ga, const float* __restrict__ x, int nt, int nrhs, int c0, int lane,
    int i0, float (&acc)[NR][kRows]) {
  const int l = __ldg(lc + p * 128 + lane);
  const long long g = static_cast<long long>(ga) + (l >> 7);
  float xv[NR][8];
  load_x<NR, L>(x, g, l & 127, nt, nrhs, c0, xv);
  // 64-bit plane offsets: P·8192 passes 2^31 near 10 M rows.
  const V* vp = values + (p * 64 + i0 * 8) * 128 + lane;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float v = load_value(vp + (r * 8 + j) * 128);
#pragma unroll
      for (int c = 0; c < NR; ++c)
        acc[c][r] = __fadd_rn(acc[c][r], __fmul_rn(v, xv[c][j]));
    }
  }
}

template <int NR, typename L>
__device__ __forceinline__ void store_group(float* __restrict__ y, int g,
                                            int nt, int nrhs, int c0,
                                            int lane, int i0,
                                            const float (&acc)[NR][kRows]) {
#pragma unroll
  for (int c = 0; c < NR; ++c) {
    if (c0 + c >= nrhs) continue;
    float* yp = y + L::at(c0 + c, g, nt, nrhs) + i0 * 128 + lane;
#pragma unroll
    for (int r = 0; r < kRows; ++r) yp[r * 128] = acc[c][r];
  }
}

// The plane walks of K7, K8, K10 and P1: the planes of group g are
// order[ptr[g] .. ptr[g+1]); GaOf reads a plane's window start (K7's and
// K10's walk from p_ga, K8's and P1's from the low half of packed); L is
// the layout of x and y (K10's stacked, else batched).
struct GaFromArray {
  const int* ga;
  __device__ int operator()(int p) const { return __ldg(ga + p); }
};
struct GaFromPacked {
  const int* packed;
  __device__ int operator()(int p) const { return __ldg(packed + p) & 0xFFFF; }
};

template <typename V, int NR, typename GaOf, typename L>
__global__ void __launch_bounds__(kThreads)
    wbell_resident_kernel(const V* __restrict__ values,
                          const int* __restrict__ lc,
                          const int* __restrict__ order,
                          const int* __restrict__ ptr, GaOf ga_of,
                          const float* __restrict__ x, float* __restrict__ y,
                          int nt, int nrhs) {
  const int g = blockIdx.x;
  const int c0 = blockIdx.y * NR;
  const int lane = threadIdx.x & 127;
  const int i0 = (threadIdx.x >> 7) * kRows;
  float acc[NR][kRows] = {};
  const int s1 = ptr[g + 1];
  for (int s = ptr[g]; s < s1; ++s) {
    const int p = __ldg(order + s);
    add_plane<V, NR, L>(values, lc, p, ga_of(p), x, nt, nrhs, c0, lane, i0,
                        acc);
  }
  store_group<NR, L>(y, g, nt, nrhs, c0, lane, i0, acc);
}

// K9: the virtual tiles of group g are torder[tptr[g] .. tptr[g+1]); tile t
// holds planes ps[t] .. ps[t]+wb[t]-1, window start g0[t] + pgo[p].
template <typename V, int NR>
__global__ void __launch_bounds__(kThreads)
    wbell_windowed_kernel(const V* __restrict__ values,
                          const int* __restrict__ lc,
                          const int* __restrict__ torder,
                          const int* __restrict__ tptr,
                          const int* __restrict__ ps,
                          const int* __restrict__ wb,
                          const int* __restrict__ g0,
                          const int* __restrict__ pgo,
                          const float* __restrict__ x, float* __restrict__ y,
                          int nt, int nrhs) {
  const int g = blockIdx.x;
  const int c0 = blockIdx.y * NR;
  const int lane = threadIdx.x & 127;
  const int i0 = (threadIdx.x >> 7) * kRows;
  float acc[NR][kRows] = {};
  const int s1 = tptr[g + 1];
  for (int s = tptr[g]; s < s1; ++s) {
    const int t = __ldg(torder + s);
    const int p0 = __ldg(ps + t);
    const int cnt = __ldg(wb + t);
    const int w0 = __ldg(g0 + t);
    for (int j = 0; j < cnt; ++j) {
      const int p = p0 + j;
      add_plane<V, NR, Batched>(values, lc, p, w0 + __ldg(pgo + p), x, nt,
                                nrhs, c0, lane, i0, acc);
    }
  }
  store_group<NR, Batched>(y, g, nt, nrhs, c0, lane, i0, acc);
}

// P3's plane walk: the half-block planes (P, 4, 8, 128) of group g are
// order[ptr[g] .. ptr[g+1]), window start the low half of packed[p] = og <<
// 16 | ga.  Thread half h (rows 4h .. 4h+3) adds a plane at its lane only
// where the lane's half bit (lc bit 14) is h.
template <typename V, int NR>
__global__ void __launch_bounds__(kThreads)
    wbell_half_kernel(const V* __restrict__ values,
                      const int* __restrict__ lc,
                      const int* __restrict__ order,
                      const int* __restrict__ ptr,
                      const int* __restrict__ packed,
                      const float* __restrict__ x, float* __restrict__ y,
                      int nt, int nrhs) {
  const int g = blockIdx.x;
  const int c0 = blockIdx.y * NR;
  const int lane = threadIdx.x & 127;
  const int half = threadIdx.x >> 7;
  float acc[NR][kRows] = {};
  const int s1 = ptr[g + 1];
  for (int s = ptr[g]; s < s1; ++s) {
    const long long p = __ldg(order + s);
    const int l = __ldg(lc + p * 128 + lane);
    if (((l >> 14) & 1) != half) continue;
    const int off = l & 0x3FFF;
    const long long gx =
        static_cast<long long>(__ldg(packed + p) & 0xFFFF) + (off >> 7);
    float xv[NR][8];
    load_x<NR, Batched>(x, gx, off & 127, nt, nrhs, c0, xv);
    const V* vp = values + p * 32 * 128 + lane;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float part[NR] = {};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float v = load_value(vp + (r * 8 + j) * 128);
#pragma unroll
        for (int c = 0; c < NR; ++c)
          part[c] = __fadd_rn(part[c], __fmul_rn(v, xv[c][j]));
      }
#pragma unroll
      for (int c = 0; c < NR; ++c) acc[c][r] = __fadd_rn(acc[c][r], part[c]);
    }
  }
  store_group<NR, Batched>(y, g, nt, nrhs, c0, lane, half * kRows, acc);
}

// -- K7 and K9 over the row layout ------------------------------------------

constexpr int kSlice = 32;        // rows of a slice: one warp
constexpr int kRowThreads = 512;  // K7: 16 slices (half a group) a block
constexpr int kGroupRows = 1024;  // K9: one block per group, a row a thread
constexpr int kUnroll = 4;        // slots whose loads are in flight at once
constexpr int kBarBytes = 128;    // K9: two mbarriers, padded to 128 bytes

// The row layout streams once per product: loaded evict-first (__ldcs), so
// that the L1 and the L2 keep x for the gathers.
__device__ __forceinline__ float stream_value(const float* p) {
  return __ldcs(p);
}
__device__ __forceinline__ float stream_value(const __nv_bfloat16* p) {
  return __bfloat162float(__ldcs(p));
}
__device__ __forceinline__ int stream_col(const int* p) { return __ldcs(p); }
__device__ __forceinline__ int stream_col(const unsigned short* p) {
  return __ldcs(p);
}

// This lane's segment flags of slots t .. t+31 (bit s: slot t + s), from
// the slot-major flag words fp[t + i] (bit e: lane e): one coalesced load
// of 32 words and a 32×32 bit transpose across the warp, so that no slot
// costs a load of its own.  Every lane of the warp must call it.
__device__ __forceinline__ unsigned lane_flags(
    const unsigned* __restrict__ fp, int t, int w, int lane) {
  unsigned x = t + lane < w ? __ldcs(fp + t + lane) : 0u;
#pragma unroll
  for (int j = 16; j > 0; j >>= 1) {
    // Columns c with (c & j) != 0: 0xFFFF0000, 0xFF00FF00, ... 0xAAAAAAAA.
    const unsigned m = j == 16  ? 0xFFFF0000u
                       : j == 8 ? 0xFF00FF00u
                       : j == 4 ? 0xF0F0F0F0u
                       : j == 2 ? 0xCCCCCCCCu
                                : 0xAAAAAAAAu;
    const unsigned other = __shfl_xor_sync(0xFFFFFFFFu, x, j);
    x = (lane & j) ? (x & m) | ((other & m) >> j)
                   : (x & ~m) | ((other & ~m) << j);
  }
  return x;
}

// Adds slots [t0, min(t0 + kUnroll, w)) of this lane's row, in order, to
// acc; x operands from xv (global or shared) at xv[col] (column k at
// xv[k·cstride + col]; L = Stacked: internal row r = xbase + col of column
// k at xv[Stacked::at(k, r >> 10, 0, nrhs) + (r & 1023)], xv at column 0
// of the chunk).  The loads of the kUnroll slots are issued before the
// first sum.  kSeg (P3's segmented layout): bit u of `cont` flags slot t0
// + u as continuing its segment; each product goes to the segment sum
// part, and an unflagged slot first adds part to acc and restarts it from
// 0.
template <typename V, typename C, int NR, bool kGlobal, bool kSeg = false,
          typename L = Batched>
__device__ __forceinline__ void add_slots(const V* __restrict__ vp,
                                          const C* __restrict__ cp, int t0,
                                          int w, const float* __restrict__ xv,
                                          long long cstride, int ncol,
                                          float (&acc)[NR],
                                          float (&part)[NR],
                                          unsigned cont = 0, int xbase = 0,
                                          int nrhs = 0) {
  float v[kUnroll];
  int c[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    if (t0 + u < w) {
      v[u] = stream_value(vp + (t0 + u) * kSlice);
      c[u] = stream_col(cp + (t0 + u) * kSlice);
    }
  }
  float xs[kUnroll][NR];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
    for (int k = 0; k < NR; ++k) {
      xs[u][k] = 0.0f;
      if (t0 + u < w && k < ncol) {
        if constexpr (kGlobal && std::is_same_v<L, Stacked>) {
          const int r = xbase + c[u];
          xs[u][k] = __ldg(xv + Stacked::at(k, r >> 10, 0, nrhs) +
                           (r & 1023));
        } else if constexpr (kGlobal) {
          xs[u][k] = __ldg(xv + k * cstride + c[u]);
        } else {
          xs[u][k] = xv[c[u]];
        }
      }
    }
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    if (t0 + u < w) {
      if constexpr (kSeg) {
        if (!((cont >> u) & 1u)) {
#pragma unroll
          for (int k = 0; k < NR; ++k) {
            acc[k] = __fadd_rn(acc[k], part[k]);
            part[k] = 0.0f;
          }
        }
#pragma unroll
        for (int k = 0; k < NR; ++k)
          part[k] = __fadd_rn(part[k], __fmul_rn(v[u], xs[u][k]));
      } else {
#pragma unroll
        for (int k = 0; k < NR; ++k)
          acc[k] = __fadd_rn(acc[k], __fmul_rn(v[u], xs[u][k]));
      }
    }
  }
}

// K7, K8, P1, (kSeg) P3 and (L = Stacked) K10: slice k = 16·blockIdx.x +
// warp holds slots sbase[k] .. sbase[k+1] (width w = that / 32) of group
// k / 32, whose columns count from x0[k / 32]; lane e's row is rowmap[32·k
// + e]; columns c0 .. c0+NR-1 of x (those < nrhs).  C is unsigned short
// (16-bit offsets) or int (x0 = 0); with kSeg, flags[sbase[k] / 32 + t]
// holds slot t's segment flags, one bit a lane (lane_flags reads 32 slots'
// at a time).  L is the layout of x and y: Batched (nrhs, nrows) or
// Stacked (nt, nrhs·8, 128), where internal row r of column c lies at
// Stacked::at(c, r >> 10, nt, nrhs) + (r & 1023).
template <typename V, typename C, int NR, bool kSeg, typename L = Batched>
__global__ void __launch_bounds__(kRowThreads)
    wbell_rows_kernel(const V* __restrict__ values,
                      const C* __restrict__ cols,
                      const unsigned* __restrict__ flags,
                      const long long* __restrict__ sbase,
                      const int* __restrict__ rowmap,
                      const int* __restrict__ x0,
                      const float* __restrict__ x, float* __restrict__ y,
                      int nslices, long long nrows, int nrhs) {
  const int k = blockIdx.x * (kRowThreads / kSlice) + (threadIdx.x >> 5);
  if (k >= nslices) return;
  const int lane = threadIdx.x & 31;
  const int c0 = blockIdx.y * NR;
  const int ncol = min(NR, nrhs - c0);
  const long long b = sbase[k];
  const int w = static_cast<int>((sbase[k + 1] - b) / kSlice);
  const V* vp = values + b + lane;
  const C* cp = cols + b + lane;
  constexpr bool kStacked = std::is_same_v<L, Stacked>;
  const int xb = x0[k / kSlice];
  const float* xc = kStacked ? x + c0 * kGroupRows : x + c0 * nrows + xb;
  float acc[NR] = {};
  float part[NR] = {};
  unsigned fl = 0;
  for (int t = 0; t < w; t += kUnroll) {
    if constexpr (kSeg) {
      if ((t & (kSlice - 1)) == 0) fl = lane_flags(flags + b / kSlice, t, w,
                                                   lane);
    }
    add_slots<V, C, NR, true, kSeg, L>(vp, cp, t, w, xc, nrows, ncol, acc,
                                       part, fl >> (t & (kSlice - 1)), xb,
                                       nrhs);
  }
  if constexpr (kSeg) {
#pragma unroll
    for (int c = 0; c < NR; ++c) acc[c] = __fadd_rn(acc[c], part[c]);
  }
  const long long row = rowmap[static_cast<long long>(k) * kSlice + lane];
#pragma unroll
  for (int c = 0; c < NR; ++c) {
    if (c < ncol) {
      if constexpr (kStacked) {
        y[Stacked::at(c0 + c, row >> 10, 0, nrhs) + (row & 1023)] = acc[c];
      } else {
        y[(c0 + c) * nrows + row] = acc[c];
      }
    }
  }
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, int parity) {
  unsigned ok;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return ok != 0;
}

// One thread: expect `bytes` on `bar` and copy them from global src to
// shared dst (both 16-byte aligned, bytes a multiple of 16).
__device__ __forceinline__ void bulk_load(float* dst, const float* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// K9: group g = blockIdx.x has stages sptr[g] .. sptr[g+1]; stage st's
// window is x[x0[st] .. x0[st] + xlen[st]) of each column, and its slice
// for warp w is 32·st + w.  Step q = (stage s, column c), stage-major, uses
// buffer q & 1 for the (q >> 1)-th time.
template <typename V, int NR>
__global__ void __launch_bounds__(kGroupRows)
    wbell_rows_windowed_kernel(const V* __restrict__ values,
                               const unsigned short* __restrict__ offs,
                               const long long* __restrict__ sbase,
                               const int* __restrict__ rowmap,
                               const int* __restrict__ sptr,
                               const int* __restrict__ x0,
                               const int* __restrict__ xlen,
                               const float* __restrict__ x,
                               float* __restrict__ y, long long nrows,
                               int nrhs, int window) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* buf = reinterpret_cast<float*>(smem + kBarBytes);
  const int g = blockIdx.x;
  const int c0 = blockIdx.y * NR;
  const int ncol = min(NR, nrhs - c0);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int st0 = sptr[g];
  const int nst = sptr[g + 1] - st0;
  const int nq = nst * ncol;
  const float* xc = x + c0 * nrows;
  auto issue = [&](int q) {
    const int st = st0 + q / ncol;
    const int c = q - (q / ncol) * ncol;
    bulk_load(buf + (q & 1) * window, xc + c * nrows + x0[st],
              static_cast<unsigned>(xlen[st]) * 4u, bar + (q & 1));
  };
  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_init(bar + 1, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (nq > 0) issue(0);
    if (nq > 1) issue(1);
  }
  __syncthreads();
  float acc[NR] = {};
  for (int s = 0; s < nst; ++s) {
    const long long k = static_cast<long long>(st0 + s) * kSlice + warp;
    const long long b = sbase[k];
    const int w = static_cast<int>((sbase[k + 1] - b) / kSlice);
    const V* vp = values + b + lane;
    const unsigned short* op = offs + b + lane;
#pragma unroll
    for (int c = 0; c < NR; ++c) {
      if (c < ncol) {
        const int q = s * ncol + c;
        while (!mbar_try_wait(bar + (q & 1), (q >> 1) & 1)) {
        }
        const float* xs = buf + (q & 1) * window;
        float one[1] = {acc[c]};
        float unused[1] = {};
        for (int t = 0; t < w; t += kUnroll)
          add_slots<V, unsigned short, 1, false>(vp, op, t, w, xs, 0, 1,
                                                 one, unused);
        acc[c] = one[0];
        __syncthreads();  // every warp is done with buffer q & 1
        if (tid == 0 && q + 2 < nq) {
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          issue(q + 2);
        }
      }
    }
  }
  const long long row = rowmap[static_cast<long long>(g) * kGroupRows + tid];
#pragma unroll
  for (int c = 0; c < NR; ++c)
    if (c < ncol) y[(c0 + c) * nrows + row] = acc[c];
}

template <typename T>
struct Tag {
  using type = T;
};

// Calls f(Tag<V>, integral_constant<NR>) for the plane type and the
// column-chunk width NR (1, 2, 4 or 8; nrhs > 8 runs in chunks of 8 along
// the grid's y dimension).
template <typename F>
int with_types(int bf16, int nrhs, F f) {
  const int nr = nrhs <= 1 ? 1 : nrhs <= 2 ? 2 : nrhs <= 4 ? 4 : 8;
  if (bf16) {
    switch (nr) {
      case 1: return f(Tag<__nv_bfloat16>{}, std::integral_constant<int, 1>{});
      case 2: return f(Tag<__nv_bfloat16>{}, std::integral_constant<int, 2>{});
      case 4: return f(Tag<__nv_bfloat16>{}, std::integral_constant<int, 4>{});
      default: return f(Tag<__nv_bfloat16>{}, std::integral_constant<int, 8>{});
    }
  }
  switch (nr) {
    case 1: return f(Tag<float>{}, std::integral_constant<int, 1>{});
    case 2: return f(Tag<float>{}, std::integral_constant<int, 2>{});
    case 4: return f(Tag<float>{}, std::integral_constant<int, 4>{});
    default: return f(Tag<float>{}, std::integral_constant<int, 8>{});
  }
}

bool bad_shape(int nt, int nrhs) {
  return nt < 1 || nrhs < 1 || (nrhs + 7) / 8 > 65535;
}

}  // namespace

// Each entry launches on `stream` and returns cudaGetLastError() after the
// launch.  `values` is fp32, or bf16 when `bf16` is 1; x and y are fp32.

// The plane walk in K7's order (K7's "before"): planes of each group from
// (order, ptr), window starts from p_ga.
extern "C" int cgx_wbell_resident(const void* values, int bf16,
                                  const int* lc, const int* order,
                                  const int* ptr, const int* p_ga,
                                  const float* x, float* y, int nt, int nrhs,
                                  void* stream) {
  if (bad_shape(nt, nrhs)) return cudaErrorInvalidValue;
  return with_types(bf16, nrhs, [&](auto vt, auto nrt) {
    using V = typename decltype(vt)::type;
    constexpr int NR = decltype(nrt)::value;
    const dim3 grid(nt, (nrhs + NR - 1) / NR);
    wbell_resident_kernel<V, NR, GaFromArray, Batched>
        <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const V*>(values), lc, order, ptr, GaFromArray{p_ga},
            x, y, nt, nrhs);
    return static_cast<int>(cudaGetLastError());
  });
}

// The plane walk in K7's order on the stacked layout, x and y (nt, nrhs·8,
// 128): K10's first design (its "before").
extern "C" int cgx_wbell_stacked(const void* values, int bf16, const int* lc,
                                 const int* order, const int* ptr,
                                 const int* p_ga, const float* x, float* y,
                                 int nt, int nrhs, void* stream) {
  if (bad_shape(nt, nrhs)) return cudaErrorInvalidValue;
  return with_types(bf16, nrhs, [&](auto vt, auto nrt) {
    using V = typename decltype(vt)::type;
    constexpr int NR = decltype(nrt)::value;
    const dim3 grid(nt, (nrhs + NR - 1) / NR);
    wbell_resident_kernel<V, NR, GaFromArray, Stacked>
        <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const V*>(values), lc, order, ptr, GaFromArray{p_ga},
            x, y, nt, nrhs);
    return static_cast<int>(cudaGetLastError());
  });
}

// The plane walk of K8 and P1 (their "before"): a tier plan's planes of
// each group from (order, ptr), class-major; window starts from packed =
// og << 16 | ga.
extern "C" int cgx_wbell_tiered(const void* values, int bf16, const int* lc,
                                const int* order, const int* ptr,
                                const int* packed, const float* x, float* y,
                                int nt, int nrhs, void* stream) {
  if (bad_shape(nt, nrhs)) return cudaErrorInvalidValue;
  return with_types(bf16, nrhs, [&](auto vt, auto nrt) {
    using V = typename decltype(vt)::type;
    constexpr int NR = decltype(nrt)::value;
    const dim3 grid(nt, (nrhs + NR - 1) / NR);
    wbell_resident_kernel<V, NR, GaFromPacked, Batched>
        <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const V*>(values), lc, order, ptr,
            GaFromPacked{packed}, x, y, nt, nrhs);
    return static_cast<int>(cudaGetLastError());
  });
}

// The plane walk in K9's order (K9's "before"): the virtual tiles of each
// group from (torder, tptr).
extern "C" int cgx_wbell_windowed(const void* values, int bf16,
                                  const int* lc, const int* torder,
                                  const int* tptr, const int* ps,
                                  const int* wb, const int* g0,
                                  const int* pgo, const float* x, float* y,
                                  int nt, int nrhs, void* stream) {
  if (bad_shape(nt, nrhs)) return cudaErrorInvalidValue;
  return with_types(bf16, nrhs, [&](auto vt, auto nrt) {
    using V = typename decltype(vt)::type;
    constexpr int NR = decltype(nrt)::value;
    const dim3 grid(nt, (nrhs + NR - 1) / NR);
    wbell_windowed_kernel<V, NR>
        <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const V*>(values), lc, torder, tptr, ps, wb, g0, pgo,
            x, y, nt, nrhs);
    return static_cast<int>(cudaGetLastError());
  });
}

// The plane walk of P3 (its "before"): half-block planes (P, 4, 8, 128) of
// each group from (order, ptr), window starts from packed = og << 16 | ga,
// the half in lc bit 14.
extern "C" int cgx_wbell_half(const void* values, int bf16, const int* lc,
                              const int* order, const int* ptr,
                              const int* packed, const float* x, float* y,
                              int nt, int nrhs, void* stream) {
  if (bad_shape(nt, nrhs)) return cudaErrorInvalidValue;
  return with_types(bf16, nrhs, [&](auto vt, auto nrt) {
    using V = typename decltype(vt)::type;
    constexpr int NR = decltype(nrt)::value;
    const dim3 grid(nt, (nrhs + NR - 1) / NR);
    wbell_half_kernel<V, NR>
        <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const V*>(values), lc, order, ptr, packed, x, y, nt,
            nrhs);
    return static_cast<int>(cudaGetLastError());
  });
}

// K7, K8, P1 and P3: the row layout; slices 32·nt; columns 16-bit offsets
// from x0 of their group, or int32 indices when `wide` is 1; `flags` is
// P3's segment flags (one 32-bit word a slice and slot), null for the
// other layouts.
extern "C" int cgx_wbell_rows(const void* values, int bf16, const void* cols,
                              int wide, const unsigned* flags,
                              const long long* sbase, const int* rowmap,
                              const int* x0, const float* x, float* y, int nt,
                              int nrhs, void* stream) {
  if (bad_shape(nt, nrhs)) return cudaErrorInvalidValue;
  const int nslices = nt * kSlice;
  const long long nrows = static_cast<long long>(nt) * kGroupRows;
  return with_types(bf16, nrhs, [&](auto vt, auto nrt) {
    using V = typename decltype(vt)::type;
    constexpr int NR = decltype(nrt)::value;
    const int per_block = kRowThreads / kSlice;
    const dim3 grid((nslices + per_block - 1) / per_block,
                    (nrhs + NR - 1) / NR);
    const auto st = static_cast<cudaStream_t>(stream);
    auto launch = [&](auto ct, auto seg) {
      using C = typename decltype(ct)::type;
      wbell_rows_kernel<V, C, NR, decltype(seg)::value>
          <<<grid, kRowThreads, 0, st>>>(
              static_cast<const V*>(values), static_cast<const C*>(cols),
              flags, sbase, rowmap, x0, x, y, nslices, nrows, nrhs);
    };
    if (wide && flags) {
      launch(Tag<int>{}, std::true_type{});
    } else if (wide) {
      launch(Tag<int>{}, std::false_type{});
    } else if (flags) {
      launch(Tag<unsigned short>{}, std::true_type{});
    } else {
      launch(Tag<unsigned short>{}, std::false_type{});
    }
    return static_cast<int>(cudaGetLastError());
  });
}

// K10: K7's row layout (16-bit columns from x0 of their group, or int32
// indices when `wide` is 1) with x and y in the stacked layout (nt,
// nrhs·8, 128).
extern "C" int cgx_wbell_rows_stacked(const void* values, int bf16,
                                      const void* cols, int wide,
                                      const long long* sbase,
                                      const int* rowmap, const int* x0,
                                      const float* x, float* y, int nt,
                                      int nrhs, void* stream) {
  if (bad_shape(nt, nrhs)) return cudaErrorInvalidValue;
  const int nslices = nt * kSlice;
  const long long nrows = static_cast<long long>(nt) * kGroupRows;
  return with_types(bf16, nrhs, [&](auto vt, auto nrt) {
    using V = typename decltype(vt)::type;
    constexpr int NR = decltype(nrt)::value;
    const int per_block = kRowThreads / kSlice;
    const dim3 grid((nslices + per_block - 1) / per_block,
                    (nrhs + NR - 1) / NR);
    const auto st = static_cast<cudaStream_t>(stream);
    auto launch = [&](auto ct) {
      using C = typename decltype(ct)::type;
      wbell_rows_kernel<V, C, NR, false, Stacked>
          <<<grid, kRowThreads, 0, st>>>(
              static_cast<const V*>(values), static_cast<const C*>(cols),
              nullptr, sbase, rowmap, x0, x, y, nslices, nrows, nrhs);
    };
    if (wide) {
      launch(Tag<int>{});
    } else {
      launch(Tag<unsigned short>{});
    }
    return static_cast<int>(cudaGetLastError());
  });
}

// K9: the windowed row layout, 16-bit columns from each stage's window
// start; `window` is the widest stage window (floats), which sets the two
// shared-memory buffers.  The layout cuts its stages to 28 groups of x
// (STAGE_WINDOW_GROUPS), which fit; a wider window is refused with
// cudaFuncSetAttribute's error.  x must be 16-byte aligned.
extern "C" int cgx_wbell_rows_windowed(const void* values, int bf16,
                                       const unsigned short* offs,
                                       const long long* sbase,
                                       const int* rowmap, const int* sptr,
                                       const int* x0, const int* xlen,
                                       const float* x, float* y, int nt,
                                       int nrhs, int window, void* stream) {
  if (bad_shape(nt, nrhs) || window < 0) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(x) % 16) return cudaErrorInvalidValue;
  const int stride = (window + 31) / 32 * 32;  // 128-byte aligned buffers
  const size_t smem = kBarBytes + 2 * static_cast<size_t>(stride) * 4;
  const long long nrows = static_cast<long long>(nt) * kGroupRows;
  return with_types(bf16, nrhs, [&](auto vt, auto nrt) {
    using V = typename decltype(vt)::type;
    constexpr int NR = decltype(nrt)::value;
    auto kernel = wbell_rows_windowed_kernel<V, NR>;
    cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (rc != cudaSuccess) {
      cudaGetLastError();  // not sticky: leave no error for the next launch
      return static_cast<int>(rc);
    }
    const dim3 grid(nt, (nrhs + NR - 1) / NR);
    kernel<<<grid, kGroupRows, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const V*>(values), offs, sbase, rowmap, sptr, x0, xlen, x,
        y, nrows, nrhs, stride);
    return static_cast<int>(cudaGetLastError());
  });
}
