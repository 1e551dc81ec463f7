// K7, K8, K9, K10 and P3: the WBELL (windowed block-ELL) product Y = A·X
// over slot planes, for nrhs right-hand sides in the internal layout (nrhs,
// nt, 8, 128) or, for K10, the stacked layout (nt, nrhs·8, 128).
//
// Replaces four Pallas kernels of cgx/kernels/wbell.py and one of
// experiments/halfblock_proto.py, which compute the same Y and differ in how
// a plane finds its output group og and its window start ga, and in layout:
//   K7  _kernel_resident          og = p_og[p], ga = p_ga[p]        (plane order)
//   K8  _kernel_resident_tiers    og, ga unpacked from packed[p]     (class-major)
//   K9  _kernel                   og = outg[t], ga = g0[t] + pgo[p]  (virtual tiles)
//   K10 _kernel_resident_stacked  K7's walk; x and y stacked: column c, row j
//                                 of group g at x[(g·nrhs + c)·8 + j][m]
//   P3  _kernel_half              K7's walk over (P, 4, 8, 128) half-block
//                                 planes; lc bits 0-13 the offset, bit 14
//                                 the half of the 8 rows the block fills
// For each plane p, lane l, row i and column c:
//   lc = lc[p, 0, l];  g = ga + lc / 128;  m = lc % 128
//   Y[c, og, i, l] += sum_j values[p, i, j, l] * X[c, g, j, m]
//
// On the TPU the grid runs in order on one core and carries Y in VMEM from
// step to step.  Here one block owns one output group (128 lanes × 8 rows ×
// up to NR columns) and walks that group's planes in the order the TPU grid
// visits them, from per-group ranges built once on the host side
// (cgx_torch/sparse/wbell.py: group_walk).  No two blocks write one output,
// there are no atomics, every output (pad groups included) is written once,
// and two runs are bitwise equal.  Each product and each sum is rounded on
// its own (__fmul_rn, __fadd_rn, j in order), as the plain PyTorch version
// rounds it, so the two agree bit for bit.
//
// The floor is bytes: the slot planes (65 words per lane per plane, fill
// included) stream once; x (5 MB at thermal2 scale) stays in the L2.  A
// warp reads one (i, j) row of a plane as 32 consecutive floats; the 8
// operands of a block sit 128 floats apart and neighbouring lanes read
// unrelated columns, so the x reads are gathers that hit the L2.  This first
// version keeps everything in registers: no shared memory, no TMA.
//
// K10 is K7 with the column index moved inside the group index: the k
// columns of a group sit in one contiguous k·4 KB window, and one lc load
// per plane and lane serves every column of the block's chunk.  Whether the
// contiguous window helps the gathers is what the smoke's E6 measures (on
// the TPU it lost: each column still needed its own vreg gather).
//
// P3 stores 4×8 half-blocks: plane p holds, per lane, the top or the bottom
// four rows of the lane's 8-row block row (bit 14 of lc).  The thread of
// each half of the rows adds a plane's block at its lane only where the
// lane's half bit names its half: a plane's 4×8 product is summed on its own
// (j in order, from 0) and then added to the accumulator, as the prototype
// does, so the plain version rounds the same way.  Fewer stored zeros
// (fill) buy more planes and half the threads idle per plane.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

// K7 / K8 / K10: the planes of group g are order[ptr[g] .. ptr[g+1]); GaOf
// reads a plane's window start (K7, K10 from p_ga, K8 from the low half of
// packed); L is the layout of x and y (K10 stacked, else batched).
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

// P3: the half-block planes (P, 4, 8, 128) of group g are order[ptr[g] ..
// ptr[g+1]), window start the low half of packed[p] = og << 16 | ga.  Thread
// half h (rows 4h .. 4h+3) adds a plane at its lane only where the lane's
// half bit (lc bit 14) is h.
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

// K7: planes of each group from (order, ptr), window starts from p_ga.
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

// K10: K7's walk on the stacked layout, x and y (nt, nrhs·8, 128).
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

// K8: a tier plan's planes of each group from (order, ptr), class-major;
// window starts from packed = og << 16 | ga.
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

// K9: the virtual tiles of each group from (torder, tptr).
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

// P3: half-block planes (P, 4, 8, 128) of each group from (order, ptr),
// window starts from packed = og << 16 | ga, the half in lc bit 14.
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
