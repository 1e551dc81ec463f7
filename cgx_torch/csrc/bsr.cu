// K11, K12 and P2: the block-ELL SpMM Y = A·X.  A has nbr block rows of
// wb dense (bs, bs) blocks each (values (nbr, wb, bs, bs), block columns
// cols (nbr, wb) int32; a padding block is all zero and points at block
// column 0); X is (nbc·bs, k) row-major and Y (nbr·bs, k) row-major fp32:
//   Y[i·bs + r, c] = sum_j sum_q values[i, j, r, q] · X[cols[i, j]·bs + q, c]
//
// Replaces both Pallas kernels of cgx/kernels/bsr.py: _bell_spmm_dma (:93)
// and _bell_spmm_resident (:151).  They compute the same Y and differ only
// in where X sits in the TPU's VMEM (fetched by DMA per (row, slot) grid
// step, or pinned whole); the card has no such choice to make, so one
// kernel serves the engines "auto", "resident" and "dma".  K12
// (_bell_spmm_prefetch, :215) computes the same Y too, in chunks of 256
// block rows that the TPU's SMEM id table forces; its entry point
// (cgx_torch/kernels/bsr.py) launches this kernel once per chunk at pointer
// offsets into values, cols and Y, and has no device code of its own.
//
// P2 (experiments/bell_pair_proto.py:16, the paired-slot prototype) is this
// kernel with two slots staged per shared-memory round (S = 2): a (bs, 2bs)
// value tile and a (2bs, KT) tile of X, so half the barriers and loop trips
// per block row.  The contraction runs over slot j's q, then slot j+1's, with
// the same fused multiply-add per term as K11 (S = 1), so its Y equals K11's
// bit for bit.  It needs an even wb.  Like K11 it is bound by its fp32
// operations; the doubled tiles cost shared memory and registers, so fewer
// blocks stay resident per SM than K11's.
//
// On the TPU the grid (nbr, wb) runs in order and revisits the output block
// across the wb slots, accumulating in place.  Here one CUDA block owns one
// block row and one column tile of KT columns (grid (nbr, ceil(k / KT))),
// reads its own row of block columns, and walks the wb slots in slot order:
// for each slot it stages the (bs, bs) value block and the (bs, KT) tile of
// X in shared memory (bf16 widened to fp32 on the load) and adds the
// block's product into fp32 registers, the contraction q in index order.
// It writes its Y tile once: no atomics, and two runs are bitwise equal.
// A ragged k is masked (the tile's dead columns read 0 and are not stored).
//
// What bounds it: at the records' block-dense size (512 block rows, bs 64,
// wb 8, k 256, fp32) the operations, 8.6 GFLOP against 134 MB: exact fp32
// has no tensor-core path, so 67 TFLOP/s on the CUDA cores is the floor.
// With bf16 operands the tensor cores could take the products and the
// bytes bound it.  This first version is simple: every product is an FMA
// on the CUDA cores from shared memory, one column per thread and up to 32
// rows in registers, so each staged X value is reused across the thread's
// rows and each value read is a broadcast across the warp.  The value
// block's rows are padded to bs + 1 words so that threads of one warp that
// own different rows (small KT) read different banks.  Tensor cores
// (mma.sync on bf16, wgmma with TMA) and cp.async double-buffering of the
// slot loads are for a later version.
//
// Shared memory: bs (S bs + 1) + S bs KT fp32 words, dynamic and sized to
// the call: 320 B at bs 8 and k 1, 33 KB at bs 64 and k >= 64, 97 KB at bs
// 128; with S = 2, 66 KB at bs 64 and 197 KB at bs 128 (allowed above the 48
// KB default with cudaFuncSetAttribute, within the 227 KB a block may use).  A static
// array sized for bs 64 would hold an SM to 6 resident blocks whatever bs
// is, which starves the 32-thread blocks of bs 8 and k 1.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kTileMax = 64;    // the column tile KT, at most
constexpr int kMaxBs = 128;
constexpr int kDefaultSmem = 48 * 1024;  // above this, opt in per kernel

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// RPT: rows of the tile per thread (a power of two >= bs / (threads / KT));
// S: slots staged per shared-memory round (1 for K11, 2 for P2).
template <typename T, int RPT, int S>
__global__ void __launch_bounds__(kMaxThreads)
    bell_spmm_kernel(const T* __restrict__ values,
                     const int* __restrict__ cols, const T* __restrict__ x,
                     float* __restrict__ y, int wb, int bs, int k, int kt) {
  extern __shared__ float sv[];
  const int ldv = S * bs + 1;
  float* sx = sv + bs * ldv;

  const long long i = blockIdx.x;  // block row
  const int c0 = blockIdx.y * kt;
  const int t = threadIdx.x;
  const int nthreads = blockDim.x;
  const int c = t % kt;            // this thread's column of the tile
  const int rg = t / kt;           // its first row
  const int stride = nthreads / kt;
  const int kc = min(kt, k - c0);  // live columns of this tile

  float acc[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) acc[r] = 0.0f;

  const long long bsq = static_cast<long long>(bs) * bs;
  for (int j = 0; j < wb; j += S) {
    __syncthreads();  // the previous round's reads are done
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const long long col = __ldg(cols + i * wb + j + s);
      const T* vb = values + (i * wb + j + s) * bsq;
      const T* xb = x + col * bs * k + c0;
      // Slot s fills columns s·bs .. of the value tile and rows s·bs .. of
      // the X tile.
      for (int e = t; e < bs * bs; e += nthreads)
        sv[(e / bs) * ldv + s * bs + e % bs] = widen(vb[e]);
      for (int e = t; e < bs * kt; e += nthreads) {
        const int q = e / kt;
        const int cc = e - q * kt;
        sx[s * bs * kt + e] =
            cc < kc ? widen(xb[static_cast<long long>(q) * k + cc]) : 0.0f;
      }
    }
    __syncthreads();
    for (int q = 0; q < S * bs; ++q) {
      const float xv = sx[q * kt + c];
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const int row = rg + r * stride;
        if (row < bs) acc[r] = fmaf(sv[row * ldv + q], xv, acc[r]);
      }
    }
  }
  if (c < kc) {
    float* yb = y + i * bs * k + c0 + c;
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int row = rg + r * stride;
      if (row < bs) yb[static_cast<long long>(row) * k] = acc[r];
    }
  }
}

int pow2_at_least(int v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

template <typename T, int RPT, int S>
int launch(const void* values, const int* cols, const void* x, float* y,
           int nbr, int wb, int bs, int k, int kt, int nthreads,
           cudaStream_t stream) {
  const dim3 grid(nbr, (k + kt - 1) / kt);
  const int smem =
      (bs * (S * bs + 1) + S * bs * kt) * static_cast<int>(sizeof(float));
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        bell_spmm_kernel<T, RPT, S>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  bell_spmm_kernel<T, RPT, S><<<grid, nthreads, smem, stream>>>(
      static_cast<const T*>(values), cols, static_cast<const T*>(x), y, wb, bs,
      k, kt);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int S>
int dispatch(int rpt, const void* values, const int* cols, const void* x,
             float* y, int nbr, int wb, int bs, int k, int kt, int nthreads,
             cudaStream_t s) {
  switch (rpt) {
    case 1: return launch<T, 1, S>(values, cols, x, y, nbr, wb, bs, k, kt, nthreads, s);
    case 2: return launch<T, 2, S>(values, cols, x, y, nbr, wb, bs, k, kt, nthreads, s);
    case 4: return launch<T, 4, S>(values, cols, x, y, nbr, wb, bs, k, kt, nthreads, s);
    case 8: return launch<T, 8, S>(values, cols, x, y, nbr, wb, bs, k, kt, nthreads, s);
    case 16: return launch<T, 16, S>(values, cols, x, y, nbr, wb, bs, k, kt, nthreads, s);
    default: return launch<T, 32, S>(values, cols, x, y, nbr, wb, bs, k, kt, nthreads, s);
  }
}

// The tile and thread shape of a call, then the launch with S slots per
// round.  The column tile KT is the least power of two >= k, at most 64,
// and the block has bs·KT threads rounded up to a power of two in [32, 256].
template <int S>
int spmm(const void* values, const int* cols, const void* x, float* y,
         int nbr, int wb, int bs, int k, int bf16, void* stream) {
  if (nbr < 0 || wb < 1 || wb % S != 0 || bs < 1 || bs > kMaxBs || k < 1)
    return cudaErrorInvalidValue;
  if (nbr == 0) return cudaSuccess;
  const int kt = pow2_at_least(k < kTileMax ? k : kTileMax);
  if ((k + kt - 1) / kt > 65535) return cudaErrorInvalidValue;
  int nthreads = pow2_at_least(bs * kt);
  nthreads = nthreads < 32 ? 32 : (nthreads > kMaxThreads ? kMaxThreads : nthreads);
  const int stride = nthreads / kt;
  const int rpt = pow2_at_least((bs + stride - 1) / stride);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch<__nv_bfloat16, S>(rpt, values, cols, x, y, nbr, wb, bs,
                                      k, kt, nthreads, s);
  return dispatch<float, S>(rpt, values, cols, x, y, nbr, wb, bs, k, kt,
                            nthreads, s);
}

}  // namespace

// Each entry launches on `stream` and returns cudaGetLastError() after the
// launch.  values and x are fp32, or both bf16 when `bf16` is 1; y is fp32.

// K11 (and each chunk of K12): one slot per round.
extern "C" int cgx_bell_spmm(const void* values, const int* cols,
                             const void* x, float* y, int nbr, int wb, int bs,
                             int k, int bf16, void* stream) {
  return spmm<1>(values, cols, x, y, nbr, wb, bs, k, bf16, stream);
}

// P2: two slots per round; wb must be even.
extern "C" int cgx_bell_spmm_paired(const void* values, const int* cols,
                                    const void* x, float* y, int nbr, int wb,
                                    int bs, int k, int bf16, void* stream) {
  return spmm<2>(values, cols, x, y, nbr, wb, bs, k, bf16, stream);
}
