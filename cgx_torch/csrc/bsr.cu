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
// entry serves the engines "auto", "resident" and "dma".  K12
// (_bell_spmm_prefetch, :215) computes the same Y too, in chunks of 256
// block rows that the TPU's SMEM id table forces; its entry point
// (cgx_torch/kernels/bsr.py) launches this entry once per chunk at pointer
// offsets into values, cols and Y, and has no device code of its own.
//
// P2 (experiments/bell_pair_proto.py:16, the paired-slot prototype) is this
// entry with two slots staged per shared-memory round (S = 2).  Every path
// issues the terms of S = 2 in the order of S = 1, so P2 equals K11 bit for
// bit on every path.  It needs an even wb.
//
// On the TPU the grid (nbr, wb) runs in order and revisits the output block
// across the wb slots, accumulating in place.  Here a CUDA block owns one
// block row (or, on the rows path, several) and a tile of columns, reads its
// own row of block columns, and walks the wb slots in slot order.  It writes
// its Y tile once: no atomics, and two runs are bitwise equal.  A ragged k
// is masked (dead columns of a tile read 0 and are not stored).
//
// Four paths, one plan.  bell_plan (cgx_torch/kernels/bsr.py) picks the path,
// the column tile, the threads, the shared memory and the grid from (bs, k,
// dtype, whether values, x and y are 16-byte aligned), slots per round S and
// the block rows of the call; the path and tile never from nbr or wb, so
// K12's chunks and P2 take K11's path.  The entry recomputes the threads,
// the shared memory and the grid of the plan it is given and refuses a plan
// that does not match or that the shape cannot take:
//
// tiled (fp32, bs % 8 == 0, k >= 16, k % 4 == 0; B1): SGEMM-style register
//   tiles on the CUDA cores.  A block owns one block row and KT (16..128)
//   columns; each thread keeps an 8×8 patch of Y in registers (rows tr +
//   m·bs/8 for m < 8, columns 4·tc .. 4·tc + 3 and KT/2 + 4·tc .. + 3).  Per slot the value
//   block (rows padded to bs + 4 words: the float4 reads of neighbouring rows
//   fall in distinct bank quads) and the (bs, KT) tile of X are staged with
//   16-byte cp.async into one stage; the blocks resident on an SM cover each
//   other's copies.  At B1 (bs 64, KT 128, 128 threads) the stage is 49 KB,
//   4 blocks an SM; a two-stage ring (2 blocks an SM) took 1.056× the time
//   there, so the path has one.  Per 4 q a thread makes 8 float4 reads of
//   values and 8 of X for 256 FMAs, against 17 reads per 16 FMAs in the
//   general path.  The plan leaves blocks of 2 to 4 threads (bs 8 with k <=
//   32, bs 16 with k 16) to the general path, which was 1.2-2.4× faster
//   there (cgx_torch/experiments/bell_sweep.py); from 5 threads on (bs 8 at
//   k 64 has 8) the tiled path was faster at every bs and k swept.
//   Each output takes the general path's terms in its order (slots in
//   order, q ascending, one fmaf each, from 0): the two paths are equal bit
//   for bit.  TF32 is out: the JAX package's fp32 product is exact fp32.
//   Bound: the operations (67 TFLOP/s fp32 at B1).  Registers (ptxas,
//   capped at 128 so that 4 blocks of 128 threads fit): the bs 64 / KT 128
//   instance 125 with no spill at S = 1, 128 at S = 2; the run-time
//   instance 128 with 28 bytes of spill stores at S = 1, 84 at S = 2.  P2 (S = 2) at B1: 98 KB, 2 blocks an SM.
// mma (bf16, bs % 16 == 0, k % 8 == 0; B2): the products on the tensor cores
//   with mma.sync.m16n8k16 (bf16 in, fp32 accumulate), fragments read from
//   shared memory with ldmatrix (.trans for X, whose row-major (q, c) tile is
//   the .col B operand), staged with 16-byte cp.async in a two-stage ring,
//   rows padded by 8 elements so each 8×8 ldmatrix hits 8 distinct bank
//   quads.  No widening pass: bf16 goes straight to the MMA.  A warp owns all
//   bs rows and 8·NI columns (acc[bs/16][NI][4], at most 64 fp32 registers);
//   a block has up to 8 warps side by side.  Each accumulator sees the same
//   mma sequence (slots in order, q in steps of 16) whatever S and the tile:
//   P2 and K12 equal K11 bit for bit; the sum order differs from the plain
//   version's matmul (held to 1e-5 of the peak).  At B2 (bs 64, k 256) one
//   block of 8 warps takes all 256 columns: 124 registers (ptxas, no
//   spill), 84 KB, 2 blocks an SM; P2 128 registers, 168 KB, 1.  Why
//   mma.sync and not
//   wgmma with TMA: B2 is bound by bytes (17.2 GFLOP take 17 µs at 989
//   TFLOP/s against a byte bound of 50.1 µs), and mma.sync already leaves
//   the math under that bound; wgmma's warpgroup tiles and shared-memory
//   descriptors would buy nothing here.
// rows (fp32, bs <= 16, k <= 8; B3): many small block rows per block, no
//   shared memory and no barrier.  One thread owns one output row and all k
//   columns; a block of 256 threads covers 256 / bs block rows.  Per slot a
//   thread reads its row of the value block and the x block through the
//   read-only path, as float4 where bs % 4 == 0 and (k == 1 or k % 4 == 0),
//   else as scalars; the threads of one block row read the same x block,
//   which L1 serves.  q ascending, one fmaf per term, slot by slot: equal
//   to the general path bit for bit.  Bound: the bytes of the value blocks.
//   It stages nothing, so S has no meaning there.  32 registers at bs 8 and
//   k 1 (8 blocks of 256 threads an SM), 38 at k 4 (6).
// general (every other shape: bf16 with bs % 16 != 0, odd bs, fp32 k < 16
//   beyond rows' range, k not a multiple of 16 bytes, unaligned pointers):
//   the first version, unchanged.  One column per thread and up to 32 rows in
//   registers, the value block (rows padded to S·bs + 1 words) and the X
//   tile staged in shared memory with scalar loads (bf16 widened on the
//   load), two barriers per round.  Shared memory: bs (S bs + 1) + S bs KT
//   fp32 words, 33 KB at bs 64 and k >= 64, 97 KB at bs 128, 197 KB with S =
//   2 at bs 128.  Above 48 KB every path opts in with cudaFuncSetAttribute,
//   within the 227 KB a block may use.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kTileMax = 64;    // the general path's column tile, at most
constexpr int kMaxBs = 128;
constexpr int kDefaultSmem = 48 * 1024;  // above this, opt in per kernel
constexpr int kSmemMax = 232448;         // 227 KB, what a block may use
constexpr int kRowsThreads = 256;        // the rows path's block, at most

enum Path { kGeneral = 0, kTiled = 1, kMma = 2, kRows = 3 };

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// -- general ------------------------------------------------------------------

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

// Opt a kernel in to more than 48 KB of dynamic shared memory.
template <typename K>
cudaError_t allow_smem(K kernel, int smem) {
  if (smem <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

template <typename T, int RPT, int S>
int launch_general(const void* values, const int* cols, const void* x,
                   float* y, dim3 grid, int wb, int bs, int k, int kt,
                   int nthreads, int smem, cudaStream_t stream) {
  const cudaError_t err = allow_smem(bell_spmm_kernel<T, RPT, S>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  bell_spmm_kernel<T, RPT, S><<<grid, nthreads, smem, stream>>>(
      static_cast<const T*>(values), cols, static_cast<const T*>(x), y, wb, bs,
      k, kt);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int S>
int dispatch_general(int rpt, const void* values, const int* cols,
                     const void* x, float* y, dim3 grid, int wb, int bs, int k,
                     int kt, int nthreads, int smem, cudaStream_t s) {
  switch (rpt) {
    case 1: return launch_general<T, 1, S>(values, cols, x, y, grid, wb, bs, k, kt, nthreads, smem, s);
    case 2: return launch_general<T, 2, S>(values, cols, x, y, grid, wb, bs, k, kt, nthreads, smem, s);
    case 4: return launch_general<T, 4, S>(values, cols, x, y, grid, wb, bs, k, kt, nthreads, smem, s);
    case 8: return launch_general<T, 8, S>(values, cols, x, y, grid, wb, bs, k, kt, nthreads, smem, s);
    case 16: return launch_general<T, 16, S>(values, cols, x, y, grid, wb, bs, k, kt, nthreads, smem, s);
    default: return launch_general<T, 32, S>(values, cols, x, y, grid, wb, bs, k, kt, nthreads, smem, s);
  }
}

// -- cp.async, ldmatrix and mma.sync --------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, bypassing L1; zeros where !live.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(live ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// d += a·b for a 16×16 bf16 A fragment, a 16×8 bf16 B fragment, fp32 d.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Walk `rounds` rounds of S slots through a ring of NST stages (1 for the
// tiled path, 2 for mma): stage(rd, st) issues round rd's cp.async copies
// into stage st, and compute(st) multiplies the stage.  With two stages
// round rd + 1 loads while round rd is multiplied; one barrier per round.
template <int NST, typename Stage, typename Compute>
__device__ __forceinline__ void ring(int rounds, Stage stage,
                                     Compute compute) {
  if constexpr (NST == 1) {
    for (int rd = 0; rd < rounds; ++rd) {
      __syncthreads();  // the previous round's reads are done
      stage(rd, 0);
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
      compute(0);
    }
  } else {
    stage(0, 0);
    cp_async_commit();
    for (int rd = 0; rd < rounds; ++rd) {
      cp_async_wait_all();  // round rd has landed (this thread's copies)
      __syncthreads();      // everyone's, and round rd - 1 is multiplied
      if (rd + 1 < rounds) stage(rd + 1, (rd + 1) & 1);
      cp_async_commit();
      compute(rd & 1);
    }
  }
}

// -- tiled: fp32 register tiles ---------------------------------------------------

constexpr int kTiledPad = 4;  // words of padding per staged value row

// BS, KT: the block and the column tile fixed at compile time (0: taken
// from the arguments), so the shared-memory offsets of the inner loop are
// immediates and free their registers.
template <int S, int BS, int KT>
__global__ void __launch_bounds__(kMaxThreads, 2)
    bell_tiled_kernel(const float* __restrict__ values,
                      const int* __restrict__ cols,
                      const float* __restrict__ x, float* __restrict__ y,
                      int wb, int bs_arg, int k, int kt_arg, int ntiles) {
  extern __shared__ __align__(16) float tiled_raw[];
  const int bs = BS ? BS : bs_arg;
  const int kt = KT ? KT : kt_arg;
  const int lda = bs + kTiledPad;
  const int slot_words = bs * lda + bs * kt;
  const long long blk = blockIdx.x;
  const long long i = blk / ntiles;  // block row; the column tile is fastest
  const int c0 = static_cast<int>(blk % ntiles) * kt;
  const int kc = min(kt, k - c0);
  const int t = threadIdx.x;
  const int nthreads = blockDim.x;
  const int ntc = kt / 8;  // threads across the tile's columns
  const int ntr = bs / 8;  // threads down its rows
  // A warp spans 4 thread rows × 8 thread columns where the tile allows:
  // its X reads are 8 neighbouring float4 (128 bytes, one wavefront) and its
  // value reads 4 rows in distinct bank quads, each broadcast to 8 lanes.
  int tc = t % ntc;
  int tr = t / ntc;
  if (ntc % 8 == 0 && ntr % 4 == 0) {
    const int w = t >> 5;
    tc = (t & 7) + 8 * (w % (ntc / 8));
    tr = ((t & 31) >> 3) + 4 * (w / (ntc / 8));
  }
  const int half = kt / 2;
  const long long bsq = static_cast<long long>(bs) * bs;
  // The 16-byte chunks a thread copies per slot, found without a division
  // per chunk: in the value block rows v_r0, v_r0 + v_dr, ... at column v_c
  // (bs / 4 chunks a row, and the threads are kt / 16 rows of them); in the
  // X tile chunk t, t + nthreads, ... of kt / 4 a row, stepped by x_dq rows
  // and x_dc chunks.
  const int vq = bs / 4;
  const int v_c = 4 * (t % vq), v_r0 = t / vq, v_dr = nthreads / vq;
  const int xq = kt / 4;
  const int x_dq = nthreads / xq, x_dc = nthreads % xq;

  auto stage = [&](int rd, int) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const long long j = i * wb + rd * S + s;
      const long long col = __ldg(cols + j);
      const float* vb = values + j * bsq;
      const float* xb = x + col * bs * k + c0;
      float* sv = tiled_raw + s * slot_words;
      float* sx = sv + bs * lda;
      for (int r = v_r0; r < bs; r += v_dr)
        cp_async16(sv + r * lda + v_c, vb + r * bs + v_c, true);
      for (int q = t / xq, c = t % xq; q < bs;) {
        const bool live = 4 * c < kc;
        cp_async16(sx + q * kt + 4 * c,
                   live ? xb + static_cast<long long>(q) * k + 4 * c : x,
                   live);
        q += x_dq;
        c += x_dc;
        if (c >= xq) {
          c -= xq;
          ++q;
        }
      }
    }
  };

  float acc[8][8];
#pragma unroll
  for (int m = 0; m < 8; ++m)
#pragma unroll
    for (int n = 0; n < 8; ++n) acc[m][n] = 0.0f;

  auto compute = [&](int) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float* sv = tiled_raw + s * slot_words + tr * lda;
      const float* sx = tiled_raw + s * slot_words + bs * lda + 4 * tc;
#pragma unroll  // whole where bs is fixed at compile time
      for (int q = 0; q < bs; q += 4) {
        float4 a[8];
#pragma unroll
        for (int m = 0; m < 8; ++m)
          a[m] = *reinterpret_cast<const float4*>(sv + m * ntr * lda + q);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float* xr = sx + (q + u) * kt;
          const float4 b0 = *reinterpret_cast<const float4*>(xr);
          const float4 b1 = *reinterpret_cast<const float4*>(xr + half);
          const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int m = 0; m < 8; ++m) {
            const float av = u == 0 ? a[m].x
                             : u == 1 ? a[m].y
                             : u == 2 ? a[m].z
                                      : a[m].w;
#pragma unroll
            for (int n = 0; n < 8; ++n) acc[m][n] = fmaf(av, b[n], acc[m][n]);
          }
        }
      }
    }
  };

  ring<1>(wb / S, stage, compute);

  float* yb = y + i * bs * static_cast<long long>(k) + c0;
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    float* yr = yb + static_cast<long long>(tr + m * ntr) * k;
    if (4 * tc < kc)
      *reinterpret_cast<float4*>(yr + 4 * tc) =
          make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
    if (half + 4 * tc < kc)
      *reinterpret_cast<float4*>(yr + half + 4 * tc) =
          make_float4(acc[m][4], acc[m][5], acc[m][6], acc[m][7]);
  }
}

int tiled_threads(int bs, int kt) { return (bs / 8) * (kt / 8); }
int tiled_smem_bytes(int bs, int kt, int s) {
  return s * (bs * (bs + kTiledPad) + bs * kt) *
         static_cast<int>(sizeof(float));
}

template <int S, int BS, int KT>
int launch_tiled_as(const void* values, const int* cols, const void* x,
                    float* y, dim3 grid, int wb, int bs, int k, int kt,
                    int nthreads, int smem, cudaStream_t stream) {
  const cudaError_t err = allow_smem(bell_tiled_kernel<S, BS, KT>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  bell_tiled_kernel<S, BS, KT><<<grid, nthreads, smem, stream>>>(
      static_cast<const float*>(values), cols, static_cast<const float*>(x),
      y, wb, bs, k, kt, (k + kt - 1) / kt);
  return static_cast<int>(cudaGetLastError());
}

// The records' shape (bs 64 in 128-column tiles) compiled for its sizes;
// every other shape through the instance that reads them at run time.
template <int S>
int launch_tiled(const void* values, const int* cols, const void* x, float* y,
                 dim3 grid, int wb, int bs, int k, int kt, int nthreads,
                 int smem, cudaStream_t stream) {
  if (bs == 64 && kt == 128)
    return launch_tiled_as<S, 64, 128>(values, cols, x, y, grid, wb, bs, k,
                                       kt, nthreads, smem, stream);
  return launch_tiled_as<S, 0, 0>(values, cols, x, y, grid, wb, bs, k, kt,
                                  nthreads, smem, stream);
}

// -- mma: bf16 on the tensor cores -------------------------------------------------

constexpr int kMmaPad = 8;  // bf16 elements of padding per staged row
constexpr int kMmaStages = 2;

// n-tiles of 8 columns per warp for bs = 16·MI: at most 64 accumulators.
__host__ __device__ constexpr int mma_ni(int mi) {
  return mi <= 2 ? 8 : (mi <= 4 ? 4 : 2);
}

template <int MI, int S>
__global__ void __launch_bounds__(kMaxThreads)
    bell_mma_kernel(const __nv_bfloat16* __restrict__ values,
                    const int* __restrict__ cols,
                    const __nv_bfloat16* __restrict__ x,
                    float* __restrict__ y, int wb, int k, int kt,
                    int ntiles) {
  constexpr int BS = 16 * MI;
  constexpr int NI = mma_ni(MI);
  constexpr int WN = 8 * NI;           // columns per warp
  constexpr int LDA = BS + kMmaPad;    // staged value row, elements
  constexpr int VQ = BS / 8;           // 16-byte chunks per value row
  extern __shared__ __align__(16) unsigned char mma_raw[];
  auto* mma_smem = reinterpret_cast<__nv_bfloat16*>(mma_raw);
  const int ldx = kt + kMmaPad;
  const int slot_elems = BS * LDA + BS * ldx;
  const long long blk = blockIdx.x;
  const long long i = blk / ntiles;
  const int c0 = static_cast<int>(blk % ntiles) * kt;
  const int kc = min(kt, k - c0);
  const int t = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = t & 31;
  const int wn0 = (t >> 5) * WN;       // this warp's first column
  const long long bsq = static_cast<long long>(BS) * BS;
  // X's chunks a thread copies per slot: column x_c, rows x_r0, x_r0 + x_dr,
  // ... (kt / 8 chunks a row; the threads, 32 per 8·NI columns, are a
  // multiple of that).
  const int xq = kt / 8;
  const int x_c = 8 * (t % xq), x_r0 = t / xq, x_dr = nthreads / xq;

  auto stage = [&](int rd, int st) {
    __nv_bfloat16* base = mma_smem + st * S * slot_elems;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const long long j = i * wb + rd * S + s;
      const long long col = __ldg(cols + j);
      const __nv_bfloat16* vb = values + j * bsq;
      const __nv_bfloat16* xb = x + col * BS * k + c0;
      __nv_bfloat16* sa = base + s * slot_elems;
      __nv_bfloat16* sb = sa + BS * LDA;
      for (int e = t; e < BS * VQ; e += nthreads) {
        const int r = e / VQ;
        const int c = 8 * (e - r * VQ);
        cp_async16(sa + r * LDA + c, vb + r * BS + c, true);
      }
      const bool live = x_c < kc;
      for (int q = x_r0; q < BS; q += x_dr)
        cp_async16(sb + q * ldx + x_c,
                   live ? xb + static_cast<long long>(q) * k + x_c : x, live);
    }
  };

  float acc[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;

  // ldmatrix row addresses: lanes 0-15 give rows 0-15 of the 16-row
  // fragment at column +0, lanes 16-31 the same rows at column +8.
  const int lrow = lane & 15;
  const int lcol = (lane >> 4) * 8;
  auto compute = [&](int st) {
    const __nv_bfloat16* base = mma_smem + st * S * slot_elems;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const __nv_bfloat16* sa = base + s * slot_elems;
      const __nv_bfloat16* sb = sa + BS * LDA;
#pragma unroll
      for (int kk = 0; kk < BS; kk += 16) {
        unsigned a[MI][4];
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
          ldmatrix_x4(a[mi], sa + (mi * 16 + lrow) * LDA + kk + lcol);
        unsigned b[NI][2];
#pragma unroll
        for (int ni = 0; ni < NI; ni += 2) {
          // X's (q, c) tile is row-major: .trans gives the .col B fragments
          // of two n-tiles, (k 0-7, k 8-15) of each.
          unsigned r[4];
          ldmatrix_x4_trans(r, sb + (kk + lrow) * ldx + wn0 + ni * 8 + lcol);
          b[ni][0] = r[0];
          b[ni][1] = r[1];
          b[ni + 1][0] = r[2];
          b[ni + 1][1] = r[3];
        }
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
          for (int ni = 0; ni < NI; ++ni)
            mma_bf16(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
      }
    }
  };

  ring<kMmaStages>(wb / S, stage, compute);

  // Accumulator e of (mi, ni): row mi·16 + lane/4 (+8 for e >= 2), column
  // wn0 + ni·8 + 2·(lane % 4) (+1 for odd e).
  float* yb = y + i * BS * static_cast<long long>(k) + c0;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      const int c = wn0 + ni * 8 + 2 * (lane & 3);
      if (c >= kc) continue;
      const long long r = mi * 16 + (lane >> 2);
      *reinterpret_cast<float2*>(yb + r * k + c) =
          make_float2(acc[mi][ni][0], acc[mi][ni][1]);
      *reinterpret_cast<float2*>(yb + (r + 8) * k + c) =
          make_float2(acc[mi][ni][2], acc[mi][ni][3]);
    }
}

int mma_threads(int bs, int kt) { return 32 * (kt / (8 * mma_ni(bs / 16))); }
int mma_smem_bytes(int bs, int kt, int s) {
  return kMmaStages * s * (bs * (bs + kMmaPad) + bs * (kt + kMmaPad)) *
         static_cast<int>(sizeof(__nv_bfloat16));
}

template <int MI, int S>
int launch_mma(const void* values, const int* cols, const void* x, float* y,
               dim3 grid, int wb, int k, int kt, int nthreads, int smem,
               cudaStream_t stream) {
  const cudaError_t err = allow_smem(bell_mma_kernel<MI, S>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  bell_mma_kernel<MI, S><<<grid, nthreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(values), cols,
      static_cast<const __nv_bfloat16*>(x), y, wb, k, kt, (k + kt - 1) / kt);
  return static_cast<int>(cudaGetLastError());
}

template <int S>
int dispatch_mma(int mi, const void* values, const int* cols, const void* x,
                 float* y, dim3 grid, int wb, int k, int kt, int nthreads,
                 int smem, cudaStream_t s) {
  switch (mi) {
    case 1: return launch_mma<1, S>(values, cols, x, y, grid, wb, k, kt, nthreads, smem, s);
    case 2: return launch_mma<2, S>(values, cols, x, y, grid, wb, k, kt, nthreads, smem, s);
    case 3: return launch_mma<3, S>(values, cols, x, y, grid, wb, k, kt, nthreads, smem, s);
    case 4: return launch_mma<4, S>(values, cols, x, y, grid, wb, k, kt, nthreads, smem, s);
    case 5: return launch_mma<5, S>(values, cols, x, y, grid, wb, k, kt, nthreads, smem, s);
    case 6: return launch_mma<6, S>(values, cols, x, y, grid, wb, k, kt, nthreads, smem, s);
    case 7: return launch_mma<7, S>(values, cols, x, y, grid, wb, k, kt, nthreads, smem, s);
    default: return launch_mma<8, S>(values, cols, x, y, grid, wb, k, kt, nthreads, smem, s);
  }
}

// -- rows: small blocks, one thread per output row -------------------------------

// float4 reads: BS in {4, 8, 12, 16}, K in {1, 4, 8}.
template <int BS, int K>
__global__ void __launch_bounds__(kRowsThreads)
    bell_rows_vec_kernel(const float* __restrict__ values,
                         const int* __restrict__ cols,
                         const float* __restrict__ x, float* __restrict__ y,
                         long long nbr, int wb) {
  const int rpc = blockDim.x / BS;
  const int t = threadIdx.x;
  const long long i = static_cast<long long>(blockIdx.x) * rpc + t / BS;
  const int r = t % BS;
  if (i >= nbr) return;
  float acc[K];
#pragma unroll
  for (int c = 0; c < K; ++c) acc[c] = 0.0f;
  const float* vrow = values + i * wb * BS * BS + r * BS;
  const int* crow = cols + i * wb;
#pragma unroll 4
  for (int j = 0; j < wb; ++j) {
    const long long col = __ldg(crow + j);
    const float4* vr =
        reinterpret_cast<const float4*>(vrow + static_cast<long long>(j) * BS * BS);
    const float* xb = x + col * BS * K;
    float v[BS];
#pragma unroll
    for (int c4 = 0; c4 < BS / 4; ++c4) {
      const float4 f = __ldg(vr + c4);
      v[4 * c4] = f.x;
      v[4 * c4 + 1] = f.y;
      v[4 * c4 + 2] = f.z;
      v[4 * c4 + 3] = f.w;
    }
    if constexpr (K == 1) {
#pragma unroll
      for (int c4 = 0; c4 < BS / 4; ++c4) {
        const float4 xv = __ldg(reinterpret_cast<const float4*>(xb) + c4);
        acc[0] = fmaf(v[4 * c4], xv.x, acc[0]);
        acc[0] = fmaf(v[4 * c4 + 1], xv.y, acc[0]);
        acc[0] = fmaf(v[4 * c4 + 2], xv.z, acc[0]);
        acc[0] = fmaf(v[4 * c4 + 3], xv.w, acc[0]);
      }
    } else {
#pragma unroll
      for (int q = 0; q < BS; ++q) {
#pragma unroll
        for (int c4 = 0; c4 < K / 4; ++c4) {
          const float4 xv =
              __ldg(reinterpret_cast<const float4*>(xb + q * K) + c4);
          acc[4 * c4] = fmaf(v[q], xv.x, acc[4 * c4]);
          acc[4 * c4 + 1] = fmaf(v[q], xv.y, acc[4 * c4 + 1]);
          acc[4 * c4 + 2] = fmaf(v[q], xv.z, acc[4 * c4 + 2]);
          acc[4 * c4 + 3] = fmaf(v[q], xv.w, acc[4 * c4 + 3]);
        }
      }
    }
  }
  float* yr = y + (i * BS + r) * K;
  if constexpr (K == 1) {
    yr[0] = acc[0];
  } else {
#pragma unroll
    for (int c4 = 0; c4 < K / 4; ++c4)
      reinterpret_cast<float4*>(yr)[c4] = make_float4(
          acc[4 * c4], acc[4 * c4 + 1], acc[4 * c4 + 2], acc[4 * c4 + 3]);
  }
}

// Scalar reads: any bs <= 16, K in 1..8.
template <int K>
__global__ void __launch_bounds__(kRowsThreads)
    bell_rows_kernel(const float* __restrict__ values,
                     const int* __restrict__ cols,
                     const float* __restrict__ x, float* __restrict__ y,
                     long long nbr, int wb, int bs) {
  const int rpc = blockDim.x / bs;
  const int t = threadIdx.x;
  const long long i = static_cast<long long>(blockIdx.x) * rpc + t / bs;
  const int r = t % bs;
  if (i >= nbr) return;
  float acc[K];
#pragma unroll
  for (int c = 0; c < K; ++c) acc[c] = 0.0f;
  const long long bsq = static_cast<long long>(bs) * bs;
  for (int j = 0; j < wb; ++j) {
    const long long col = __ldg(cols + i * wb + j);
    const float* vr = values + (i * wb + j) * bsq + r * bs;
    const float* xb = x + col * bs * K;
    for (int q = 0; q < bs; ++q) {
      const float v = __ldg(vr + q);
#pragma unroll
      for (int c = 0; c < K; ++c)
        acc[c] = fmaf(v, __ldg(xb + q * K + c), acc[c]);
    }
  }
  float* yr = y + (i * bs + r) * K;
#pragma unroll
  for (int c = 0; c < K; ++c) yr[c] = acc[c];
}

int rows_threads(int bs) { return (kRowsThreads / bs) * bs; }
bool rows_vec(int bs, int k) {
  return bs % 4 == 0 && (k == 1 || k == 4 || k == 8);
}

template <int BS>
int launch_rows_vec(int k, const float* values, const int* cols,
                    const float* x, float* y, int nbr, int wb, dim3 grid,
                    int nthreads, cudaStream_t s) {
  switch (k) {
    case 1: bell_rows_vec_kernel<BS, 1><<<grid, nthreads, 0, s>>>(values, cols, x, y, nbr, wb); break;
    case 4: bell_rows_vec_kernel<BS, 4><<<grid, nthreads, 0, s>>>(values, cols, x, y, nbr, wb); break;
    default: bell_rows_vec_kernel<BS, 8><<<grid, nthreads, 0, s>>>(values, cols, x, y, nbr, wb); break;
  }
  return static_cast<int>(cudaGetLastError());
}

int launch_rows(const void* values_, const int* cols, const void* x_,
                float* y, dim3 grid, int nbr, int wb, int bs, int k,
                int nthreads, cudaStream_t s) {
  const auto* values = static_cast<const float*>(values_);
  const auto* x = static_cast<const float*>(x_);
  if (rows_vec(bs, k)) {
    switch (bs) {
      case 4: return launch_rows_vec<4>(k, values, cols, x, y, nbr, wb, grid, nthreads, s);
      case 8: return launch_rows_vec<8>(k, values, cols, x, y, nbr, wb, grid, nthreads, s);
      case 12: return launch_rows_vec<12>(k, values, cols, x, y, nbr, wb, grid, nthreads, s);
      default: return launch_rows_vec<16>(k, values, cols, x, y, nbr, wb, grid, nthreads, s);
    }
  }
  switch (k) {
    case 1: bell_rows_kernel<1><<<grid, nthreads, 0, s>>>(values, cols, x, y, nbr, wb, bs); break;
    case 2: bell_rows_kernel<2><<<grid, nthreads, 0, s>>>(values, cols, x, y, nbr, wb, bs); break;
    case 3: bell_rows_kernel<3><<<grid, nthreads, 0, s>>>(values, cols, x, y, nbr, wb, bs); break;
    case 4: bell_rows_kernel<4><<<grid, nthreads, 0, s>>>(values, cols, x, y, nbr, wb, bs); break;
    case 5: bell_rows_kernel<5><<<grid, nthreads, 0, s>>>(values, cols, x, y, nbr, wb, bs); break;
    case 6: bell_rows_kernel<6><<<grid, nthreads, 0, s>>>(values, cols, x, y, nbr, wb, bs); break;
    case 7: bell_rows_kernel<7><<<grid, nthreads, 0, s>>>(values, cols, x, y, nbr, wb, bs); break;
    default: bell_rows_kernel<8><<<grid, nthreads, 0, s>>>(values, cols, x, y, nbr, wb, bs); break;
  }
  return static_cast<int>(cudaGetLastError());
}

// -- the plan, checked again, and the launch -------------------------------------

bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

// Launch the plan (path, tile, threads, smem, grid) that bell_plan made for
// S slots per round over nbr block rows, after checking that the shape takes
// the path and that the threads, shared memory and grid are what this side
// computes for it.
template <int S>
int spmm(const void* values, const int* cols, const void* x, float* y,
         int nbr, int wb, int bs, int k, int bf16, int path, int tile,
         int threads, int smem, int gx, int gy, void* stream) {
  if (nbr < 0 || wb < 1 || wb % S != 0 || bs < 1 || bs > kMaxBs || k < 1 ||
      tile < 1)
    return cudaErrorInvalidValue;
  if (nbr == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = aligned16(values) && aligned16(x) && aligned16(y);
  const long long ntiles = (k + tile - 1) / tile;
  // The general path's grid is (block row, column tile); the others run
  // the column tile fastest in one dimension (rows: rpc block rows a block).
  long long want_x = nbr * ntiles, want_y = 1;
  if (path == kGeneral) {
    want_x = nbr;
    want_y = ntiles;
  } else if (path == kRows) {
    const int rpc = threads / bs;
    want_x = rpc < 1 ? 0 : (nbr + rpc - 1) / rpc;
  }
  if (gx != want_x || gy != want_y || want_x > 0x7fffffffLL ||
      want_y > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid(gx, gy);
  switch (path) {
    case kGeneral: {
      const int kt = pow2_at_least(k < kTileMax ? k : kTileMax);
      int want = pow2_at_least(bs * kt);
      want = want < 32 ? 32 : (want > kMaxThreads ? kMaxThreads : want);
      const int words = bs * (S * bs + 1) + S * bs * kt;
      if (tile != kt || threads != want ||
          smem != words * static_cast<int>(sizeof(float)))
        return cudaErrorInvalidValue;
      const int stride = threads / kt;
      const int rpt = pow2_at_least((bs + stride - 1) / stride);
      if (bf16)
        return dispatch_general<__nv_bfloat16, S>(rpt, values, cols, x, y,
                                                  grid, wb, bs, k, kt,
                                                  threads, smem, s);
      return dispatch_general<float, S>(rpt, values, cols, x, y, grid, wb, bs,
                                        k, kt, threads, smem, s);
    }
    case kTiled:
      if (bf16 || !aligned || bs % 8 != 0 || k < 16 || k % 4 != 0 ||
          (tile != 16 && tile != 32 && tile != 64 && tile != 128) ||
          threads != tiled_threads(bs, tile) || threads > kMaxThreads ||
          smem != tiled_smem_bytes(bs, tile, S) || smem > kSmemMax)
        return cudaErrorInvalidValue;
      return launch_tiled<S>(values, cols, x, y, grid, wb, bs, k, tile,
                             threads, smem, s);
    case kMma: {
      const int wn = bs % 16 == 0 ? 8 * mma_ni(bs / 16) : 1;
      if (!bf16 || !aligned || bs % 16 != 0 || k % 8 != 0 || tile % wn != 0 ||
          tile / wn > 8 || threads != mma_threads(bs, tile) ||
          smem != mma_smem_bytes(bs, tile, S) || smem > kSmemMax)
        return cudaErrorInvalidValue;
      return dispatch_mma<S>(bs / 16, values, cols, x, y, grid, wb, k, tile,
                             threads, smem, s);
    }
    case kRows:
      if (bf16 || !aligned || bs > 16 || k > 8 || tile != k ||
          threads != rows_threads(bs) || smem != 0)
        return cudaErrorInvalidValue;
      return launch_rows(values, cols, x, y, grid, nbr, wb, bs, k, threads,
                         s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Each entry launches on `stream` and returns cudaGetLastError() after the
// launch.  values and x are fp32, or both bf16 when `bf16` is 1; y is fp32.
// path is 0 general, 1 tiled, 2 mma, 3 rows; tile, threads, smem and the
// grid (gx, gy) are bell_plan's for the call.

// K11 (and each chunk of K12): one slot per round.
extern "C" int cgx_bell_spmm(const void* values, const int* cols,
                             const void* x, float* y, int nbr, int wb, int bs,
                             int k, int bf16, int path, int tile, int threads,
                             int smem, int gx, int gy, void* stream) {
  return spmm<1>(values, cols, x, y, nbr, wb, bs, k, bf16, path, tile,
                 threads, smem, gx, gy, stream);
}

// P2: two slots per round; wb must be even.
extern "C" int cgx_bell_spmm_paired(const void* values, const int* cols,
                                    const void* x, float* y, int nbr, int wb,
                                    int bs, int k, int bf16, int path,
                                    int tile, int threads, int smem, int gx,
                                    int gy, void* stream) {
  return spmm<2>(values, cols, x, y, nbr, wb, bs, k, bf16, path, tile,
                 threads, smem, gx, gy, stream);
}
