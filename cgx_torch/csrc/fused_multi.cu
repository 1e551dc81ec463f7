// K5: the two-pass CG iteration over k right-hand sides (kernels A and B).
//
// Replaces the Pallas kernels cgx/kernels/fused_multi.py:_kernel_a_multi
// (Q = Ã·P for k columns with the per-column p·q and q·q) and
// :_kernel_b_multi (per-column α and β with the live freeze, then
// X += αP, R −= αQ, P = R + βP with per-column Σr² and Σr²·w), which
// _solve_multi runs once each per iteration under a lax.while_loop.  It is
// K3 (fused_engine.cu) over k columns: the same arithmetic per column, so a
// column of K5 rounds as K3 rounds it.
//
// Layout: k flat columns, (k, n) contiguous (the JAX package's b.T).  The
// band-stacked TPU layout, its band tiling and VMEM windows are placement
// for the TPU and are not carried over.
//
// What bounds it on this card is bytes, and the reason for the kernel is
// the coefficient planes: one thread per row reads each plane value (and
// its mirror) once and applies it to all k columns from a register, so the
// 13 plane streams of a symmetric 27-point operator are read once per
// iteration instead of k times.  Per iteration A reads the planes and P and
// writes Q; B reads X, R, P, Q and the one weight vector w shared by all
// columns, and writes X, R, P.  Columns are processed kCols = 4 at a time;
// above 4 the planes stream once per group of 4.
//
// Control stays on the device, as in K3, in a block of int32 words (floats
// by bit pattern): a header, then five float arrays of k.  Unlike K3, the
// cross-block sums are folded once, by the block that finishes last (a
// ticket counter per kernel; the block partials are fenced before the
// ticket): with k columns every block folding every partial, as K3 does,
// would read 2k·grid values per block per kernel.  One block folds in one
// fixed order without further atomics, so two runs are bit-identical:
//
//   * kernel A's last block folds Σ p·q and Σ q·q per column into the block;
//   * kernel B reads them with Σr² of the previous pass, computes per column
//     live = rz > 0 && pq > 0, α = live ? rz/pq : 0 and
//     β = live ? (α²·qq − rz)/rz : 0 (the communication-avoiding identity,
//     as in K3), updates, and its last block folds Σr² and Σr²·w per
//     column, counts the iteration and takes the shared exit
//     k < maxit && any_j(rw_j > tol²_j);  once it is taken every later
//     launch returns at once, so the host reads the flag once per chunk.
//
// A column that has converged keeps iterating with the others (the JAX
// package's semantics); a column whose rz or pq reaches 0 is frozen
// (α = β = 0: x and r unchanged, p ← r), so a zero column coasts without
// NaN.  The four sums are taken exactly, as K3 takes them: fp64 products of
// fp32 values, fp64 sums, one rounding to fp32.
//
// bf16 planes (the Pallas kernel's plane_dtype, cgx/kernels/fused_multi.py
// :160): kernel A is a template on the plane type P, float or bf16.  A bf16
// plane value is widened to fp32 in a register as it is loaded (exact) and
// everything else is unchanged, so the bf16 mode equals the fp32 mode run on
// the planes rounded through bf16, bit for bit.  Kernel B streams no planes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "stencil.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 4;  // columns per pass over the rows

// The control block.  The wrapper (cgx_torch/kernels/fused_multi.py) fills
// it before a run and reads the iteration, the flag and rz/rw after it.
constexpr int kIt = 0;      // iterations done
constexpr int kDone = 1;    // 1: the shared exit is taken
constexpr int kMaxit = 2;   // iteration cap of the run
constexpr int kCountA = 3;  // kernel A's ticket counter (0 between launches)
constexpr int kCountB = 4;  // kernel B's ticket counter
constexpr int kHead = 8;
// Float arrays of ncols after the header, in this order.
constexpr int kRz = 0;   // Σ r² (solve space; β's denominator)
constexpr int kRw = 1;   // Σ r²·w (the exit test)
constexpr int kPq = 2;   // Σ p·q of the last kernel A
constexpr int kQq = 3;   // Σ q·q of the last kernel A
constexpr int kTol = 4;  // tol² per column

__device__ __forceinline__ float* field(int* ctl, int ncols, int f) {
  return reinterpret_cast<float*>(ctl + kHead + f * ncols);
}

// True in the block that finishes last.  Thread 0 has written the block's
// partials; the fence orders them before its ticket, so the last block
// reads every partial through L2 (grid_sum uses __ldcg).  The last block
// resets the counter for the next launch: every other block has taken its
// ticket by then.
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

struct AArgs {
  const float* p;        // ncols × n
  float* q;              // ncols × n
  const void* planes;    // P; null: constant taps only
  double* part;          // 2·ncols × gridDim.x: Σ p·q per column, then Σ q·q
  int* ctl;
  int ncols;
  int nx, ny, nz;
  cgx::PlaneTaps taps;
};

template <int kTaps, bool kPlanes, bool kSym, typename P>
__global__ void __launch_bounds__(kThreads) multi_a(AArgs a) {
  __shared__ double smem[kWarps + 1];
  if (a.ctl[kDone]) return;
  const int n = a.nx * a.ny * a.nz;
  const size_t ld = static_cast<size_t>(n);
  const int stride = gridDim.x * kThreads;
  for (int c0 = 0; c0 < a.ncols; c0 += kCols) {
    const int nc = min(kCols, a.ncols - c0);
    const float* p = a.p + c0 * ld;
    float* q = a.q + c0 * ld;
    double pq[kCols];
    double qq[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) pq[c] = qq[c] = 0.0;
    for (int row = blockIdx.x * kThreads + threadIdx.x; row < n;
         row += stride) {
      float acc[kCols];
      if constexpr (kPlanes) {
        cgx::plane_row_multi<kTaps, kSym, kCols>(
            p, ld, nc, static_cast<const P*>(a.planes), row, n, a.nx, a.ny,
            a.nz, a.taps, acc);
      } else {
        cgx::stencil_row_multi<kTaps, kCols>(p, ld, nc, row, a.nx, a.ny,
                                             a.nz, a.taps.s, acc);
      }
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        if (c < nc) {
          q[c * ld + row] = acc[c];
          const double qd = acc[c];
          const double pd = __ldg(p + c * ld + row);
          pq[c] = __dadd_rn(pq[c], __dmul_rn(qd, pd));
          qq[c] = __dadd_rn(qq[c], __dmul_rn(qd, qd));
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      if (c < nc) {  // nc is the same in every thread of the block
        const double s = cgx::block_sum<kThreads>(pq[c], smem);
        const double s2 = cgx::block_sum<kThreads>(qq[c], smem);
        if (threadIdx.x == 0) {
          a.part[static_cast<size_t>(c0 + c) * gridDim.x + blockIdx.x] = s;
          a.part[static_cast<size_t>(a.ncols + c0 + c) * gridDim.x +
                 blockIdx.x] = s2;
        }
      }
    }
  }
  if (!last_block(a.ctl + kCountA)) return;
  float* pqs = field(a.ctl, a.ncols, kPq);
  float* qqs = field(a.ctl, a.ncols, kQq);
  for (int c = 0; c < a.ncols; ++c) {
    const double s = cgx::grid_sum<kThreads>(
        a.part + static_cast<size_t>(c) * gridDim.x, gridDim.x, smem);
    const double s2 = cgx::grid_sum<kThreads>(
        a.part + static_cast<size_t>(a.ncols + c) * gridDim.x, gridDim.x,
        smem);
    if (threadIdx.x == 0) {
      pqs[c] = static_cast<float>(s);
      qqs[c] = static_cast<float>(s2);
    }
  }
}

struct BArgs {
  float* x;        // ncols × n, updated in place
  float* r;
  float* p;
  const float* q;
  const float* w;  // n, shared by the columns; null: unweighted
  double* part;    // 2·ncols × gridDim.x: Σ r² per column, then Σ r²·w
  int* ctl;
  int ncols;
  int n;
};

template <bool kWeighted>
__global__ void __launch_bounds__(kThreads) multi_b(BArgs a) {
  __shared__ double smem[kWarps + 1];
  int* ctl = a.ctl;
  if (ctl[kDone]) return;
  const float* rzs = field(ctl, a.ncols, kRz);
  const float* pqs = field(ctl, a.ncols, kPq);
  const float* qqs = field(ctl, a.ncols, kQq);
  const size_t ld = static_cast<size_t>(a.n);
  const int stride = gridDim.x * kThreads;
  for (int c0 = 0; c0 < a.ncols; c0 += kCols) {
    const int nc = min(kCols, a.ncols - c0);
    float alpha[kCols];
    float beta[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      alpha[c] = beta[c] = 0.0f;
      if (c < nc) {
        const float rz = rzs[c0 + c];
        const float pq = pqs[c0 + c];
        const float qq = qqs[c0 + c];
        if (rz > 0.0f && pq > 0.0f) {
          alpha[c] = __fdiv_rn(rz, pq);
          beta[c] = __fdiv_rn(
              __fsub_rn(__fmul_rn(__fmul_rn(alpha[c], alpha[c]), qq), rz), rz);
        }
      }
    }
    double acc[kCols];
    double accw[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[c] = accw[c] = 0.0;
    for (int row = blockIdx.x * kThreads + threadIdx.x; row < a.n;
         row += stride) {
      double wd = 0.0;
      if constexpr (kWeighted) wd = static_cast<double>(a.w[row]);
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        if (c < nc) {
          const size_t i = (c0 + c) * ld + row;
          const float pv = a.p[i];
          a.x[i] = __fadd_rn(a.x[i], __fmul_rn(alpha[c], pv));
          const float rv = __fsub_rn(a.r[i], __fmul_rn(alpha[c], a.q[i]));
          a.r[i] = rv;
          a.p[i] = __fadd_rn(rv, __fmul_rn(beta[c], pv));
          const double rsq = __dmul_rn(rv, rv);
          acc[c] = __dadd_rn(acc[c], rsq);
          if constexpr (kWeighted)
            accw[c] = __dadd_rn(accw[c], __dmul_rn(rsq, wd));
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      if (c < nc) {
        const double s = cgx::block_sum<kThreads>(acc[c], smem);
        double sw = s;
        if constexpr (kWeighted) sw = cgx::block_sum<kThreads>(accw[c], smem);
        if (threadIdx.x == 0) {
          a.part[static_cast<size_t>(c0 + c) * gridDim.x + blockIdx.x] = s;
          a.part[static_cast<size_t>(a.ncols + c0 + c) * gridDim.x +
                 blockIdx.x] = sw;
        }
      }
    }
  }
  // Every block has read rz (its α and β) before its ticket, so the last
  // block may overwrite it.
  if (!last_block(ctl + kCountB)) return;
  float* rz_out = field(ctl, a.ncols, kRz);
  float* rw_out = field(ctl, a.ncols, kRw);
  const float* tol = field(ctl, a.ncols, kTol);
  bool go = false;
  for (int c = 0; c < a.ncols; ++c) {
    const double s = cgx::grid_sum<kThreads>(
        a.part + static_cast<size_t>(c) * gridDim.x, gridDim.x, smem);
    const double sw = cgx::grid_sum<kThreads>(
        a.part + static_cast<size_t>(a.ncols + c) * gridDim.x, gridDim.x,
        smem);
    const float rw = static_cast<float>(sw);
    go = go || rw > tol[c];
    if (threadIdx.x == 0) {
      rz_out[c] = static_cast<float>(s);
      rw_out[c] = rw;
    }
  }
  if (threadIdx.x == 0) {
    const int it = ctl[kIt] + 1;
    ctl[kIt] = it;
    ctl[kDone] = (it < ctl[kMaxit] && go) ? 0 : 1;
  }
}

template <typename P>
const void* a_kernel_typed(int ntaps, int variable, int sym) {
  const bool wide = ntaps > 7;
  if (!variable)
    return wide ? reinterpret_cast<const void*>(
                      multi_a<cgx::kMaxTaps, false, false, P>)
                : reinterpret_cast<const void*>(multi_a<7, false, false, P>);
  if (sym)
    return wide ? reinterpret_cast<const void*>(
                      multi_a<cgx::kMaxTaps, true, true, P>)
                : reinterpret_cast<const void*>(multi_a<7, true, true, P>);
  return wide ? reinterpret_cast<const void*>(
                    multi_a<cgx::kMaxTaps, true, false, P>)
              : reinterpret_cast<const void*>(multi_a<7, true, false, P>);
}

const void* a_kernel_for(int ntaps, int variable, int sym, int plane_bf16) {
  return plane_bf16 && variable
             ? a_kernel_typed<__nv_bfloat16>(ntaps, variable, sym)
             : a_kernel_typed<float>(ntaps, variable, sym);
}

const void* b_kernel_for(int weighted) {
  return weighted ? reinterpret_cast<const void*>(multi_b<true>)
                  : reinterpret_cast<const void*>(multi_b<false>);
}

}  // namespace

extern "C" int cgx_multi_a_grid(int device, int ntaps, int variable, int sym,
                                int plane_bf16, int* grid) {
  return cgx::full_grid<kThreads>(
      device, a_kernel_for(ntaps, variable, sym, plane_bf16), grid);
}

extern "C" int cgx_multi_b_grid(int device, int weighted, int* grid) {
  return cgx::full_grid<kThreads>(device, b_kernel_for(weighted), grid);
}

// Kernel A on `stream` over ncols columns of n = nx·ny·nz rows.
// `plane[t]` is tap t's plane index (−1: constant tap coeffs[t]); `planes`
// is null for a constant-coefficient operator and holds bf16 when
// plane_bf16.  `part` holds 2·ncols·grid doubles; `ctl` is the control
// block.
extern "C" int cgx_multi_a(const float* p, float* q, const void* planes,
                           double* part, int grid, int* ctl, int ncols, int nx,
                           int ny, int nz, int ntaps, const int* taps,
                           const float* coeffs, const int* plane, int sym,
                           int plane_bf16, void* stream) {
  if (ntaps < 1 || ntaps > cgx::kMaxTaps || grid < 1 || ncols < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  AArgs a{p,     q,  planes, part, ctl, ncols, nx, ny, nz,
          cgx::make_plane_taps(ntaps, taps, coeffs, plane, ny, nz)};
  return cgx::launch<kThreads>(
      a_kernel_for(ntaps, planes != nullptr, sym, plane_bf16), grid, &a,
      stream);
}

// Kernel B on `stream`; `w` is null for an unweighted solve.
extern "C" int cgx_multi_b(float* x, float* r, float* p, const float* q,
                           const float* w, double* part, int grid, int* ctl,
                           int ncols, int n, void* stream) {
  if (grid < 1 || ncols < 1) return static_cast<int>(cudaErrorInvalidValue);
  BArgs a{x, r, p, q, w, part, ctl, ncols, n};
  return cgx::launch<kThreads>(b_kernel_for(w != nullptr), grid, &a, stream);
}
