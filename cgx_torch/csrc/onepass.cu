// K6: the one-pass CG iteration, one cooperative launch per iteration.
//
// Replaces the Pallas kernel cgx/kernels/fused_onepass.py:_kernel_c, which
// OnePassCG runs once per iteration: with the four sums of the previous
// iteration [Σr², Σr²·w, p·Ap, ‖Ap‖²] it computes
//
//   α = rz/pq, β = (α²·qq − rz)/rz      (the CA identity, as K3)
//   q = A·p;  x' = x + αp;  r' = r − αq;  p' = r' + βp
//   w = A·p'; the sums [Σr'², Σr'², p'·w, w·w] of the next iteration
//
// so q is never stored.  The second apply reads p' at neighbour rows that
// other blocks write.  The TPU recomputes r' and p' on ±sl margins of each
// block; on the card a halo as wide as an x-plane (ny·nz rows) would cost
// more than the block's own rows, so the launch is cooperative instead,
// with one grid-wide barrier between the update and the second apply.  r
// and p ping-pong between two buffers by the parity of k (the Pallas
// kernel's operands are not aliased either); only x is updated in place.
//
// Sums: exact as in K3 (fp64 products and sums, rounded once), and taken
// over K3's partition: the update sweep over kernel B's grid g_b, the
// second apply over kernel A's g_a, each in K3's per-thread order and
// block tree.  So K6 equals K3's solve bit for bit — x, the iteration
// count and the history — whatever its own grid.
//
// The redesign (onepass2_kernel; the first design, onepass_kernel, stays as
// the same-run "before", design 0, reached by no entry point and counted by
// no launch counter):
//
//   * Balance and occupancy.  At 7 taps the first design's own grid was
//     K3's (1056 blocks on the H100); at 27 taps it took more registers
//     and fit fewer blocks than K3, so some blocks swept two of K3's
//     virtual blocks while the rest swept one.  The redesign holds K3's 8
//     blocks an SM (__launch_bounds__), and the wrapper picks the grid
//     (fused_onepass.py `launch_grid`) so that it divides K3's grids
//     where it can: every block then sweeps as many virtual blocks.
//   * No division a row: a thread's rows in a virtual block are row₀ +
//     m·g·256, and the node is carried (cgx::Walk, stencil_row_at).
//   * The folds once a launch: the control block always holds the sums of
//     iterate k.  After the barrier block 0 folds the update's Σr²
//     partials; the block that finishes the second apply last (a ticket in
//     the control block) folds p'·w and w·w and advances k, each fold in
//     K3's fixed order (grid_sum).  The first design folded all four
//     partial arrays in every block's prologue.
//
// The host launches a chunk of iterations without reading anything, as for
// K3 (fused_engine.cu): the exit test k < maxit and Σr² > tol² is taken by
// every block from the control block, and a launch past the exit returns
// at once.
//
// Constant taps only, fp32 vectors, unweighted (the Pallas kernel's
// limits).  Bound: bytes.  The function reads x, r, p and writes x, r', p'
// (6 streams, the Pallas kernel's count); this version also reads p' again
// in the second apply (from the L2 where it fits), so 7 in device memory.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "stencil.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// The control block: 16 int32 words in device memory (floats by bit
// pattern).  The wrapper (cgx_torch/kernels/fused_onepass.py) fills it
// before a run and reads words 0-6 after it.
struct Ctl {
  float rz, rw, pq, qq;  // the sums of iterate k, when !pending
  int k;                 // iterations done: x, r[k&1], p[k&1] hold iterate k
  int pending;           // 1: the sums of iterate k are in partials [k&1]
  int done;
  float tol_sq;
  int maxit;
  int hist_len;
  int pad[6];
};
static_assert(sizeof(Ctl) == 64, "Ctl is 16 words");

struct Args {
  float* x;
  float* r0;
  float* r1;
  float* p0;
  float* p1;
  double* part_a;  // 2 parities × 2 × grid_a: Σ p·Ap, Σ (Ap)²
  double* part_b;  // 2 parities × 2 × grid_b: Σ r², Σ r² (unweighted)
  int grid_a, grid_b;
  Ctl* ctl;
  float* history;  // hist_len floats, or null
  int nx, ny, nz;
  cgx::StencilTaps taps;
};

template <int kTaps>
__global__ void __launch_bounds__(kThreads) onepass_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ double smem[kWarps + 1];
  Ctl* c = a.ctl;
  if (c->done) return;
  const int n = a.nx * a.ny * a.nz;
  const int k = c->k;
  const int par = k & 1;
  const bool pending = c->pending != 0;
  const bool lead = blockIdx.x == 0 && threadIdx.x == 0;
  float rz, rw, pq, qq;
  if (pending) {
    const double* pa = a.part_a + par * 2 * a.grid_a;
    const double* pb = a.part_b + par * 2 * a.grid_b;
    rz = static_cast<float>(cgx::grid_sum<kThreads>(pb, a.grid_b, smem));
    rw = static_cast<float>(
        cgx::grid_sum<kThreads>(pb + a.grid_b, a.grid_b, smem));
    pq = static_cast<float>(cgx::grid_sum<kThreads>(pa, a.grid_a, smem));
    qq = static_cast<float>(
        cgx::grid_sum<kThreads>(pa + a.grid_a, a.grid_a, smem));
  } else {
    rz = c->rz;
    rw = c->rw;
    pq = c->pq;
    qq = c->qq;
  }
  const int hist_len = c->hist_len;
  const bool stop = !(k < c->maxit && rw > c->tol_sq);
  if (stop) {
    grid.sync();  // every block has read the control block
    if (lead) {
      c->rz = rz;
      c->rw = rw;
      c->pq = pq;
      c->qq = qq;
      c->pending = 0;
      c->done = 1;
      if (pending && hist_len > 0)
        a.history[k < hist_len ? k : hist_len - 1] = rw;
    }
    return;
  }
  const float alpha = __fdiv_rn(rz, pq);
  const float beta =
      __fdiv_rn(__fsub_rn(__fmul_rn(__fmul_rn(alpha, alpha), qq), rz), rz);
  const float* r_in = par ? a.r1 : a.r0;
  float* r_out = par ? a.r0 : a.r1;
  const float* p_in = par ? a.p1 : a.p0;
  float* p_out = par ? a.p0 : a.p1;
  double* pa_out = a.part_a + (par ^ 1) * 2 * a.grid_a;
  double* pb_out = a.part_b + (par ^ 1) * 2 * a.grid_b;

  // The update over kernel B's partition; q = A·p from the read-only p.
  cgx::virtual_sweep<kThreads>(
      a.grid_b, n,
      [&](int row, double (&acc)[2]) {
        const float pv = __ldg(p_in + row);
        const float qv =
            cgx::stencil_row<true, kTaps>(p_in, row, a.nx, a.ny, a.nz, a.taps);
        a.x[row] = __fadd_rn(a.x[row], __fmul_rn(alpha, pv));
        const float rv = __fsub_rn(r_in[row], __fmul_rn(alpha, qv));
        r_out[row] = rv;
        p_out[row] = __fadd_rn(rv, __fmul_rn(beta, pv));
        acc[0] = __dadd_rn(acc[0], __dmul_rn(rv, rv));
      },
      [&](int vb, double (&acc)[2]) {
        const double s = cgx::block_sum<kThreads>(acc[0], smem);
        if (threadIdx.x == 0) {
          pb_out[vb] = s;
          pb_out[a.grid_b + vb] = s;
        }
      });
  grid.sync();
  if (lead) {
    c->k = k + 1;
    c->pending = 1;
    if (pending && hist_len > 0)
      a.history[k < hist_len ? k : hist_len - 1] = rw;
  }
  // The second apply over kernel A's partition: w = A·p', Σ p'·w, Σ w·w.
  // p' was written in this launch, so plain loads (the barrier orders them).
  cgx::virtual_sweep<kThreads>(
      a.grid_a, n,
      [&](int row, double (&acc)[2]) {
        const float wv = cgx::stencil_row<false, kTaps>(p_out, row, a.nx,
                                                        a.ny, a.nz, a.taps);
        const double wd = wv;
        acc[0] = __dadd_rn(acc[0],
                           __dmul_rn(wd, static_cast<double>(p_out[row])));
        acc[1] = __dadd_rn(acc[1], __dmul_rn(wd, wd));
      },
      [&](int vb, double (&acc)[2]) {
        const double s = cgx::block_sum<kThreads>(acc[0], smem);
        const double s2 = cgx::block_sum<kThreads>(acc[1], smem);
        if (threadIdx.x == 0) {
          pa_out[vb] = s;
          pa_out[a.grid_a + vb] = s2;
        }
      });
}

// The control block of the redesign: the sums of iterate k, always folded.
// Words 0-4 and 6-9 are Ctl's, so the wrapper fills and reads both alike.
struct Ctl2 {
  float rz, rw, pq, qq;  // the sums of iterate k
  int k;                 // iterations done: x, r[k&1], p[k&1] hold iterate k
  int ticket;            // blocks past the second apply in this launch
  int done;
  float tol_sq;
  int maxit;
  int hist_len;
  int pad[6];
};
static_assert(sizeof(Ctl2) == 64, "Ctl2 is 16 words");

// The update sweep's values of a row: x', r', p'.
struct Update {
  float x, r, p;
};

// 8 blocks an SM, K3's occupancy: 32 registers a thread (a few bytes
// spill at 27 taps, none at 7; nvcc -Xptxas -v).
template <int kTaps>
__global__ void __launch_bounds__(kThreads, 8) onepass2_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ double smem[kWarps + 1];
  __shared__ int last;
  Ctl2* c = reinterpret_cast<Ctl2*>(a.ctl);
  if (c->done) return;
  const int n = a.nx * a.ny * a.nz;
  const int k = c->k;
  const float rz = c->rz, rw = c->rw, pq = c->pq, qq = c->qq;
  const int hist_len = c->hist_len;
  const bool lead = blockIdx.x == 0 && threadIdx.x == 0;
  if (!(k < c->maxit && rw > c->tol_sq)) {
    // Nothing else in the control block changes in this launch.
    if (lead) c->done = 1;
    return;
  }
  const float alpha = __fdiv_rn(rz, pq);
  const float beta =
      __fdiv_rn(__fsub_rn(__fmul_rn(__fmul_rn(alpha, alpha), qq), rz), rz);
  const int par = k & 1;
  const float* r_in = par ? a.r1 : a.r0;
  float* r_out = par ? a.r0 : a.r1;
  const float* p_in = par ? a.p1 : a.p0;
  float* p_out = par ? a.p0 : a.p1;
  float* x = a.x;
  const int nx = a.nx, ny = a.ny, nz = a.nz;

  // The update over kernel B's partition; q = A·p from the read-only p.
  cgx::virtual_sweep_walk<kThreads>(
      a.grid_b, n, ny, nz,
      [&](int row, const cgx::Walk& w) {
        const float pv = __ldg(p_in + row);
        const float qv = cgx::stencil_row_at<kTaps>(
            [=](int i) { return __ldg(p_in + i); }, w, nx, ny, nz, a.taps);
        const float rv = __fsub_rn(r_in[row], __fmul_rn(alpha, qv));
        return Update{__fadd_rn(x[row], __fmul_rn(alpha, pv)), rv,
                      __fadd_rn(rv, __fmul_rn(beta, pv))};
      },
      [&](int row, const Update& v, double (&acc)[2]) {
        x[row] = v.x;
        r_out[row] = v.r;
        p_out[row] = v.p;
        acc[0] = __dadd_rn(acc[0], __dmul_rn(v.r, v.r));
      },
      [&](int vb, double (&acc)[2]) {
        const double s = cgx::block_sum<kThreads>(acc[0], smem);
        if (threadIdx.x == 0) a.part_b[vb] = s;
      });
  grid.sync();
  // Every block has read the control block: block 0 folds Σr'² (unweighted:
  // Σr'²·w is the same sum) for iterate k + 1.
  if (blockIdx.x == 0) {
    const float rz1 = static_cast<float>(
        cgx::grid_sum<kThreads>(a.part_b, a.grid_b, smem));
    if (threadIdx.x == 0) {
      c->rz = rz1;
      c->rw = rz1;
      if (hist_len > 0)
        a.history[k + 1 < hist_len ? k + 1 : hist_len - 1] = rz1;
    }
  }
  // The second apply over kernel A's partition: w = A·p', Σ p'·w, Σ w·w.
  // p' was written in this launch, so plain loads (the barrier orders them).
  cgx::virtual_sweep_walk<kThreads>(
      a.grid_a, n, ny, nz,
      [&](int row, const cgx::Walk& w) {
        return make_float2(
            cgx::stencil_row_at<kTaps>([=](int i) { return p_out[i]; }, w,
                                       nx, ny, nz, a.taps),
            p_out[row]);
      },
      [&](int, float2 v, double (&acc)[2]) {
        const double wd = v.x;
        acc[0] = __dadd_rn(acc[0], __dmul_rn(wd, static_cast<double>(v.y)));
        acc[1] = __dadd_rn(acc[1], __dmul_rn(wd, wd));
      },
      [&](int vb, double (&acc)[2]) {
        const double s = cgx::block_sum<kThreads>(acc[0], smem);
        const double s2 = cgx::block_sum<kThreads>(acc[1], smem);
        if (threadIdx.x == 0) {
          a.part_a[vb] = s;
          a.part_a[a.grid_a + vb] = s2;
        }
      });
  // The last block to get here folds p'·w and w·w and advances k.
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(&c->ticket, 1) == static_cast<int>(gridDim.x) - 1;
  }
  __syncthreads();
  if (last) {
    __threadfence();
    const float pq1 = static_cast<float>(
        cgx::grid_sum<kThreads>(a.part_a, a.grid_a, smem));
    const float qq1 = static_cast<float>(
        cgx::grid_sum<kThreads>(a.part_a + a.grid_a, a.grid_a, smem));
    if (threadIdx.x == 0) {
      c->pq = pq1;
      c->qq = qq1;
      c->k = k + 1;
      c->ticket = 0;
    }
  }
}

// design 0: the first design (the "before"); 1: the redesign.
const void* kernel_for(int ntaps, int design) {
  const bool wide = ntaps > 7;
  if (design == 0)
    return wide ? reinterpret_cast<const void*>(onepass_kernel<cgx::kMaxTaps>)
                : reinterpret_cast<const void*>(onepass_kernel<7>);
  if (design == 1)
    return wide ? reinterpret_cast<const void*>(
                      onepass2_kernel<cgx::kMaxTaps>)
                : reinterpret_cast<const void*>(onepass2_kernel<7>);
  return nullptr;
}

}  // namespace

// The cooperative grid of the instance: as many blocks as fit at once.
extern "C" int cgx_onepass_grid(int device, int ntaps, int design,
                                int* grid) {
  const void* k = kernel_for(ntaps, design);
  if (k == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return cgx::full_grid<kThreads>(device, k, grid);
}

// One iteration on `stream`.  ctl: the 16-word control block; part_a holds
// 4 × grid_a doubles, part_b 4 × grid_b (K3's kernel A and B grids).
// design: 0 the first design, 1 the redesign.
extern "C" int cgx_onepass(float* x, float* r0, float* r1, float* p0,
                           float* p1, double* part_a, int grid_a,
                           double* part_b, int grid_b, int grid, int design,
                           int* ctl, float* history, int nx, int ny, int nz,
                           int ntaps, const int* taps, const float* coeffs,
                           void* stream) {
  const void* k = kernel_for(ntaps, design);
  if (ntaps < 1 || ntaps > cgx::kMaxTaps || grid < 1 || grid_a < 1 ||
      grid_b < 1 || k == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{x,      r0,     r1,     p0, p1, part_a, part_b, grid_a, grid_b,
         reinterpret_cast<Ctl*>(ctl), history, nx, ny, nz,
         cgx::make_taps(ntaps, taps, coeffs)};
  return cgx::launch_cooperative<kThreads>(k, grid, &a, stream);
}
