// K3: the two-pass CG iteration (kernel A, kernel B).
//
// Replaces the Pallas kernels cgx/kernels/fused_engine.py:_kernel_a (q = A·p
// with the p·q and q·q partials) and :_kernel_b (α and β on the core, then
// x += αp, r −= αq, p = r + βp with Σr² and Σr²·w), which FusedCG runs once
// each per iteration under a lax.while_loop.  β comes before the update
// pass from the communication-avoiding identity ‖r'‖² = α²·q·q − rz, so the
// iteration needs two passes; Σr² is still summed from the updated r every
// iteration, so the exit test never reads the identity.
//
// On the card the loop is driven from the host, so the host must not read
// anything per iteration (a read costs more than an iteration).  The
// control state therefore lives on the device, in a small block `Ctl`, and
// both kernels keep the exact iteration count by themselves:
//
//   * kernel A's prologue folds kernel B's block partials of the previous
//     iteration (Σr², Σr²·w) into (rz, rw, k), writes the history slot,
//     and takes the exit decision k < maxit and rw > tol²;  once it is
//     taken, A and every later A and B return at once, so the host may
//     launch a chunk of iterations and read the `done` flag once per chunk;
//   * kernel B's prologue folds kernel A's block partials into p·q and q·q,
//     computes α = rz/pq and β = (α²·qq − rz)/rz, and updates x, r, p.
//
// Each prologue is computed by every block itself, from the partials in
// one fixed order and without atomics, so all blocks agree bit for bit and
// two runs are bit-identical.  The four sums are taken exactly: a product
// of two fp32 values is exact in fp64, and the sums run in fp64 (per
// thread, block tree, the fold), rounded to fp32 once.  The plain version
// does the same, so kernel and plain version differ only in the order of
// fp64 additions.  With fp32 sums, differences of 1e-7 in p·q or q·q move
// the β of the CA identity enough to shift the exit by tens of iterations
// (measured on an H100 at DIA-7 192³: 533 iterations in the kernel, 578 in
// the plain version, 541 with the kernel's partials summed another way).
//
// A kernel never reads a field of `Ctl` that it writes: kernel A's block 0
// writes the "next" fields that only kernel B reads, kernel B's block 0
// writes the "current" fields that only kernel A reads, and the kernel
// boundary orders the two.
//
// Both kernels are bound by bytes: A reads p (its neighbours from L1/L2)
// and the coefficient planes and writes q; B reads x, r, p, q (and w) and
// writes x, r, p.  That is 9 vector streams plus the planes per iteration,
// as in the Pallas engine.  Rows are a flat grid-stride loop; there is no
// halo layout (see stencil.cuh for the flat reading of plane taps).
#include <cuda_runtime.h>

#include "stencil.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// The control block: 16 int32 words in device memory (floats by bit
// pattern).  The wrapper (cgx_torch/kernels/fused_engine.py) fills words
// 0-7 before a run and reads words 0-4 after it.
struct Ctl {
  // Written by kernel B's block 0 (and the host), read by kernel A.
  float rz, rw;  // state at the start of iteration k
  int k;
  int pending;  // 1: the newest Σr², Σr²·w are still in kernel B's partials
  int done;
  // Constant during a run.
  float tol_sq;
  int maxit;
  int hist_len;
  // Written by kernel A's block 0, read by kernel B.
  float n_rz, n_rw;
  int n_k;
  int n_done;
  int pad[4];
};
static_assert(sizeof(Ctl) == 64, "Ctl is 16 words");

struct AArgs {
  const float* p;
  float* q;
  const float* planes;  // null: constant taps only
  double* part_a;        // 2 × gridDim.x: Σ p·q, Σ q·q
  const double* part_b;  // 2 × grid_b: kernel B's Σ r², Σ r²·w
  int grid_b;
  Ctl* ctl;
  float* history;  // hist_len floats, or null
  int init;        // 1: only q = A·p (the x0 start), no control state
  int nx, ny, nz;
  cgx::PlaneTaps taps;
};

template <int kTaps, bool kPlanes, bool kSym>
__global__ void __launch_bounds__(kThreads) kernel_a(AArgs a) {
  __shared__ double smem[kWarps + 1];
  if (!a.init) {
    const Ctl* c = a.ctl;
    if (c->done) return;
    float rz = c->rz;
    float rw = c->rw;
    int k = c->k;
    const bool pending = c->pending != 0;
    if (pending) {
      rz = static_cast<float>(
          cgx::grid_sum<kThreads>(a.part_b, a.grid_b, smem));
      rw = static_cast<float>(
          cgx::grid_sum<kThreads>(a.part_b + a.grid_b, a.grid_b, smem));
      ++k;
    }
    const bool stop = !(k < c->maxit && rw > c->tol_sq);
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      a.ctl->n_rz = rz;
      a.ctl->n_rw = rw;
      a.ctl->n_k = k;
      a.ctl->n_done = stop ? 1 : 0;
      if (pending && c->hist_len > 0)
        a.history[k < c->hist_len ? k : c->hist_len - 1] = rw;
    }
    if (stop) return;
  }
  const int n = a.nx * a.ny * a.nz;
  const int stride = gridDim.x * kThreads;
  double pq = 0.0, qq = 0.0;
  for (int row = blockIdx.x * kThreads + threadIdx.x; row < n;
       row += stride) {
    float qv;
    if constexpr (kPlanes) {
      qv = cgx::plane_row<true, kTaps, kSym>(a.p, a.planes, row, n, a.nx,
                                             a.ny, a.nz, a.taps);
    } else {
      qv = cgx::stencil_row<true, kTaps>(a.p, row, a.nx, a.ny, a.nz,
                                         a.taps.s);
    }
    a.q[row] = qv;
    const double qd = qv;
    pq = __dadd_rn(pq, __dmul_rn(qd, static_cast<double>(__ldg(a.p + row))));
    qq = __dadd_rn(qq, __dmul_rn(qd, qd));
  }
  pq = cgx::block_sum<kThreads>(pq, smem);
  qq = cgx::block_sum<kThreads>(qq, smem);
  if (threadIdx.x == 0) {
    a.part_a[blockIdx.x] = pq;
    a.part_a[gridDim.x + blockIdx.x] = qq;
  }
}

struct BArgs {
  float* x;
  float* r;
  float* p;
  const float* q;
  const float* w;        // null: unweighted (Σr²·w = Σr²)
  const double* part_a;  // 2 × grid_a: kernel A's Σ p·q, Σ q·q
  int grid_a;
  double* part_b;  // 2 × gridDim.x
  Ctl* ctl;
  int n;
};

template <bool kWeighted>
__global__ void __launch_bounds__(kThreads) kernel_b(BArgs a) {
  __shared__ double smem[kWarps + 1];
  Ctl* c = a.ctl;
  const bool lead = blockIdx.x == 0 && threadIdx.x == 0;
  if (c->n_done) {
    // Kernel A of this iteration took the exit: publish the final state.
    if (lead) {
      c->rz = c->n_rz;
      c->rw = c->n_rw;
      c->k = c->n_k;
      c->pending = 0;
      c->done = 1;
    }
    return;
  }
  const float rz = c->n_rz;
  const float pq =
      static_cast<float>(cgx::grid_sum<kThreads>(a.part_a, a.grid_a, smem));
  const float qq = static_cast<float>(
      cgx::grid_sum<kThreads>(a.part_a + a.grid_a, a.grid_a, smem));
  const float alpha = __fdiv_rn(rz, pq);
  const float beta = __fdiv_rn(
      __fsub_rn(__fmul_rn(__fmul_rn(alpha, alpha), qq), rz), rz);
  const int stride = gridDim.x * kThreads;
  double acc = 0.0, accw = 0.0;
  for (int row = blockIdx.x * kThreads + threadIdx.x; row < a.n;
       row += stride) {
    const float pv = a.p[row];
    a.x[row] = __fadd_rn(a.x[row], __fmul_rn(alpha, pv));
    const float rv = __fsub_rn(a.r[row], __fmul_rn(alpha, a.q[row]));
    a.r[row] = rv;
    a.p[row] = __fadd_rn(rv, __fmul_rn(beta, pv));
    const double rsq = __dmul_rn(rv, rv);
    acc = __dadd_rn(acc, rsq);
    if constexpr (kWeighted)
      accw = __dadd_rn(accw, __dmul_rn(rsq, static_cast<double>(a.w[row])));
  }
  acc = cgx::block_sum<kThreads>(acc, smem);
  if constexpr (kWeighted) {
    accw = cgx::block_sum<kThreads>(accw, smem);
  } else {
    accw = acc;
  }
  if (threadIdx.x == 0) {
    a.part_b[blockIdx.x] = acc;
    a.part_b[gridDim.x + blockIdx.x] = accw;
  }
  if (lead) {
    c->rz = rz;
    c->rw = c->n_rw;
    c->k = c->n_k;
    c->pending = 1;
    c->done = 0;
  }
}

const void* a_kernel_for(int ntaps, int variable, int sym) {
  const bool wide = ntaps > 7;
  if (!variable)
    return wide ? reinterpret_cast<const void*>(
                      kernel_a<cgx::kMaxTaps, false, false>)
                : reinterpret_cast<const void*>(kernel_a<7, false, false>);
  if (sym)
    return wide ? reinterpret_cast<const void*>(
                      kernel_a<cgx::kMaxTaps, true, true>)
                : reinterpret_cast<const void*>(kernel_a<7, true, true>);
  return wide ? reinterpret_cast<const void*>(
                    kernel_a<cgx::kMaxTaps, true, false>)
              : reinterpret_cast<const void*>(kernel_a<7, true, false>);
}

const void* b_kernel_for(int weighted) {
  return weighted ? reinterpret_cast<const void*>(kernel_b<true>)
                  : reinterpret_cast<const void*>(kernel_b<false>);
}

}  // namespace

extern "C" int cgx_fused_a_grid(int device, int ntaps, int variable, int sym,
                                int* grid) {
  return cgx::full_grid<kThreads>(device, a_kernel_for(ntaps, variable, sym),
                                  grid);
}

extern "C" int cgx_fused_b_grid(int device, int weighted, int* grid) {
  return cgx::full_grid<kThreads>(device, b_kernel_for(weighted), grid);
}

// Kernel A on `stream`.  `plane[t]` is tap t's plane index (−1: constant
// tap coeffs[t]); `planes` is null for a constant-coefficient operator.
extern "C" int cgx_fused_a(const float* p, float* q, const float* planes,
                           double* part_a, int grid_a, const double* part_b,
                           int grid_b, int* ctl, float* history, int init,
                           int nx, int ny, int nz, int ntaps,
                           const int* taps, const float* coeffs,
                           const int* plane, int sym, void* stream) {
  if (ntaps < 1 || ntaps > cgx::kMaxTaps || grid_a < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  AArgs a{p, q, planes, part_a, part_b, grid_b, reinterpret_cast<Ctl*>(ctl),
          history, init, nx, ny, nz,
          cgx::make_plane_taps(ntaps, taps, coeffs, plane, ny, nz)};
  return cgx::launch<kThreads>(a_kernel_for(ntaps, planes != nullptr, sym),
                               grid_a, &a, stream);
}

// Kernel B on `stream`; `w` is null for an unweighted solve.
extern "C" int cgx_fused_b(float* x, float* r, float* p, const float* q,
                           const float* w, const double* part_a, int grid_a,
                           double* part_b, int grid_b, int* ctl, int n,
                           void* stream) {
  if (grid_a < 1 || grid_b < 1) return static_cast<int>(cudaErrorInvalidValue);
  BArgs a{x, r, p, q, w, part_a, grid_a, part_b,
          reinterpret_cast<Ctl*>(ctl), n};
  return cgx::launch<kThreads>(b_kernel_for(w != nullptr), grid_b, &a,
                               stream);
}
