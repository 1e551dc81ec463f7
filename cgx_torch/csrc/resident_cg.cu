// K2: the whole CG solve in one launch.
//
// Replaces the Pallas kernel cgx/kernels/fused_resident.py:_kernel (entries
// resident_cg_call / resident_stencil_cg / resident_dia_cg), which keeps
// x, r, p in VMEM and runs the whole while-loop inside one pallas_call.
// It has two modes, as the Pallas kernel has:
//
//   * constant taps (two_phase_kernel over ConstRow): a constant-
//     coefficient stencil;
//   * planes/weight (two_phase_kernel over PlaneRow): a Jacobi-scaled DIA
//     operator Ã = E·A·E whose taps are coefficient planes streamed from
//     device memory, mixed with constant taps (the unit diagonal), optionally
//     symmetric (one plane per ±off pair, applied at i and mirrored at
//     i−off), with the weighted true residual Σ r̃²·w (w = diag A) as the
//     exit test while β keeps the solve-space Σ r̃².
//
// One cooperative, persistent grid (occupancy × SM count blocks) runs the
// loop; each iteration is two phases, each closed by a grid-wide barrier
// (cooperative_groups::this_grid().sync()).  β of the previous iteration is
// known when an iteration starts, and p ping-pongs between two buffers:
//
//   1'. p_new = r + β·p_old at every own row, written to the other buffer;
//       q = A·p_new, each neighbour's p_new formed on the fly from r and
//       p_old there (both stable in this phase), stored; block partials of
//       p·q;
//   2'. α = rz / p·q; x += α·p_new, r −= α·q, block partials of r·r (and of
//       r·r·w in planes mode).
//
// The first iteration takes p_new = r (p on resume) as it stands.  At the
// exit the kernel writes p = r + β·p_old into the first buffer, so the
// state it returns, (x, r, p, rz, rw), is the textbook one at an iteration
// boundary and resume works as before.
//
// The loop, α, β and the exit test (k < maxit and rw > tol²) stay on the
// device: no host synchronisation per iteration.  Every block sums the
// block partials itself, in the same fixed order and with no atomics, so
// all blocks compute bit-identical α, β and exit decisions (a block that
// left the loop alone would hang the next barrier) and two runs give
// bit-identical results.  Sums are fp32 per thread, then a block tree,
// then the fixed-order cross-block sum, as in the Pallas kernel.  Every
// product and sum is rounded on its own (__fmul_rn/__fadd_rn, never
// contracted into an FMA), as PyTorch's elementwise ops round them, so the
// kernel and its plain version differ only in the order of the sums.  A
// thread's rows are the grid-stride walk first, first + stride, …, as in
// the three-phase kernel, with the node carried (cgx::Walk) instead of two
// divisions a row; p_new and q are the three-phase kernel's values and the
// sums its sums, so at one grid the two kernels agree bit for bit: x, r,
// p, the iteration count and (rz, rw).
//
// Bound: bytes, plus 2 grid barriers an iteration.  An iteration moves 10
// vector streams (1': r, p_old in, p_new, q out; 2': x, p_new, r, q in, x,
// r out) plus in planes mode the planes (read at i and, symmetric, at
// i−off: cache hits) and w; the three-phase form moved 11.  Recomputing q
// in 2' from the complete p_new would move 8 in the constant mode, but it
// measured slower on an NVIDIA H100 80GB HBM3 at 700.00 W, at 128³ and at
// 224³ (PERF.md §6): the neighbour reads cost more than q's two streams.
//
// The three-phase kernels (resident_cg_kernel, resident_dia_kernel; 1:
// q = A·p, p·q; 2: x, r, r·r; 3: p = r + β·p, three barriers) stay as the
// same-run "before" (variant 1): no entry point of the package reaches them
// and no launch counter counts them.
//
// bf16 planes (the Pallas kernel's plane_dtype, cgx/kernels/
// fused_resident.py:149): the planes-mode kernel is a template on the plane
// type P, float or bf16, and the vectors stay fp32.  A bf16 plane value is
// widened to fp32 in a register as it is loaded (exact) and nothing else
// changes, so at one grid the bf16 mode equals the fp32 mode run on the
// planes rounded through bf16, bit for bit; it halves the plane bytes.  The
// occupancy grid is the instance's own, and the iteration's sums depend on
// the grid, so the wrapper can launch either instance at a given grid.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "stencil.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// The two-phase kernels' build knobs, by mode: rows a thread keeps in
// flight in its walks (cgx::walk_rows: their loads overlap, the sums keep
// the one-row order) and the blocks an SM must hold at once
// (__launch_bounds__, which caps a thread's registers at 40 and 32).
// Uncapped, the planes instances took so many registers that one block an
// SM fit at DIA-27; on an NVIDIA H100 80GB HBM3 at 700.00 W these settings
// were the fastest of those tried at 128³, 224³, DIA-7 192³ and DIA-27
// 128³ (PERF.md §6).
constexpr int kConstRows = 2;
constexpr int kConstMinBlocks = 6;
constexpr int kPlaneRows = 1;
constexpr int kPlaneMinBlocks = 8;

struct Args {
  float* x;
  float* r;
  float* p;         // the state's p (the first p buffer)
  float* p1;        // the second p buffer (two-phase)
  float* q;
  float* partials;  // 2 × gridDim.x
  int nx, ny, nz;
  const float* tol_sq;  // device scalar: max(tol²·‖b‖², atol²)
  int maxit;
  int resume;           // 1: continue from (x, r, p) and rz_in
  const float* rz_in;   // device (rz, rw) on resume
  int* k_out;           // device: iterations run
  float* rz_out;        // device: (rz, rw) at exit
  cgx::StencilTaps taps;
};

template <int kTaps>
__global__ void __launch_bounds__(kThreads) resident_cg_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float smem[kWarps + 1];
  const int n = a.nx * a.ny * a.nz;
  const int first = blockIdx.x * kThreads + threadIdx.x;
  const int stride = gridDim.x * kThreads;
  const int nblk = gridDim.x;
  float* part_pq = a.partials;
  float* part_rr = a.partials + nblk;

  float rz, rw;
  if (!a.resume) {
    // r0 = b − A·x0 (r holds b on entry), p0 = r0.
    float acc = 0.0f;
    for (int row = first; row < n; row += stride) {
      const float rv = __fsub_rn(
          a.r[row], cgx::stencil_row<false, kTaps>(a.x, row, a.nx, a.ny,
                                                   a.nz, a.taps));
      a.r[row] = rv;
      a.p[row] = rv;
      acc = __fadd_rn(acc, __fmul_rn(rv, rv));
    }
    const float s = cgx::block_sum<kThreads>(acc, smem);
    if (threadIdx.x == 0) part_rr[blockIdx.x] = s;
    grid.sync();
    rz = cgx::grid_sum<kThreads>(part_rr, nblk, smem);
    rw = rz;
  } else {
    rz = a.rz_in[0];
    rw = a.rz_in[1];
  }
  const float tol_sq = *a.tol_sq;

  int k = 0;
  while (k < a.maxit && rw > tol_sq) {
    // Phase 1: q = A·p, Σ p·q.
    float acc = 0.0f;
    for (int row = first; row < n; row += stride) {
      const float qv = cgx::stencil_row<false, kTaps>(a.p, row, a.nx, a.ny,
                                                      a.nz, a.taps);
      a.q[row] = qv;
      acc = __fadd_rn(acc, __fmul_rn(a.p[row], qv));
    }
    float s = cgx::block_sum<kThreads>(acc, smem);
    if (threadIdx.x == 0) part_pq[blockIdx.x] = s;
    grid.sync();
    const float alpha = rz / cgx::grid_sum<kThreads>(part_pq, nblk, smem);

    // Phase 2: x += α·p, r −= α·q, Σ r·r.
    acc = 0.0f;
    for (int row = first; row < n; row += stride) {
      a.x[row] = __fadd_rn(a.x[row], __fmul_rn(alpha, a.p[row]));
      const float rv = __fsub_rn(a.r[row], __fmul_rn(alpha, a.q[row]));
      a.r[row] = rv;
      acc = __fadd_rn(acc, __fmul_rn(rv, rv));
    }
    s = cgx::block_sum<kThreads>(acc, smem);
    if (threadIdx.x == 0) part_rr[blockIdx.x] = s;
    grid.sync();
    const float rz_new = cgx::grid_sum<kThreads>(part_rr, nblk, smem);
    const float beta = rz_new / rz;

    // Phase 3: p = r + β·p.
    for (int row = first; row < n; row += stride)
      a.p[row] = __fadd_rn(a.r[row], __fmul_rn(beta, a.p[row]));
    grid.sync();

    rz = rz_new;
    rw = rz_new;
    ++k;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *a.k_out = k;
    a.rz_out[0] = rz;
    a.rz_out[1] = rw;
  }
}

struct DiaArgs {
  float* x;
  float* r;
  float* p;   // the state's p (the first p buffer)
  float* p1;  // the second p buffer (two-phase)
  float* q;
  float* partials;      // 3 × gridDim.x
  const void* planes;   // (n_planes, n) of P
  const float* w;       // (n,) weights, or null: rw = rz
  int nx, ny, nz;
  const float* tol_sq;  // device scalar: max(tol²·Σ b²·w, atol²)
  int maxit;
  int resume;
  const float* rz_in;
  int* k_out;
  float* rz_out;
  cgx::PlaneTaps taps;
};

// Planes/weight mode.  The same three phases; phase 2 also sums r·r·w
// (rounded as (r·r)·w, as the plain version does) when w is given.
template <int kTaps, bool kSym, typename P>
__global__ void __launch_bounds__(kThreads) resident_dia_kernel(DiaArgs a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float smem[kWarps + 1];
  const P* planes = static_cast<const P*>(a.planes);
  const int n = a.nx * a.ny * a.nz;
  const int first = blockIdx.x * kThreads + threadIdx.x;
  const int stride = gridDim.x * kThreads;
  const int nblk = gridDim.x;
  const bool weighted = a.w != nullptr;
  float* part_pq = a.partials;
  float* part_rr = a.partials + nblk;
  float* part_rw = a.partials + 2 * nblk;

  // Σ r², Σ r²·w of this thread's rows into the block partials.
  auto store_sums = [&](float acc, float accw) {
    const float s = cgx::block_sum<kThreads>(acc, smem);
    const float sw = weighted ? cgx::block_sum<kThreads>(accw, smem) : s;
    if (threadIdx.x == 0) {
      part_rr[blockIdx.x] = s;
      part_rw[blockIdx.x] = sw;
    }
  };

  float rz, rw;
  if (!a.resume) {
    float acc = 0.0f, accw = 0.0f;
    for (int row = first; row < n; row += stride) {
      const float rv = __fsub_rn(
          a.r[row], cgx::plane_row<false, kTaps, kSym>(
                        a.x, planes, row, n, a.nx, a.ny, a.nz, a.taps));
      a.r[row] = rv;
      a.p[row] = rv;
      const float rsq = __fmul_rn(rv, rv);
      acc = __fadd_rn(acc, rsq);
      if (weighted) accw = __fadd_rn(accw, __fmul_rn(rsq, a.w[row]));
    }
    store_sums(acc, accw);
    grid.sync();
    rz = cgx::grid_sum<kThreads>(part_rr, nblk, smem);
    rw = weighted ? cgx::grid_sum<kThreads>(part_rw, nblk, smem) : rz;
  } else {
    rz = a.rz_in[0];
    rw = a.rz_in[1];
  }
  const float tol_sq = *a.tol_sq;

  int k = 0;
  while (k < a.maxit && rw > tol_sq) {
    // Phase 1: q = Ã·p, Σ p·q.
    float acc = 0.0f;
    for (int row = first; row < n; row += stride) {
      const float qv = cgx::plane_row<false, kTaps, kSym>(
          a.p, planes, row, n, a.nx, a.ny, a.nz, a.taps);
      a.q[row] = qv;
      acc = __fadd_rn(acc, __fmul_rn(a.p[row], qv));
    }
    const float s = cgx::block_sum<kThreads>(acc, smem);
    if (threadIdx.x == 0) part_pq[blockIdx.x] = s;
    grid.sync();
    const float alpha = rz / cgx::grid_sum<kThreads>(part_pq, nblk, smem);

    // Phase 2: x += α·p, r −= α·q, Σ r², Σ r²·w.
    acc = 0.0f;
    float accw = 0.0f;
    for (int row = first; row < n; row += stride) {
      a.x[row] = __fadd_rn(a.x[row], __fmul_rn(alpha, a.p[row]));
      const float rv = __fsub_rn(a.r[row], __fmul_rn(alpha, a.q[row]));
      a.r[row] = rv;
      const float rsq = __fmul_rn(rv, rv);
      acc = __fadd_rn(acc, rsq);
      if (weighted) accw = __fadd_rn(accw, __fmul_rn(rsq, a.w[row]));
    }
    store_sums(acc, accw);
    grid.sync();
    const float rz_new = cgx::grid_sum<kThreads>(part_rr, nblk, smem);
    const float rw_new =
        weighted ? cgx::grid_sum<kThreads>(part_rw, nblk, smem) : rz_new;
    const float beta = rz_new / rz;

    // Phase 3: p = r + β·p.
    for (int row = first; row < n; row += stride)
      a.p[row] = __fadd_rn(a.r[row], __fmul_rn(beta, a.p[row]));
    grid.sync();

    rz = rz_new;
    rw = rw_new;
    ++k;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *a.k_out = k;
    a.rz_out[0] = rz;
    a.rz_out[1] = rw;
  }
}

// -- The two-phase kernels --------------------------------------------------

// The p buffer iteration k reads (p_old) and the one it writes (p_new):
// iteration k writes buffer (k + 1) & 1 and reads buffer k & 1; iteration
// 0 reads r (p on resume) instead.  After K iterations the newest p_new is
// in buffer K & 1.  kernels/fused_resident.py `pingpong_step` and
// `pingpong_exit` mirror it.
__device__ __forceinline__ float* p_buffer(float* p, float* p1, int b) {
  return (b & 1) ? p1 : p;
}

// The exit: p = r + β·p_old into the first buffer (in place when p_old is
// it), the three-phase kernel's last phase 3; after no iteration p = r
// (p stays as given on resume).
__device__ __forceinline__ void materialise_p(float* p, float* p1,
                                              const float* r, float beta,
                                              int k, int resume, int first,
                                              int stride, int n) {
  if (k == 0) {
    if (!resume)
      for (int row = first; row < n; row += stride) p[row] = r[row];
    return;
  }
  const float* pl = p_buffer(p, p1, k);
  for (int row = first; row < n; row += stride)
    p[row] = __fadd_rn(r[row], __fmul_rn(beta, pl[row]));
}

// The operator row of each mode at a carried node, v read through ld.
template <int kTaps>
struct ConstRow {
  template <typename Load>
  __device__ __forceinline__ static float at(const Args& a, Load ld, int,
                                             const cgx::Walk& w, int) {
    return cgx::stencil_row_at<kTaps>(ld, w, a.nx, a.ny, a.nz, a.taps);
  }
};

template <int kTaps, bool kSym, typename P>
struct PlaneRow {
  template <typename Load>
  __device__ __forceinline__ static float at(const DiaArgs& a, Load ld,
                                             int row, const cgx::Walk& w,
                                             int n) {
    return cgx::plane_row_at<kTaps, kSym>(ld, static_cast<const P*>(a.planes),
                                          row, w, n, a.nx, a.ny, a.nz,
                                          a.taps);
  }
};

// The exit test's weights: none in the constant mode (rw = rz).
__device__ __forceinline__ const float* weights(const Args&) {
  return nullptr;
}
__device__ __forceinline__ const float* weights(const DiaArgs& a) {
  return a.w;
}

// Phase 1': p_new at every own row into pnew, q = A·p_new into q, with
// each neighbour's p_new formed from r and p_old there; the thread's
// Σ p·q.  kDirect: p_new = p_old (the first iteration).
template <typename Row, int kRows, bool kDirect, typename A>
__device__ __forceinline__ float phase1(const A& a, const float* pold,
                                        float* pnew, float beta, int first,
                                        int stride, int n) {
  const float* r = a.r;
  float* q = a.q;
  auto pn = [=](int idx) {
    if constexpr (kDirect) {
      return pold[idx];
    } else {
      return __fadd_rn(r[idx], __fmul_rn(beta, pold[idx]));
    }
  };
  float acc = 0.0f;
  cgx::walk_rows<kRows>(
      first, stride, n, a.ny, a.nz,
      [&](int row, const cgx::Walk& w) {
        return make_float2(pn(row), Row::at(a, pn, row, w, n));
      },
      [&](int row, float2 v) {
        pnew[row] = v.x;
        q[row] = v.y;
        acc = __fadd_rn(acc, __fmul_rn(v.x, v.y));
      });
  return acc;
}

// A row's values in phase 2': x', r' and the row's weight.
struct Update {
  float x, r, w;
};

// Both modes: A is Args (constant taps, Row = ConstRow) or DiaArgs
// (planes, Row = PlaneRow).  The weighted mode also sums r·r·w (rounded as
// (r·r)·w, as the plain version does).  kRows and kMinBlocks are the
// mode's build knobs (above).
template <typename Row, int kRows, int kMinBlocks, typename A>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    two_phase_kernel(A a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float smem[kWarps + 1];
  const int n = a.nx * a.ny * a.nz;
  const int first = blockIdx.x * kThreads + threadIdx.x;
  const int stride = gridDim.x * kThreads;
  const int nblk = gridDim.x;
  const float* wt = weights(a);
  const bool weighted = wt != nullptr;
  float* part_pq = a.partials;
  float* part_rr = a.partials + nblk;
  float* part_rw = a.partials + 2 * nblk;  // weighted only
  float* x = a.x;
  float* r = a.r;

  // Σ r², Σ r²·w of this thread's rows into the block partials.
  auto store_sums = [&](float acc, float accw) {
    const float s = cgx::block_sum<kThreads>(acc, smem);
    const float sw = weighted ? cgx::block_sum<kThreads>(accw, smem) : s;
    if (threadIdx.x == 0) {
      part_rr[blockIdx.x] = s;
      if (weighted) part_rw[blockIdx.x] = sw;
    }
  };
  auto use_sums = [&](float& acc, float& accw, float rv, float wv) {
    const float rsq = __fmul_rn(rv, rv);
    acc = __fadd_rn(acc, rsq);
    if (weighted) accw = __fadd_rn(accw, __fmul_rn(rsq, wv));
  };

  float rz, rw;
  if (!a.resume) {
    // r0 = b − A·x0 (r holds b on entry).
    float acc = 0.0f, accw = 0.0f;
    cgx::walk_rows<kRows>(
        first, stride, n, a.ny, a.nz,
        [&](int row, const cgx::Walk& w) {
          return make_float2(
              __fsub_rn(r[row],
                        Row::at(a, [=](int i) { return x[i]; }, row, w, n)),
              weighted ? wt[row] : 0.0f);
        },
        [&](int row, float2 v) {
          r[row] = v.x;
          use_sums(acc, accw, v.x, v.y);
        });
    store_sums(acc, accw);
    grid.sync();
    rz = cgx::grid_sum<kThreads>(part_rr, nblk, smem);
    rw = weighted ? cgx::grid_sum<kThreads>(part_rw, nblk, smem) : rz;
  } else {
    rz = a.rz_in[0];
    rw = a.rz_in[1];
  }
  const float tol_sq = *a.tol_sq;

  int k = 0;
  float beta = 0.0f;
  while (k < a.maxit && rw > tol_sq) {
    // Phase 1': p_new = r + β·p_old, q = A·p_new, Σ p·q.
    float* pnew = p_buffer(a.p, a.p1, k + 1);
    const float acc1 =
        k == 0 ? phase1<Row, kRows, true>(a, a.resume ? a.p : r, pnew, beta,
                                          first, stride, n)
               : phase1<Row, kRows, false>(a, p_buffer(a.p, a.p1, k), pnew,
                                           beta, first, stride, n);
    const float s = cgx::block_sum<kThreads>(acc1, smem);
    if (threadIdx.x == 0) part_pq[blockIdx.x] = s;
    grid.sync();
    const float alpha = rz / cgx::grid_sum<kThreads>(part_pq, nblk, smem);

    // Phase 2': x += α·p_new, r −= α·q, Σ r², Σ r²·w.
    const float* pc = pnew;
    const float* q = a.q;
    float acc = 0.0f, accw = 0.0f;
    cgx::walk_rows<kRows>(
        first, stride, n, a.ny, a.nz,
        [&](int row, const cgx::Walk&) {
          return Update{__fadd_rn(x[row], __fmul_rn(alpha, pc[row])),
                        __fsub_rn(r[row], __fmul_rn(alpha, q[row])),
                        weighted ? wt[row] : 0.0f};
        },
        [&](int row, Update v) {
          x[row] = v.x;
          r[row] = v.r;
          use_sums(acc, accw, v.r, v.w);
        });
    store_sums(acc, accw);
    grid.sync();
    const float rz_new = cgx::grid_sum<kThreads>(part_rr, nblk, smem);
    const float rw_new =
        weighted ? cgx::grid_sum<kThreads>(part_rw, nblk, smem) : rz_new;
    beta = rz_new / rz;
    rz = rz_new;
    rw = rw_new;
    ++k;
  }
  materialise_p(a.p, a.p1, r, beta, k, a.resume, first, stride, n);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *a.k_out = k;
    a.rz_out[0] = rz;
    a.rz_out[1] = rw;
  }
}

// The instantiation for an operator of `ntaps` taps; variant 0 is the
// two-phase kernel, 1 the three-phase "before".
template <int kTaps>
const void* const_instance(int variant) {
  return variant == 1
             ? reinterpret_cast<const void*>(resident_cg_kernel<kTaps>)
             : reinterpret_cast<const void*>(
                   two_phase_kernel<ConstRow<kTaps>, kConstRows,
                                    kConstMinBlocks, Args>);
}

const void* kernel_for(int ntaps, int variant) {
  return ntaps <= 7 ? const_instance<7>(variant)
                    : const_instance<cgx::kMaxTaps>(variant);
}

template <int kTaps, bool kSym, typename P>
const void* dia_instance(int variant) {
  return variant == 1
             ? reinterpret_cast<const void*>(
                   resident_dia_kernel<kTaps, kSym, P>)
             : reinterpret_cast<const void*>(
                   two_phase_kernel<PlaneRow<kTaps, kSym, P>, kPlaneRows,
                                    kPlaneMinBlocks, DiaArgs>);
}

template <typename P>
const void* dia_kernel_typed(int ntaps, int sym, int variant) {
  if (ntaps <= 7)
    return sym ? dia_instance<7, true, P>(variant)
               : dia_instance<7, false, P>(variant);
  return sym ? dia_instance<cgx::kMaxTaps, true, P>(variant)
             : dia_instance<cgx::kMaxTaps, false, P>(variant);
}

const void* dia_kernel_for(int ntaps, int sym, int plane_bf16, int variant) {
  return plane_bf16 ? dia_kernel_typed<__nv_bfloat16>(ntaps, sym, variant)
                    : dia_kernel_typed<float>(ntaps, sym, variant);
}

bool valid_variant(int variant) { return variant == 0 || variant == 1; }

}  // namespace

// The cooperative grid for `ntaps` taps: as many blocks as can be
// co-resident.
extern "C" int cgx_resident_cg_grid(int device, int ntaps, int variant,
                                    int* grid) {
  if (!valid_variant(variant)) return static_cast<int>(cudaErrorInvalidValue);
  return cgx::full_grid<kThreads>(device, kernel_for(ntaps, variant), grid);
}

// Launches on `stream`; returns the launch's error (a grid larger than the
// co-resident capacity is refused here, never retried smaller).  Both
// variants take q; variant 0 (two-phase) also the second p buffer p1.
extern "C" int cgx_resident_cg(float* x, float* r, float* p, float* p1,
                               float* q, float* partials, int grid, int nx,
                               int ny, int nz, int ntaps, const int* taps,
                               const float* coeffs, const float* tol_sq,
                               int maxit, int resume, const float* rz_in,
                               int* k_out, float* rz_out, int variant,
                               void* stream) {
  if (ntaps < 1 || ntaps > cgx::kMaxTaps || grid < 1 ||
      !valid_variant(variant) || q == nullptr ||
      (variant == 0 && p1 == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{x,     r,      p,     p1,    q,     partials, nx, ny, nz,
         tol_sq, maxit, resume, rz_in, k_out, rz_out,
         cgx::make_taps(ntaps, taps, coeffs)};
  return cgx::launch_cooperative<kThreads>(kernel_for(ntaps, variant), grid,
                                           &a, stream);
}

extern "C" int cgx_resident_dia_cg_grid(int device, int ntaps, int sym,
                                        int plane_bf16, int variant,
                                        int* grid) {
  if (!valid_variant(variant)) return static_cast<int>(cudaErrorInvalidValue);
  return cgx::full_grid<kThreads>(
      device, dia_kernel_for(ntaps, sym, plane_bf16, variant), grid);
}

// Planes/weight mode.  `plane[t]` is tap t's plane index (−1: constant tap
// coeffs[t]); `planes` holds bf16 when plane_bf16; `w` may be null
// (unweighted).  partials: 3 × grid floats.  Both variants take q; the
// two-phase one also p1.
extern "C" int cgx_resident_dia_cg(
    float* x, float* r, float* p, float* p1, float* q, float* partials,
    int grid, int nx, int ny, int nz, int ntaps, const int* taps,
    const float* coeffs, const int* plane, const void* planes, const float* w,
    int sym, int plane_bf16, const float* tol_sq, int maxit, int resume,
    const float* rz_in, int* k_out, float* rz_out, int variant,
    void* stream) {
  if (ntaps < 1 || ntaps > cgx::kMaxTaps || grid < 1 ||
      !valid_variant(variant) || q == nullptr ||
      (variant == 0 && p1 == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  DiaArgs a{x, r, p, p1, q, partials, planes, w, nx, ny, nz, tol_sq, maxit,
            resume, rz_in, k_out, rz_out,
            cgx::make_plane_taps(ntaps, taps, coeffs, plane, ny, nz)};
  return cgx::launch_cooperative<kThreads>(
      dia_kernel_for(ntaps, sym, plane_bf16, variant), grid, &a, stream);
}
