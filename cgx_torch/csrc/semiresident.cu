// K4: the semi-resident whole-solve CG, one cooperative launch per solve.
//
// Replaces the Pallas kernel cgx/kernels/fused_semiresident.py:_kernel
// (entries sr_cg_call / sr_stencil_cg / sr_dia_cg), which runs the whole
// PCG loop in one pallas_call with some of r, p, q pinned in VMEM (the
// residency tiers) and the rest streamed.  Its algebra is the two-pass
// engine's (K3, fused_engine.cu), and so is this kernel's:
//
//   init    rz, rw of the start state (from the wrapper), then a gram sweep
//   loop    α = rz/pq, β = (α²·qq − rz)/rz   (the CA identity)
//           update sweep: x += αp, r' = r − αq, p' = r' + βp, Σr'², Σr'²·w
//           exit test k < maxit and Σr'²·w > tol²
//           gram sweep: pq = p'·Ap', qq = ‖Ap'‖²
//
// with one grid-wide barrier after each sweep: the loop, α, β and the exit
// test stay on the device, as in the whole-solve kernel K2 (resident_cg.cu).
//
// The tiers.  On the TPU a tier is a placement in VMEM.  Underneath it is a
// choice of what the iteration stores:
//   * rpq stores q = A·p in the gram sweep and reads it in the update sweep
//     (one operator apply per iteration; 9 vector streams);
//   * rp and p never store q: the update sweep recomputes q = A·p_old (two
//     applies per iteration; 7 streams).
// Here every vector lives in device memory and the card's L2 caches what
// fits (the tier plan in fused_semiresident.py asks whether the tier's
// resident vectors fit the L2); rp and p run the same code and differ only
// in that plan.  The TPU sweep updates p in place block after block with a
// rolling strip of old values at each block's left margin; on the card the
// blocks run at once, so an in-place p update would race with a neighbour
// block still reading p_old at its halo.  rp and p therefore keep two p
// buffers and swap them each iteration (the barrier after the update sweep
// orders the swap); at the exit the newest p is copied into the first.  rpq
// updates p in place: its update sweep reads no neighbours.
//
// Sums.  The four sums are taken exactly, as K3 takes them: fp64 products
// of fp32 values, fp64 sums, rounded to fp32 once.  More than that, they
// are taken over K3's own partition (virtual_sweep in stencil.cuh): the
// gram sweep over kernel A's grid, the update sweep over kernel B's, each
// with K3's per-thread order and block tree, and each fold (grid_sum) as
// K3 folds.  Every product and update is rounded on its own as in K3.  So
// this kernel equals K3's solve bit for bit — x, r, p, the iteration count
// and the sums — in every tier and for any grid of its own.  The wrapper
// passes K3's grids (fused_engine.FusedCG.grids).
//
// Operators: constant taps (a stencil; stencil_row), or coefficient planes
// mixed with constant taps (the Jacobi-scaled DIA operator; plane_row),
// planes fp32 or bf16 (P, widened as loaded), optionally symmetric (each
// plane also at its mirror tap), with the weight w of the exit test.  The
// rp and p tiers read the planes twice per iteration, as the Pallas kernel
// does (cgx/kernels/fused_semiresident.py:390-394).
//
// Bound: bytes.  Per iteration rpq reads p (neighbours from L1/L2) and
// writes q, then reads x, r, p, q and writes x, r, p: 9 streams, plus the
// planes and w.  rp and p read p (gram) and x, r, p_old, writing x, r,
// p_new: 7 streams, plus the planes twice.  Nothing of the TPU's VMEM
// placement is carried over; keeping the resident vectors in shared memory
// or the L2 on purpose is later work.
//
// The redesign (sr2_kernel; the first design, sr_kernel, stays as the
// same-run "before", design 0 of the C entries, reached by no entry point
// of the package).  The first design lost to the two-phase whole solve K2
// in every tier while moving fewer streams (9 or 7 against K2's 10):
//
//   * every block re-summed all of the other sweep's partials after each
//     barrier (grid_sum over ~1,056 doubles, twice, in each of ~1,056
//     blocks).  Now the block that reaches a sweep's barrier last folds
//     them, both arrays in one pass, in grid_sum's fixed order and
//     publishes the two floats in a control block in device memory before
//     it releases the others (cgx::barrier_fold: the arrival count is the
//     ticket): (pq, qq) after the gram sweep, (rz, rw) after the update;
//     every block reads two floats after the barrier;
//   * each row's node came from two integer divisions and a thread had one
//     row in flight.  Now a stencil's rows carry their node (cgx::Walk,
//     stencil_row_at), and a 27-tap operator's gram sweep keeps two of a
//     thread's rows in flight (virtual_sweep_rows), plane operators there
//     at the carried node (plane_row_at, not carried where no constant tap
//     off the centre reads it); their sums are added in row order, so K3's
//     partition and order, and with them every bit, are unchanged.  At 7
//     taps a second row or a carried node spilled at 32 registers and lost
//     on the H100, so a thread takes one row a step and a plane operator
//     reads flat (plane_row).  The update sweep loads all of a row's
//     vectors before it stores any.  p is written in the kernel, so it is
//     read with plain loads; the planes, which nothing writes, through the
//     read-only path;
//   * the kernel had no blocks-an-SM floor and the grid was whatever fit.
//     Now it holds K3's first kernel A's occupancy (8 blocks an SM at 7
//     taps, 4 at 27), and the wrapper picks a grid that divides K3's grids
//     where it can (fused_onepass.launch_grid), so blocks sweep as many
//     virtual blocks as each other.
//
// Plane operators of at most 7 taps in the rpq tier still run the first
// design: there the redesign measured 1.012–1.019× its time on the H100
// (fused_semiresident._design_for; PERF.md §6).
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "stencil.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// The redesign's control block (8 words in device memory, zero before a
// launch): the sums folded at each sweep's barrier, and the barrier.
struct Ctl {
  float pq, qq;        // after the gram sweep
  float rz, rw;        // after the update sweep
  unsigned int count;  // blocks at the current barrier (0 between them)
  unsigned int gen;    // barriers passed
  int pad[2];
};
static_assert(sizeof(Ctl) == 32, "Ctl is 8 words");

struct Args {
  float* x;
  float* r;
  float* p;
  float* p_alt;         // rp / p tiers: the second p buffer; rpq: null
  float* q;             // rpq: q = A·p; rp / p: null
  const void* planes;   // (n_planes, n) of P; null: constant taps only
  const float* w;       // (n,) weights of the exit test; null: rw = rz
  double* part_a;       // 2 × grid_a: Σ p·q, Σ q·q over kernel A's grid
  double* part_b;       // 2 × grid_b: Σ r², Σ r²·w over kernel B's grid
  int grid_a, grid_b;
  int nx, ny, nz;
  const float* tol_sq;  // device scalar
  int maxit;
  const float* rz_in;   // device (rz, rw) of the start state
  int* k_out;           // device: iterations run
  float* rz_out;        // device: (rz, rw) at the exit
  cgx::PlaneTaps taps;
  Ctl* ctl;             // the redesign's control block; design 0: null
};

// One operator row of v: K3 kernel A's reader for the same operator.
template <int kTaps, bool kPlanes, bool kSym, typename P>
__device__ __forceinline__ float op_row(const Args& a, const float* v,
                                        int row, int n) {
  if constexpr (kPlanes) {
    return cgx::plane_row<false, kTaps, kSym>(
        v, static_cast<const P*>(a.planes), row, n, a.nx, a.ny, a.nz,
        a.taps);
  } else {
    return cgx::stencil_row<false, kTaps>(v, row, a.nx, a.ny, a.nz,
                                          a.taps.s);
  }
}

template <int kTaps, bool kPlanes, bool kSym, bool kRemat, typename P>
__global__ void __launch_bounds__(kThreads) sr_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ double smem[kWarps + 1];
  const int n = a.nx * a.ny * a.nz;
  const bool weighted = a.w != nullptr;
  float* p = a.p;
  float* p_new = kRemat ? a.p_alt : a.p;

  // Gram sweep over kernel A's partition: q = A·p (stored by rpq), Σ p·q,
  // Σ q·q, as kernel A rounds and sums them.
  auto gram = [&]() {
    cgx::virtual_sweep<kThreads>(
        a.grid_a, n,
        [&](int row, double (&acc)[2]) {
          const float qv = op_row<kTaps, kPlanes, kSym, P>(a, p, row, n);
          if constexpr (!kRemat) a.q[row] = qv;
          const double qd = qv;
          acc[0] = __dadd_rn(acc[0], __dmul_rn(qd, static_cast<double>(p[row])));
          acc[1] = __dadd_rn(acc[1], __dmul_rn(qd, qd));
        },
        [&](int vb, double (&acc)[2]) {
          const double pq = cgx::block_sum<kThreads>(acc[0], smem);
          const double qq = cgx::block_sum<kThreads>(acc[1], smem);
          if (threadIdx.x == 0) {
            a.part_a[vb] = pq;
            a.part_a[a.grid_a + vb] = qq;
          }
        });
  };

  // Update sweep over kernel B's partition, as kernel B rounds and sums.
  // rp / p recompute q = A·p_old from the old buffer and write the other.
  auto update = [&](float alpha, float beta) {
    cgx::virtual_sweep<kThreads>(
        a.grid_b, n,
        [&](int row, double (&acc)[2]) {
          const float pv = p[row];
          float qv;
          if constexpr (kRemat) {
            qv = op_row<kTaps, kPlanes, kSym, P>(a, p, row, n);
          } else {
            qv = a.q[row];
          }
          a.x[row] = __fadd_rn(a.x[row], __fmul_rn(alpha, pv));
          const float rv = __fsub_rn(a.r[row], __fmul_rn(alpha, qv));
          a.r[row] = rv;
          p_new[row] = __fadd_rn(rv, __fmul_rn(beta, pv));
          const double rsq = __dmul_rn(rv, rv);
          acc[0] = __dadd_rn(acc[0], rsq);
          if (weighted)
            acc[1] = __dadd_rn(acc[1],
                               __dmul_rn(rsq, static_cast<double>(a.w[row])));
        },
        [&](int vb, double (&acc)[2]) {
          const double s = cgx::block_sum<kThreads>(acc[0], smem);
          const double sw =
              weighted ? cgx::block_sum<kThreads>(acc[1], smem) : s;
          if (threadIdx.x == 0) {
            a.part_b[vb] = s;
            a.part_b[a.grid_b + vb] = sw;
          }
        });
  };

  float rz = a.rz_in[0];
  float rw = a.rz_in[1];
  const float tol_sq = *a.tol_sq;
  int k = 0;
  if (k < a.maxit && rw > tol_sq) {
    gram();
    grid.sync();
    float pq = static_cast<float>(
        cgx::grid_sum<kThreads>(a.part_a, a.grid_a, smem));
    float qq = static_cast<float>(
        cgx::grid_sum<kThreads>(a.part_a + a.grid_a, a.grid_a, smem));
    while (true) {
      const float alpha = __fdiv_rn(rz, pq);
      const float beta = __fdiv_rn(
          __fsub_rn(__fmul_rn(__fmul_rn(alpha, alpha), qq), rz), rz);
      update(alpha, beta);
      grid.sync();
      rz = static_cast<float>(
          cgx::grid_sum<kThreads>(a.part_b, a.grid_b, smem));
      rw = static_cast<float>(
          cgx::grid_sum<kThreads>(a.part_b + a.grid_b, a.grid_b, smem));
      ++k;
      if constexpr (kRemat) {
        float* t = p;
        p = p_new;
        p_new = t;
      }
      if (!(k < a.maxit && rw > tol_sq)) break;
      gram();
      grid.sync();
      pq = static_cast<float>(
          cgx::grid_sum<kThreads>(a.part_a, a.grid_a, smem));
      qq = static_cast<float>(
          cgx::grid_sum<kThreads>(a.part_a + a.grid_a, a.grid_a, smem));
    }
  }
  if constexpr (kRemat) {
    // The newest p into the first buffer (after the last barrier nothing
    // reads either buffer).
    if (p != a.p) {
      for (int row = blockIdx.x * kThreads + threadIdx.x; row < n;
           row += gridDim.x * kThreads)
        a.p[row] = p[row];
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *a.k_out = k;
    a.rz_out[0] = rz;
    a.rz_out[1] = rw;
  }
}

// -- The redesign ------------------------------------------------------------

// The redesign's build knobs, by the operator's taps, picked on the H100
// (PERF.md §6): the blocks an SM the kernel is held to (K3's first
// kernel A's occupancy: 32 or 64 registers a thread); rows of a thread in
// flight in the gram sweep (the update sweep keeps one); whether a plane
// operator carries the node (else it reads flat, dividing only at a
// constant tap off the centre, as the first design).  At 7 taps a second
// row or a carried node spilled at 32 registers and lost.
template <int kTaps>
constexpr int kSr2Blocks = kTaps > 7 ? 4 : 8;
template <int kTaps>
constexpr int kGramRows = kTaps > 7 ? 2 : 1;
template <int kTaps>
constexpr bool kCarryPlanes = kTaps > 7;

template <int kTaps, bool kPlanes, bool kSym, bool kRemat, typename P>
__global__ void __launch_bounds__(kThreads, kSr2Blocks<kTaps>)
    sr2_kernel(Args a) {
  __shared__ double smem[2 * (kWarps + 1)];
  const int nx = a.nx, ny = a.ny, nz = a.nz;
  const int n = nx * ny * nz;
  const int ga = a.grid_a, gb = a.grid_b;
  const int u = threadIdx.x;
  const bool weighted = a.w != nullptr;
  Ctl* c = a.ctl;
  float* p = a.p;
  float* p_new = kRemat ? a.p_alt : a.p;
  // The node is read only by constant taps off the centre (the plane taps
  // guard by flat index): without them the walk is not carried.
  bool walk = !kPlanes;
  for (int t = 0; t < a.taps.s.n; ++t)
    walk = walk || (a.taps.plane[t] < 0 &&
                    (a.taps.s.dx[t] | a.taps.s.dy[t] | a.taps.s.dz[t]) != 0);
  if (kPlanes && !kCarryPlanes<kTaps>) walk = false;
  // A row of A·v, v read with plain loads (v is written in this kernel),
  // the planes through the read-only path.
  const auto apply = [&](const float* v, int row, const cgx::Walk& w) {
    const auto ld = [=](int i) { return v[i]; };
    if constexpr (kPlanes && kCarryPlanes<kTaps>) {
      return cgx::plane_row_at<kTaps, kSym>(ld, static_cast<const P*>(a.planes),
                                            row, w, n, nx, ny, nz, a.taps);
    } else if constexpr (kPlanes) {
      return cgx::plane_row<false, kTaps, kSym, float, P, true>(
          v, static_cast<const P*>(a.planes), row, n, nx, ny, nz, a.taps);
    } else {
      return cgx::stencil_row_at<kTaps>(ld, w, nx, ny, nz, a.taps.s);
    }
  };
  // A sweep ends at a grid-wide barrier whose last arriving block folds
  // the sweep's g partials (two arrays) in grid_sum's order and publishes
  // the two floats before it releases the others.
  const auto barrier = [&](const double* part, int g, float* out) {
    cgx::barrier_fold(&c->count, &c->gen, [&]() {
      double s0, s1;
      cgx::grid_sum2<kThreads>(part, g, s0, s1, smem);
      if (u == 0) {
        out[0] = static_cast<float>(s0);
        out[1] = static_cast<float>(s1);
      }
    });
    return make_float2(__ldcg(out), __ldcg(out + 1));
  };

  // Gram sweep over kernel A's partition: q = A·p (stored by rpq), Σ p·q,
  // Σ q·q, as kernel A rounds and sums them.
  auto gram = [&]() {
    cgx::virtual_sweep_rows<kThreads, kGramRows<kTaps>>(
        ga, n, ny, nz, walk,
        [&](int row, const cgx::Walk& w) {
          return make_float2(apply(p, row, w), p[row]);
        },
        [&](int row, float2 v, double (&acc)[2]) {
          if constexpr (!kRemat) a.q[row] = v.x;
          const double qd = v.x;
          acc[0] = __dadd_rn(acc[0], __dmul_rn(qd, static_cast<double>(v.y)));
          acc[1] = __dadd_rn(acc[1], __dmul_rn(qd, qd));
        },
        [&](int vb, double (&acc)[2]) {
          cgx::block_sum2<kThreads>(acc[0], acc[1], smem);
          if (u == 0) {
            a.part_a[vb] = acc[0];
            a.part_a[ga + vb] = acc[1];
          }
        });
    return barrier(a.part_a, ga, &c->pq);
  };

  // Update sweep over kernel B's partition, as kernel B rounds and sums.
  // rp / p recompute q = A·p_old from the old buffer and write the other.
  struct Row {
    cgx::Updated<float> v;
    float w;
  };
  auto update = [&](float alpha, float beta) {
    const auto store = [&](int vb, double (&acc)[2]) {
      if (weighted) {
        cgx::block_sum2<kThreads>(acc[0], acc[1], smem);
      } else {
        acc[0] = acc[1] = cgx::block_sum<kThreads>(acc[0], smem);
      }
      if (u == 0) {
        a.part_b[vb] = acc[0];
        a.part_b[gb + vb] = acc[1];
      }
    };
    cgx::virtual_sweep_rows<kThreads, 1>(
        gb, n, ny, nz, kRemat && walk,
        [&](int row, const cgx::Walk& w) {
          const float pv = p[row];
          float qv;
          if constexpr (kRemat) {
            qv = apply(p, row, w);
          } else {
            qv = a.q[row];
          }
          return Row{cgx::cg_update<float>(a.x[row], a.r[row], pv, qv, alpha,
                                           beta),
                     weighted ? a.w[row] : 0.0f};
        },
        [&](int row, const Row& v, double (&acc)[2]) {
          a.x[row] = v.v.x;
          a.r[row] = v.v.r;
          p_new[row] = v.v.p;
          const double rsq = __dmul_rn(v.v.r, v.v.r);
          acc[0] = __dadd_rn(acc[0], rsq);
          if (weighted)
            acc[1] = __dadd_rn(acc[1], __dmul_rn(rsq, static_cast<double>(v.w)));
        },
        store);
    return barrier(a.part_b, gb, &c->rz);
  };

  float rz = a.rz_in[0];
  float rw = a.rz_in[1];
  const float tol_sq = *a.tol_sq;
  int k = 0;
  if (k < a.maxit && rw > tol_sq) {
    float2 s = gram();
    while (true) {
      const float pq = s.x, qq = s.y;
      const float alpha = __fdiv_rn(rz, pq);
      const float beta = __fdiv_rn(
          __fsub_rn(__fmul_rn(__fmul_rn(alpha, alpha), qq), rz), rz);
      // A control word is written again only at its sweep's next barrier,
      // which no block reaches before it has read the word.
      s = update(alpha, beta);
      rz = s.x;
      rw = s.y;
      ++k;
      if constexpr (kRemat) {
        float* t = p;
        p = p_new;
        p_new = t;
      }
      if (!(k < a.maxit && rw > tol_sq)) break;
      s = gram();
    }
  }
  if constexpr (kRemat) {
    // The newest p into the first buffer (after the last barrier nothing
    // reads either buffer).
    if (p != a.p) {
      for (int row = blockIdx.x * kThreads + u; row < n;
           row += gridDim.x * kThreads)
        a.p[row] = p[row];
    }
  }
  if (blockIdx.x == 0 && u == 0) {
    *a.k_out = k;
    a.rz_out[0] = rz;
    a.rz_out[1] = rw;
  }
}

// design 0: the first design (sr_kernel); 1: the redesign (sr2_kernel).
#define CGX_SR(T, PL, SY, RE, P)                                          \
  (design ? reinterpret_cast<const void*>(sr2_kernel<T, PL, SY, RE, P>)   \
          : reinterpret_cast<const void*>(sr_kernel<T, PL, SY, RE, P>))

template <int kTaps, bool kRemat>
const void* planes_kernel(int sym, int plane_bf16, int design) {
  using bf16 = __nv_bfloat16;
  if (plane_bf16)
    return sym ? CGX_SR(kTaps, true, true, kRemat, bf16)
               : CGX_SR(kTaps, true, false, kRemat, bf16);
  return sym ? CGX_SR(kTaps, true, true, kRemat, float)
             : CGX_SR(kTaps, true, false, kRemat, float);
}

template <bool kRemat>
const void* kernel_remat(int ntaps, int variable, int sym, int plane_bf16,
                         int design) {
  const bool wide = ntaps > 7;
  if (!variable)
    return wide ? CGX_SR(cgx::kMaxTaps, false, false, kRemat, float)
                : CGX_SR(7, false, false, kRemat, float);
  return wide ? planes_kernel<cgx::kMaxTaps, kRemat>(sym, plane_bf16, design)
              : planes_kernel<7, kRemat>(sym, plane_bf16, design);
}

#undef CGX_SR

// The instance for the operator, the plane type, the tier (remat: rp or
// p, which never store q) and the design; null for an unknown design.
const void* kernel_for(int ntaps, int variable, int sym, int plane_bf16,
                       int remat, int design) {
  if (design != 0 && design != 1) return nullptr;
  return remat ? kernel_remat<true>(ntaps, variable, sym, plane_bf16, design)
               : kernel_remat<false>(ntaps, variable, sym, plane_bf16,
                                     design);
}

}  // namespace

// The cooperative grid of the instance: as many blocks as fit at once.
extern "C" int cgx_sr_grid(int device, int ntaps, int variable, int sym,
                           int plane_bf16, int remat, int design, int* grid) {
  const void* k = kernel_for(ntaps, variable, sym, plane_bf16, remat, design);
  if (k == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return cgx::full_grid<kThreads>(device, k, grid);
}

// One solve on `stream`.  `plane[t]` is tap t's plane index (−1: constant
// tap coeffs[t]); `planes` is null for a constant-coefficient operator and
// holds bf16 when plane_bf16; `w` may be null.  remat = 0 (rpq) needs q,
// remat = 1 (rp, p) needs p_alt.  grid_a and grid_b are K3's kernel A and
// B grids: the partition of the sums.  design 0: the first design; 1: the
// redesign, which needs `ctl` (8 words, zero).
extern "C" int cgx_sr_cg(float* x, float* r, float* p, float* p_alt,
                         float* q, const void* planes, const float* w,
                         double* part_a, int grid_a, double* part_b,
                         int grid_b, int grid, int nx, int ny, int nz,
                         int ntaps, const int* taps, const float* coeffs,
                         const int* plane, int sym, int plane_bf16,
                         int remat, const float* tol_sq, int maxit,
                         const float* rz_in, int* k_out, float* rz_out,
                         int* ctl, int design, void* stream) {
  const void* k =
      kernel_for(ntaps, planes != nullptr, sym, plane_bf16, remat, design);
  if (ntaps < 1 || ntaps > cgx::kMaxTaps || grid < 1 || grid_a < 1 ||
      grid_b < 1 || (remat ? p_alt == nullptr : q == nullptr) ||
      k == nullptr || (design == 1 && ctl == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{x,      r,      p,      p_alt,  q,     planes, w,     part_a,
         part_b, grid_a, grid_b, nx,     ny,    nz,     tol_sq, maxit,
         rz_in,  k_out,  rz_out,
         cgx::make_plane_taps(ntaps, taps, coeffs, plane, ny, nz),
         reinterpret_cast<Ctl*>(ctl)};
  return cgx::launch_cooperative<kThreads>(k, grid, &a, stream);
}
