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
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "stencil.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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

template <int kTaps, bool kRemat>
const void* planes_kernel(int sym, int plane_bf16) {
  using bf16 = __nv_bfloat16;
  if (plane_bf16)
    return sym ? reinterpret_cast<const void*>(
                     sr_kernel<kTaps, true, true, kRemat, bf16>)
               : reinterpret_cast<const void*>(
                     sr_kernel<kTaps, true, false, kRemat, bf16>);
  return sym ? reinterpret_cast<const void*>(
                   sr_kernel<kTaps, true, true, kRemat, float>)
             : reinterpret_cast<const void*>(
                   sr_kernel<kTaps, true, false, kRemat, float>);
}

template <bool kRemat>
const void* kernel_remat(int ntaps, int variable, int sym, int plane_bf16) {
  const bool wide = ntaps > 7;
  if (!variable)
    return wide ? reinterpret_cast<const void*>(
                      sr_kernel<cgx::kMaxTaps, false, false, kRemat, float>)
                : reinterpret_cast<const void*>(
                      sr_kernel<7, false, false, kRemat, float>);
  return wide ? planes_kernel<cgx::kMaxTaps, kRemat>(sym, plane_bf16)
              : planes_kernel<7, kRemat>(sym, plane_bf16);
}

// The instance for the operator, the plane type and the tier (remat: rp or
// p, which never store q).
const void* kernel_for(int ntaps, int variable, int sym, int plane_bf16,
                       int remat) {
  return remat ? kernel_remat<true>(ntaps, variable, sym, plane_bf16)
               : kernel_remat<false>(ntaps, variable, sym, plane_bf16);
}

}  // namespace

// The cooperative grid of the instance: as many blocks as fit at once.
extern "C" int cgx_sr_grid(int device, int ntaps, int variable, int sym,
                           int plane_bf16, int remat, int* grid) {
  return cgx::full_grid<kThreads>(
      device, kernel_for(ntaps, variable, sym, plane_bf16, remat), grid);
}

// One solve on `stream`.  `plane[t]` is tap t's plane index (−1: constant
// tap coeffs[t]); `planes` is null for a constant-coefficient operator and
// holds bf16 when plane_bf16; `w` may be null.  remat = 0 (rpq) needs q,
// remat = 1 (rp, p) needs p_alt.  grid_a and grid_b are K3's kernel A and
// B grids: the partition of the sums.
extern "C" int cgx_sr_cg(float* x, float* r, float* p, float* p_alt,
                         float* q, const void* planes, const float* w,
                         double* part_a, int grid_a, double* part_b,
                         int grid_b, int grid, int nx, int ny, int nz,
                         int ntaps, const int* taps, const float* coeffs,
                         const int* plane, int sym, int plane_bf16,
                         int remat, const float* tol_sq, int maxit,
                         const float* rz_in, int* k_out, float* rz_out,
                         void* stream) {
  if (ntaps < 1 || ntaps > cgx::kMaxTaps || grid < 1 || grid_a < 1 ||
      grid_b < 1 || (remat ? p_alt == nullptr : q == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{x,      r,      p,      p_alt,  q,     planes, w,     part_a,
         part_b, grid_a, grid_b, nx,     ny,    nz,     tol_sq, maxit,
         rz_in,  k_out,  rz_out,
         cgx::make_plane_taps(ntaps, taps, coeffs, plane, ny, nz)};
  return cgx::launch_cooperative<kThreads>(
      kernel_for(ntaps, planes != nullptr, sym, plane_bf16, remat), grid, &a,
      stream);
}
