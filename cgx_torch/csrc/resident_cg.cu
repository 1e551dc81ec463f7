// K2: the whole CG solve in one launch.
//
// Replaces the Pallas kernel cgx/kernels/fused_resident.py:_kernel (entries
// resident_cg_call / resident_stencil_cg / resident_dia_cg), which keeps
// x, r, p in VMEM and runs the whole while-loop inside one pallas_call.
// It has two modes, as the Pallas kernel has:
//
//   * constant taps (resident_cg_kernel): a constant-coefficient stencil;
//   * planes/weight (resident_dia_kernel): a Jacobi-scaled DIA operator
//     Ã = E·A·E whose taps are coefficient planes streamed from device
//     memory, mixed with constant taps (the unit diagonal), optionally
//     symmetric (one plane per ±off pair, applied at i and mirrored at
//     i−off), with the weighted true residual Σ r̃²·w (w = diag A) as the
//     exit test while β keeps the solve-space Σ r̃².
//
// Here one cooperative, persistent grid (occupancy × SM count blocks) runs
// the loop; each iteration is three phases, each closed by a grid-wide
// barrier (cooperative_groups::this_grid().sync()):
//
//   1. q = A·p through the shared operator row (stencil.cuh), block
//      partials of p·q;
//   2. α = rz / p·q, x += α·p, r −= α·q, block partials of r·r (and of
//      r·r·w in planes mode);
//   3. β = rz' / rz, p = r + β·p.
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
// kernel and its plain version differ only in the order of the sums.
//
// It is bound by bytes plus 3 grid barriers per iteration.  The Pallas
// kernel moves about 5 vector streams per iteration; this three-phase form
// moves 11 (phase 1 reads p and writes q, phase 2 reads x, p, r, q and
// writes x, r, phase 3 reads r, p and writes p), plus in planes mode the
// planes (twice each in the symmetric mode: at i and at i−off) and w.
// There is no VMEM-like cap: larger grids stream from HBM.  Fusing phase 3
// into the next phase 1, and weighing this design against per-iteration
// kernels in a CUDA graph, are later work.
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

struct Args {
  float* x;
  float* r;
  float* p;
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
  float* p;
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

// The instantiation for an operator of `ntaps` taps.
const void* kernel_for(int ntaps) {
  return ntaps <= 7 ? reinterpret_cast<const void*>(resident_cg_kernel<7>)
                    : reinterpret_cast<const void*>(
                          resident_cg_kernel<cgx::kMaxTaps>);
}

template <typename P>
const void* dia_kernel_typed(int ntaps, int sym) {
  if (ntaps <= 7)
    return sym ? reinterpret_cast<const void*>(resident_dia_kernel<7, true, P>)
               : reinterpret_cast<const void*>(
                     resident_dia_kernel<7, false, P>);
  return sym ? reinterpret_cast<const void*>(
                   resident_dia_kernel<cgx::kMaxTaps, true, P>)
             : reinterpret_cast<const void*>(
                   resident_dia_kernel<cgx::kMaxTaps, false, P>);
}

const void* dia_kernel_for(int ntaps, int sym, int plane_bf16) {
  return plane_bf16 ? dia_kernel_typed<__nv_bfloat16>(ntaps, sym)
                    : dia_kernel_typed<float>(ntaps, sym);
}

// As many blocks of `kernel` as can be co-resident.
int cooperative_grid(int device, const void* kernel, int* grid) {
  int sms = 0;
  int per_sm = 0;
  cudaError_t e =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                    0);
  if (e != cudaSuccess) return static_cast<int>(e);
  *grid = per_sm * sms;
  return *grid > 0 ? 0 : static_cast<int>(cudaErrorInvalidConfiguration);
}

int launch(const void* kernel, int grid, void* args, void* stream) {
  void* params[] = {args};
  cudaError_t e = cudaLaunchCooperativeKernel(
      kernel, dim3(grid), dim3(kThreads), params, 0,
      static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The cooperative grid for `ntaps` taps: as many blocks as can be
// co-resident.
extern "C" int cgx_resident_cg_grid(int device, int ntaps, int* grid) {
  return cooperative_grid(device, kernel_for(ntaps), grid);
}

// Launches on `stream`; returns the launch's error (a grid larger than the
// co-resident capacity is refused here, never retried smaller).
extern "C" int cgx_resident_cg(float* x, float* r, float* p, float* q,
                               float* partials, int grid, int nx, int ny,
                               int nz, int ntaps, const int* taps,
                               const float* coeffs, const float* tol_sq,
                               int maxit, int resume, const float* rz_in,
                               int* k_out, float* rz_out, void* stream) {
  if (ntaps < 1 || ntaps > cgx::kMaxTaps || grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{x, r, p, q, partials, nx, ny, nz, tol_sq, maxit, resume, rz_in,
         k_out, rz_out, cgx::make_taps(ntaps, taps, coeffs)};
  return launch(kernel_for(ntaps), grid, &a, stream);
}

extern "C" int cgx_resident_dia_cg_grid(int device, int ntaps, int sym,
                                        int plane_bf16, int* grid) {
  return cooperative_grid(device, dia_kernel_for(ntaps, sym, plane_bf16),
                          grid);
}

// Planes/weight mode.  `plane[t]` is tap t's plane index (−1: constant tap
// coeffs[t]); `planes` holds bf16 when plane_bf16; `w` may be null
// (unweighted).  partials: 3 × grid floats.
extern "C" int cgx_resident_dia_cg(
    float* x, float* r, float* p, float* q, float* partials, int grid,
    int nx, int ny, int nz, int ntaps, const int* taps, const float* coeffs,
    const int* plane, const void* planes, const float* w, int sym,
    int plane_bf16, const float* tol_sq, int maxit, int resume,
    const float* rz_in, int* k_out, float* rz_out, void* stream) {
  if (ntaps < 1 || ntaps > cgx::kMaxTaps || grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  DiaArgs a{x, r, p, q, partials, planes, w, nx, ny, nz, tol_sq, maxit,
            resume, rz_in, k_out, rz_out,
            cgx::make_plane_taps(ntaps, taps, coeffs, plane, ny, nz)};
  return launch(dia_kernel_for(ntaps, sym, plane_bf16), grid, &a, stream);
}
