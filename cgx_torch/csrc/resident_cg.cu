// K2: the whole CG solve in one launch, for a constant-coefficient stencil.
//
// Replaces the Pallas kernel cgx/kernels/fused_resident.py:_kernel (entries
// resident_cg_call / resident_stencil_cg, constant-tap mode), which keeps
// x, r, p in VMEM and runs the whole while-loop inside one pallas_call.
// Here one cooperative, persistent grid (occupancy × SM count blocks) runs
// the loop; each iteration is three phases, each closed by a grid-wide
// barrier (cooperative_groups::this_grid().sync()):
//
//   1. q = A·p through the shared stencil row (stencil.cuh), block partials
//      of p·q;
//   2. α = rz / p·q, x += α·p, r −= α·q, block partials of r·r;
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
// kernel and its plain version differ only in the order of the two sums.
//
// It is bound by bytes plus 3 grid barriers per iteration.  The Pallas
// kernel moves about 5 vector streams per iteration; this three-phase form
// moves 11 (phase 1 reads p and writes q, phase 2 reads x, p, r, q and
// writes x, r, phase 3 reads r, p and writes p).  At 128³ the working set
// (x, r, p, q: 4 × 8 MiB) fits in the H100's 50 MB L2, the card's
// counterpart of VMEM residency; there is no VMEM-like cap, so larger
// grids stream from HBM.  Fusing phase 3 into the next phase 1, and
// weighing this design against per-iteration kernels in a CUDA graph,
// are later work.
#include <cooperative_groups.h>
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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Block tree sum of one value per thread; the result is in smem[kWarps]
// for every thread after the call.
__device__ __forceinline__ float block_sum(float v, float* smem) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) smem[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s += smem[w];
    smem[kWarps] = s;
  }
  __syncthreads();
  const float s = smem[kWarps];
  __syncthreads();
  return s;
}

// Sum of the gridDim.x block partials, in the same order in every block.
// __ldcg reads through L2, where the other blocks' writes land.
__device__ __forceinline__ float grid_sum(const float* part, float* smem) {
  float v = 0.0f;
  for (int b = threadIdx.x; b < static_cast<int>(gridDim.x); b += kThreads)
    v += __ldcg(part + b);
  return block_sum(v, smem);
}

template <int kTaps>
__global__ void __launch_bounds__(kThreads) resident_cg_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float smem[kWarps + 1];
  const int n = a.nx * a.ny * a.nz;
  const int first = blockIdx.x * kThreads + threadIdx.x;
  const int stride = gridDim.x * kThreads;
  float* part_pq = a.partials;
  float* part_rr = a.partials + gridDim.x;

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
    const float s = block_sum(acc, smem);
    if (threadIdx.x == 0) part_rr[blockIdx.x] = s;
    grid.sync();
    rz = grid_sum(part_rr, smem);
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
    float s = block_sum(acc, smem);
    if (threadIdx.x == 0) part_pq[blockIdx.x] = s;
    grid.sync();
    const float alpha = rz / grid_sum(part_pq, smem);

    // Phase 2: x += α·p, r −= α·q, Σ r·r.
    acc = 0.0f;
    for (int row = first; row < n; row += stride) {
      a.x[row] = __fadd_rn(a.x[row], __fmul_rn(alpha, a.p[row]));
      const float rv = __fsub_rn(a.r[row], __fmul_rn(alpha, a.q[row]));
      a.r[row] = rv;
      acc = __fadd_rn(acc, __fmul_rn(rv, rv));
    }
    s = block_sum(acc, smem);
    if (threadIdx.x == 0) part_rr[blockIdx.x] = s;
    grid.sync();
    const float rz_new = grid_sum(part_rr, smem);
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

// The instantiation for an operator of `ntaps` taps.
const void* kernel_for(int ntaps) {
  return ntaps <= 7 ? reinterpret_cast<const void*>(resident_cg_kernel<7>)
                    : reinterpret_cast<const void*>(
                          resident_cg_kernel<cgx::kMaxTaps>);
}

}  // namespace

// The cooperative grid for `ntaps` taps: as many blocks as can be
// co-resident.
extern "C" int cgx_resident_cg_grid(int device, int ntaps, int* grid) {
  int sms = 0;
  int per_sm = 0;
  cudaError_t e =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel_for(ntaps), kThreads, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  *grid = per_sm * sms;
  return *grid > 0 ? 0 : static_cast<int>(cudaErrorInvalidConfiguration);
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
  void* params[] = {&a};
  cudaError_t e = cudaLaunchCooperativeKernel(
      kernel_for(ntaps), dim3(grid), dim3(kThreads), params, 0,
      static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
