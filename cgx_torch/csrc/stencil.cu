// K1: constant-coefficient 3-D stencil SpMV, y = A·x, zero Dirichlet boundary.
//
// Replaces the Pallas kernel cgx/kernels/stencil.py:_kernel (entry
// stencil3d_spmv_pallas), which DMAs one halo window of rows per grid step
// into VMEM.  On Hopper there are no windows: one thread per row in a
// grid-stride loop decomposes the row into (i, j, k) and reads its
// neighbours with __ldg through the read-only cache.  The floor is set by
// bytes: about 8 B/row (read x, write y) when the neighbour reads hit
// L1/L2, which they mostly do for the ±1, ±nz, ±ny·nz reach of a 7-point
// stencil.  This version runs about 5× above that floor at 128³ (25 µs per
// launch on an H100 80GB HBM3 at 700 W): per-row index arithmetic and
// seven scalar loads bound it.  Several rows per thread with float4 loads
// is later work.
#include <cuda_runtime.h>

#include "stencil.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    stencil_spmv_kernel(const float* __restrict__ x, float* __restrict__ y,
                        int nx, int ny, int nz, cgx::StencilTaps taps) {
  const long long n = static_cast<long long>(nx) * ny * nz;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long row = static_cast<long long>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
       row < n; row += stride) {
    y[row] = cgx::stencil_row<true, 7>(x, static_cast<int>(row), nx, ny,
                                       nz, taps);
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() after the launch.
extern "C" int cgx_stencil3d_spmv(const float* x, float* y, int nx, int ny,
                                  int nz, int ntaps, const int* taps,
                                  const float* coeffs, void* stream) {
  if (ntaps < 1 || ntaps > 7) return cudaErrorInvalidValue;
  const cgx::StencilTaps t = cgx::make_taps(ntaps, taps, coeffs);
  const long long n = static_cast<long long>(nx) * ny * nz;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > (1 << 20)) blocks = 1 << 20;
  if (blocks < 1) blocks = 1;
  stencil_spmv_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(x, y, nx, ny,
                                                             nz, t);
  return static_cast<int>(cudaGetLastError());
}
