// Constant-coefficient stencil row, shared by the SpMV kernel (stencil.cu)
// and the whole-solve CG kernel (resident_cg.cu).
//
// y[row] = sum_t c[t] * x[(i+dx[t], j+dy[t], k+dz[t])] over the taps whose
// neighbour lies inside the nx × ny × nz grid (zero Dirichlet boundary):
// the boundary masks come from index arithmetic, nothing is stored.
// Node (i, j, k) is row (i*ny + j)*nz + k, as in the JAX package.  Each
// product and sum is rounded on its own, in tap order, as the plain
// PyTorch version (GeneralStencil3D.matvec) rounds them.
#pragma once

#include <cuda_runtime.h>

namespace cgx {

constexpr int kMaxTaps = 27;

// Taps by value: a kernel parameter, read from the constant bank.
struct StencilTaps {
  int n;
  int dx[kMaxTaps];
  int dy[kMaxTaps];
  int dz[kMaxTaps];
  float c[kMaxTaps];
};

// Host side: pack (n, taps[3n], coeffs[n]) host arrays into the struct.
inline StencilTaps make_taps(int n, const int* taps, const float* coeffs) {
  StencilTaps t{};
  t.n = n;
  for (int s = 0; s < n; ++s) {
    t.dx[s] = taps[3 * s];
    t.dy[s] = taps[3 * s + 1];
    t.dz[s] = taps[3 * s + 2];
    t.c[s] = coeffs[s];
  }
  return t;
}

// kReadOnly selects the non-coherent read-only path (__ldg).  It is only
// valid for data no thread writes during the kernel: the SpMV's x.  The
// CG kernel rewrites p every iteration, so it reads with plain loads,
// which the grid-wide barrier orders.
template <bool kReadOnly>
__device__ __forceinline__ float load(const float* p) {
  if constexpr (kReadOnly) {
    return __ldg(p);
  } else {
    return *p;
  }
}

// kTaps bounds the unrolled tap loop (7 for the 7-point operator, kMaxTaps
// otherwise): every tap field is then a static index into the parameter
// struct, and a 7-point row runs 7 guarded taps instead of 27.
template <bool kReadOnly, int kTaps>
__device__ __forceinline__ float stencil_row(const float* x, int row, int nx,
                                             int ny, int nz,
                                             const StencilTaps& t) {
  const int line = row / nz;
  const int k = row - line * nz;
  const int i = line / ny;
  const int j = line - i * ny;
  float acc = 0.0f;
#pragma unroll
  for (int s = 0; s < kTaps; ++s) {
    if (s < t.n) {
      const int ii = i + t.dx[s];
      const int jj = j + t.dy[s];
      const int kk = k + t.dz[s];
      if (ii >= 0 && ii < nx && jj >= 0 && jj < ny && kk >= 0 && kk < nz) {
        acc = __fadd_rn(
            acc, __fmul_rn(t.c[s], load<kReadOnly>(x + (ii * ny + jj) * nz +
                                                    kk)));
      }
    }
  }
  return acc;
}

}  // namespace cgx
