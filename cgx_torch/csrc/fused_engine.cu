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
//
// Narrow modes (mixed precision; the Pallas kernels' bf16 vectors and
// plane_dtype, cgx/kernels/fused_engine.py:366-381, :399-404, :428-429).
// Both kernels are templates on the vector type V and kernel A also on
// the plane type P, each float or bf16: fp32/fp32 (unchanged bit for bit),
// fp32 vectors with bf16 planes, and bf16 vectors with bf16 planes or none.
// Halving the bytes of a stream is the lever, since both kernels are bound
// by bytes.  The rounding:
//   * every value is widened to fp32 in registers as it is loaded;
//   * kernel A sums a row's taps in fp32, in tap order, and rounds q once
//     to V when it stores it; its sums read the stored q;
//   * kernel B rounds α and β to V, as the Pallas kernel does, then computes
//     x + αp, r − αq and r' + βp in fp32 and rounds each once on store (p
//     from the stored r');
//   * the four sums stay exact: fp64 products of the widened values.
// The JAX package on the CPU rounds each bf16 term instead, so the port
// agrees with it to a bf16 tolerance and with its own plain version
// (fused_engine.py: kernel_a_reference, kernel_b_reference), which rounds
// as above, bit for bit.  The bf16 loads are 2-byte scalar loads.
#include <cuda_bf16.h>
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

using bf16 = __nv_bfloat16;

struct AArgs {
  const void* p;       // V
  void* q;             // V
  const void* planes;  // P; null: constant taps only
  double* part_a;        // 2 × gridDim.x: Σ p·q, Σ q·q
  const double* part_b;  // 2 × grid_b: kernel B's Σ r², Σ r²·w
  int grid_b;
  Ctl* ctl;
  float* history;  // hist_len floats, or null
  int init;        // 1: only q = A·p (the x0 start), no control state
  int nx, ny, nz;
  cgx::PlaneTaps taps;
};

template <int kTaps, bool kPlanes, bool kSym, typename V, typename P>
__global__ void __launch_bounds__(kThreads) kernel_a(AArgs a) {
  __shared__ double smem[kWarps + 1];
  const V* p = static_cast<const V*>(a.p);
  V* q = static_cast<V*>(a.q);
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
      qv = cgx::plane_row<true, kTaps, kSym>(
          p, static_cast<const P*>(a.planes), row, n, a.nx, a.ny, a.nz,
          a.taps);
    } else {
      qv = cgx::stencil_row<true, kTaps>(p, row, a.nx, a.ny, a.nz, a.taps.s);
    }
    const V qs = cgx::narrow<V>(qv);
    q[row] = qs;
    const double qd = cgx::widen(qs);
    pq = __dadd_rn(
        pq, __dmul_rn(qd, static_cast<double>(cgx::load<true>(p + row))));
    qq = __dadd_rn(qq, __dmul_rn(qd, qd));
  }
  pq = cgx::block_sum<kThreads>(pq, smem);
  qq = cgx::block_sum<kThreads>(qq, smem);
  if (threadIdx.x == 0) {
    a.part_a[blockIdx.x] = pq;
    a.part_a[gridDim.x + blockIdx.x] = qq;
  }
}

struct BArgs {  // x, r, p, q, w of the vector type V
  void* x;
  void* r;
  void* p;
  const void* q;
  const void* w;         // null: unweighted (Σr²·w = Σr²)
  const double* part_a;  // 2 × grid_a: kernel A's Σ p·q, Σ q·q
  int grid_a;
  double* part_b;  // 2 × gridDim.x
  Ctl* ctl;
  int n;
};

template <bool kWeighted, typename V>
__global__ void __launch_bounds__(kThreads) kernel_b(BArgs a) {
  __shared__ double smem[kWarps + 1];
  V* x = static_cast<V*>(a.x);
  V* r = static_cast<V*>(a.r);
  V* p = static_cast<V*>(a.p);
  const V* q = static_cast<const V*>(a.q);
  const V* w = static_cast<const V*>(a.w);
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
  const float alpha32 = __fdiv_rn(rz, pq);
  const float beta32 = __fdiv_rn(
      __fsub_rn(__fmul_rn(__fmul_rn(alpha32, alpha32), qq), rz), rz);
  // α and β rounded to the vector type, as the Pallas kernel rounds them.
  const float alpha = cgx::widen(cgx::narrow<V>(alpha32));
  const float beta = cgx::widen(cgx::narrow<V>(beta32));
  const int stride = gridDim.x * kThreads;
  double acc = 0.0, accw = 0.0;
  for (int row = blockIdx.x * kThreads + threadIdx.x; row < a.n;
       row += stride) {
    const float pv = cgx::widen(p[row]);
    x[row] = cgx::narrow<V>(
        __fadd_rn(cgx::widen(x[row]), __fmul_rn(alpha, pv)));
    const V rs = cgx::narrow<V>(
        __fsub_rn(cgx::widen(r[row]), __fmul_rn(alpha, cgx::widen(q[row]))));
    r[row] = rs;
    const float rv = cgx::widen(rs);
    p[row] = cgx::narrow<V>(__fadd_rn(rv, __fmul_rn(beta, pv)));
    const double rsq = __dmul_rn(rv, rv);
    acc = __dadd_rn(acc, rsq);
    if constexpr (kWeighted)
      accw = __dadd_rn(accw,
                       __dmul_rn(rsq, static_cast<double>(cgx::widen(w[row]))));
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

template <typename V, typename P>
const void* a_kernel_typed(int ntaps, int variable, int sym) {
  const bool wide = ntaps > 7;
  if (!variable)
    return wide ? reinterpret_cast<const void*>(
                      kernel_a<cgx::kMaxTaps, false, false, V, P>)
                : reinterpret_cast<const void*>(kernel_a<7, false, false, V, P>);
  if (sym)
    return wide ? reinterpret_cast<const void*>(
                      kernel_a<cgx::kMaxTaps, true, true, V, P>)
                : reinterpret_cast<const void*>(kernel_a<7, true, true, V, P>);
  return wide ? reinterpret_cast<const void*>(
                    kernel_a<cgx::kMaxTaps, true, false, V, P>)
              : reinterpret_cast<const void*>(kernel_a<7, true, false, V, P>);
}

// The instance for the operator and the types; null for bf16 vectors with
// fp32 planes, which no caller builds.
const void* a_kernel_for(int ntaps, int variable, int sym, int vec_bf16,
                         int plane_bf16) {
  if (!vec_bf16)
    return plane_bf16 ? a_kernel_typed<float, bf16>(ntaps, variable, sym)
                      : a_kernel_typed<float, float>(ntaps, variable, sym);
  if (variable && !plane_bf16) return nullptr;
  return a_kernel_typed<bf16, bf16>(ntaps, variable, sym);
}

const void* b_kernel_for(int weighted, int vec_bf16) {
  if (vec_bf16)
    return weighted ? reinterpret_cast<const void*>(kernel_b<true, bf16>)
                    : reinterpret_cast<const void*>(kernel_b<false, bf16>);
  return weighted ? reinterpret_cast<const void*>(kernel_b<true, float>)
                  : reinterpret_cast<const void*>(kernel_b<false, float>);
}

}  // namespace

extern "C" int cgx_fused_a_grid(int device, int ntaps, int variable, int sym,
                                int vec_bf16, int plane_bf16, int* grid) {
  const void* k = a_kernel_for(ntaps, variable, sym, vec_bf16, plane_bf16);
  if (k == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return cgx::full_grid<kThreads>(device, k, grid);
}

extern "C" int cgx_fused_b_grid(int device, int weighted, int vec_bf16,
                                int* grid) {
  return cgx::full_grid<kThreads>(device, b_kernel_for(weighted, vec_bf16),
                                  grid);
}

// Kernel A on `stream`.  `plane[t]` is tap t's plane index (−1: constant
// tap coeffs[t]); `planes` is null for a constant-coefficient operator.
// p and q hold bf16 when vec_bf16, planes bf16 when plane_bf16.
extern "C" int cgx_fused_a(const void* p, void* q, const void* planes,
                           double* part_a, int grid_a, const double* part_b,
                           int grid_b, int* ctl, float* history, int init,
                           int nx, int ny, int nz, int ntaps,
                           const int* taps, const float* coeffs,
                           const int* plane, int sym, int vec_bf16,
                           int plane_bf16, void* stream) {
  const void* k =
      a_kernel_for(ntaps, planes != nullptr, sym, vec_bf16, plane_bf16);
  if (ntaps < 1 || ntaps > cgx::kMaxTaps || grid_a < 1 || k == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  AArgs a{p, q, planes, part_a, part_b, grid_b, reinterpret_cast<Ctl*>(ctl),
          history, init, nx, ny, nz,
          cgx::make_plane_taps(ntaps, taps, coeffs, plane, ny, nz)};
  return cgx::launch<kThreads>(k, grid_a, &a, stream);
}

// Kernel B on `stream`; `w` is null for an unweighted solve.  x, r, p, q
// and w hold bf16 when vec_bf16.
extern "C" int cgx_fused_b(void* x, void* r, void* p, const void* q,
                           const void* w, const double* part_a, int grid_a,
                           double* part_b, int grid_b, int* ctl, int n,
                           int vec_bf16, void* stream) {
  if (grid_a < 1 || grid_b < 1) return static_cast<int>(cudaErrorInvalidValue);
  BArgs a{x, r, p, q, w, part_a, grid_a, part_b,
          reinterpret_cast<Ctl*>(ctl), n};
  return cgx::launch<kThreads>(b_kernel_for(w != nullptr, vec_bf16), grid_b,
                               &a, stream);
}
