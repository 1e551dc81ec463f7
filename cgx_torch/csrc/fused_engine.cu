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
// both kernels keep the exact iteration count by themselves.  In the first
// design (kernel_a, kernel_b; the redesign below folds once a launch):
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
//
// Distribution (the Pallas engine under shard_map, FusedCG(axis_name=...):
// cgx/kernels/fused_engine.py:_exchange and _allsum, the halo rows and the
// two psums).  A rank runs kernel_a2 and kernel_b2 on its own x-planes of
// the grid, in the cross-rank mode (the instances with kShard, chosen where
// the C entry gets a span and `sums`):
//   * kernel A reads p one ghost x-plane beyond its planes on each side
//     where a neighbour rank exists (cgx::Span; the planes carry ghost
//     planes too in the symmetric mode, for the mirror taps).  The wrapper
//     sends the boundary planes before each kernel A; the outer ranks have
//     no neighbour there, and their masks drop those taps;
//   * kernel A's last block writes its rank's p·q and q·q unrounded, in
//     fp64, to sums[0..1]; NCCL sums them over the ranks on the stream;
//     kernel B rounds the reduced values to fp32 once;
//   * kernel B's last block writes Σr², Σr²·w unrounded to sums[2..3],
//     counts the iteration and sets `pending`; after their all-reduce the
//     next kernel A rounds them, writes the history slot and takes the exit
//     decision.  So an iteration makes two all-reduces of two doubles, the
//     Pallas engine's two psums, and the host still reads one flag a chunk.
// Every rank reads the same reduced bits, so every rank takes the same
// exit.  A sum over one rank is the rank's own value, so at one rank the
// cross-rank mode equals the single-card mode bit for bit; over P ranks the
// sums differ from one card's only in the order of fp64 additions.  The
// single-card instances (kShard false) read the whole grid with the span's
// zeros as constants and have no cross-rank branch.
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
  // The redesign (kernel_a2, kernel_b2): p·q and q·q, folded by kernel A's
  // last block and read by kernel B, and the two kernels' ticket counters
  // (0 between launches).  In the cross-rank mode `pending` (1: kernel B's
  // newest sums are in `sums`, reduced over the ranks) is written by kernel
  // B and read by kernel A.
  float pq, qq;
  int ticket_a, ticket_b;
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
  cgx::Span span;  // kernel_a2 of a shard: what p and the planes hold
  double* sums;    // kernel_a2, kernel_b2 of a shard: the cross-rank sums
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
  float* history;  // hist_len floats, or null (kernel_b2 writes it)
  int n;
  double* sums;    // kernel_b2 of a shard: the cross-rank sums
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

// -- The redesign: kernel_a2, kernel_b2 --------------------------------------
// Kernel A computed every row's taps from global memory with two integer
// divisions a row, and every block of A and of B re-summed the other
// kernel's partials in its prologue.  The redesign keeps K3's partition of
// the sums — thread u of virtual block vb of grid_a (the first kernel A's
// occupancy grid, cgx_fused_a_grid) takes rows vb·256 + u + m·grid_a·256
// in order — so q, the partials, p·q and q·q are those of kernel_a bit for
// bit, and K4's and K6's copies of the partition stay valid.  Within it:
//
//   * each thread carries its node (cgx::Walk): no division a row (and no
//     walk at all where no constant tap off the centre reads the node);
//   * the taps are read from global memory (stencil_row_at, plane_row_at)
//     with two of a thread's rows in flight, their sums added in row
//     order.  Staging each step's segments of p in shared memory with
//     cp.async lost to this at every instance measured on the H100
//     (PERF.md §6): K3's rows are one a thread a step, so the L1 already
//     serves the reuse a stage would give;
//   * a block walks the virtual blocks blockIdx.x, + gridDim.x, … (its own
//     grid is what fits at once, cgx_fused_a_fit);
//   * the folds happen once a launch: kernel A's last block (a ticket)
//     folds Σ p·q and Σ q·q, kernel B's last block folds Σr² and Σr²·w,
//     counts the iteration and writes the history slot, each in the first
//     design's fixed order (grid_sum), and publishes them in Ctl.
//
// The first design (kernel_a, kernel_b) stays as the same-run "before",
// design 0 of the C entries: no entry point of the package reaches it.
// Kernel B's sweep is redesigned too: see kernel_b2.

struct A2Args {
  AArgs a;
  int grid_a;  // K3's partition: the virtual blocks
};

// The first kernel A's occupancy (cgx_fused_a_grid) is 8 blocks an SM at 7
// taps and 4 at 27 on the H100, so K3's partition has that many virtual
// blocks; kernel_a2 is held to the same (32 or 64 registers) and runs one
// virtual block a block.
template <int kTaps>
constexpr int kA2Blocks = kTaps > 7 ? 4 : 8;

template <int kTaps, bool kPlanes, bool kSym, bool kShard, typename V,
          typename P>
__global__ void __launch_bounds__(kThreads, kA2Blocks<kTaps>)
    kernel_a2(A2Args args) {
  __shared__ double smem[kWarps + 1];
  const AArgs& a = args.a;
  const V* __restrict__ p = static_cast<const V*>(a.p);
  V* __restrict__ q = static_cast<V*>(a.q);
  Ctl* c = a.ctl;
  if (!a.init) {
    // Kernel B's last block has folded the sums of iterate k into Ctl, or,
    // across ranks, into `sums`, which NCCL has reduced since.
    if (c->done) return;
    const bool fresh = kShard && c->pending != 0;
    const float rz = fresh ? static_cast<float>(a.sums[2]) : c->rz;
    const float rw = fresh ? static_cast<float>(a.sums[3]) : c->rw;
    const int k = c->k;
    const bool stop = !(k < c->maxit && rw > c->tol_sq);
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      c->n_rz = rz;
      c->n_rw = rw;
      c->n_k = k;
      c->n_done = stop ? 1 : 0;
      if (fresh && c->hist_len > 0)
        a.history[k < c->hist_len ? k : c->hist_len - 1] = rw;
      if (kShard && stop) {  // nothing left for NCCL to sum
        a.sums[0] = 0.0;
        a.sums[1] = 0.0;
      }
    }
    if (stop) return;
  }
  const int ny = a.ny, nz = a.nz;
  const int n = a.nx * ny * nz;
  const cgx::Span span = kShard ? a.span : cgx::whole_grid(n, a.nx);
  const int ga = args.grid_a;
  const int step = ga * kThreads;
  const int u = threadIdx.x;
  const auto ld = [=](int i) { return cgx::load<true>(p + i); };
  // The node is read only by constant taps off the centre (the plane taps
  // guard by flat index): without them the walk is not carried.
  bool walk = !kPlanes;
  for (int t = 0; t < a.taps.s.n; ++t)
    walk = walk || (a.taps.plane[t] < 0 &&
                    (a.taps.s.dx[t] | a.taps.s.dy[t] | a.taps.s.dz[t]) != 0);
  // A row's q (unrounded).
  const auto value = [&](int row, const cgx::Walk& w) {
    if constexpr (kPlanes) {
      return cgx::plane_row_span<kTaps, kSym>(
          ld, static_cast<const P*>(a.planes), row, w, span, ny, nz, a.taps);
    } else {
      return cgx::stencil_row_span<kTaps>(ld, w, span, ny, nz, a.taps.s);
    }
  };
  // Store q and add the row's terms to the sums, in row order.
  const auto use = [&](int row, float qv, float pv, double& pq, double& qq) {
    const V qs = cgx::narrow<V>(qv);
    q[row] = qs;
    const double qd = cgx::widen(qs);
    pq = __dadd_rn(pq, __dmul_rn(qd, static_cast<double>(pv)));
    qq = __dadd_rn(qq, __dmul_rn(qd, qd));
  };
  for (int vb = blockIdx.x; vb < ga; vb += gridDim.x) {
    double pq = 0.0, qq = 0.0;
    int s = vb * kThreads;
    cgx::Walk w(s + u, step, ny, nz);
    for (; s + step < n; s += 2 * step) {
      const int r0 = s + u, r1 = r0 + step;
      cgx::Walk w1 = w;
      if (walk) w1.advance(ny, nz);
      const float v0 = r0 < n ? value(r0, w) : 0.0f;
      const float v1 = r1 < n ? value(r1, w1) : 0.0f;
      const float p0 = r0 < n ? ld(r0) : 0.0f;
      const float p1 = r1 < n ? ld(r1) : 0.0f;
      if (r0 < n) use(r0, v0, p0, pq, qq);
      if (r1 < n) use(r1, v1, p1, pq, qq);
      w = w1;
      if (walk) w.advance(ny, nz);
    }
    if (s + u < n) use(s + u, value(s + u, w), ld(s + u), pq, qq);
    pq = cgx::block_sum<kThreads>(pq, smem);
    qq = cgx::block_sum<kThreads>(qq, smem);
    if (u == 0) {
      a.part_a[vb] = pq;
      a.part_a[ga + vb] = qq;
    }
  }
  if (a.init || !cgx::last_block(&c->ticket_a)) return;
  __threadfence();
  const double pqs = cgx::grid_sum<kThreads>(a.part_a, ga, smem);
  const double qqs = cgx::grid_sum<kThreads>(a.part_a + ga, ga, smem);
  if (u == 0) {
    if constexpr (kShard) {  // this rank's share, summed by NCCL next
      a.sums[0] = pqs;
      a.sums[1] = qqs;
    } else {
      c->pq = static_cast<float>(pqs);
      c->qq = static_cast<float>(qqs);
    }
  }
}

// Kernel B's redesign.  The first design's sweep had one row a thread a
// step, and its pointers could alias, so the compiler could not load the
// next row before this row's three stores: with bf16 vectors (2-byte
// loads) it moved 46 % of its bound.  kernel_b2 takes the pointers as
// __restrict__ (the wrapper refuses vectors that share storage) and, with
// bf16 vectors, loads two of a thread's rows, all five streams, before it
// stores either; it then updates and stores them and adds their sums in
// row order.  fp32 vectors keep one row a step: two rows measured 1.02×
// (unweighted) and 1.13× (weighted, where they spill at 32 registers) the
// first design's time on the H100 (PERF.md §6).  It runs on the first
// design's grid_b blocks and partition: thread u of block b takes rows
// b·256 + u + m·grid_b·256 in order, so x', r', p' and every partial equal
// the first design's bit for bit.  It holds the first design's 8 blocks
// an SM (32 registers).  The sweep is a loop over K3's blocks that runs
// once at this grid: with bf16 vectors the same sweep without the loop
// measured 1.13× the loop's time.  The last block folds the partials in
// the first design's fixed order (grid_sum).
template <typename V>
struct BRows {  // kernel_b2's rows of a thread in flight
  static constexpr int value = 1;
};
template <>
struct BRows<bf16> {
  static constexpr int value = 2;
};

struct B2Args {
  BArgs a;
  int grid_b;  // K3's partition: the blocks of the first design
};

template <bool kWeighted, bool kShard, typename V>
__global__ void __launch_bounds__(kThreads, 8) kernel_b2(B2Args args) {
  __shared__ double smem[kWarps + 1];
  const BArgs& a = args.a;
  V* __restrict__ x = static_cast<V*>(a.x);
  V* __restrict__ r = static_cast<V*>(a.r);
  V* __restrict__ p = static_cast<V*>(a.p);
  const V* __restrict__ q = static_cast<const V*>(a.q);
  const V* __restrict__ w = static_cast<const V*>(a.w);
  Ctl* c = a.ctl;
  if (c->n_done) {
    // Kernel A of this iteration took the exit; Ctl holds the final state
    // (across ranks kernel A read it from `sums`: publish it).
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      if constexpr (kShard) {
        c->rz = c->n_rz;
        c->rw = c->n_rw;
        c->k = c->n_k;
        c->pending = 0;
        a.sums[2] = 0.0;
        a.sums[3] = 0.0;
      }
      c->done = 1;
    }
    return;
  }
  const float rz = c->n_rz;
  const float pq = kShard ? static_cast<float>(a.sums[0]) : c->pq;
  const float qq = kShard ? static_cast<float>(a.sums[1]) : c->qq;
  const float alpha32 = __fdiv_rn(rz, pq);
  const float beta32 = __fdiv_rn(
      __fsub_rn(__fmul_rn(__fmul_rn(alpha32, alpha32), qq), rz), rz);
  const float alpha = cgx::widen(cgx::narrow<V>(alpha32));
  const float beta = cgx::widen(cgx::narrow<V>(beta32));
  const int n = a.n;
  const int gb = args.grid_b;
  const int step = gb * kThreads;
  const int u = threadIdx.x;
  constexpr int kBRows = BRows<V>::value;
  // Update a row from its loaded values, store it, add its sums.
  const auto use = [&](int row, float xv, float rv, float pv, float qv,
                       float wv, double& acc, double& accw) {
    const cgx::Updated<V> v = cgx::cg_update<V>(xv, rv, pv, qv, alpha, beta);
    x[row] = v.x;
    r[row] = v.r;
    p[row] = v.p;
    const float rn = cgx::widen(v.r);
    const double rsq = __dmul_rn(rn, rn);
    acc = __dadd_rn(acc, rsq);
    if constexpr (kWeighted)
      accw = __dadd_rn(accw, __dmul_rn(rsq, static_cast<double>(wv)));
  };
  for (int vb = blockIdx.x; vb < gb; vb += gridDim.x) {
    double acc = 0.0, accw = 0.0;
    int s = vb * kThreads;
    // kBRows rows a step; only the last of them can lie past n.
    for (; s + (kBRows - 1) * step < n; s += kBRows * step) {
      float xv[kBRows], rv[kBRows], pv[kBRows], qv[kBRows], wv[kBRows];
#pragma unroll
      for (int j = 0; j < kBRows; ++j) {
        const int row = s + u + j * step;
        xv[j] = rv[j] = pv[j] = qv[j] = wv[j] = 0.0f;
        if (j < kBRows - 1 || row < n) {
          xv[j] = cgx::widen(x[row]);
          rv[j] = cgx::widen(r[row]);
          pv[j] = cgx::widen(p[row]);
          qv[j] = cgx::widen(q[row]);
          if constexpr (kWeighted) wv[j] = cgx::widen(w[row]);
        }
      }
#pragma unroll
      for (int j = 0; j < kBRows; ++j) {
        const int row = s + u + j * step;
        if (j < kBRows - 1 || row < n)
          use(row, xv[j], rv[j], pv[j], qv[j], wv[j], acc, accw);
      }
    }
    for (int row = s + u; row < n; row += step)
      use(row, cgx::widen(x[row]), cgx::widen(r[row]), cgx::widen(p[row]),
          cgx::widen(q[row]), kWeighted ? cgx::widen(w[row]) : 0.0f, acc,
          accw);
    acc = cgx::block_sum<kThreads>(acc, smem);
    if constexpr (kWeighted) {
      accw = cgx::block_sum<kThreads>(accw, smem);
    } else {
      accw = acc;
    }
    if (u == 0) {
      a.part_b[vb] = acc;
      a.part_b[gb + vb] = accw;
    }
  }
  // Every block has read n_rz, pq and qq before its ticket.
  if (!cgx::last_block(&c->ticket_b)) return;
  __threadfence();
  const double s1 = cgx::grid_sum<kThreads>(a.part_b, gb, smem);
  const double sw1 = cgx::grid_sum<kThreads>(a.part_b + gb, gb, smem);
  if (u == 0) {
    const int k1 = c->n_k + 1;
    if constexpr (kShard) {  // the next kernel A rounds the reduced sums
      a.sums[2] = s1;
      a.sums[3] = sw1;
      c->k = k1;
      c->pending = 1;
      return;
    }
    const float rw1 = static_cast<float>(sw1);
    c->rz = static_cast<float>(s1);
    c->rw = rw1;
    c->k = k1;
    c->pending = 0;
    const int hl = c->hist_len;
    if (hl > 0) a.history[k1 < hl ? k1 : hl - 1] = rw1;
  }
}

// The instance of kernel A (design 0: kernel_a, the first design; 1:
// kernel_a2, a shard's when `shard`) for the operator and the types.
template <typename V, typename P>
const void* a_kernel_typed(int ntaps, int variable, int sym, int design,
                           bool shard) {
  const bool wide = ntaps > 7;
#define CGX_A(T, PL, SY)                                                    \
  (design == 0 ? reinterpret_cast<const void*>(kernel_a<T, PL, SY, V, P>)   \
   : shard ? reinterpret_cast<const void*>(kernel_a2<T, PL, SY, true, V, P>) \
           : reinterpret_cast<const void*>(kernel_a2<T, PL, SY, false, V, P>))
  if (!variable)
    return wide ? CGX_A(cgx::kMaxTaps, false, false) : CGX_A(7, false, false);
  if (sym)
    return wide ? CGX_A(cgx::kMaxTaps, true, true) : CGX_A(7, true, true);
  return wide ? CGX_A(cgx::kMaxTaps, true, false) : CGX_A(7, true, false);
#undef CGX_A
}

// The instance for the operator and the types; null for bf16 vectors with
// fp32 planes, which no caller builds.
const void* a_kernel_for(int ntaps, int variable, int sym, int vec_bf16,
                         int plane_bf16, int design, bool shard = false) {
  if (!vec_bf16)
    return plane_bf16 ? a_kernel_typed<float, bf16>(ntaps, variable, sym,
                                                    design, shard)
                      : a_kernel_typed<float, float>(ntaps, variable, sym,
                                                     design, shard);
  if (variable && !plane_bf16) return nullptr;
  return a_kernel_typed<bf16, bf16>(ntaps, variable, sym, design, shard);
}

// The instance of kernel B: design 0 the first design, 1 kernel_b2 (a
// shard's when `shard`); null for another design.
const void* b_kernel_for(int weighted, int vec_bf16, int design,
                         bool shard = false) {
#define CGX_B(KW, V)                                                       \
  (design == 0 ? reinterpret_cast<const void*>(kernel_b<KW, V>)            \
   : shard     ? reinterpret_cast<const void*>(kernel_b2<KW, true, V>)     \
               : reinterpret_cast<const void*>(kernel_b2<KW, false, V>))
  if (design != 0 && design != 1) return nullptr;
  if (vec_bf16) return weighted ? CGX_B(true, bf16) : CGX_B(false, bf16);
  return weighted ? CGX_B(true, float) : CGX_B(false, float);
#undef CGX_B
}

}  // namespace

// The grids of the first design: K3's partition of the sums (kernel A's
// and kernel B's occupancy), which the redesign and K4 and K6 keep.
extern "C" int cgx_fused_a_grid(int device, int ntaps, int variable, int sym,
                                int vec_bf16, int plane_bf16, int* grid) {
  const void* k = a_kernel_for(ntaps, variable, sym, vec_bf16, plane_bf16, 0);
  if (k == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return cgx::full_grid<kThreads>(device, k, grid);
}

extern "C" int cgx_fused_b_grid(int device, int weighted, int vec_bf16,
                                int* grid) {
  return cgx::full_grid<kThreads>(device,
                                  b_kernel_for(weighted, vec_bf16, 0),
                                  grid);
}

// Blocks of kernel_a2 that fit on the card at once (a shard's instance is
// held to the same launch bounds and launched on the same grid).
extern "C" int cgx_fused_a_fit(int device, int ntaps, int variable, int sym,
                               int vec_bf16, int plane_bf16, int* blocks) {
  const void* k = a_kernel_for(ntaps, variable, sym, vec_bf16, plane_bf16, 1);
  if (k == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return cgx::full_grid<kThreads>(device, k, blocks);
}

// Kernel A on `stream`.  `plane[t]` is tap t's plane index (−1: constant
// tap coeffs[t]); `planes` is null for a constant-coefficient operator.
// p and q hold bf16 when vec_bf16, planes bf16 when plane_bf16.  part_a
// holds 2 × grid_a doubles (K3's partition).  design 0 runs the first
// kernel A on grid_a blocks; design 1 runs kernel_a2 on `grid` blocks.
// A rank's shard (design 1 only) runs the cross-rank instance: nx is its
// x-planes, `span` five ints (lo, hi, xlo, xhi, pstride: cgx::Span), p and
// planes point at the first local row and `sums` holds 4 doubles; on one
// card both are null.
extern "C" int cgx_fused_a(const void* p, void* q, const void* planes,
                           double* part_a, int grid_a, const double* part_b,
                           int grid_b, int* ctl, float* history, int init,
                           int nx, int ny, int nz, int ntaps,
                           const int* taps, const float* coeffs,
                           const int* plane, int sym, int vec_bf16,
                           int plane_bf16, int design, int grid,
                           const int* span, double* sums, void* stream) {
  const bool shard = span != nullptr;
  const void* k = a_kernel_for(ntaps, planes != nullptr, sym, vec_bf16,
                               plane_bf16, design, shard);
  if (ntaps < 1 || ntaps > cgx::kMaxTaps || grid_a < 1 || k == nullptr ||
      shard != (sums != nullptr) || (design == 0 && shard))
    return static_cast<int>(cudaErrorInvalidValue);
  const cgx::Span sp =
      shard ? cgx::Span{span[0], span[1], span[2], span[3], span[4]}
            : cgx::Span{};
  AArgs a{p, q, planes, part_a, part_b, grid_b, reinterpret_cast<Ctl*>(ctl),
          history, init, nx, ny, nz,
          cgx::make_plane_taps(ntaps, taps, coeffs, plane, ny, nz), sp,
          sums};
  if (design == 0) return cgx::launch<kThreads>(k, grid_a, &a, stream);
  if (grid < 1) return static_cast<int>(cudaErrorInvalidValue);
  A2Args a2{a, grid_a};
  return cgx::launch<kThreads>(k, grid, &a2, stream);
}

// Kernel B on `stream`; `w` is null for an unweighted solve.  x, r, p, q
// and w hold bf16 when vec_bf16.  Both designs run on grid_b blocks.
// design 0: the first kernel B (folds part_a itself); 1: kernel_b2 (reads
// p·q and q·q from ctl, folds its own partials in its last block, writes
// `history`), which needs x, r, p, q and w in storage of their own.
// `sums` (design 1; null on one card): a shard's cross-rank instance, p·q
// and q·q read from sums[0..1], Σr² and Σr²·w written to sums[2..3].
extern "C" int cgx_fused_b(void* x, void* r, void* p, const void* q,
                           const void* w, const double* part_a, int grid_a,
                           double* part_b, int grid_b, int* ctl,
                           float* history, int n, int vec_bf16, int design,
                           double* sums, void* stream) {
  const void* k = b_kernel_for(w != nullptr, vec_bf16, design,
                               sums != nullptr);
  if (grid_a < 1 || grid_b < 1 || k == nullptr ||
      (design == 0 && sums != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  BArgs a{x, r, p, q, w, part_a, grid_a, part_b,
          reinterpret_cast<Ctl*>(ctl), history, n, sums};
  if (design == 0) return cgx::launch<kThreads>(k, grid_b, &a, stream);
  B2Args b2{a, grid_b};
  return cgx::launch<kThreads>(k, grid_b, &b2, stream);
}
