// K5: the two-pass CG iteration over k right-hand sides (kernels A and B).
//
// Replaces the Pallas kernels cgx/kernels/fused_multi.py:_kernel_a_multi
// (Q = Ã·P for k columns with the per-column p·q and q·q) and
// :_kernel_b_multi (per-column α and β with the live freeze, then
// X += αP, R −= αQ, P = R + βP with per-column Σr² and Σr²·w), which
// _solve_multi runs once each per iteration under a lax.while_loop.  It is
// K3 (fused_engine.cu) over k columns: the same arithmetic per column, so a
// column of K5 rounds as K3 rounds it.
//
// Layout: k flat columns, (k, n) contiguous (the JAX package's b.T).  The
// band-stacked TPU layout, its band tiling and VMEM windows are placement
// for the TPU and are not carried over.
//
// What bounds it on this card is bytes, and the reason for the kernel is
// the coefficient planes: one thread per row reads each plane value (and
// its mirror) once and applies it to all k columns from a register, so the
// 13 plane streams of a symmetric 27-point operator are read once per
// iteration instead of k times.  Per iteration A reads the planes and P and
// writes Q; B reads X, R, P, Q and the one weight vector w shared by all
// columns, and writes X, R, P.  Columns are processed kCols = 4 at a time;
// above 4 the planes stream once per group of 4.
//
// Control stays on the device, as in K3, in a block of int32 words (floats
// by bit pattern): a header, then five float arrays of k.  Unlike K3, the
// cross-block sums are folded once, by the block that finishes last (a
// ticket counter per kernel; the block partials are fenced before the
// ticket): with k columns every block folding every partial, as K3 does,
// would read 2k·grid values per block per kernel.  One block folds in one
// fixed order without further atomics, so two runs are bit-identical:
//
//   * kernel A's last block folds Σ p·q and Σ q·q per column into the block;
//   * kernel B reads them with Σr² of the previous pass, computes per column
//     live = rz > 0 && pq > 0, α = live ? rz/pq : 0 and
//     β = live ? (α²·qq − rz)/rz : 0 (the communication-avoiding identity,
//     as in K3), updates, and its last block folds Σr² and Σr²·w per
//     column, counts the iteration and takes the shared exit
//     k < maxit && any_j(rw_j > tol²_j);  once it is taken every later
//     launch returns at once, so the host reads the flag once per chunk.
//
// A column that has converged keeps iterating with the others (the JAX
// package's semantics); a column whose rz or pq reaches 0 is frozen
// (α = β = 0: x and r unchanged, p ← r), so a zero column coasts without
// NaN.  The four sums are taken exactly, as K3 takes them: fp64 products of
// fp32 values, fp64 sums, one rounding to fp32.
//
// bf16 planes (the Pallas kernel's plane_dtype, cgx/kernels/fused_multi.py
// :160): kernel A is a template on the plane type P, float or bf16.  A bf16
// plane value is widened to fp32 in a register as it is loaded (exact) and
// everything else is unchanged, so the bf16 mode equals the fp32 mode run on
// the planes rounded through bf16, bit for bit.  Kernel B streams no planes.
//
// Distribution (cgx/kernels/fused_multi.py:_exchange_multi and the psums of
// _solve_multi under shard_map): K3's cross-rank mode (fused_engine.cu) over
// k columns.  A rank holds its x-planes of every column; P's columns carry
// one ghost x-plane on each side (column stride ldp, P pointing at the first
// local row; the wrapper sends the boundary planes before kernel A), and a
// cgx::Span says which ghost planes hold a neighbour's values.  The march
// stages planes i0 − 1 … i1 of its chunk from that span, so a chunk at the
// rank's first or last plane reads the ghost plane, and the outer ranks'
// masks drop the taps that leave the grid.  A shard runs the cross-rank
// instances (kShard; the C entries take them where they get a span and
// `sums`, 4·ncols doubles):
//   * kernel A's last block writes its rank's Σ p·q and Σ q·q per column
//     unrounded (sums[0, 2k)); NCCL sums them; kernel B rounds them once;
//   * kernel B's last block writes Σr² and Σr²·w per column unrounded
//     (sums[2k, 4k)), counts the iteration and sets `pending`; after their
//     all-reduce the next kernel A's blocks each round them and take the
//     shared exit (the same bits in every block and on every rank), and its
//     block 0 publishes rz, rw and the flag.
// At one rank this is the single-card iteration bit for bit.  The
// single-card instances (kShard false) read the whole grid with the span's
// zeros and n as constants and have no cross-rank branch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "stencil.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 4;  // columns per pass over the rows

// The control block.  The wrapper (cgx_torch/kernels/fused_multi.py) fills
// it before a run and reads the iteration, the flag and rz/rw after it.
constexpr int kIt = 0;      // iterations done
constexpr int kDone = 1;    // 1: the shared exit is taken
constexpr int kMaxit = 2;   // iteration cap of the run
constexpr int kCountA = 3;  // kernel A's ticket counter (0 between launches)
constexpr int kCountB = 4;  // kernel B's ticket counter
constexpr int kPending = 5;  // cross-rank mode: B's sums wait in `sums`
constexpr int kHead = 8;
// Float arrays of ncols after the header, in this order.
constexpr int kRz = 0;   // Σ r² (solve space; β's denominator)
constexpr int kRw = 1;   // Σ r²·w (the exit test)
constexpr int kPq = 2;   // Σ p·q of the last kernel A
constexpr int kQq = 3;   // Σ q·q of the last kernel A
constexpr int kTol = 4;  // tol² per column

__device__ __forceinline__ float* field(int* ctl, int ncols, int f) {
  return reinterpret_cast<float*>(ctl + kHead + f * ncols);
}

using cgx::last_block;

struct AArgs {
  const float* p;        // ncols columns, ldp apart
  float* q;              // ncols × n
  const void* planes;    // P; null: constant taps only
  double* part;          // 2·ncols × gridDim.x: Σ p·q per column, then Σ q·q
  int* ctl;
  int ncols;
  int nx, ny, nz;
  cgx::PlaneTaps taps;
  cgx::Span span;        // a shard's: what P and the planes hold
  int ldp;               // a shard's P column stride (n on one card)
  double* sums;          // a shard's cross-rank sums (4·ncols)
};

// Kernel A's entry: true when the shared exit is taken.  Across ranks the
// exit is decided here, from kernel B's sums reduced since: every block
// rounds them and decides alike, block 0 publishes them (no block reads
// what it writes except the flag, and a block that reads the flag set
// returns as the deciding blocks do).
template <bool kShard>
__device__ __forceinline__ bool multi_a_stop(const AArgs& a) {
  int* ctl = a.ctl;
  if (ctl[kDone]) return true;
  if (!kShard || !ctl[kPending]) return false;
  const int k = a.ncols;
  const float* tol = field(ctl, k, kTol);
  bool go = false;
  for (int c = 0; c < k; ++c)
    go = go || static_cast<float>(a.sums[3 * k + c]) > tol[c];
  const bool stop = !(ctl[kIt] < ctl[kMaxit] && go);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    float* rz = field(ctl, k, kRz);
    float* rw = field(ctl, k, kRw);
    for (int c = 0; c < k; ++c) {
      rz[c] = static_cast<float>(a.sums[2 * k + c]);
      rw[c] = static_cast<float>(a.sums[3 * k + c]);
    }
    if (stop) {  // nothing left for NCCL to sum (kernel B clears the rest)
      ctl[kDone] = 1;
      for (int c = 0; c < 2 * k; ++c) a.sums[c] = 0.0;
    }
  }
  return stop;
}

// Kernel A's last block: the per-column sums, to the control block or,
// across ranks, unrounded to `sums`.
template <bool kShard>
__device__ __forceinline__ void multi_a_fold(const AArgs& a, double* smem) {
  float* pqs = field(a.ctl, a.ncols, kPq);
  float* qqs = field(a.ctl, a.ncols, kQq);
  for (int c = 0; c < a.ncols; ++c) {
    const double s = cgx::grid_sum<kThreads>(
        a.part + static_cast<size_t>(c) * gridDim.x, gridDim.x, smem);
    const double s2 = cgx::grid_sum<kThreads>(
        a.part + static_cast<size_t>(a.ncols + c) * gridDim.x, gridDim.x,
        smem);
    if (threadIdx.x == 0) {
      if constexpr (kShard) {
        a.sums[c] = s;
        a.sums[a.ncols + c] = s2;
      } else {
        pqs[c] = static_cast<float>(s);
        qqs[c] = static_cast<float>(s2);
      }
    }
  }
}

template <int kTaps, bool kPlanes, bool kSym, bool kShard, typename P>
__global__ void __launch_bounds__(kThreads) multi_a(AArgs a) {
  __shared__ double smem[kWarps + 1];
  if (multi_a_stop<kShard>(a)) return;
  const int n = a.nx * a.ny * a.nz;
  const size_t ld = static_cast<size_t>(n);
  const size_t ldp = kShard ? static_cast<size_t>(a.ldp) : ld;
  const cgx::Span span = kShard ? a.span : cgx::whole_grid(n, a.nx);
  const int stride = gridDim.x * kThreads;
  for (int c0 = 0; c0 < a.ncols; c0 += kCols) {
    const int nc = min(kCols, a.ncols - c0);
    const float* p = a.p + c0 * ldp;
    float* q = a.q + c0 * ld;
    double pq[kCols];
    double qq[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) pq[c] = qq[c] = 0.0;
    for (int row = blockIdx.x * kThreads + threadIdx.x; row < n;
         row += stride) {
      float acc[kCols];
      if constexpr (kPlanes) {
        cgx::plane_row_multi<kTaps, kSym, kCols>(
            p, ldp, nc, static_cast<const P*>(a.planes), row, span, a.ny,
            a.nz, a.taps, acc);
      } else {
        cgx::stencil_row_multi<kTaps, kCols>(p, ldp, nc, row, span, a.ny,
                                             a.nz, a.taps.s, acc);
      }
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        if (c < nc) {
          q[c * ld + row] = acc[c];
          const double qd = acc[c];
          const double pd = __ldg(p + c * ldp + row);
          pq[c] = __dadd_rn(pq[c], __dmul_rn(qd, pd));
          qq[c] = __dadd_rn(qq[c], __dmul_rn(qd, qd));
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      if (c < nc) {  // nc is the same in every thread of the block
        const double s = cgx::block_sum<kThreads>(pq[c], smem);
        const double s2 = cgx::block_sum<kThreads>(qq[c], smem);
        if (threadIdx.x == 0) {
          a.part[static_cast<size_t>(c0 + c) * gridDim.x + blockIdx.x] = s;
          a.part[static_cast<size_t>(a.ncols + c0 + c) * gridDim.x +
                 blockIdx.x] = s2;
        }
      }
    }
  }
  if (!last_block(a.ctl + kCountA)) return;
  multi_a_fold<kShard>(a, smem);
}

// -- The redesign: multi_a2, the 2.5-D march ---------------------------------
// multi_a read every neighbour of every column straight from global memory,
// one scalar load a tap and column, and divided twice a row: K5 A ran at 15 %
// of its byte bound at k = 4, its time following its loads (134 a row
// against K3 A's 53).  multi_a2 partitions the rows by tiles of the grid
// instead (cgx::MarchPlan): block b owns a tj × tk tile of nodes (j, k), two
// a thread, over `len` x-planes; it stages each x-plane of the kCols
// columns, tile and halo, into a ring of four slots in shared memory with
// cp.async (16-byte copies where a line is aligned, 4-byte ones at a ragged
// edge), copying plane i + 2 while it computes plane i from planes i − 1,
// i, i + 1.  A thread reads the stage at 32-bit shared addresses (cgx::lds),
// the taps' offsets come from the host (MarchPlan::rel) and their in-grid
// masks are taken once for j and k and once a plane for i.  Each row's
// arithmetic is multi_a's (stencil_tile_multi, plane_tile_multi: the same
// taps, masks, products and sums in the same order), so q equals
// multi_a's, the plain version's and K3 A's per column bit for bit; the
// plane values are read from global memory (their mirrors from the L2, as
// before: staging them too cost occupancy and measured slower).  The sums
// run in fp64 per thread along its march, then the block tree, then the
// last block's fold: another fixed order than multi_a's, the same in every
// run.  The grid comes from the shape (tiles × chunks, the chunks filling
// the card in one wave), not from occupancy.  multi_a (design 0) runs where
// the taps' halo does not fit the ring (kernels/fused_multi.py:
// FusedCGMulti.march is None) and is elsewhere the same-run "before".
struct A2Args {
  AArgs a;
  cgx::MarchPlan mp;
};

// Build knobs, picked by measurement on the H100 (PERF.md §6): 4 blocks an
// SM (64 registers; 3 and 5 were slower), one x-plane in flight ahead of
// the three a step reads (two took a fifth slot and cost a block an SM),
// two nodes a thread in a plane (one and four were slower).
constexpr int kBlocksPerSm = 4;
constexpr int kAhead = 1;
constexpr int kSlots = 3 + kAhead;
constexpr int kRows = 2;

__device__ __forceinline__ int ring_slot(int ip) {
  return ((ip % kSlots) + kSlots) % kSlots;
}

template <int kTaps, bool kPlanes, bool kSym, bool kShard, typename P>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    multi_a2(A2Args args) {
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ double smem[kWarps + 1];
  const AArgs& a = args.a;
  const cgx::MarchPlan& mp = args.mp;
  if (multi_a_stop<kShard>(a)) return;
  const int nx = a.nx, ny = a.ny, nz = a.nz;
  const int n = nx * ny * nz;
  const size_t ld = static_cast<size_t>(n);
  const size_t ldp = kShard ? static_cast<size_t>(a.ldp) : ld;
  const cgx::Span span = kShard ? a.span : cgx::whole_grid(n, nx);
  // The block's tile and chunk: k tiles fastest, then j tiles, then chunks.
  int b = blockIdx.x;
  const int tkx = b % mp.tiles_k;
  b /= mp.tiles_k;
  const int tjx = b % mp.tiles_j;
  const int ic = b / mp.tiles_j;
  const int j0 = tjx * mp.tj, k0 = tkx * mp.tk;
  const int i0 = ic * mp.len;
  const int i1 = min(i0 + mp.len, nx);
  const int u = threadIdx.x;
  // Thread u takes node k0 + kx of lines j0 + jx0 + r·(tj / rows), r <
  // rows.
  const int jx0 = u / mp.tk;
  const int kx = u - jx0 * mp.tk;
  const int jstep = mp.tj / mp.rows;
  const int k = k0 + kx;
  const int lines = mp.tj + 2 * mp.hj;
  const int width = mp.tk + 2 * mp.hk;
  const int cstride = lines * width;  // a column's share of a slot
  const int slot = kCols * cstride;
  const int chunks_line = width / 4;
  float* ring = reinterpret_cast<float*>(dyn);
  const int own0 = (jx0 + mp.hj) * width + kx + mp.hk;
  // The taps inside the grid in j and k, for each of the thread's nodes
  // (none for a node past the grid's edge), and all taps in i.
  unsigned jk_in[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int j = j0 + jx0 + r * jstep;
    jk_in[r] = j < ny && k < nz ? cgx::jk_taps(j, k, ny, nz, a.taps.s) : 0u;
  }
  const unsigned all_i = (1u << (a.taps.s.n - 1) << 1) - 1u;
  // Shared-window byte addresses: the ring, a slot, a column, the node.
  const unsigned ring_b =
      static_cast<unsigned>(__cvta_generic_to_shared(ring));
  const unsigned slot_b = slot * 4u, cstride_b = cstride * 4u;

  for (int c0 = 0; c0 < a.ncols; c0 += kCols) {
    const int nc = min(kCols, a.ncols - c0);
    const float* p = a.p + c0 * ldp;
    float* q = a.q + c0 * ld;
    // x-plane ip of the nc columns, tile and halo, into its ring slot.
    auto stage_plane = [&](int ip) {
      float* dst = ring + ring_slot(ip) * slot;
      const int total = nc * lines * chunks_line;
      for (int idx = u; idx < total; idx += kThreads) {
        const int cl = idx / chunks_line;
        const int ch = idx - cl * chunks_line;
        const int c = cl / lines;
        const int line = cl - c * lines;
        const long f = (static_cast<long>(ip) * ny + (j0 - mp.hj + line)) *
                           nz + k0 - mp.hk + ch * 4;
        cgx::stage_chunk(dst + c * cstride + line * width + ch * 4,
                         p + c * ldp, f, span.lo, span.hi);
      }
    };
    double pq[kCols];
    double qq[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) pq[c] = qq[c] = 0.0;
    for (int ip = i0 - 1; ip <= i0 + 1; ++ip) stage_plane(ip);
    cgx::cp_async_commit();
    for (int ip = i0 + 2; ip < i0 + 2 + kAhead; ++ip) {
      if (ip <= i1) stage_plane(ip);
      cgx::cp_async_commit();
    }
    for (int i = i0; i < i1; ++i) {
      cgx::cp_async_wait<kAhead>();
      __syncthreads();
      const unsigned i_in = (i > span.xlo && i < span.xhi - 1)
                                ? all_i
                                : cgx::i_taps(i, span.xlo, span.xhi,
                                              a.taps.s);
      const unsigned bm = ring_b + ring_slot(i - 1) * slot_b;
      const unsigned b0 = ring_b + ring_slot(i) * slot_b;
      const unsigned bp = ring_b + ring_slot(i + 1) * slot_b;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int j = j0 + jx0 + r * jstep;
        if (j >= ny || k >= nz) continue;
        const int row = (i * ny + j) * nz + k;
        const unsigned own = (own0 + r * jstep * width) * 4u;
        float acc[kCols];
        const unsigned in = jk_in[r] & i_in;
        if constexpr (kPlanes) {
          cgx::plane_tile_multi<kTaps, kSym, kCols>(
              bm + own, b0 + own, bp + own, cstride_b, in, mp.rel,
              static_cast<const P*>(a.planes), row, span, a.taps, acc);
        } else {
          cgx::stencil_tile_multi<kTaps, kCols>(bm + own, b0 + own, bp + own,
                                                cstride_b, in, mp.rel,
                                                a.taps.s, acc);
        }
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          if (c < nc) {
            q[c * ld + row] = acc[c];
            const double qd = acc[c];
            const double pd = cgx::lds(b0 + own + c * cstride_b);
            pq[c] = __dadd_rn(pq[c], __dmul_rn(qd, pd));
            qq[c] = __dadd_rn(qq[c], __dmul_rn(qd, qd));
          }
        }
      }
      __syncthreads();
      if (i + 2 + kAhead <= i1) stage_plane(i + 2 + kAhead);
      cgx::cp_async_commit();
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      if (c < nc) {  // nc is the same in every thread of the block
        const double s = cgx::block_sum<kThreads>(pq[c], smem);
        const double s2 = cgx::block_sum<kThreads>(qq[c], smem);
        if (u == 0) {
          a.part[static_cast<size_t>(c0 + c) * gridDim.x + blockIdx.x] = s;
          a.part[static_cast<size_t>(a.ncols + c0 + c) * gridDim.x +
                 blockIdx.x] = s2;
        }
      }
    }
  }
  if (!last_block(a.ctl + kCountA)) return;
  __threadfence();
  multi_a_fold<kShard>(a, smem);
}

struct BArgs {
  float* x;        // ncols × n, updated in place
  float* r;
  float* p;        // ncols columns, ldp apart (its rows only are written)
  const float* q;
  const float* w;  // n, shared by the columns; null: unweighted
  double* part;    // 2·ncols × gridDim.x: Σ r² per column, then Σ r²·w
  int* ctl;
  int ncols;
  int n;
  int ldp;         // a shard's P column stride (n on one card)
  double* sums;    // a shard's cross-rank sums (4·ncols)
};

template <bool kWeighted, bool kShard>
__global__ void __launch_bounds__(kThreads) multi_b(BArgs a) {
  __shared__ double smem[kWarps + 1];
  int* ctl = a.ctl;
  if (ctl[kDone]) {
    if (kShard && blockIdx.x == 0 && threadIdx.x == 0)
      for (int c = 2 * a.ncols; c < 4 * a.ncols; ++c) a.sums[c] = 0.0;
    return;
  }
  const float* rzs = field(ctl, a.ncols, kRz);
  const float* pqs = field(ctl, a.ncols, kPq);
  const float* qqs = field(ctl, a.ncols, kQq);
  const size_t ld = static_cast<size_t>(a.n);
  const size_t ldp = kShard ? static_cast<size_t>(a.ldp) : ld;
  const int stride = gridDim.x * kThreads;
  for (int c0 = 0; c0 < a.ncols; c0 += kCols) {
    const int nc = min(kCols, a.ncols - c0);
    float alpha[kCols];
    float beta[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      alpha[c] = beta[c] = 0.0f;
      if (c < nc) {
        const float rz = rzs[c0 + c];
        const float pq = kShard ? static_cast<float>(a.sums[c0 + c])
                                : pqs[c0 + c];
        const float qq = kShard
                             ? static_cast<float>(a.sums[a.ncols + c0 + c])
                             : qqs[c0 + c];
        if (rz > 0.0f && pq > 0.0f) {
          alpha[c] = __fdiv_rn(rz, pq);
          beta[c] = __fdiv_rn(
              __fsub_rn(__fmul_rn(__fmul_rn(alpha[c], alpha[c]), qq), rz), rz);
        }
      }
    }
    double acc[kCols];
    double accw[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[c] = accw[c] = 0.0;
    for (int row = blockIdx.x * kThreads + threadIdx.x; row < a.n;
         row += stride) {
      double wd = 0.0;
      if constexpr (kWeighted) wd = static_cast<double>(a.w[row]);
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        if (c < nc) {
          const size_t i = (c0 + c) * ld + row;
          const size_t ip = (c0 + c) * ldp + row;
          const float pv = a.p[ip];
          a.x[i] = __fadd_rn(a.x[i], __fmul_rn(alpha[c], pv));
          const float rv = __fsub_rn(a.r[i], __fmul_rn(alpha[c], a.q[i]));
          a.r[i] = rv;
          a.p[ip] = __fadd_rn(rv, __fmul_rn(beta[c], pv));
          const double rsq = __dmul_rn(rv, rv);
          acc[c] = __dadd_rn(acc[c], rsq);
          if constexpr (kWeighted)
            accw[c] = __dadd_rn(accw[c], __dmul_rn(rsq, wd));
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      if (c < nc) {
        const double s = cgx::block_sum<kThreads>(acc[c], smem);
        double sw = s;
        if constexpr (kWeighted) sw = cgx::block_sum<kThreads>(accw[c], smem);
        if (threadIdx.x == 0) {
          a.part[static_cast<size_t>(c0 + c) * gridDim.x + blockIdx.x] = s;
          a.part[static_cast<size_t>(a.ncols + c0 + c) * gridDim.x +
                 blockIdx.x] = sw;
        }
      }
    }
  }
  // Every block has read rz (its α and β) before its ticket, so the last
  // block may overwrite it.
  if (!last_block(ctl + kCountB)) return;
  float* rz_out = field(ctl, a.ncols, kRz);
  float* rw_out = field(ctl, a.ncols, kRw);
  const float* tol = field(ctl, a.ncols, kTol);
  bool go = false;
  for (int c = 0; c < a.ncols; ++c) {
    const double s = cgx::grid_sum<kThreads>(
        a.part + static_cast<size_t>(c) * gridDim.x, gridDim.x, smem);
    const double sw = cgx::grid_sum<kThreads>(
        a.part + static_cast<size_t>(a.ncols + c) * gridDim.x, gridDim.x,
        smem);
    if constexpr (kShard) {  // the next kernel A rounds the reduced sums
      if (threadIdx.x == 0) {
        a.sums[2 * a.ncols + c] = s;
        a.sums[3 * a.ncols + c] = sw;
      }
      continue;
    }
    const float rw = static_cast<float>(sw);
    go = go || rw > tol[c];
    if (threadIdx.x == 0) {
      rz_out[c] = static_cast<float>(s);
      rw_out[c] = rw;
    }
  }
  if (threadIdx.x == 0) {
    const int it = ctl[kIt] + 1;
    ctl[kIt] = it;
    if constexpr (kShard)
      ctl[kPending] = 1;
    else
      ctl[kDone] = (it < ctl[kMaxit] && go) ? 0 : 1;
  }
}

// The instance of kernel A (design 0: multi_a, 1: multi_a2; a shard's when
// `shard`).
template <bool kShard, typename P>
const void* a_kernel_shard(int ntaps, int variable, int sym, int design) {
  const bool wide = ntaps > 7;
#define CGX_A(T, PL, SY)                                                  \
  (design ? reinterpret_cast<const void*>(multi_a2<T, PL, SY, kShard, P>) \
          : reinterpret_cast<const void*>(multi_a<T, PL, SY, kShard, P>))
  if (!variable)
    return wide ? CGX_A(cgx::kMaxTaps, false, false) : CGX_A(7, false, false);
  if (sym)
    return wide ? CGX_A(cgx::kMaxTaps, true, true) : CGX_A(7, true, true);
  return wide ? CGX_A(cgx::kMaxTaps, true, false) : CGX_A(7, true, false);
#undef CGX_A
}

template <typename P>
const void* a_kernel_typed(int ntaps, int variable, int sym, int design,
                           bool shard) {
  return shard ? a_kernel_shard<true, P>(ntaps, variable, sym, design)
               : a_kernel_shard<false, P>(ntaps, variable, sym, design);
}

const void* a_kernel_for(int ntaps, int variable, int sym, int plane_bf16,
                         int design, bool shard = false) {
  return plane_bf16 && variable
             ? a_kernel_typed<__nv_bfloat16>(ntaps, variable, sym, design,
                                             shard)
             : a_kernel_typed<float>(ntaps, variable, sym, design, shard);
}

const void* b_kernel_for(int weighted, bool shard = false) {
#define CGX_B(KW)                                                  \
  (shard ? reinterpret_cast<const void*>(multi_b<KW, true>)        \
         : reinterpret_cast<const void*>(multi_b<KW, false>))
  return weighted ? CGX_B(true) : CGX_B(false);
#undef CGX_B
}

// The march's checks: 256 threads a tile, whole 16-byte chunks a line, and
// every tap inside the staged halo.
bool march_ok(const cgx::MarchPlan& mp, int nx, int ny, int nz, int ntaps,
              const int* taps) {
  if (mp.tj < 1 || mp.tk < 1 || mp.rows != kRows || mp.tj % mp.rows != 0 ||
      mp.tj / mp.rows * mp.tk != kThreads || mp.len < 1 || mp.hj < 0 ||
      mp.hk < 0 || mp.hk % 4 != 0 || mp.tk % 4 != 0)
    return false;
  if (mp.tiles_j != (ny + mp.tj - 1) / mp.tj ||
      mp.tiles_k != (nz + mp.tk - 1) / mp.tk ||
      mp.chunks != (nx + mp.len - 1) / mp.len)
    return false;
  for (int t = 0; t < ntaps; ++t) {
    const int dx = taps[3 * t], dy = taps[3 * t + 1], dz = taps[3 * t + 2];
    if (dx < -1 || dx > 1 || dy < -mp.hj || dy > mp.hj || dz < -mp.hk ||
        dz > mp.hk)
      return false;
  }
  return true;
}

// The ring: kSlots x-planes of kCols columns' staged lines.
int march_smem(const cgx::MarchPlan& mp) {
  return kSlots * kCols * (mp.tj + 2 * mp.hj) * (mp.tk + 2 * mp.hk) *
         static_cast<int>(sizeof(float));
}

}  // namespace

// design 0: the first kernel A's grid (as many blocks as fit at once; a
// shard's instance runs on the same grid, the same partition of the sums);
// design 1: the march's, tiles_j × tiles_k × chunks from the plan (tj, tk,
// len over the nx × ny × nz grid).
extern "C" int cgx_multi_a_grid(int device, int ntaps, int variable, int sym,
                                int plane_bf16, int design, int nx, int ny,
                                int nz, int tj, int tk, int len, int* grid) {
  if (design == 0)
    return cgx::full_grid<kThreads>(
        device, a_kernel_for(ntaps, variable, sym, plane_bf16, 0), grid);
  if (tj < 1 || tk < 1 || len < 1 || nx < 1 || ny < 1 || nz < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long g = static_cast<long>((ny + tj - 1) / tj) * ((nz + tk - 1) / tk) *
                 ((nx + len - 1) / len);
  if (g > 2147483647L) return static_cast<int>(cudaErrorInvalidValue);
  *grid = static_cast<int>(g);
  return 0;
}

// Kernel B's grid, the partition of its sums (a shard's instance runs on
// the same grid).
extern "C" int cgx_multi_b_grid(int device, int weighted, int* grid) {
  return cgx::full_grid<kThreads>(device, b_kernel_for(weighted), grid);
}

// Kernel A on `stream` over ncols columns of n = nx·ny·nz rows.
// `plane[t]` is tap t's plane index (−1: constant tap coeffs[t]); `planes`
// is null for a constant-coefficient operator and holds bf16 when
// plane_bf16.  `part` holds 2·ncols·grid doubles; `ctl` is the control
// block.  design 0 runs the first kernel A on `grid` blocks; design 1 the
// march on the plan (tj, tk, rows, len, hj, hk), `grid` its tiles ×
// chunks, with its ring of stage in dynamic shared memory; a plan that does
// not fit the shape, the taps or the shared memory is refused.  A rank's
// shard runs the cross-rank instance: nx is its x-planes, `span` five ints
// (lo, hi, xlo, xhi, pstride: cgx::Span), P's columns ldp apart, p and
// planes pointing at the first local row, and `sums` 4·ncols doubles; on
// one card span and sums are null and ldp is n.
extern "C" int cgx_multi_a(const float* p, float* q, const void* planes,
                           double* part, int grid, int* ctl, int ncols, int nx,
                           int ny, int nz, int ntaps, const int* taps,
                           const float* coeffs, const int* plane, int sym,
                           int plane_bf16, int design, int tj, int tk,
                           int rows, int len, int hj, int hk, const int* span,
                           int ldp, double* sums, void* stream) {
  if (ntaps < 1 || ntaps > cgx::kMaxTaps || grid < 1 || ncols < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n = nx * ny * nz;
  const bool shard = span != nullptr;
  if (shard != (sums != nullptr) || (shard ? ldp < n : ldp != n))
    return static_cast<int>(cudaErrorInvalidValue);
  const cgx::Span sp =
      shard ? cgx::Span{span[0], span[1], span[2], span[3], span[4]}
            : cgx::Span{};
  AArgs a{p,
          q,
          planes,
          part,
          ctl,
          ncols,
          nx,
          ny,
          nz,
          cgx::make_plane_taps(ntaps, taps, coeffs, plane, ny, nz),
          sp,
          ldp,
          sums};
  const void* k =
      a_kernel_for(ntaps, planes != nullptr, sym, plane_bf16, design, shard);
  if (design == 0) return cgx::launch<kThreads>(k, grid, &a, stream);
  cgx::MarchPlan mp{tj, tk, rows, len, hj, hk, 0, 0, 0, {}};
  for (int t = 0; t < ntaps; ++t)
    mp.rel[t] = 4 * (taps[3 * t + 1] * (tk + 2 * hk) + taps[3 * t + 2]);
  if (tj >= 1 && tk >= 1 && len >= 1) {
    mp.tiles_j = (ny + tj - 1) / tj;
    mp.tiles_k = (nz + tk - 1) / tk;
    mp.chunks = (nx + len - 1) / len;
  }
  if (!march_ok(mp, nx, ny, nz, ntaps, taps) ||
      static_cast<long>(mp.tiles_j) * mp.tiles_k * mp.chunks != grid)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = march_smem(mp);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) {
      cudaGetLastError();  // not left for the next launch to report
      return static_cast<int>(e);
    }
  }
  A2Args a2{a, mp};
  void* params[] = {&a2};
  const cudaError_t e = cudaLaunchKernel(k, dim3(grid), dim3(kThreads),
                                         params, smem,
                                         static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// Kernel B on `stream`; `w` is null for an unweighted solve.  P's columns
// lie ldp apart (n on one card); `sums` (4·ncols doubles; null on one card)
// selects a shard's cross-rank instance.
extern "C" int cgx_multi_b(float* x, float* r, float* p, const float* q,
                           const float* w, double* part, int grid, int* ctl,
                           int ncols, int n, int ldp, double* sums,
                           void* stream) {
  const bool shard = sums != nullptr;
  if (grid < 1 || ncols < 1 || (shard ? ldp < n : ldp != n))
    return static_cast<int>(cudaErrorInvalidValue);
  BArgs a{x, r, p, q, w, part, ctl, ncols, n, ldp, sums};
  return cgx::launch<kThreads>(b_kernel_for(w != nullptr, shard), grid, &a,
                               stream);
}
