// IC(0) numeric factorization + level scheduling over CSR (host setup path).
//
// The port's own copy of the JAX package's engine (cgx/native/src/ic0.cpp),
// behind cgx_torch.solve.ic0: the factorization is sequential host work; the
// apply runs on the device as level sweeps of torch ops.  The Python loops in
// cgx_torch.solve.ic0 are the reference semantics (use_native=False).
//
// Input: the LOWER-triangular pattern of A in CSR (row-sorted columns,
// diagonal last in each row).  In-place numeric factorization, then level
// assignment.  Returns 0 on success, 1 with the row index in *fail_row on
// pivot breakdown.

#include <cmath>
#include <cstdint>
#include <vector>

extern "C" {

// values: (nnz) in/out — on entry tril(A) values, on exit L values.
// cols/indptr: tril pattern.  levels: (n) out — dependency level per row.
int32_t cgx_ic0_factor(int64_t n, const int32_t* indptr, const int32_t* cols,
                       double* values, int32_t* levels, int64_t* fail_row) {
  // Position of column c in row r (dense scratch, reset per row): for the
  // "up-looking" dot products we need random access into row j.
  std::vector<int64_t> pos(static_cast<size_t>(n), -1);

  for (int64_t i = 0; i < n; ++i) {
    const int64_t s = indptr[i], e = indptr[i + 1];
    // Mark row i's columns.
    for (int64_t t = s; t < e; ++t) pos[cols[t]] = t;

    int32_t lvl = 0;
    for (int64_t t = s; t < e; ++t) {
      const int64_t j = cols[t];
      const int64_t js = indptr[j], je = indptr[j + 1];
      double acc = values[t];
      if (j < i) {
        // acc -= dot(L[i, :j], L[j, :j]) over the sparse intersection —
        // iterate the (usually shorter) row j, probe row i via pos[].
        for (int64_t tt = js; tt < je - 1; ++tt) {
          const int64_t c = cols[tt];
          const int64_t pi = pos[c];
          if (pi >= 0 && pi < t) acc -= values[pi] * values[tt];
        }
        values[t] = acc / values[je - 1];  // diag of row j is last
        if (levels[j] + 1 > lvl) lvl = levels[j] + 1;
      } else {
        // Pivot: acc -= ||L[i, :i]||^2 over this row's off-diagonals.
        for (int64_t tt = s; tt < t; ++tt) acc -= values[tt] * values[tt];
        if (acc <= 0.0) {
          for (int64_t tt = s; tt < e; ++tt) pos[cols[tt]] = -1;
          *fail_row = i;
          return 1;
        }
        values[t] = std::sqrt(acc);
      }
    }
    levels[i] = lvl;
    for (int64_t t = s; t < e; ++t) pos[cols[t]] = -1;
  }
  return 0;
}

// Level schedule for an arbitrary lower-triangular CSR factor (diag last).
void cgx_level_schedule(int64_t n, const int32_t* indptr, const int32_t* cols,
                        int32_t* levels) {
  for (int64_t i = 0; i < n; ++i) {
    int32_t lvl = 0;
    for (int64_t t = indptr[i]; t < indptr[i + 1] - 1; ++t) {
      const int32_t l = levels[cols[t]] + 1;
      if (l > lvl) lvl = l;
    }
    levels[i] = lvl;
  }
}

}  // extern "C"
