// cask_tpu native preprocessing core.
//
// cask analog: the C++ host runtime / frontend (SURVEY.md §2 R1, R6) —
// matrix parsing, format encoding, partitioning and factorization ran in
// native code there, and do here too.  The TPU compute path is JAX/Pallas;
// this library owns the host-side hot loops that are awkward or slow to
// vectorize in numpy:
//
//   - MatrixMarket coordinate-body parsing
//   - ILU(0) factorization (sequential row recurrence)
//   - triangular level-schedule extraction
//   - reverse Cuthill–McKee reordering (bandwidth reduction feeds the
//     DIA/windowed kernels)
//   - CSR → BSR block grouping
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in the image).
// All index arrays are int32 (TPU-native width); sizes are int64.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <algorithm>
#include <queue>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// MatrixMarket coordinate body: parse nnz lines of "i j [v]".
// field: 0 = pattern (v=1), 1 = real/integer, 2 = complex (keep real part).
// Returns number of entries parsed, or -1 on malformed input.
// ---------------------------------------------------------------------------
int64_t cask_parse_mtx_body(const char* buf, int64_t len, int64_t nnz,
                            int32_t field, int32_t* row, int32_t* col,
                            double* val) {
  const char* p = buf;
  const char* end = buf + len;
  for (int64_t k = 0; k < nnz; ++k) {
    char* q;
    long r = strtol(p, &q, 10);
    if (q == p) return -1;
    p = q;
    long c = strtol(p, &q, 10);
    if (q == p) return -1;
    p = q;
    double v = 1.0;
    if (field != 0) {
      v = strtod(p, &q);
      if (q == p) return -1;
      p = q;
      if (field == 2) {  // skip imaginary part
        strtod(p, &q);
        p = q;
      }
    }
    if (p > end) return -1;
    row[k] = (int32_t)(r - 1);
    col[k] = (int32_t)(c - 1);
    val[k] = v;
  }
  return nnz;
}

// ---------------------------------------------------------------------------
// ILU(0): in-place IKJ factorization on the CSR pattern.
// Requires sorted column indices per row and a present diagonal.
// Returns 0 on success, -(i+1) for a structural/zero pivot in row i.
// ---------------------------------------------------------------------------
int32_t cask_ilu0(int32_t n, const int32_t* indptr, const int32_t* indices,
                  double* lu) {
  std::vector<int32_t> diag(n, -1);
  std::vector<int32_t> pos(n, -1);
  for (int32_t i = 0; i < n; ++i) {
    for (int32_t t = indptr[i]; t < indptr[i + 1]; ++t)
      if (indices[t] == i) { diag[i] = t; break; }
    if (diag[i] < 0) return -(i + 1);
  }
  for (int32_t i = 0; i < n; ++i) {
    const int32_t s = indptr[i], e = indptr[i + 1];
    for (int32_t t = s; t < e; ++t) pos[indices[t]] = t;
    for (int32_t t = s; t < e; ++t) {
      const int32_t k = indices[t];
      if (k >= i) break;
      const double dk = lu[diag[k]];
      if (dk == 0.0) { for (int32_t t2 = s; t2 < e; ++t2) pos[indices[t2]] = -1;
                       return -(k + 1); }
      const double lik = lu[t] / dk;
      lu[t] = lik;
      for (int32_t u = diag[k] + 1; u < indptr[k + 1]; ++u) {
        const int32_t p = pos[indices[u]];
        if (p >= 0) lu[p] -= lik * lu[u];
      }
    }
    if (lu[diag[i]] == 0.0) { for (int32_t t = s; t < e; ++t) pos[indices[t]] = -1;
                              return -(i + 1); }
    for (int32_t t = s; t < e; ++t) pos[indices[t]] = -1;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Level schedule for a (lower) triangular pattern: level[i] =
// 1 + max(level[j]) over strict dependencies j of row i.  For an upper
// pattern, the caller passes the structure reflected (rows reversed).
// strict CSR: per-row strict off-diagonal entries only.
// Returns number of levels.
// ---------------------------------------------------------------------------
int32_t cask_levels_lower(int32_t n, const int32_t* sptr, const int32_t* scol,
                          int32_t* level) {
  int32_t nlev = 0;
  for (int32_t i = 0; i < n; ++i) {
    int32_t lv = 0;
    for (int32_t t = sptr[i]; t < sptr[i + 1]; ++t) {
      const int32_t l = level[scol[t]] + 1;
      if (l > lv) lv = l;
    }
    level[i] = lv;
    if (lv + 1 > nlev) nlev = lv + 1;
  }
  return nlev;
}

// ---------------------------------------------------------------------------
// Reverse Cuthill–McKee: bandwidth-reducing permutation on the pattern's
// symmetrized graph (caller passes a structurally symmetric CSR).
// perm[new] = old.  Handles disconnected components.
// ---------------------------------------------------------------------------
void cask_rcm(int32_t n, const int32_t* indptr, const int32_t* indices,
              int32_t* perm) {
  std::vector<int32_t> deg(n);
  for (int32_t i = 0; i < n; ++i) deg[i] = indptr[i + 1] - indptr[i];
  std::vector<uint8_t> seen(n, 0);
  std::vector<int32_t> order;
  order.reserve(n);
  std::vector<int32_t> nbrs;
  for (int32_t comp_start = 0; comp_start < n;) {
    // next unseen vertex of minimum degree as the component seed
    int32_t seed = -1, best = INT32_MAX;
    for (int32_t i = 0; i < n; ++i)
      if (!seen[i] && deg[i] < best) { best = deg[i]; seed = i; }
    if (seed < 0) break;
    std::queue<int32_t> q;
    q.push(seed);
    seen[seed] = 1;
    while (!q.empty()) {
      const int32_t u = q.front();
      q.pop();
      order.push_back(u);
      nbrs.clear();
      for (int32_t t = indptr[u]; t < indptr[u + 1]; ++t) {
        const int32_t v = indices[t];
        if (v >= 0 && v < n && !seen[v]) { seen[v] = 1; nbrs.push_back(v); }
      }
      std::sort(nbrs.begin(), nbrs.end(),
                [&](int32_t a, int32_t b) { return deg[a] < deg[b]; });
      for (int32_t v : nbrs) q.push(v);
    }
    comp_start = (int32_t)order.size();
  }
  // reverse
  for (int32_t i = 0; i < n; ++i) perm[i] = order[n - 1 - i];
}

// ---------------------------------------------------------------------------
// CSR → BSR, two-pass.  Pass 1 (count): number of occupied (br,bc) blocks.
// Pass 2 (fill): block indptr/indices + dense block values.
// Pattern must have sorted columns per row.  Scratch: head[] of size
// n_block_cols, caller-allocated, initialized to -1 by this function.
// ---------------------------------------------------------------------------
int64_t cask_bsr_count(int32_t m, int32_t n, const int32_t* indptr,
                       const int32_t* indices, int32_t br, int32_t bc) {
  const int32_t nbr = (m + br - 1) / br;
  const int32_t nbc = (n + bc - 1) / bc;
  std::vector<int32_t> stamp(nbc, -1);
  int64_t blocks = 0;
  for (int32_t b = 0; b < nbr; ++b) {
    const int32_t r0 = b * br;
    const int32_t r1 = std::min(r0 + br, m);
    for (int32_t r = r0; r < r1; ++r)
      for (int32_t t = indptr[r]; t < indptr[r + 1]; ++t) {
        const int32_t j = indices[t] / bc;
        if (stamp[j] != b) { stamp[j] = b; ++blocks; }
      }
  }
  return blocks;
}

int64_t cask_bsr_fill(int32_t m, int32_t n, const int32_t* indptr,
                      const int32_t* indices, const double* data, int32_t br,
                      int32_t bc, int32_t* bindptr, int32_t* bindices,
                      double* bdata /* (nblocks, br, bc) zero-initialized */) {
  const int32_t nbr = (m + br - 1) / br;
  const int32_t nbc = (n + bc - 1) / bc;
  std::vector<int32_t> slot(nbc, -1);
  std::vector<int32_t> stamp(nbc, -1);
  int64_t blocks = 0;
  bindptr[0] = 0;
  for (int32_t b = 0; b < nbr; ++b) {
    const int32_t r0 = b * br;
    const int32_t r1 = std::min(r0 + br, m);
    const int64_t row_start = blocks;
    // discover blocks in sorted block-column order: collect then sort
    std::vector<int32_t> cols_here;
    for (int32_t r = r0; r < r1; ++r)
      for (int32_t t = indptr[r]; t < indptr[r + 1]; ++t) {
        const int32_t j = indices[t] / bc;
        if (stamp[j] != b) { stamp[j] = b; cols_here.push_back(j); }
      }
    std::sort(cols_here.begin(), cols_here.end());
    for (int32_t j : cols_here) {
      slot[j] = (int32_t)blocks;
      bindices[blocks] = j;
      ++blocks;
    }
    for (int32_t r = r0; r < r1; ++r)
      for (int32_t t = indptr[r]; t < indptr[r + 1]; ++t) {
        const int32_t j = indices[t] / bc;
        const int64_t s = slot[j];
        bdata[(s * br + (r - r0)) * bc + (indices[t] - j * bc)] += data[t];
      }
    bindptr[b + 1] = (int32_t)blocks;
    (void)row_start;
  }
  return blocks;
}

// ---------------------------------------------------------------------------
// SpGEMM (Gustavson).  Two-pass: count nnz per C row, then fill sorted
// columns + values.  Dense scratch of size p per pass (the classic
// sparse-accumulator).  Used when the expansion-based device plan would
// blow up (heavy-tailed graphs).
// ---------------------------------------------------------------------------
int64_t cask_spgemm_count(int32_t m, int32_t p, const int32_t* a_ptr,
                          const int32_t* a_col, const int32_t* b_ptr,
                          const int32_t* b_col, int32_t* c_ptr /* m+1 */) {
  std::vector<int32_t> stamp(p, -1);
  int64_t total = 0;
  c_ptr[0] = 0;
  for (int32_t i = 0; i < m; ++i) {
    int32_t cnt = 0;
    for (int32_t t = a_ptr[i]; t < a_ptr[i + 1]; ++t) {
      const int32_t k = a_col[t];
      for (int32_t u = b_ptr[k]; u < b_ptr[k + 1]; ++u) {
        const int32_t j = b_col[u];
        if (stamp[j] != i) { stamp[j] = i; ++cnt; }
      }
    }
    total += cnt;
    c_ptr[i + 1] = (int32_t)total;
  }
  return total;
}

void cask_spgemm_fill(int32_t m, int32_t p, const int32_t* a_ptr,
                      const int32_t* a_col, const double* a_val,
                      const int32_t* b_ptr, const int32_t* b_col,
                      const double* b_val, const int32_t* c_ptr,
                      int32_t* c_col, double* c_val) {
  std::vector<double> acc(p, 0.0);
  std::vector<int32_t> stamp(p, -1);
  std::vector<int32_t> cols;
  for (int32_t i = 0; i < m; ++i) {
    cols.clear();
    for (int32_t t = a_ptr[i]; t < a_ptr[i + 1]; ++t) {
      const int32_t k = a_col[t];
      const double av = a_val[t];
      for (int32_t u = b_ptr[k]; u < b_ptr[k + 1]; ++u) {
        const int32_t j = b_col[u];
        if (stamp[j] != i) { stamp[j] = i; acc[j] = 0.0; cols.push_back(j); }
        acc[j] += av * b_val[u];
      }
    }
    std::sort(cols.begin(), cols.end());
    int32_t w = c_ptr[i];
    for (int32_t j : cols) { c_col[w] = j; c_val[w] = acc[j]; ++w; }
  }
}

// ---------------------------------------------------------------------------
// Greedy (Vaněk) aggregation over a symmetric strength graph in CSR form:
// pass 1 roots nodes whose strong neighborhood is fully unaggregated,
// pass 2 attaches leftovers to their first aggregated strong neighbor,
// pass 3 makes isolated nodes singletons.  Mirrors the numpy/Python
// fallback in solvers/amg.py exactly (order-dependent by design, so the
// two paths produce identical aggregates).  Returns the aggregate count.
// ---------------------------------------------------------------------------
int32_t cask_aggregate(int32_t n, const int32_t* indptr,
                       const int32_t* indices, int32_t* agg) {
  for (int32_t i = 0; i < n; ++i) agg[i] = -1;
  int32_t next_id = 0;
  for (int32_t i = 0; i < n; ++i) {
    if (agg[i] != -1) continue;
    bool free_nbhd = true;
    for (int32_t k = indptr[i]; k < indptr[i + 1]; ++k)
      if (agg[indices[k]] != -1) { free_nbhd = false; break; }
    if (free_nbhd) {
      agg[i] = next_id;
      for (int32_t k = indptr[i]; k < indptr[i + 1]; ++k)
        agg[indices[k]] = next_id;
      ++next_id;
    }
  }
  for (int32_t i = 0; i < n; ++i) {
    if (agg[i] != -1) continue;
    for (int32_t k = indptr[i]; k < indptr[i + 1]; ++k) {
      int32_t a = agg[indices[k]];
      if (a != -1) { agg[i] = a; break; }
    }
  }
  for (int32_t i = 0; i < n; ++i)
    if (agg[i] == -1) agg[i] = next_id++;
  return next_id;
}

}  // extern "C"
