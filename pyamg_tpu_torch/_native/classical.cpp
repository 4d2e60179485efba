// Classical (Ruge-Stuben) setup over CSR/ELL host buffers: the port's copy
// of rs_cf_splitting, rs_cf_splitting_pass2, remove_strong_ff_ell and
// classical_interpolation_ell in pyamg_tpu/_native/amg_host.cpp (after the
// reference's ruge_stuben.h:285,484,1133,1239).  The splitting fixes every
// coarse level and the interpolation weights fix P, so this copy must
// compute exactly what the reference's does.  Values are float64; the
// caller casts P back to A's dtype.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -o libclassical.so classical.cpp
// ABI: plain C functions over int32 / float64 buffers (ctypes).

#include <cmath>
#include <cstddef>
#include <cstdint>
#include <queue>
#include <utility>
#include <vector>

using i32 = std::int32_t;
using f64 = double;
using std::size_t;

namespace {
constexpr i32 U_NODE = -3;   // unassigned
constexpr i32 PRE_F = -2;    // tentative F
constexpr i32 F_NODE = 0;
constexpr i32 C_NODE = 1;
}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// Ruge-Stuben first-pass C/F splitting (classic greedy, max-heap variant).
//   S  : strength CSR  (row i = points strongly influencing i)
//   T  : S transpose   (row i = points i strongly influences)
//   influence: extra per-node weights (usually 0)
//   splitting out: 1 = C, 0 = F
// ---------------------------------------------------------------------------
void rs_cf_splitting(i32 n, const i32* Sp, const i32* Sj,
                     const i32* Tp, const i32* Tj,
                     const i32* influence, i32* splitting) {
  std::vector<i32> lam(n);
  std::vector<i32> state(n, U_NODE);

  for (i32 i = 0; i < n; ++i)
    lam[i] = (Tp[i + 1] - Tp[i]) + (influence ? influence[i] : 0);

  // isolated nodes (no influence on anyone) start as F
  for (i32 i = 0; i < n; ++i) {
    bool only_self = (Tp[i + 1] - Tp[i] == 1) && (Tj[Tp[i]] == i);
    if (lam[i] == 0 || (lam[i] == 1 && only_self)) state[i] = F_NODE;
  }

  // lazy-deletion max-heap of (lambda, node)
  using Entry = std::pair<i32, i32>;
  std::priority_queue<Entry> heap;
  for (i32 i = 0; i < n; ++i)
    if (state[i] == U_NODE) heap.push({lam[i], i});

  while (!heap.empty()) {
    auto [l, i] = heap.top();
    heap.pop();
    if (state[i] != U_NODE || l != lam[i]) continue;  // stale entry
    if (lam[i] <= 0) break;
    state[i] = C_NODE;

    // neighbors that i influences become F
    for (i32 jj = Tp[i]; jj < Tp[i + 1]; ++jj) {
      i32 j = Tj[jj];
      if (state[j] == U_NODE) state[j] = PRE_F;
    }
    for (i32 jj = Tp[i]; jj < Tp[i + 1]; ++jj) {
      i32 j = Tj[jj];
      if (state[j] != PRE_F) continue;
      state[j] = F_NODE;
      // unassigned influencers of the new F point gain weight
      for (i32 kk = Sp[j]; kk < Sp[j + 1]; ++kk) {
        i32 k = Sj[kk];
        if (state[k] == U_NODE && lam[k] < n - 1) {
          ++lam[k];
          heap.push({lam[k], k});
        }
      }
    }
    // unassigned influencers of the new C point lose weight
    for (i32 jj = Sp[i]; jj < Sp[i + 1]; ++jj) {
      i32 j = Sj[jj];
      if (state[j] == U_NODE && lam[j] > 0) {
        --lam[j];
        heap.push({lam[j], j});
      }
    }
  }

  for (i32 i = 0; i < n; ++i)
    splitting[i] = (state[i] == C_NODE) ? 1 : 0;
}

// ---------------------------------------------------------------------------
// RS second pass: ensure strong F-F pairs share a common C point
// (reference ruge_stuben.h:484 semantics).
// ---------------------------------------------------------------------------
void rs_cf_splitting_pass2(i32 n, const i32* Sp, const i32* Sj,
                           i32* splitting) {
  for (i32 row = 0; row < n; ++row) {
    if (splitting[row] != 0) continue;  // F only
    i32 cpt0 = -1;
    for (i32 jj = Sp[row]; jj < Sp[row + 1]; ++jj) {
      i32 j = Sj[jj];
      if (j == row || splitting[j] != 0) continue;
      // does row share a strong C with j?
      bool dep = false;
      for (i32 ii = Sp[row]; ii < Sp[row + 1] && !dep; ++ii) {
        i32 c = Sj[ii];
        if (splitting[c] != 1) continue;
        for (i32 kk = Sp[j]; kk < Sp[j + 1]; ++kk)
          if (Sj[kk] == c) { dep = true; break; }
      }
      if (dep) continue;
      if (cpt0 < 0) {
        cpt0 = j;
        splitting[j] = 1;
      } else {
        splitting[cpt0] = 0;
        cpt0 = j;
        splitting[j] = 1;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Strong F-F filter over the ELL strength layout (reference
// ruge_stuben.h:1133 remove_strong_FF_connections): mark strength entries
// (i, j) with i, j both F-points that share no strong C neighbor.  The
// caller zeroes the marked values.  Decisions are made against the
// ORIGINAL values (drop flags applied afterwards), matching the vectorized
// twin in classical/interpolate.py:108.
//   s_cols/s_vals: (n, Ws) row-major padded strength arrays; a slot is
//   "strong" when slot < s_nnz[row] and s_vals != 0.
// ---------------------------------------------------------------------------
void remove_strong_ff_ell(i32 n, i32 Ws, const i32* s_cols,
                          const f64* s_vals, const i32* s_nnz,
                          const i32* split, i32* drop) {
  std::vector<i32> markstamp(n, -1);
  for (i32 i = 0; i < n; ++i) {
    const i32* ci = s_cols + (size_t)i * Ws;
    const f64* vi = s_vals + (size_t)i * Ws;
    i32* di = drop + (size_t)i * Ws;
    for (i32 t = 0; t < Ws; ++t) di[t] = 0;
    if (split[i] != 0) continue;                    // F rows only
    // mark strong-C neighbors of i
    for (i32 t = 0; t < s_nnz[i]; ++t)
      if (vi[t] != 0 && ci[t] != i && split[ci[t]] == 1)
        markstamp[ci[t]] = i;
    for (i32 t = 0; t < s_nnz[i]; ++t) {
      i32 j = ci[t];
      if (vi[t] == 0 || j == i || split[j] != 0) continue;   // strong F-F
      bool common = false;
      const i32* cj = s_cols + (size_t)j * Ws;
      const f64* vj = s_vals + (size_t)j * Ws;
      for (i32 q = 0; q < s_nnz[j]; ++q)
        if (vj[q] != 0 && markstamp[cj[q]] == i) { common = true; break; }
      if (!common) di[t] = 1;
    }
  }
}

// ---------------------------------------------------------------------------
// Distance-1 (modified) classical interpolation over ELL layouts
// (reference ruge_stuben.h:1083,1239 rs_classical_interpolation_pass1/2;
// exact value semantics of the vectorized twin classical/interpolate.py:130).
// The vectorized twin materializes an (n, Ws, Wa, Ws) 2-hop tensor (~GBs
// at 250k rows); this is the same math as O(nnz * Ws) scalar loops with a
// stamped sparse accumulator.
//   A: (n, Wa) padded operator; S: (n, Ws) padded strength pattern whose
//   values gate "strong" (the slot VALUES used in the formula are A's
//   entries at those columns, looked up here).  Output P: (n, Wp) padded.
// ---------------------------------------------------------------------------
void classical_interpolation_ell(
    i32 n, i32 Wa, const i32* a_cols, const f64* a_vals, const i32* a_nnz,
    i32 Ws, const i32* s_cols, const f64* s_vals, const i32* s_nnz,
    const i32* split, const i32* cmap, i32 modified,
    i32 Wp, i32* p_cols, f64* p_vals, i32* p_nnz) {
  // A diagonal (for a_kk and denominators)
  std::vector<f64> diag(n, 0.0);
  for (i32 i = 0; i < n; ++i) {
    const i32* c = a_cols + (size_t)i * Wa;
    const f64* v = a_vals + (size_t)i * Wa;
    for (i32 t = 0; t < a_nnz[i]; ++t)
      if (c[t] == i) { diag[i] = v[t]; break; }
  }
  // stamped sparse maps: column -> A value of row i / strength slot of i
  std::vector<i32> astamp(n, -1), sstamp(n, -1), slotof(n, 0);
  std::vector<f64> acolval(n, 0.0);
  std::vector<f64> aval_t(Ws), numer(Ws);
  std::vector<i32> cols_t(Ws);
  std::vector<char> is_sc(Ws), is_sf(Ws);

  for (i32 i = 0; i < n; ++i) {
    i32* pc = p_cols + (size_t)i * Wp;
    f64* pv = p_vals + (size_t)i * Wp;
    if (split[i] == 1) {                       // C row: identity
      pc[0] = cmap[i];
      pv[0] = 1.0;
      p_nnz[i] = 1;
      continue;
    }
    const i32* ac = a_cols + (size_t)i * Wa;
    const f64* av = a_vals + (size_t)i * Wa;
    f64 di = 0, pos = 0, neg = 0;
    for (i32 t = 0; t < a_nnz[i]; ++t) {
      i32 j = ac[t];
      astamp[j] = i;
      acolval[j] = av[t];
      if (j == i) di = av[t];
      else if (av[t] > 0) pos += av[t];
      else if (av[t] < 0) neg += av[t];
    }
    // strength slots of row i (value = A entry at that column)
    const i32* sc = s_cols + (size_t)i * Ws;
    const f64* sv = s_vals + (size_t)i * Ws;
    i32 ns = 0;
    f64 ssum = 0;
    for (i32 t = 0; t < s_nnz[i]; ++t) {
      i32 j = sc[t];
      if (sv[t] == 0 || j == i) continue;
      f64 aij = (astamp[j] == i) ? acolval[j] : 0.0;
      cols_t[ns] = j;
      aval_t[ns] = aij;
      is_sc[ns] = (split[j] == 1);
      is_sf[ns] = (split[j] == 0);
      numer[ns] = aij;
      sstamp[j] = i;
      slotof[j] = ns;
      ssum += aij;
      ++ns;
    }
    f64 denom = (di + pos + neg) - ssum;
    if (denom == 0) denom = 1.0;
    // 2-hop corrections through strong-F neighbors k
    for (i32 k = 0; k < ns; ++k) {
      if (!is_sf[k]) continue;
      i32 kc = cols_t[k];
      f64 akk = diag[kc];
      f64 a_ik = aval_t[k];
      const i32* ck = a_cols + (size_t)kc * Wa;
      const f64* vk = a_vals + (size_t)kc * Wa;
      f64 inner = 0;
      for (i32 q = 0; q < a_nnz[kc]; ++q) {
        i32 j2 = ck[q];
        if (sstamp[j2] != i || !is_sc[slotof[j2]]) continue;
        f64 akj = vk[q];
        f64 eff = akj;
        if (modified) {
          int sm = (akj > 0) - (akj < 0);
          int sk = (akk > 0) - (akk < 0);
          if (sm == sk) eff = 0.0;
        }
        inner += eff;
      }
      if (inner == 0) continue;
      for (i32 q = 0; q < a_nnz[kc]; ++q) {
        i32 j2 = ck[q];
        if (sstamp[j2] != i || !is_sc[slotof[j2]]) continue;
        f64 akj = vk[q];
        f64 eff = akj;
        if (modified) {
          int sm = (akj > 0) - (akj < 0);
          int sk = (akk > 0) - (akk < 0);
          if (sm == sk) eff = 0.0;
        }
        if (std::fabs(eff) > 1e-15 * std::fabs(a_ik))
          numer[slotof[j2]] += a_ik * eff / inner;
      }
    }
    i32 m = 0;
    for (i32 t = 0; t < ns; ++t) {
      if (!is_sc[t]) continue;
      pc[m] = cmap[cols_t[t]];
      pv[m] = -numer[t] / denom;
      ++m;
    }
    p_nnz[i] = m;
  }
}

}  // extern "C"
