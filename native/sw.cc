// Local Smith-Waterman alignment with affine gaps (Gotoh), plus traceback
// identity statistics.  Rebuild of the reference's single native
// component: the SSW striped Smith-Waterman C library loaded via JNI in
// EstimateROC (reference main/EstimateROC.java:294-313, :789).
//
// Scoring matches the reference's SSW invocation: match=+2, mismatch=-2,
// gap-open 2, gap-extend 1, where a length-L gap costs gapO + (L-1)*gapE
// (SSW recurrence E = max(E - gapE, H - gapO)).
//
// The identity definition mirrors EstimateROC.getScore(ssw.Alignment):
// errors = mismatches + inserted + deleted bases over the aligned region,
// identity = 1 - errors/len where len counts M+I+D columns.
//
// An optional band (|i-j| <= band) accelerates the near-diagonal case used
// by the validation harness; band < 0 means full DP.

#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>

namespace {

struct Cell {
  int32_t h;
  int32_t e;  // gap in query (deletion from ref perspective)
};

enum Trace : uint8_t { T_STOP = 0, T_DIAG = 1, T_UP = 2, T_LEFT = 3 };

}  // namespace

extern "C" {

// Aligns query q (length n) vs reference r (length m) locally.
// Outputs: out[0]=best score, out[1]=q_begin, out[2]=q_end (inclusive),
// out[3]=r_begin, out[4]=r_end, out[5]=matches, out[6]=errors,
// out[7]=alignment length (M+I+D columns).
// Returns 0 on success, -1 if inputs too large.
int mhap_sw_align(const uint8_t* q, int n, const uint8_t* r, int m,
                  int match, int mismatch, int gapo, int gape, int band,
                  int64_t* out) {
  if (n <= 0 || m <= 0) return -1;
  // traceback matrix: (n+1) x (m+1) 2-bit codes packed in bytes (simple).
  // For very large problems this is the memory bottleneck; the validation
  // harness aligns read-overlap regions (<= ~50kb), which fits.
  size_t tb_size = (size_t)(n + 1) * (size_t)(m + 1);
  if (tb_size > (size_t)4e9) return -1;
  std::vector<uint8_t> tb_h(tb_size, T_STOP);

  std::vector<Cell> row(m + 1);
  std::vector<int32_t> f_row(m + 1);  // gap in ref (vertical)
  for (int j = 0; j <= m; ++j) {
    row[j].h = 0;
    row[j].e = INT32_MIN / 2;
    f_row[j] = INT32_MIN / 2;
  }

  int32_t best = 0;
  int best_i = 0, best_j = 0;

  for (int i = 1; i <= n; ++i) {
    int32_t h_diag = 0;  // H[i-1][j-1]
    int jlo = 1, jhi = m;
    if (band >= 0) {
      jlo = std::max(1, i - band);
      jhi = std::min(m, i + band);
      if (jlo > 1) h_diag = 0;
    }
    int32_t h_left = 0;       // H[i][j-1]
    int32_t e_left = INT32_MIN / 2;
    if (jlo > 1) {
      h_diag = row[jlo - 1].h;
      row[jlo - 1].h = 0;  // outside band treated as 0 start (local align)
    }
    for (int j = jlo; j <= jhi; ++j) {
      int32_t up_h = row[j].h;  // H[i-1][j]
      // E: gap in query (move along ref), from left
      int32_t e = std::max(e_left - gape, h_left - gapo);
      // F: gap in ref (move along query), from up
      int32_t f = std::max(f_row[j] - gape, up_h - gapo);
      int32_t diag = h_diag + (q[i - 1] == r[j - 1] ? match : mismatch);
      int32_t h = std::max({0, diag, e, f});

      uint8_t code = T_STOP;
      if (h > 0) {
        if (h == diag) code = T_DIAG;
        else if (h == f) code = T_UP;
        else code = T_LEFT;
      }
      tb_h[(size_t)i * (m + 1) + j] = code;

      if (h > best) {
        best = h;
        best_i = i;
        best_j = j;
      }
      h_diag = up_h;
      h_left = h;
      e_left = e;
      row[j].h = h;
      row[j].e = e;
      f_row[j] = f;
    }
    if (band >= 0 && jhi < m) row[jhi + 1].h = 0;
  }

  // traceback from (best_i, best_j)
  int64_t matches = 0, errors = 0, length = 0;
  int i = best_i, j = best_j;
  int q_end = best_i - 1, r_end = best_j - 1;
  while (i > 0 && j > 0) {
    uint8_t code = tb_h[(size_t)i * (m + 1) + j];
    if (code == T_STOP) break;
    if (code == T_DIAG) {
      if (q[i - 1] == r[j - 1]) matches++; else errors++;
      length++;
      i--; j--;
    } else if (code == T_UP) {
      errors++; length++;
      i--;
    } else {  // T_LEFT
      errors++; length++;
      j--;
    }
  }
  out[0] = best;
  out[1] = i;          // q_begin (0-based)
  out[2] = q_end;      // q_end inclusive
  out[3] = j;          // r_begin
  out[4] = r_end;
  out[5] = matches;
  out[6] = errors;
  out[7] = length;
  return 0;
}

}  // extern "C"
