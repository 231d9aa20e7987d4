// C entry for the stage-2 scorer (scorer.h), loaded via ctypes by the
// Python differential fuzz tests (tests/test_scorer_differential.py).
//
// This is the independently written implementation of the
// BottomOverlapSketch merge automaton (ported from the Java sources, not
// from the Python oracle); fuzzing it pair-by-pair against
// mhap_tpu/oracle/scorer.py targets exactly the semantics that were once
// single-sourced: duplicate-run cursor extension,
// shift-window advances, optimizeShifts dedup, and UMVU rounding.

#include "scorer.h"

extern "C" {

// Returns 1 and fills out[6] = {score, raw, a1, a2, b1, b2} on a match;
// returns 0 for OverlapInfo.EMPTY.
int mhap_score_pair(const int32_t *oh1, const int32_t *op1, int n1,
                    int num_kmers1, const int32_t *oh2, const int32_t *op2,
                    int n2, int num_kmers2, int ordered_kmer_size,
                    double max_shift, double *out) {
  mhap::Sketch s1, s2;
  s1.oh.assign(oh1, oh1 + n1);
  s1.op.assign(op1, op1 + n1);
  s1.num_kmers = num_kmers1;
  s2.oh.assign(oh2, oh2 + n2);
  s2.op.assign(op2, op2 + n2);
  s2.num_kmers = num_kmers2;
  mhap::ScoreParams sp{ordered_kmer_size, max_shift};
  double score = 0.0, raw = 0.0;
  int a1 = 0, a2 = 0, b1 = 0, b2 = 0;
  if (!mhap::get_overlap_info(s1, s2, sp, &score, &raw, &a1, &a2, &b1,
                              &b2))
    return 0;
  out[0] = score;
  out[1] = raw;
  out[2] = a1;
  out[3] = a2;
  out[4] = b1;
  out[5] = b2;
  return 1;
}

}  // extern "C"
